"""Fixtures of the benchmark's own tests (`python -m pytest perfbench/tests
-q`): a temporary checkout whose cells are tiny copies of the benchmark's,
added as data files alone, which the harness runs on the CPU; and the
`card` marker, whose tests skip where no CUDA card is found (decided in a
fixture, never when a module is imported)."""
import copy
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

# the limits of a tiny path-tracing cell (no cell of the benchmark traces
# paths alone yet)
PT_LIMITS = {"mismatch_share": 0.01, "count_errors": 0}
# tiny cells: (name, config, traffic, the cell whose limits it takes, or
# the limits themselves)
TINY_CELLS = (
    ("tiny_cornell_pt", "tiny_cornell", "tiny_pt", PT_LIMITS),
    ("tiny_cornell_spcbpt", "tiny_cornell", "tiny_spcbpt",
     "cornell_spcbpt_1920"),
    ("tiny_wide_spcbpt", "tiny_wide", "tiny_spcbpt", "cornell_spcbpt_1920"),
)
TINY_CONFIGS = {
    "tiny_cornell": {"scene": {"file":
                               "perfbench/scenes/cornell/cornell.scene"},
                     "image": [16, 16]},
    "tiny_wide": {"scene": {"file": "perfbench/scenes/cornell/cornell.scene"},
                  "image": [24, 12]},
}
TINY_TRAFFIC = {
    "tiny_pt": {"algorithm": "pt", "max_depth": 30, "n_pool": 128,
                "check_frames": 2},
    "tiny_spcbpt": {"algorithm": "spcbpt", "light_paths": 512,
                    "light_depth": 4, "eye_depth": 4, "connection_n": 3,
                    "n_pool": 128},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where there is none)")


def write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def add_cell(root: str, name: str, config: str, traffic: str,
             limits_of) -> None:
    """Adds a cell to the checkout at root as files and a manifest entry
    alone: its config and traffic files (from the tiny ones), its limits
    (those of an existing cell, or a dict), and the cell's name on every
    per-layer metric."""
    bench = os.path.join(root, "perfbench")
    man_path = os.path.join(root, "BENCHMARK.json")
    with open(man_path) as f:
        man = json.load(f)
    if config not in {c["name"] for c in man["configs"]}:
        write_json(os.path.join(bench, "configs", f"{config}.json"),
                   dict(TINY_CONFIGS[config], name=config))
        man["configs"].append({"name": config, "source": "tiny test copy",
                               "file": f"perfbench/configs/{config}.json",
                               "reduced": [], "why": "CPU test"})
    write_json(os.path.join(bench, "traffic", f"{traffic}.json"),
               TINY_TRAFFIC[traffic])
    if isinstance(limits_of, dict):
        write_json(os.path.join(bench, "limits", f"{name}.json"), limits_of)
    else:
        shutil.copy(os.path.join(bench, "limits", f"{limits_of}.json"),
                    os.path.join(bench, "limits", f"{name}.json"))
    man["workloads"].append({"name": name, "config": config,
                             "traffic": traffic, "chips": 1,
                             "why": "CPU test"})
    for m in man["per_layer"]:
        m["workloads"].append(name)
    write_json(man_path, man)


def make_checkout(dest: str) -> str:
    """A copy of the benchmark's files (BENCHMARK.json and perfbench/)."""
    os.makedirs(dest, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(dest, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = make_checkout(str(tmp_path_factory.mktemp("checkout")))
    for cell in TINY_CELLS:
        add_cell(root, *cell)
    return root


@pytest.fixture(scope="session", autouse=True)
def _threads():
    import torch
    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def manifest_copy():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return copy.deepcopy(json.load(f))
