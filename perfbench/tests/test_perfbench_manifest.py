"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""
import json
import os
import re

import pytest

from conftest import ROOT, add_cell, make_checkout
from perfbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_manifest_keys_and_names(manifest_copy):
    man = manifest_copy
    assert set(man) == KEYS
    assert man["command"] == ["python3", "perfbench/run.py"]
    assert man["paths"] == ["perfbench"]
    assert 1 <= man["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in man[k]}) == len(man[k])
    metrics = man["end_to_end"] + man["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/")
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        # every per-layer metric names the cells that report it
        assert m["workloads"] and set(m["workloads"]) <= cells


def test_every_cell_reports_what_the_contract_asks(manifest_copy):
    man = manifest_copy
    for w in man["workloads"]:
        e2e = {m["name"] for m in manifest.reported(man, w, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.reported(man, w, "per_layer")
    e2e_names = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e_names


def test_check_budget_fits(manifest_copy):
    runs = 2 + 14 * 24
    total = runs * (manifest_copy["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_every_file_is_found_by_name(manifest_copy):
    man = manifest_copy
    for w in man["workloads"]:
        cfg = manifest.config(man, w["config"])
        assert cfg["name"] == w["config"]
        assert manifest.traffic(w["traffic"])["algorithm"] in ("pt",
                                                               "spcbpt")
        lim = manifest.limits(w["name"])
        light = {"light_mismatch_share"} if w["traffic"] == "spcbpt_frames" \
            else set()
        assert set(lim) == {"mismatch_share", "count_errors"} | light
        assert lim["count_errors"] == 0
    for m in man["end_to_end"] + man["per_layer"]:
        mod = manifest.reader(m["name"])
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
        assert callable(mod.read)
        if m in man["per_layer"]:
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]


@pytest.mark.parametrize("cell", ["cornell_spcbpt_1920"])
def test_cell_added_as_files_alone_is_found(tmp_path, cell):
    root = make_checkout(str(tmp_path / "checkout"))
    before = {p for p in _files(root)}
    add_cell(root, "added_cell", "tiny_cornell", "tiny_pt", cell)
    man = manifest.load(root)
    wl = manifest.workload(man, "added_cell")
    assert manifest.config(man, wl["config"], root)["image"] == [16, 16]
    assert manifest.traffic(wl["traffic"], root)["n_pool"] == 128
    assert manifest.limits("added_cell", root) == manifest.limits(cell)
    per_layer = {m["name"] for m in manifest.reported(man, wl, "per_layer")}
    assert "traces_per_spp" in per_layer
    # only the manifest changed among the files that were there
    changed = {p for p in before if p != "BENCHMARK.json"
               and _read(root, p) != _read(ROOT, p)}
    assert not changed


def _files(root):
    for d, _, fs in os.walk(root):
        for f in fs:
            yield os.path.relpath(os.path.join(d, f), root)


def _read(root, rel):
    with open(os.path.join(root, rel), "rb") as f:
        return f.read()


def test_config_files_hold_the_scene(manifest_copy):
    for c in manifest_copy["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["precision"] == "float32"
        assert len(cfg["image"]) == 2 and "scene" in cfg
