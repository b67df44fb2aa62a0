"""The CUDA kernels of csrc/, built at first use (build.py), their bindings
and their launch counters: each binding adds one to its module's LAUNCHES
where it launches its kernel. A launch recorded into a CUDA graph runs
only when the graph is replayed: `capture_launches` takes a capture's
launches back out of the counters and `add_launches` counts them once a
replay, so that the counters stay one count a launch that ran."""
from __future__ import annotations

import contextlib
import importlib

KERNEL_MODULES = ("ray_walk", "brute_trace", "tile_walk", "list_walk")


def _modules():
    return [importlib.import_module(f"{__name__}.{m}") for m in KERNEL_MODULES]


def reset_launches() -> None:
    for mod in _modules():
        mod.reset_launches()


def read_launches() -> dict:
    """Every kernel's launches since the last reset, by kernel name."""
    out = {}
    for mod in _modules():
        out.update(mod.LAUNCHES)
    return out


@contextlib.contextmanager
def capture_launches():
    """Around a CUDA graph capture: the launches the bindings count inside
    the block are recorded, not run. They are taken back out of the
    counters, and the yielded dict gets them by kernel name, for
    `add_launches` at each replay."""
    before = read_launches()
    captured = {}
    try:
        yield captured
    finally:
        for mod in _modules():
            for name, n in mod.LAUNCHES.items():
                if n != before[name]:
                    captured[name] = n - before[name]
                    mod.LAUNCHES[name] = before[name]


def add_launches(launches: dict) -> None:
    """Counts the launches of a replayed CUDA graph (by kernel name, as
    `capture_launches` yields them)."""
    for mod in _modules():
        for name in launches.keys() & mod.LAUNCHES.keys():
            mod.LAUNCHES[name] += launches[name]
