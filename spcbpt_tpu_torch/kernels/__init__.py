"""The CUDA kernels of csrc/, built at first use (build.py), their bindings
and their launch counters: each binding adds one to its module's LAUNCHES
where it launches its kernel."""
from __future__ import annotations

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
