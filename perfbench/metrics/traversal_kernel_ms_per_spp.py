"""traversal_kernel_ms_per_spp: device time of the traversal kernels per
sample per pixel in the traced stretch, by the names the profiler gives
them: the kernels of spcbpt_tpu_torch/csrc/ (ray_walk.cu K1/K2,
brute_trace.cu K3, tile_walk.cu K4/K5, list_walk.cu K6) are defined in
anonymous namespaces under the names below."""
import re

LAYER = "kernels"
SOURCE = "device_trace"
UNIT = "ms/spp"
MOVES = "ms_per_spp"
KERNELS = ("closest_kernel", "any_kernel", "closest_walk_kernel",
           "any_tile_kernel", "round_walk_kernel", "round_kernel")
_NAME = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)[<(]")


def is_traversal(name: str) -> bool:
    m = _NAME.match(name)
    return bool(m) and m.group(1) in KERNELS


def read(rec):
    p = rec["profile"]
    if not p:
        return None
    s = sum(v[0] for n, v in p["by_name"].items() if is_traversal(n))
    return 1e3 * s / p["frames"] if s else None
