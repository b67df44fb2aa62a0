"""device_kernels_per_spp: device kernels per sample per pixel in the
traced stretch of whole frames (torch.profiler's device activities, copies
and sets left out): the launch rate of the pools and the estimators."""
LAYER = "estimator"
SOURCE = "device_trace"
UNIT = "kernels/spp"
MOVES = "ms_per_spp"


def read(rec):
    p = rec["profile"]
    if not p or not p["kernels"]:
        return None
    return p["kernels"] / p["frames"]
