"""device_busy_pct: the union of the device's activity over the traced
stretch of whole frames, as a share of the stretch's wall time."""
LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "ms_per_spp"


def read(rec):
    p = rec["profile"]
    if not p or not p["busy_s"]:
        return None
    return 100.0 * p["busy_s"] / p["wall_s"]
