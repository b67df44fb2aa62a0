"""light_pass_ms: the mean span of a frame's light pass, the light
sub-paths (render/light_trace.py) and their sampler (render/lvc.py), from
the frame's start to a sync after the sampler's build, over the traced
stretch's frames (the timed window has no such sync). The benchmark's own
span; none in a cell without a light pass."""
LAYER = "light pass"
SOURCE = "host_clock"
UNIT = "ms"
MOVES = "ms_per_spp"


def read(rec):
    spans = rec["spans"]["light_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
