"""eye_pass_ms: the mean span of a frame's eye pool
(render/spcbpt_pool.py with render/spcbpt.py and render/rmis.py) and the
progressive sums, from the sync after the light pass to the frame's, over
the traced stretch's frames. The benchmark's own span; none in a cell
without a light pass."""
LAYER = "eye pool"
SOURCE = "host_clock"
UNIT = "ms"
MOVES = "ms_per_spp"


def read(rec):
    spans = rec["spans"]["eye_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
