"""walk_trace_ms_per_spp: the host's time in the row walk's trace calls per
sample per pixel, the program's spans `walk.closest` and `walk.any` around
the walk branch of the trace API (scene/scene.py: whole calls, the parts
walked in turn and their sort included), summed over the traced stretch's
frames. A reading of the stretch, traced on the device, where each launch
carries the profiler's cost: not comparable with `ms_per_spp`, only with
itself. None where the program records none (a scene in another mode, or
a program without these spans)."""
from perfbench.harness import program

LAYER = "traversal wrappers"
SOURCE = "program_span"
UNIT = "ms/spp"
MOVES = "ms_per_spp"
SPANS = ("walk.closest", "walk.any")


def read(rec):
    got = [program.span_ms_per_spp(rec, name) for name in SPANS]
    got = [v for v in got if v is not None]
    return sum(got) if got else None
