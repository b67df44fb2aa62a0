"""light_trace_ms_per_spp: the host's time in a frame's light sub-path
tracing per sample per pixel, the program's spans `light_trace.paths`
around `trace_light_paths` (render/light_trace.py: the whole call, its
trace calls and, on a walk scene, their `walk.*` spans included), summed
over the traced stretch's frames. With `lvc_build_ms_per_spp` it splits
the light pass into tracing and its sampler. A reading of the stretch,
traced on the device, where each launch carries the profiler's cost: not
comparable with `ms_per_spp`, only with itself. None where the program
records no such span (a cell without a light pass, or a program without
this span)."""
from perfbench.harness import program

LAYER = "light pass"
SOURCE = "program_span"
UNIT = "ms/spp"
MOVES = "ms_per_spp"


def read(rec):
    return program.span_ms_per_spp(rec, "light_trace.paths")
