"""lvc_build_ms_per_spp: the host's time in a frame's light-vertex-cache
sampler build per sample per pixel, the program's spans `lvc.build`
around the builder that `make_builder` returns (render/lvc.py: the
vertices sorted into subspace segments, their CMFs, the packed matrix
and the presampled tables), summed over the traced stretch's frames.
With `light_trace_ms_per_spp` it splits the light pass into tracing and
its sampler. A reading of the stretch, traced on the device, where each
launch carries the profiler's cost: not comparable with `ms_per_spp`,
only with itself. None where the program records no such span (a cell
without a light pass, or a program without this span)."""
from perfbench.harness import program

LAYER = "light pass"
SOURCE = "program_span"
UNIT = "ms/spp"
MOVES = "ms_per_spp"


def read(rec):
    return program.span_ms_per_spp(rec, "lvc.build")
