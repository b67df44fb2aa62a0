"""walk_sort_ms_per_spp: the host's time in the row walk's coherence sort
per sample per pixel, the program's spans `walk.sort` around
`sort_rays_live` in ops/ray_walk.prepare, summed over the traced
stretch's frames. A reading of the stretch, traced on the device, where
each launch carries the profiler's cost: not comparable with
`ms_per_spp`, only with itself. None where the program records none (a
scene in another mode, or a program without this span)."""
from perfbench.harness import program

LAYER = "traversal wrappers"
SOURCE = "program_span"
UNIT = "ms/spp"
MOVES = "ms_per_spp"


def read(rec):
    return program.span_ms_per_spp(rec, "walk.sort")
