"""pool_sync_ms_per_spp: the host's time blocked on the device per sample
per pixel, the program's spans `<pool>.sync` around the host read of each
pool's loop condition (render/pt_pool.py, render/spcbpt_pool.py), over the
traced stretch's frames. A reading of the stretch, traced on the device,
where each launch carries the profiler's cost: not comparable with
`ms_per_spp`, only with itself. None where the program records none."""
from perfbench.harness import program

LAYER = "pool loop"
SOURCE = "program_span"
UNIT = "ms/spp"
MOVES = "ms_per_spp"


def read(rec):
    return program.span_ms_per_spp(rec, ".sync")
