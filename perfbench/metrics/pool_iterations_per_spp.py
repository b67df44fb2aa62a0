"""pool_iterations_per_spp: the pools' loop iterations per sample per
pixel, from the program's exact counters `<pool>.iterations`
(render/pt_pool.py, render/spcbpt_pool.py: one a pass of the loop body,
each pass ended by a host read of the loop condition), over the traced
stretch's frames: a mean of `cell.TRACE_FRAMES` frames, so two runs of
one seed, whose stretches render other subframes, differ by a frame's
iteration or two. None where the program records none."""
from perfbench.harness import program

LAYER = "pool loop"
SOURCE = "program_counter"
UNIT = "iterations/spp"
MOVES = "ms_per_spp"


def read(rec):
    p = program.stretch(rec)
    if p is None:
        return None
    n = sum(v for k, v in p["counters"].items() if k.endswith(".iterations"))
    return n / p["frames"] if n else None
