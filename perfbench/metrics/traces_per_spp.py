"""traces_per_spp: traversal kernel launches per sample per pixel over the
timed window, from the program's exact counters
(spcbpt_tpu_torch.kernels.read_launches, one count a launch: pool
iterations times traces an iteration). None where nothing launched (the
CPU's plain routes)."""
LAYER = "pool loop"
SOURCE = "program_counter"
UNIT = "launches/spp"
MOVES = "ms_per_spp"


def read(rec):
    n = sum(rec["launches"].values())
    return n / rec["frames"] if n else None
