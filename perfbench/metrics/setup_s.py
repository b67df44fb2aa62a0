"""setup_s: from the process's start to the first timed frame: imports,
CUDA context, scene and clusters, kernel libraries, the state from the
seed and one warm-up frame. Host clock."""
LAYER = "end to end"
SOURCE = "host_clock"
UNIT = "s"
MOVES = None


def read(rec):
    return rec["setup_s"]
