"""ms_per_spp: the timed window's milliseconds over the frames it
completed, a frame being one sample of every pixel. The window runs from
its start to the end of the first frame that ends after --seconds; every
frame ends in a device sync. Host clock."""
LAYER = "end to end"
SOURCE = "host_clock"
UNIT = "ms/spp"
MOVES = None


def read(rec):
    return 1e3 * rec["window_s"] / rec["frames"]
