"""The program's own spans and counters over the traced stretch, for the
per-layer metrics whose `source` is `program_span` or `program_counter`.

The program's recorder (`spcbpt_tpu_torch.utils.profiling`) records its
spans and host counters while torch.profiler profiles, and at no other
time: the window and the warm-up frame are not recorded. So it holds the
traced stretch's frames (`cell.TRACE_FRAMES`, traced on the device alone)
and, last, the frame that names the idle gaps (traced on the host too,
which slows the host), which is left out here. Every launch of the
stretch carries the profiler's cost, so a time read here is the
stretch's and not comparable with the window's `ms_per_spp`.
"""
from __future__ import annotations

from .cell import TRACE_FRAMES


def stretch(rec: dict):
    """The stretch as the program recorded it: {"frames": pool renders,
    "spans": [Span] closed in them, "counters": {name: total}}. None in
    an untraced run (`rec` has no `profile`) and where the program has no
    recorder (a checkout from before it). Raises where the program has
    its recorder but recorded no pool render in a traced run."""
    if not rec.get("profile"):
        return None
    try:
        from spcbpt_tpu_torch.utils.profiling import collect
    except ImportError:
        return None
    got = collect(clear=False)
    last = got["frames"] - 1            # the gap frame
    frames = set(range(max(last - TRACE_FRAMES, 0), last))
    spans = [s for s in got["spans"]
             if s.frame in frames and s.end_ns is not None]
    n = sum(1 for s in spans if s.name.endswith(".render"))
    if not n:
        raise RuntimeError(
            "the program's recorder holds no pool render of the traced "
            f"stretch ({got['frames']} frames, {len(got['spans'])} spans): "
            "does utils/profiling.is_recording still see torch.profiler?")
    counters = {name: sum(v for f, v in by.items() if f in frames)
                for name, by in got["counters"].items()}
    return {"frames": n, "spans": spans, "counters": counters}


def span_ms_per_spp(rec: dict, suffix: str):
    """The summed durations of the stretch's spans whose name ends in
    `suffix`, in ms per frame (one sample per pixel); None where the
    stretch is not recorded or has none."""
    p = stretch(rec)
    if p is None:
        return None
    ns = [s.end_ns - s.start_ns for s in p["spans"]
          if s.name.endswith(suffix)]
    return sum(ns) / 1e6 / p["frames"] if ns else None
