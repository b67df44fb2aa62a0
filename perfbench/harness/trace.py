"""Traced stretches of whole frames under torch.profiler, reduced in
memory to a small summary; no trace file is written.

The summary: the stretch's wall seconds; the device's busy seconds (the
union of every device activity's interval); each device activity name's
seconds and count; the ten names that took the most device time; and the
ten longest kinds of idle gap, each named by the host operation that
overlapped it most (the outermost operation on the host's clock; "host
outside any op" where none did).
"""
from __future__ import annotations

import bisect
import collections
import re
import time

import torch

from .frames import sync

TOP = 10
_COPY = re.compile(r"^(Memcpy|Memset)")
_NOISE = re.compile(r"^void |\bat::native::|\bat_cuda_detail::|\bat::cuda::|"
                    r"\bbinary_internal::|\(anonymous namespace\)::")


def short_name(name: str) -> str:
    """A device activity's name without its namespaces, to 120 letters:
    the functor that says what an elementwise kernel computes stays in."""
    return _NOISE.sub("", name)[:120]


def _events(prof):
    """(name, on_device, start_ns, end_ns) of every profiled activity, read
    from the profiler's raw results (some 10^5 device activities a frame:
    no event tree is built)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        s = e.start_ns()
        out.append((e.name(), dev, s, s + e.duration_ns()))
    return out


def _union(spans):
    """The merged intervals of (start, end) spans, sorted."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _outermost(spans):
    """The host operations not inside another: (start, end, name), sorted."""
    out = []
    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        if out and e <= out[-1][1]:
            continue
        out.append((s, e, n))
    return out


def summarize(events, t0_ns: int, t1_ns: int) -> dict:
    dev = [(s, e, n) for n, d, s, e in events if d and e > s
           and s >= t0_ns and e <= t1_ns]
    host = [(s, e, n) for n, d, s, e in events if not d and e > s]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for s, e, n in dev:
        k = by_name[n]
        k[0] += (e - s) / 1e9
        k[1] += 1
    busy = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    # idle gaps inside the stretch, named by the host ops overlapping them
    gaps, cur = [], t0_ns
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1_ns > cur:
        gaps.append((cur, t1_ns))
    ops = _outermost(host)
    starts = [o[0] for o in ops]
    idle = collections.defaultdict(float)
    for g0, g1 in gaps:
        left = g1 - g0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(ops) and ops[i][0] < g1:
            s, e, n = ops[i]
            ov = min(e, g1) - max(s, g0)
            if ov > 0:
                idle[n] += ov / 1e9
                left -= ov
            i += 1
        if left > 0:
            idle["host outside any op"] += left / 1e9
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "wall_s": (t1_ns - t0_ns) / 1e9,
        "busy_s": busy_s,
        "by_name": {n: v for n, v in by_name.items()},
        "kernels": sum(v[1] for n, v in by_name.items()
                       if not _COPY.match(n)),
        "device_ops": [[short_name(n), v[0]] for n, v in ranked[:TOP]],
        "idle_gaps": [[n[:120], v] for n, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def _profiled(render_frames, device, acts):
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        sync(device)
        render_frames()
        sync(device)
    events = _events(prof)
    lo = min(s for _, _, s, e in events if e > s)
    hi = max(e for _, _, s, e in events if e > s)
    return events, lo, hi


def profile(render_frames, gap_frame, device) -> dict:
    """The summary of a stretch of frames, render_frames(), traced on the
    device alone (the host's activities are not recorded, so that the
    host runs at its own pace); the stretch runs from its first recorded
    activity to its last, the syncs before and after the frames. The idle
    gaps are named from one more frame, gap_frame(), traced on the host as
    well (recording every host op slows the host, so its busy share is not
    the one reported)."""
    cpu = torch.profiler.ProfilerActivity.CPU
    acts = [cpu]
    if torch.device(device).type == "cuda":
        acts = [torch.profiler.ProfilerActivity.CUDA]
    t_reduce = 0.0
    events, lo, hi = _profiled(render_frames, device, acts)
    t0 = time.perf_counter()
    out = summarize(events, lo, hi)
    t_reduce += time.perf_counter() - t0
    out["events"] = len(events)
    events, lo, hi = _profiled(gap_frame, device, sorted(
        {cpu, *acts}, key=lambda a: a.value))
    t0 = time.perf_counter()
    out["idle_gaps"] = summarize(events, lo, hi)["idle_gaps"]
    out["reduce_s"] = t_reduce + time.perf_counter() - t0
    return out
