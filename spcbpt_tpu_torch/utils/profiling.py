"""Phase timers, device traces, and the port's recorder of spans and
counters.

Port of spcbpt_tpu/utils/profiling.py (reference: the wall-clock section
timers of the ImGui overlay, optixPathTracer.cpp:787-817, sutil.cpp:715-752,
and the CUDA-event stage timers of training, device_thrust.h:16-30): a phase
timer whose fence synchronises the devices of the tensors it is given, and
a torch.profiler trace context that writes a Chrome trace.

The recorder (`span`, `traced`, `read_flag`, `count`, `collect`; the
port's own, no JAX counterpart) keeps spans and host counters of the
program in memory while torch.profiler profiles, so that a profile
carries the program's spans, and at no other time. Off, a site costs one
check and returns a shared no-op context: no clock read, no allocation,
no device op. `device_trace` collects around its own block; a process
that profiles by torch.profiler directly calls `collect` itself.

* A span: its name, start and end in Unix-epoch nanoseconds
  (`time.time_ns()`: the clock of torch.profiler's events,
  `kineto_results.events()`' `start_ns()`, host and CUDA alike, and of
  its Chrome trace's `baseTimeNanoseconds`; tests/test_torch_recorder.py
  and, on the card, perfbench/tests/test_perfbench_program.py hold a span
  against the profiler's events), the index of the span open around it
  (-1: none), and its frame.
* A frame: the number of spans opened with `ends_frame` (the pools'
  renders) that had ended when the span opened.
* A host counter: a Python int added at a site, kept per frame.

One recorder serves the process, as torch.profiler does, so that sites
deep in the call tree take no argument; it is meant for one thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import time
from collections import defaultdict, namedtuple

import torch
import torch.autograd.profiler as _autograd_profiler

# spans, and counter entries, kept at most (beyond it they are counted as
# dropped): a profiled process that never collects stays bounded
MAX_SPANS = 1 << 16

Span = namedtuple("Span", "name start_ns end_ns parent frame")


def nvidia_smi_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them: the
    label of every time measured on it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of every tensor inside x (tensors, tuples, lists,
    dict values and dataclass fields, nested)."""
    if torch.is_tensor(x):
        if x.device.type == "cuda":
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _cuda_devices(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _cuda_devices(y, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)
    return out


def fence(x) -> None:
    """Wait for the work of every CUDA device holding a tensor of x (CPU
    tensors are ready when an op returns)."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulating per-phase wall timers with device fences.

    with timer.phase("light_trace") as h: h["fence"] = result
    print(timer.report())
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Times the block, its fence included; recorded as span `name`
        while the recorder records."""
        t0 = time.perf_counter()
        holder = {}
        with span(name):
            try:
                yield holder
            finally:
                if "fence" in holder:
                    fence(holder["fence"])
                dt = time.perf_counter() - t0
                self.totals[name] += dt
                self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:>16}: {tot*1e3:9.1f} ms total, "
                         f"{tot/n*1e3:8.2f} ms/call x{n}")
        return "\n".join(lines)

    def as_dict(self):
        return {k: {"total_s": self.totals[k], "calls": self.counts[k]}
                for k in self.totals}


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """torch.profiler over the block: CPU and CUDA activities on a CUDA
    device, the CPU's alone on the CPU. Writes the Chrome trace
    `trace.json` into logdir (view with chrome://tracing or Perfetto),
    with the program's spans of the block on a track of their own
    ("program"), on the trace's time axis, and yields the profiler (its
    events() for counts). The recorder is emptied before the block and
    after it."""
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    collect()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, collect()["spans"])


def _add_spans(path: str, spans) -> None:
    """Appends closed spans to the Chrome trace at path as complete events
    on thread 0 ("program") of this process (ts and dur in microseconds
    from the trace's `baseTimeNanoseconds`)."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = trace["traceEvents"]
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "program"}})
    for name, t0, t1, _, frame in spans:
        if t1 is not None:
            events.append({"ph": "X", "cat": "program", "name": name,
                           "pid": pid, "tid": 0,
                           "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3,
                           "args": {"frame": frame}})
    with open(path, "w") as f:
        json.dump(trace, f)


class _Recorder:
    """The recorder's state (one, `_REC`)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.spans = []          # [name, start_ns, end_ns, parent, frame]
        self.open = []           # indices of the spans open, innermost last
        self.host = defaultdict(int)    # (name, frame) -> int
        self.frame = 0
        self.dropped = 0


_REC = _Recorder()
# the shared context of a site while nothing records
_NULL = contextlib.nullcontext()


def is_recording() -> bool:
    """True while torch.profiler profiles: the flag that
    `torch.autograd.profiler.profile` (under torch.profiler.profile) sets
    while it runs, private to torch (tests/test_torch_recorder.py fails if
    it goes; the benchmark's readers fail if a traced run records
    nothing)."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


class _Span:
    __slots__ = ("name", "ends_frame", "index")

    def __init__(self, name: str, ends_frame: bool):
        self.name = name
        self.ends_frame = ends_frame

    def __enter__(self):
        rec = _REC
        if len(rec.spans) >= MAX_SPANS:
            rec.dropped += 1
            self.index = -1
        else:
            self.index = len(rec.spans)
            rec.spans.append([self.name, time.time_ns(), None,
                              rec.open[-1] if rec.open else -1, rec.frame])
            rec.open.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = _REC
        if self.index >= 0 and rec.open and rec.open[-1] == self.index:
            rec.spans[self.index][2] = time.time_ns()
            rec.open.pop()
        if self.ends_frame:
            rec.frame += 1
        return False


def span(name: str, ends_frame: bool = False):
    """A context recording span `name` over its block (`ends_frame`: the
    block is a frame's pool render, after which the next frame begins)."""
    return _Span(name, ends_frame) if is_recording() else _NULL


def traced(name: str, ends_frame: bool = False):
    """A decorator recording span `name` over each call."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not is_recording():
                return fn(*args, **kwargs)
            with _Span(name, ends_frame):
                return fn(*args, **kwargs)
        return call
    return wrap


def read_flag(name: str, flag) -> bool:
    """bool(flag), a device tensor read on the host, inside span `name`:
    the time the host waits for the device."""
    with span(name):
        return bool(flag)


def count(name: str, n: int) -> None:
    """Adds n to host counter `name` of the current frame."""
    if not is_recording():
        return
    rec = _REC
    key = (name, rec.frame)
    if key not in rec.host and len(rec.host) >= MAX_SPANS:
        rec.dropped += 1
    else:
        rec.host[key] += int(n)


def collect(clear: bool = True) -> dict:
    """What the recorder holds: {"spans": [Span], "counters": {name:
    {frame: int}}, "frames": frames begun, "dropped": spans and counter
    entries not kept}; (`clear`) empties the recorder. Call it outside
    every span (a span still open has end_ns None)."""
    rec = _REC
    counters = defaultdict(dict)
    for (name, frame), n in rec.host.items():
        counters[name][frame] = n
    out = {"spans": [Span(*s) for s in rec.spans],
           "counters": dict(counters), "frames": rec.frame,
           "dropped": rec.dropped}
    if clear:
        rec.clear()
    return out
