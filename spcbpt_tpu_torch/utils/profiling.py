"""Phase timers and device traces.

Port of spcbpt_tpu/utils/profiling.py (reference: the wall-clock section
timers of the ImGui overlay, optixPathTracer.cpp:787-817, sutil.cpp:715-752,
and the CUDA-event stage timers of training, device_thrust.h:16-30): a phase
timer whose fence synchronises the devices of the tensors it is given, and
a torch.profiler trace context that writes a Chrome trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import time
from collections import defaultdict

import torch


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
        t0 = time.perf_counter()
        holder = {}
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
    `trace.json` into logdir (view with chrome://tracing or Perfetto) and
    yields the profiler (its events() for counts)."""
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
