"""The port's phase timer and device trace (utils/profiling.py) against the
JAX package's: the same report for the same totals, a fence over nested
tensors, and a Chrome trace written by torch.profiler on the CPU."""
import json
import os

import torch

from spcbpt_tpu.utils import profiling as jprof
from spcbpt_tpu_torch.ops.intersect import Hit
from spcbpt_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

TOTALS = {"light_trace": (0.75, 3), "eye": (1.5, 4), "build": (0.0125, 1)}


def _filled(cls):
    timer = cls()
    for name, (total, calls) in TOTALS.items():
        timer.totals[name] = total
        timer.counts[name] = calls
    return timer


def test_report_matches_jax():
    jt, tt = _filled(jprof.PhaseTimer), _filled(tprof.PhaseTimer)
    assert tt.report() == jt.report()
    assert tt.as_dict() == jt.as_dict()
    assert tt.report().splitlines()[0].strip().startswith("eye:")


def test_phase_fences_nested_cpu_tensors():
    """A fence of tuples, dicts and Hits on the CPU: the phase is timed and
    counted, and no CUDA device is named."""
    x = torch.arange(16.0)
    hit = Hit(t=x, tri=x.to(torch.int32), u=x, v=x)
    fence = (x, [hit, {"a": x * 2}], 3)
    assert tprof._cuda_devices(fence, set()) == set()
    timer = tprof.PhaseTimer()
    for _ in range(2):
        with timer.phase("render") as h:
            h["fence"] = fence
    with timer.phase("idle"):
        pass
    assert timer.counts == {"render": 2, "idle": 1}
    assert all(v >= 0.0 for v in timer.totals.values())


def test_device_trace_cpu_writes_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.device_trace(logdir, "cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
