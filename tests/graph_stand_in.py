"""A stand-in, on the CPU, for the CUDA graph capture of the pool loop and
of the light pass and its sampler build (render/pool.py): `graphed` takes
the graph route on any device, and the traces count their launches as the
card's bindings do (one K3 launch a brute call, one K1 or K2 launch a walk
part). Its capture runs the eager warm-up pass, whose launches count, then
a 'capture' that records the same launches, which do not run; a replay
runs the captured function again, counting nothing, and the caller adds
the recorded launches. The card's capture and replay are checked by
chip_smoke.py. `refuse_host_data` refuses what a capture cannot record."""
import weakref

import pytest
import torch

from spcbpt_tpu_torch import kernels
from spcbpt_tpu_torch.kernels import brute_trace as brute_kernels
from spcbpt_tpu_torch.kernels import ray_walk as walk_kernels
from spcbpt_tpu_torch.ops import brute_trace, ray_walk
from spcbpt_tpu_torch.render import light_trace, lvc, pool, pt_pool
from spcbpt_tpu_torch.render import spcbpt_pool

# the traces that count a launch on the CPU under the stand-in: (module,
# function, the kernel's launch counters, its name, launches a call)
COUNTED = (
    (brute_trace, "brute_closest", brute_kernels, "brute_closest",
     lambda cs: 1),
    (brute_trace, "brute_any", brute_kernels, "brute_any", lambda cs: 1),
    (ray_walk, "walk_closest", walk_kernels, "walk_closest", lambda cs: 1),
    (ray_walk, "walk_any", walk_kernels, "walk_any", lambda cs: 1),
    (ray_walk, "walk_closest_parts", walk_kernels, "walk_closest",
     lambda parts: len(parts.parts)),
    (ray_walk, "walk_any_parts", walk_kernels, "walk_any",
     lambda parts: len(parts.parts)),
)


class Replay:
    """Stands in for a captured CUDA graph: a replay runs the captured
    function, which reads and writes its buffers, and counts none of its
    launches (the caller adds the recorded ones)."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        with kernels.capture_launches():
            self.step()


def _counted(fn, kernel_mod, name, per_call):
    def call(first, *args, **kw):
        kernel_mod.LAUNCHES[name] += per_call(first)
        return fn(first, *args, **kw)
    return call


@pytest.fixture
def graphed(monkeypatch):
    """The graph route taken on the CPU, with the stand-in capture; every
    light-vertex builder made meanwhile is kept, weakly, so that its graph
    is dropped after the test."""
    def capture(step, dev):
        before = kernels.read_launches()
        step()
        ran = {k: n - before[k] for k, n in kernels.read_launches().items()
               if n != before[k]}
        with kernels.capture_launches() as launches:
            kernels.add_launches(ran)
        return Replay(step), launches
    monkeypatch.setattr(pool, "graph_route", lambda device, mode: True)
    monkeypatch.setattr(pool, "capture", capture)
    for mod, fn, kernel_mod, name, per_call in COUNTED:
        monkeypatch.setattr(mod, fn, _counted(getattr(mod, fn), kernel_mod,
                                              name, per_call))
    builders = weakref.WeakSet()
    make_builder = lvc.make_builder

    def kept_builder(*args, **kw):
        b = make_builder(*args, **kw)
        builders.add(b)
        return b
    monkeypatch.setattr(lvc, "make_builder", kept_builder)
    yield
    # a stand-in holds its captured function, and so its scene (and
    # state): drop its pools, light passes and builds
    for cache in (pt_pool._POOLS, spcbpt_pool._POOLS, light_trace._PASSES):
        for key in [k for k, p in cache.pools.items()
                    if isinstance(p.graph, Replay)]:
            del cache.pools[key]
    for b in builders:
        b.graphed = None


def refuse_host_data(monkeypatch) -> None:
    """torch.as_tensor and Tensor.new_tensor raise when given host data (a
    number, a list, an array): on the card each is a copy from the host,
    which blocks the host and which a CUDA graph capture cannot record."""
    as_tensor, new_tensor = torch.as_tensor, torch.Tensor.new_tensor

    def refuse(data):
        if not torch.is_tensor(data):
            raise AssertionError(f"a tensor made from host data {data!r}")

    def strict_as_tensor(data, *args, **kw):
        refuse(data)
        return as_tensor(data, *args, **kw)

    def strict_new_tensor(self, data, *args, **kw):
        refuse(data)
        return new_tensor(self, data, *args, **kw)
    monkeypatch.setattr(torch, "as_tensor", strict_as_tensor)
    monkeypatch.setattr(torch.Tensor, "new_tensor", strict_new_tensor)
