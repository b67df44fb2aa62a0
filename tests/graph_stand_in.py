"""A stand-in, on the CPU, for the pool loop's CUDA graph capture
(render/pool.py): `graphed` takes the graph route on any device, and its
capture runs the eager warm-up pass, then a 'capture' whose bindings count
RECORDED launches that do not run; a replay runs the loop body again. The
card's capture and replay are checked by chip_smoke.py."""
import pytest

from spcbpt_tpu_torch import kernels
from spcbpt_tpu_torch.kernels import brute_trace
from spcbpt_tpu_torch.render import pool, pt_pool, spcbpt_pool

# what the stand-in's capture records: one K3 closest and one any launch,
# as a brute-mode iteration of either pool issues (PT: the path's closest
# hit and NEE's shadow ray; SPCBPT: the eye bounce and the connections'
# visibility)
RECORDED = {"brute_closest": 1, "brute_any": 1}


class Replay:
    """Stands in for a captured CUDA graph: a replay runs the captured
    loop body, which reads and writes the pool's buffers."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step()


def capture(step, dev):
    step()
    with kernels.capture_launches() as launches:
        for name, n in RECORDED.items():
            brute_trace.LAUNCHES[name] += n
    return Replay(step), launches


@pytest.fixture
def graphed(monkeypatch):
    """The graph route taken on the CPU, with the stand-in capture."""
    monkeypatch.setattr(pool, "graph_route", lambda device, mode: True)
    monkeypatch.setattr(pool, "capture", capture)
    yield
    # a stand-in holds its loop body, and so its scene (and state): drop
    # its pools
    for cache in (pt_pool._POOLS, spcbpt_pool._POOLS):
        for key in [k for k, p in cache.pools.items()
                    if isinstance(p.graph, Replay)]:
            del cache.pools[key]
