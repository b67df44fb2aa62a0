"""A stand-in, on the CPU, for the pool loop's CUDA graph capture
(render/pool.py): `graphed` takes the graph route on any device, and its
capture runs the eager warm-up pass, then a 'capture' whose bindings count
the RECORDED launches of the scene's mode, which do not run; a replay runs
the loop body again. The card's capture and replay are checked by
chip_smoke.py."""
import pytest

from spcbpt_tpu_torch import kernels
from spcbpt_tpu_torch.render import pool, pt_pool, spcbpt_pool

# what the stand-in's capture records, by the scene's mode: one closest and
# one any launch, as an iteration of either pool issues on a scene of one
# cluster set (PT: the path's closest hit and NEE's shadow ray; SPCBPT: the
# eye bounce and the connections' visibility), K3 on brute and K1/K2 on walk
RECORDED = {"brute": {"brute_closest": 1, "brute_any": 1},
            "walk": {"walk_closest": 1, "walk_any": 1}}


class Replay:
    """Stands in for a captured CUDA graph: a replay runs the captured
    loop body, which reads and writes the pool's buffers."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step()


@pytest.fixture
def graphed(monkeypatch):
    """The graph route taken on the CPU, with the stand-in capture, which
    records the launches of the mode the route was last asked about (the
    loop asks just before it captures)."""
    mode = []

    def graph_route(device, scene_mode):
        mode[:] = [scene_mode]
        return True

    def capture(step, dev):
        step()
        with kernels.capture_launches() as launches:
            kernels.add_launches(RECORDED[mode[0]])
        return Replay(step), launches
    monkeypatch.setattr(pool, "graph_route", graph_route)
    monkeypatch.setattr(pool, "capture", capture)
    yield
    # a stand-in holds its loop body, and so its scene (and state): drop
    # its pools
    for cache in (pt_pool._POOLS, spcbpt_pool._POOLS):
        for key in [k for k, p in cache.pools.items()
                    if isinstance(p.graph, Replay)]:
            del cache.pools[key]
