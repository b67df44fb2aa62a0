"""The traversal profiler (apps/prof_traversal), the list walk's entry point,
at a small size on the CPU: it walks both cluster sets of one BVH with
every form of the walk, the walks agree with the round walk's hits on
every lane (the same Moller-Trumbore on the same triangles; ties at a
shared edge do not occur on these 512 rays), and no kernel is launched."""
import json

import pytest
import torch

from spcbpt_tpu_torch.apps import prof_traversal
from spcbpt_tpu_torch.ops import bvh

torch.set_num_threads(1)


def test_profiler_runs_small_on_the_cpu(capsys):
    assert prof_traversal.main(["--device", "cpu", "--rays", "512",
                                "--scale", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    res = json.loads(out[-1])
    assert res["device"] == "cpu" and res["unit"] == "host ms (cpu)"
    assert res["rays"] == 512 and res["bvh_route"] == bvh.BUILD_ROUTE
    assert "2264 tris" in out[0] and "K=32 105 clusters, K=128 30" in out[0]
    # 2 wavefronts x 2 sets x 2 tiles x 2 forms closest, 2 forms any
    assert len(res["ms"]) == 18
    assert all(ms > 0 for ms in res["ms"].values())
    assert len(res["tri_agree"]) == 9
    assert all(a == 1.0 for a in res["tri_agree"].values()), res["tri_agree"]
    assert not any(res["launches"].values())
    assert sorted(res["launches"]) == ["list_walk_any",
                                       "list_walk_any_stream",
                                       "list_walk_closest",
                                       "list_walk_closest_stream"]


def test_profiler_needs_a_card_unless_told_cpu(monkeypatch):
    """The default device is the card; without one the profiler stops
    instead of measuring the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = prof_traversal.build_argparser().parse_args([])
    assert args.device == "cuda" and args.rays == 1 << 17
    assert args.scale == 4
    with pytest.raises(SystemExit, match="no CUDA device"):
        prof_traversal.run(args)
