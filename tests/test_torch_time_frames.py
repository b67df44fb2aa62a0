"""The port's frame timer (apps/time_frames, JAX's tools/time_frames.py)
at a small size on the CPU: its three lines, every frame one finite sample
a pixel, the BDPT frame equal to a direct uniform spcbpt_pool.render_pool
call on the same light-vertex cache and seed, and no run without a card
unless the CPU is asked for."""
import contextlib
import io
import re

import pytest
import torch

from spcbpt_tpu_torch.apps import time_frames
from spcbpt_tpu_torch.apps.render_cli import load_interior
from spcbpt_tpu_torch.render import light_trace, lvc, spcbpt_pool
from spcbpt_tpu_torch.train import classify

torch.set_num_threads(1)

SIDE = 16
LIGHT_PATHS = (256, 512)
ARGV = ["--device", "cpu", "--dim", str(SIDE), "--scale", "1",
        "--light-paths", ",".join(map(str, LIGHT_PATHS))]
LINE = re.compile(r"^(pt|bdpt lp=(\d+)): (\d+\.\d) ms/spp$")


@pytest.fixture(scope="module")
def small_run():
    """One run at the small size: its frames and the lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        frames = time_frames.run(time_frames.build_argparser()
                                 .parse_args(ARGV))
    return frames, buf.getvalue().splitlines()


def test_prints_the_three_lines(small_run):
    frames, lines = small_run
    assert len(lines) == 3, lines
    found = [LINE.match(line) for line in lines]
    assert all(found), lines
    assert [m.group(1) for m in found] == [
        "pt"] + [f"bdpt lp={lp}" for lp in LIGHT_PATHS]
    assert [f[0] for f in frames] == [m.group(1) for m in found]
    assert all(float(m.group(3)) > 0 for m in found)


def test_every_frame_is_one_finite_sample_a_pixel(small_run):
    frames, _ = small_run
    for label, ms, (film, count) in frames:
        assert film.shape == (SIDE * SIDE, 3), label
        assert torch.equal(count, torch.ones_like(count)), label
        assert torch.isfinite(film).all() and film.mean() > 0, label


def test_bdpt_frame_equals_a_direct_render(small_run):
    """The last timed BDPT call (frame CALLS) against the light trace, the
    sampler and the uniform eye pass called directly."""
    frames, _ = small_run
    film, count = frames[1][2]
    ts, cam = load_interior(1, "cpu")
    ss = classify.untrained_state()
    s = time_frames.CALLS
    lv = light_trace.trace_light_paths(ts, ss, LIGHT_PATHS[0], s,
                                       max_depth=time_frames.LIGHT_DEPTH)
    ref, ref_count = spcbpt_pool.render_pool(
        ts, ss, lvc.build_sampler(lv), cam.uvw(), SIDE, SIDE, 1, s,
        max_depth=time_frames.PT_DEPTH, uniform=True)
    assert torch.equal(count, ref_count)
    assert torch.equal(film, ref)


def test_time_frames_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = time_frames.build_argparser().parse_args([])
    assert (args.device, args.dim, args.scale, args.light_paths) == \
        ("cuda", 512, 4, "16384,65536")
    with pytest.raises(SystemExit, match="no CUDA device"):
        time_frames.run(args)
