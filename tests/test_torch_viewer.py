"""The port's terminal viewer (apps/viewer.py) against the JAX package's:
the camera moves and the ANSI frame on the same inputs, a scripted headless
session on the CPU, and a PT-only session's film."""
import contextlib
import os
import pty
import signal
import struct
import sys
import termios
import zlib

import numpy as np
import pytest
import torch

from spcbpt_tpu.apps import viewer as jviewer
from spcbpt_tpu.render import film as jfilm
from spcbpt_tpu_torch.apps import viewer as tviewer
from spcbpt_tpu_torch.render import film as tfilm

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)


class _Cam:
    def __init__(self):
        self.eye = np.array([0.3, 0.2, -5.0], np.float32)
        self.lookat = np.array([0.1, 0.0, 0.4], np.float32)
        self.up = np.array([0.0, 1.0, 0.1], np.float32)
        self.fov_y = 45.0


@pytest.mark.parametrize("move", [
    ("orbit", (35.0, 0.0)), ("orbit", (0.0, -20.0)), ("orbit", (10.0, 15.0)),
    ("fly", (0.1,)), ("fly", (-0.3,)), ("strafe", (0.2,)),
    ("strafe", (-0.1,))])
def test_camera_moves_match_jax(move):
    name, args = move
    jc, tc = _Cam(), _Cam()
    getattr(jviewer, name)(jc, *args)
    getattr(tviewer, name)(tc, *args)
    for f in ("eye", "lookat"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    assert not np.array_equal(tc.eye, _Cam().eye)


@pytest.mark.parametrize("shape,cols,rows", [
    ((64, 64), 32, 16), ((48, 80), 80, 40), ((33, 17), 8, 4)])
def test_ansi_frame_matches_jax(shape, cols, rows):
    img = np.random.default_rng(sum(shape)).integers(
        0, 255, shape + (3,), dtype=np.uint8)
    got = tviewer.ansi_frame(img, cols, rows)
    assert got == jviewer.ansi_frame(img, cols, rows)
    assert "▀" in got


def _read_png(path) -> np.ndarray:
    """An 8-bit RGB PNG with filter 0 on every row (utils/image.write_png)
    -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_scripted_session_renders_and_saves(tmp_path, capsys):
    """Space to BDPT, c prints the pose, p pauses: 16x16 on the CPU."""
    out = str(tmp_path / "view.png")
    rc = tviewer.main(["--scene", "cornell", "--dim", "16x16",
                       "--max-depth", "4", "--keys", " cp", "--frames", "5",
                       "--no-display", "--out", out, "--device", "cpu"])
    assert rc == 0
    assert "[camera]" in capsys.readouterr().out
    im = _read_png(out)
    assert im.shape == (16, 16, 3)
    assert im.mean() > 1  # scene is lit


def _recording(monkeypatch, module):
    """Patch module.Film with a subclass that keeps its instances."""
    made = []

    class Film(module.Film):
        def __post_init__(self):
            made.append(self)
            super().__post_init__()

    monkeypatch.setattr(module, "Film", Film)
    return made


def test_pt_session_matches_jax(monkeypatch, capsys):
    """Three PT frames at 16x16 (subframes 0-2: the same seeds in both):
    the films agree to 1e-4 relative on >= 99% of the pixels; the stats
    lines name the same algorithm and sample counts."""
    argv = ["--scene", "cornell", "--dim", "16x16", "--frames", "3"]
    films = {}
    for name, module, viewer, extra in (
            ("jax", jfilm, jviewer, []),
            ("port", tfilm, tviewer, ["--device", "cpu"])):
        made = _recording(monkeypatch, module)
        assert viewer.main(argv + extra) == 0
        assert len(made) == 1 and made[0].subframe == 3
        films[name] = np.asarray(made[0].hdr())
        lines = [l for l in capsys.readouterr().out.splitlines()
                 if l.startswith("[pt] 16x16 spp")]
        assert [int(l.split()[3]) for l in lines] == [1, 2, 3], name
    a, b = films["port"], films["jax"]
    assert np.isfinite(a).all() and a.mean() > 0.01
    err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    assert (np.where(a == b, 0.0, err) <= 1e-4).all(axis=-1).mean() >= 0.99


TTY_LIMIT_S = 120     # the interactive session's own time limit
TTY_FRAMES = 30       # a bound on its frames: 5 keys end it after 5


class _KeyTimer:
    """A PhaseTimer stand-in (utils.profiling.PhaseTimer's interface) that
    types `keys` into the pty's master at the first frame, once the viewer
    has put the tty in cbreak mode (which flushes earlier input), and
    records the tty's local flags at each frame."""

    def __init__(self, master, slave, keys: bytes):
        self.master, self.slave, self.keys = master, slave, keys
        self.lflags = []

    @contextlib.contextmanager
    def phase(self, name):
        self.lflags.append(termios.tcgetattr(self.slave)[3])
        if len(self.lflags) == 1:
            os.write(self.master, self.keys)
        yield {}


def _alarm(signum, frame):
    raise TimeoutError(f"the tty session ran past {TTY_LIMIT_S} s")


def test_interactive_tty_session(monkeypatch, capsys):
    """The interactive loop (KeySource on a tty): stdin on a pty's slave,
    keys typed into its master at once during the first frame: c (pose),
    the up arrow (ESC [ A: orbit), c, Space (PT -> BDPT), q. The two poses differ, the frames
    after Space are BDPT's, the loop ran in cbreak mode and the terminal's
    settings are restored on exit."""
    master, slave = pty.openpty()
    saved = termios.tcgetattr(slave)
    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(TTY_LIMIT_S)
    try:
        with open(slave, "r", closefd=False) as stdin:
            monkeypatch.setattr(sys, "stdin", stdin)
            timer = _KeyTimer(master, slave, b"c\x1b[Ac q")
            assert tviewer.main(["--scene", "cornell", "--dim", "16x16",
                                 "--max-depth", "2", "--light-paths", "256",
                                 "--frames", str(TTY_FRAMES), "--device",
                                 "cpu"], timer=timer) == 0
        restored = termios.tcgetattr(slave)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        os.close(master)
        os.close(slave)
    out = capsys.readouterr().out.splitlines()
    poses = [l for l in out if l.startswith("[camera]")]
    algs = [l.split("]")[0][1:] for l in out
            if l.startswith(("[pt]", "[bdpt]", "[spcbpt]"))]
    assert len(poses) == 2 and poses[0] != poses[1], poses
    assert algs == ["pt"] * 4 + ["bdpt"], algs
    assert all(not lf & termios.ICANON and not lf & termios.ECHO
               for lf in timer.lflags), timer.lflags
    assert saved[3] & termios.ICANON
    assert restored == saved
