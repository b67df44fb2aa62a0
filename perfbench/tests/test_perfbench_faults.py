"""`correct` has to come out false: the whole run on the CPU with the timed
path broken underneath, once for each fault a frame can have, and the
control (the reference in bfloat16 in the program's place)."""
import pytest
import torch

from conftest import TINY_CELLS
from perfbench import control
from perfbench.harness import cell


def _quiet(*args, **kwargs):
    pass


def _unchanged(render):
    """A frame that returns its first state again: every frame's film is
    the first one's."""
    first = []

    def fn(*args, **kwargs):
        out = render(*args, **kwargs)
        if not first:
            first.append(tuple(t.clone() for t in out))
        return tuple(t.clone() for t in first[0])
    return fn


def _half_batch(render):
    """Half of the pixels left out, the mean taken over the rest: the odd
    pixels get no sample, the even ones twice their weight."""
    def fn(*args, **kwargs):
        fs, ct = render(*args, **kwargs)
        odd = torch.arange(fs.shape[0]) % 2 == 1
        return (torch.where(odd[:, None], 0.0, 2.0 * fs),
                torch.where(odd, 0, ct).to(ct.dtype))
    return fn


def _altered(render):
    """Answers altered where they are produced: every second pixel of each
    frame returns 1.5 times its sample."""
    def fn(*args, **kwargs):
        fs, ct = render(*args, **kwargs)
        hit = torch.arange(fs.shape[0]) % 2 == 1
        return torch.where(hit[:, None], 1.5 * fs, fs), ct
    return fn


def _altered_light(trace):
    """A light vertex altered where it is produced: every eighth light
    sub-path carries 1.5 times its flux, and the eye pass connects to
    it as it is."""
    def fn(*args, **kwargs):
        lv = trace(*args, **kwargs)
        hit = torch.arange(lv.ratio.shape[1]) % 8 == 3
        lv.ratio = torch.where(hit[None, :, None], 1.5 * lv.ratio, lv.ratio)
        return lv
    return fn


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered}


CASES = [(cell_name, fault) for cell_name in (TINY_CELLS[0][0],
                                              TINY_CELLS[1][0])
         for fault in sorted(FAULTS)] + [(TINY_CELLS[1][0], "altered_light")]


@pytest.mark.parametrize("name,fault", CASES)
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, name, fault):
    from spcbpt_tpu_torch.render import light_trace, pt_pool, spcbpt_pool

    if fault == "altered_light":
        monkeypatch.setattr(light_trace, "trace_light_paths",
                            _altered_light(light_trace.trace_light_paths))
    else:
        mod = pt_pool if name.endswith("_pt") else spcbpt_pool
        monkeypatch.setattr(mod, "render_pool",
                            FAULTS[fault](mod.render_pool))
    out = cell.run(name, 2**31 + 777, 0.3, False, root=tiny_root,
                   device="cpu", log=_quiet)
    assert out["correct"] is False, out["compared"]
    if fault == "altered_light":
        light = out["compared"]["light_mismatch_share"]
        assert light["value"] > light["limit"]


@pytest.mark.parametrize("name", [c[0] for c in TINY_CELLS])
def test_control_is_not_correct(tiny_root, name):
    r = control.reading(name, 2**31 + 99, tiny_root, torch.device("cpu"))
    assert r["correct"] is False
    assert r["compared"]["mismatch_share"]["value"] > \
        r["compared"]["mismatch_share"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("name", ["cornell_pt_1920",
                                  "cornell_spcbpt_1920"])
def test_control_is_not_correct_at_the_cells_size(card, name):
    from conftest import ROOT

    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        r = control.reading(name, seed, ROOT, card)
        assert r["correct"] is False, r
