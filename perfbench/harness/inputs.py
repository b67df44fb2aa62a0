"""What the benchmark makes and hands alike to the program and to the plain
reference: the scene's files, and the subspace state drawn from the seed.

The state takes the place of trained weights (the pattern of the program's
`classify.synthetic_trained_state`, drawn here from `--seed` on the device
in a few large calls): eye and light classifier centres on points of the
scene's surfaces, a row-normalised Gamma of NUM_SUBSPACE x NUM_SUBSPACE,
Q and inv_occ. Each side derives its own tables from these arrays (row
CMFs, alias tables, published pmfs).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import manifest

NUM_SUBSPACE = 1000
NUM_LIGHT_LABELS = 800     # NUM_SUBSPACE less the light sources' 200
# the second-stage sampler the state is calibrated for (the program's
# default)
SECOND_STAGE = "mixture"


def scene_path(cfg: dict, root: str = manifest.ROOT) -> str:
    """The configuration's .scene file, a file of the benchmark."""
    return os.path.join(root, cfg["scene"]["file"])


def geometry(path: str) -> tuple:
    """(p0, e1, e2) float32 numpy arrays of the scene's triangles in the
    renderer's normalised units, read by the benchmark's own loader."""
    from ..reference import scene as ref_scene

    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    try:
        ts, _, _ = ref_scene.load_trace_scene(path, "cpu")
    finally:
        torch.set_default_dtype(old)
    return ts.tri_p0.numpy(), ts.tri_e1.numpy(), ts.tri_e2.numpy()


def _centres(gen, p0, e1, e2, n: int):
    """n points drawn uniformly over the triangles' ids and barycentric
    coordinates, with their triangles' geometric normals."""
    t = torch.randint(p0.shape[0], (n,), generator=gen, device=p0.device)
    r = torch.rand((n, 2), generator=gen, device=p0.device)
    flip = r.sum(dim=1, keepdim=True) > 1.0
    r = torch.where(flip, 1.0 - r, r)
    pos = p0[t] + r[:, :1] * e1[t] + r[:, 1:] * e2[t]
    nrm = torch.linalg.cross(e1[t], e2[t])
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=1, keepdim=True),
                            min=1e-12)
    return pos, nrm


def state_arrays(seed: int, geom: tuple, device) -> dict:
    """The subspace state's arrays, drawn from `seed` on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    p0, e1, e2 = (torch.as_tensor(a, device=device) for a in geom)
    eye_pos, eye_norm = _centres(gen, p0, e1, e2, NUM_SUBSPACE)
    light_pos, light_norm = _centres(gen, p0, e1, e2, NUM_LIGHT_LABELS)
    gamma = torch.rand((NUM_SUBSPACE, NUM_SUBSPACE), generator=gen,
                       device=device) + 0.1
    gamma = gamma / gamma.sum(dim=1, keepdim=True)
    q = torch.rand((NUM_SUBSPACE,), generator=gen, device=device) + 0.5
    inv_occ = torch.rand((NUM_SUBSPACE,), generator=gen, device=device) + 0.5
    # the positions' largest variance, as the classifier's builder takes it
    pts = np.concatenate([geom[0], geom[0] + geom[1], geom[0] + geom[2]])
    pts = pts.astype(np.float64)
    var = ((pts - pts.mean(axis=0)) ** 2).sum(axis=0) / max(len(pts) - 1, 1)
    return dict(eye_pos=eye_pos, eye_norm=eye_norm, light_pos=light_pos,
                light_norm=light_norm, diag2=float(var.max()), gamma=gamma,
                q=q, inv_occ=inv_occ)


def host_copy(arrays: dict) -> dict:
    """The arrays as numpy, for the reference."""
    return {k: v.cpu().numpy() if torch.is_tensor(v) else v
            for k, v in arrays.items()}


def program_state(arrays: dict, device):
    """The program's SubspaceState from the arrays, its tables derived by
    the program's own functions."""
    from spcbpt_tpu_torch.config import CONSERVATIVE_RATE
    from spcbpt_tpu_torch.train import classify, qgamma

    g64 = arrays["gamma"].double().cpu().numpy()
    mixed = (g64 * (1.0 - CONSERVATIVE_RATE)
             + CONSERVATIVE_RATE / NUM_SUBSPACE)
    aprob, aidx = classify.build_alias(mixed)
    diag2 = torch.tensor(arrays["diag2"], dtype=torch.float32, device=device)
    return classify.publish_tables(classify.SubspaceState(
        eye=classify.Classifier(arrays["eye_pos"], arrays["eye_norm"], diag2),
        light=classify.Classifier(arrays["light_pos"], arrays["light_norm"],
                                  diag2),
        q=arrays["q"], cmf_gamma=qgamma.gamma_to_cmf(arrays["gamma"]),
        alias_prob=torch.tensor(aprob, device=device),
        alias_idx=torch.tensor(aidx, dtype=torch.int32, device=device),
        inv_occ=arrays["inv_occ"], trained=True,
        second_stage=SECOND_STAGE))
