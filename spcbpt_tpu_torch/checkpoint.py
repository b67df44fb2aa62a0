"""Checkpoint / resume of trained artifacts.

Port of spcbpt_tpu/checkpoint.py, in the same npz format both ways: a
checkpoint written by either package loads in the other. The whole
SubspaceState (classifiers + Q + CMFGamma + alias tables + inv_occ) plus
optionally the film serialize as one npz (reference text dumps:
classTree_host.h:15-60, device_thrust.cu:3347-3404), and the close-set
network's tables as the `nn_*` arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .train import classify, nn_classifier

# the close-set network's arrays, saved as nn_<name> beside nn_blend
NN_TABLES = ("w1", "b1", "w2", "b2", "close_set", "scene_lo", "scene_hi")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_subspace_state(path: str, ss: classify.SubspaceState,
                        film=None) -> None:
    arrays = dict(
        eye_centers_pos=_np(ss.eye.centers_pos),
        eye_centers_norm=_np(ss.eye.centers_norm),
        eye_diag2=_np(ss.eye.diag2),
        light_centers_pos=_np(ss.light.centers_pos),
        light_centers_norm=_np(ss.light.centers_norm),
        light_diag2=_np(ss.light.diag2),
        q=_np(ss.q),
        cmf_gamma=_np(ss.cmf_gamma),
        trained=np.asarray(ss.trained),
        second_stage=np.asarray(ss.second_stage),
    )
    if ss.inv_occ is not None:
        arrays["inv_occ"] = _np(ss.inv_occ)
    if ss.alias_prob is not None:
        arrays["alias_prob"] = _np(ss.alias_prob)
        arrays["alias_idx"] = _np(ss.alias_idx)
    if ss.nn is not None:
        for k in NN_TABLES:
            arrays[f"nn_{k}"] = _np(getattr(ss.nn, k))
        arrays["nn_blend"] = np.asarray(ss.nn.blend)
    if film is not None:
        arrays["film_accum"] = _np(film.accum)
        arrays["film_subframe"] = np.asarray(film.subframe)
        arrays["film_shape"] = np.asarray([film.width, film.height])
    np.savez_compressed(path, **arrays)


def load_subspace_state(path: str, device="cpu") -> classify.SubspaceState:
    z = np.load(path)

    def t(name, dt=torch.float32):
        return torch.tensor(z[name], dtype=dt, device=device) \
            if name in z else None

    eye = classify.Classifier(centers_pos=t("eye_centers_pos"),
                              centers_norm=t("eye_centers_norm"),
                              diag2=t("eye_diag2"))
    light = classify.Classifier(centers_pos=t("light_centers_pos"),
                                centers_norm=t("light_centers_norm"),
                                diag2=t("light_diag2"))
    if "second_stage" in z:
        second = str(z["second_stage"])
    else:
        # legacy checkpoint (no second_stage/inv_occ): the mixture second
        # stage needs inv_occ for its MIS rates, so, as in the JAX package,
        # such a state is calibrated for the 'weighted' second stage
        second = "weighted"
    nn = None
    if "nn_w1" in z:
        # every nn_* array is required once nn_w1 is there (KeyError)
        nn = nn_classifier.NNTables(
            **{k: torch.tensor(z[f"nn_{k}"], device=device)
               for k in NN_TABLES}, blend=float(z["nn_blend"]))
    return classify.publish_tables(classify.SubspaceState(
        eye=eye, light=light, q=t("q"), cmf_gamma=t("cmf_gamma"),
        alias_prob=t("alias_prob"), alias_idx=t("alias_idx", torch.int32),
        inv_occ=t("inv_occ"), nn=nn, trained=bool(z["trained"]),
        second_stage=second))
