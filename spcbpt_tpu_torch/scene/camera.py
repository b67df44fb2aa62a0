"""Pinhole camera with the reference's UVW frame convention.

The port's own copy of spcbpt_tpu/scene/camera.py.

Reference: src/sutil/Camera.cpp:34-45 — W = lookat-eye (unnormalized, focal
length implied), U = normalize(W x up) * ulen, V = normalize(U x W)^T * vlen,
vlen = |W| tan(fov_y/2), ulen = vlen * aspect. Ray dirs are
normalize(d.x*U + d.y*V + W) with d in [-1,1]^2 (raygen.cu:104-113).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Camera:
    eye: np.ndarray
    lookat: np.ndarray
    up: np.ndarray
    fov_y: float          # degrees
    aspect: float         # width / height

    def uvw(self):
        eye = np.asarray(self.eye, np.float64)
        w = np.asarray(self.lookat, np.float64) - eye
        wlen = np.linalg.norm(w)
        u = np.cross(w, np.asarray(self.up, np.float64))
        u = u / max(np.linalg.norm(u), 1e-30)
        v = np.cross(u, w)
        v = v / max(np.linalg.norm(v), 1e-30)
        vlen = wlen * np.tan(0.5 * np.deg2rad(self.fov_y))
        v = v * vlen
        u = u * vlen * self.aspect
        return (eye.astype(np.float32), u.astype(np.float32),
                v.astype(np.float32), w.astype(np.float32))
