"""Image/film helpers: tonemap, srgb, PNG IO, error metrics.

Port of spcbpt_tpu/utils/image.py. The PNG writer uses only the standard
library (zlib), so the port needs no image package.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..config import TONEMAP_LIMIT
from .vec import luminance


def tonemap(c, limit: float = TONEMAP_LIMIT):
    """Reference display tonemap (raygen.cu:52-58): c / (1 + lum/limit)."""
    lum = luminance(c)
    return c / (1.0 + lum / limit)[..., None]


def linear_to_srgb(c):
    """Reference LinearToSrgb (raygen.cu:65-69): pow(c, 1/2.2)."""
    return torch.pow(torch.clamp(c, 0.0, 1.0), 1.0 / 2.2)


def to_display(c, limit: float = TONEMAP_LIMIT) -> np.ndarray:
    """HDR accumulation -> 8-bit displayable array (tonemap, then gamma)."""
    ldr = linear_to_srgb(tonemap(torch.as_tensor(c), limit))
    return torch.clamp(ldr * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()


def write_png(path: str, rgb8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(rgb8, np.uint8)
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                         axis=1).tobytes()       # filter byte 0 per scanline

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_hdr_npz(path: str, img: np.ndarray) -> None:
    np.savez_compressed(path, radiance=np.asarray(img, np.float32))


def rel_mse(img, ref, eps: float = 1e-2, discard: float = 0.0) -> float:
    """Relative MSE against a reference image (standard renderer metric).
    discard > 0 drops that fraction of the largest per-pixel errors before
    averaging (the SPCBPT paper's outlier/firefly protocol)."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    d = (img - ref) ** 2 / (ref ** 2 + eps)
    if d.ndim >= 2 and d.shape[-1] == 3:
        d = d.mean(axis=-1)
    d = d.ravel()
    if discard > 0.0:
        k = max(1, int(len(d) * (1.0 - discard)))
        d = np.partition(d, k - 1)[:k]
    return float(np.mean(d))
