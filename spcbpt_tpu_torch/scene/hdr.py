"""Radiance .hdr (RGBE) loader.

The port's own copy of spcbpt_tpu/scene/hdr.py (pure numpy; the port
imports nothing of the JAX package). Replaces the reference HDRLoader
(reference: scene_shift.cpp:334-590): new-RLE and flat RGBE scanlines to a
float32 (H, W, 3) raster. A scanline whose first two bytes are (2, 2) is
read as new RLE, so a writer of flat scanlines must not start a row so;
`write_hdr` writes either form and refuses such a flat row.
"""
from __future__ import annotations

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()

    # header
    pos = 0
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].split()
    pos = eol + 1
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {dims}")
    height, width = int(dims[1]), int(dims[3])

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bp = 0
    for y in range(height):
        if width < 8 or width > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2:
            # flat (possibly old-RLE, not handled) scanline
            row = buf[bp:bp + width * 4].reshape(width, 4)
            rgbe[y] = row
            bp += width * 4
            continue
        # new RLE: 4 channel planes
        bp += 4
        for c in range(4):
            x = 0
            while x < width:
                count = int(buf[bp]); bp += 1
                if count > 128:
                    count -= 128
                    rgbe[y, x:x + count, c] = buf[bp]
                    bp += 1
                else:
                    rgbe[y, x:x + count, c] = buf[bp:bp + count]
                    bp += count
                x += count

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136))  # 2^(e-128)/256
    rgb = rgbe[..., :3].astype(np.float32) * scale[..., None].astype(np.float32)
    return rgb


def encode_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) float -> (H, W, 4) uint8 RGBE: a shared exponent of the
    largest channel, 8-bit mantissas (rounded down); black below 1e-32."""
    rgb = np.asarray(rgb, np.float64)
    maxc = rgb.max(axis=-1)
    exp = np.floor(np.log2(np.maximum(maxc, 1e-32))).astype(np.int32) + 1
    scale = np.ldexp(1.0, exp - 8)
    rgbe = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    lit = maxc > 1e-32
    rgbe[..., :3] = np.where(
        lit[..., None], np.clip(np.floor(rgb / scale[..., None]), 0, 255),
        0).astype(np.uint8)
    rgbe[..., 3] = np.where(lit, exp + 128, 0).astype(np.uint8)
    return rgbe


def _rle_channel(row: np.ndarray) -> bytes:
    """One channel plane of a new-RLE scanline: runs of 3 to 127 equal
    bytes as (128 + n, byte), everything else as literals of at most 128."""
    out = bytearray()
    lit = bytearray()
    x, n = 0, len(row)
    while x < n:
        run = 1
        while x + run < n and run < 127 and row[x + run] == row[x]:
            run += 1
        if run >= 3:
            if lit:
                out += bytes([len(lit)]) + lit
                lit = bytearray()
            out += bytes([128 + run, row[x]])
            x += run
            continue
        lit.append(row[x])
        x += 1
        if len(lit) == 128:
            out += bytes([128]) + lit
            lit = bytearray()
    if lit:
        out += bytes([len(lit)]) + lit
    return bytes(out)


def write_hdr(path: str, rgb: np.ndarray, rle: bool = True) -> None:
    """Write a float (H, W, 3) raster as a Radiance file that `load_hdr`
    reads back to encode_rgbe's values: new-RLE scanlines (8 <= W <= 32767),
    or flat ones, refused if a row would start with the RLE marker (2, 2)."""
    rgbe = encode_rgbe(rgb)
    h, w, _ = rgbe.shape
    body = bytearray()
    for y in range(h):
        row = rgbe[y]
        if rle:
            if not 8 <= w <= 0x7FFF:
                raise ValueError(f"new-RLE scanlines need 8 <= width <= "
                                 f"32767, not {w}")
            body += bytes([2, 2, w >> 8, w & 0xFF])
            for c in range(4):
                body += _rle_channel(row[:, c])
        else:
            if 8 <= w <= 0x7FFF and row[0, 0] == 2 and row[0, 1] == 2:
                raise ValueError(f"flat row {y} starts with (2, 2) and would "
                                 f"be read as RLE")
            body += row.tobytes()
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(bytes(body))
