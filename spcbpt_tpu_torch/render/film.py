"""Film: progressive accumulation buffer + display conversion.

Port of spcbpt_tpu/render/film.py (reference: optixPathTracer.cpp
updateState:371-380, accumulation raygen.cu:155-169)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import image as image_mod


@dataclasses.dataclass
class Film:
    width: int
    height: int
    device: torch.device | str = "cpu"
    accum: torch.Tensor = None   # (W*H, 3)
    subframe: int = 0            # samples accumulated so far

    def __post_init__(self):
        if self.accum is None:
            self.reset()

    def reset(self):
        """Accumulation reset on camera/resize/algorithm change
        (optixPathTracer.cpp:371-380)."""
        self.accum = torch.zeros((self.width * self.height, 3),
                                 device=self.device)
        self.subframe = 0

    def add(self, sample):
        a = 1.0 / (self.subframe + 1.0)
        self.accum = self.accum + (sample - self.accum) * a
        self.subframe += 1

    def hdr(self) -> np.ndarray:
        """(H, W, 3) float32, row 0 at the image top."""
        img = self.accum.detach().cpu().numpy()
        return img.reshape(self.height, self.width, 3)[::-1]

    def display(self) -> np.ndarray:
        return image_mod.to_display(torch.from_numpy(self.hdr().copy()))

    def save_png(self, path: str):
        image_mod.write_png(path, self.display())

    def save_hdr(self, path: str):
        image_mod.write_hdr_npz(path, self.hdr())
