"""Counter-based per-lane RNG: tea<4> seed hash + LCG stream.

The benchmark's plain reference: a frozen copy of
`spcbpt_tpu_torch/utils/rng.py` (what the rendered configurations use;
skies, textures and the close-set network left out), importing
nothing of the program. Float tensors take torch's default dtype,
so that the control runs it in bfloat16.

Port of spcbpt_tpu/utils/rng.py. The stream is bit-identical to the JAX one:
torch has little uint32 arithmetic, so a state is an int64 tensor holding a
uint32 value, masked back to 32 bits after every add, multiply and left shift.

Usage is functional: every draw returns (value, new_state).
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_LCG_A = 1664525
_LCG_C = 1013904223


def _u32(x, device=None) -> torch.Tensor:
    """Any integer tensor or Python int -> int64 tensor holding its uint32."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _MASK


def tea(val0, val1, rounds: int = 4) -> torch.Tensor:
    """TEA hash of two uint32 lanes (reference src/cuda/random.h:32)."""
    v0 = _u32(val0)
    v1 = _u32(val1, v0.device)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & _MASK
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s0)
                     ^ ((v1 >> 5) + 0xC8013EA4)) & _MASK)) & _MASK
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s0)
                     ^ ((v0 >> 5) + 0x7E95761E)) & _MASK)) & _MASK
    return v0


def seed(lane_index, frame_index) -> torch.Tensor:
    """Per-lane stream state for a frame."""
    return tea(lane_index, frame_index)


def next_uint(state: torch.Tensor):
    """Advance the LCG; returns (24-bit random uint, new_state)."""
    new = (state * _LCG_A + _LCG_C) & _MASK
    return new & 0x00FFFFFF, new


def next_float(state: torch.Tensor):
    """Uniform in [0, 1) and the advanced state (reference rnd())."""
    bits, new = next_uint(state)
    return bits.to(torch.get_default_dtype()) / float(1 << 24), new


