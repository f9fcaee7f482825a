"""The counter-based hash both samplers draw their noise from, restated
(a frozen copy of the murmur3 finalizer of ``repro_torch/core/prng.py``):
the sampler's randomness is part of its specification, so the reference
draws the same uniforms for the same (seed, token, index).

Values travel as int64 holding 32-bit patterns; every step is masked back
to 32 bits. ``seed`` may be a Python int or an int64 tensor that broadcasts.
"""
from __future__ import annotations

import torch

M32 = 0xFFFF_FFFF
_C1 = 0x85EB_CA6B
_C2 = 0xC2B2_AE35
GOLDEN = 0x9E37_79B9


def fmix32(h):
    h = h ^ (h >> 16)
    h = (h * _C1) & M32
    h = h ^ (h >> 13)
    h = (h * _C2) & M32
    return h ^ (h >> 16)


def hash_bits(seed, a, b):
    h = fmix32((seed & M32) ^ GOLDEN)
    h = fmix32(h ^ ((a * _C1 + GOLDEN) & M32))
    return fmix32(h ^ ((b * _C2 + GOLDEN) & M32))


def uniform01(seed, a, b, dtype=torch.float32):
    """Uniform in (0, 1): the hash's top 24 bits, offset by a half."""
    bits = hash_bits(seed, a, b) >> 8
    return (bits.to(dtype) + 0.5) * (1.0 / (1 << 24))


def gumbel(seed, a, b, dtype=torch.float32):
    return -torch.log(-torch.log(uniform01(seed, a, b, dtype)))
