"""Counter-based stateless RNG, bit-for-bit the one of ``repro.core.prng``.

A murmur3-finalizer hash of (seed, token, k) gives i.i.d. uniform bits with no
carried RNG state, so the CUDA kernel and this plain version draw the same
noise for the same (seed, uid, k).

torch has no ``>>`` or ``+`` for ``uint32`` on the CPU, so values travel as
int64 holding 32-bit patterns and every op is masked back to 32 bits. int64
multiplication wraps modulo 2⁶⁴, which keeps the low 32 bits right. The
functions take int64 tensors or Python ints; the scalar parts of a hash
(usually the seed) stay Python ints.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFF_FFFF
_C1 = 0x85EB_CA6B
_C2 = 0xC2B2_AE35
_GOLDEN = 0x9E37_79B9


def fmix32(h):
    """murmur3 32-bit finalizer — full avalanche. ``h`` holds values in [0, 2³²)."""
    h = h ^ (h >> 16)
    h = (h * _C1) & _M32
    h = h ^ (h >> 13)
    h = (h * _C2) & _M32
    h = h ^ (h >> 16)
    return h


def hash_bits(seed, a, b):
    """32-bit hash of (seed, a, b) as int64; broadcasts like torch ops."""
    h = fmix32((seed & _M32) ^ _GOLDEN)
    h = fmix32(h ^ ((a * _C1 + _GOLDEN) & _M32))
    h = fmix32(h ^ ((b * _C2 + _GOLDEN) & _M32))
    return h if isinstance(h, torch.Tensor) else torch.tensor(h, dtype=torch.int64)


def uniform01(seed, a, b):
    """Uniform in (0, 1) as float32: top 24 bits of the hash, offset to avoid 0."""
    bits = hash_bits(seed, a, b) >> 8
    return (bits.to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def gumbel(seed, a, b):
    """Standard Gumbel noise: -log(-log(U))."""
    return -torch.log(-torch.log(uniform01(seed, a, b)))
