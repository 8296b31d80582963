"""The seeded counter-based generator of the sampled decode: a torch copy of
the part of ``jax.random`` the JAX package's decode draws from.

The JAX package samples a token as ``argmax(logits / max(t, 1e-6) + g)``
with ``g = jax.random.gumbel(fold_in(PRNGKey(seed), pos), (V,), f32)``
(``realtime_whisper_asr_tpu/models/whisper/decode.py``, ``select_next``).
This module computes the same ``g`` bit for bit, from device tensors only
(the seed and the position are tensors, so a CUDA graph can capture the
sampler), with integer and float tensor ops that round alike on the CPU and
the card:

- ``threefry2x32``: the Threefry-2x32 hash, 20 rounds, in int64 tensors
  masked to 32 bits (torch has no uint32 arithmetic);
- ``prng_key(seed)``: the key of a 32-bit seed, ``(0, seed mod 2³²)``;
- ``fold_in(key, data)``: the hash of the count pair ``(0, data)``;
- ``random_bits(key, n)``: the partitionable bits of shape (n,)
  (``jax_threefry_partitionable``, JAX's default): the hash of the 64-bit
  counts 0..n-1, its two words xor-ed;
- ``gumbel(key, n)``: JAX's default ``mode="low"``: ``-log(-log(u))``
  over ``u = uniform(key, (n,), minval=tiny, maxval=1)``.

Both logarithms are XLA's CPU ``log`` (a Cephes polynomial with fused
multiply-adds, ``xla_log``), not ``torch.log``: the two differ in the last
bit for about one input in seven, and ``-log(-log(u))`` shows it. Each fused
multiply-add is a float64 product (exact for f32 operands) and sum rounded to
f32, and every other step is one IEEE f32 op, so the card and the CPU give
the same bits. That equality with ``jax.random`` holds over every f32 input
of the sampler's range (``tests/test_torch_sampling.py``).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the count pairs (x0, x1) under the key (k1, k2):
    int64 tensors holding uint32 values, broadcast together. Returns the two
    output words, as ``jax._src.prng``'s ``threefry2x32`` lowering."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = _u32(x0 + ks[0])
    x1 = _u32(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = _u32(x0 + x1)
            x1 = _u32(x1 << r) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = _u32(x0 + ks[(i + 1) % 3])
        x1 = _u32(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def prng_key(seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.PRNGKey`` of int32 seeds (any shape): ``(0, seed mod
    2³²)``, as int64 tensors."""
    seed = seed.long()
    return torch.zeros_like(seed), _u32(seed)


def fold_in(key: tuple[torch.Tensor, torch.Tensor],
            data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in(key, data)`` for int32 ``data`` of the key's
    shape: the hash of the count pair ``(0, data mod 2³²)``."""
    data = _u32(data.long())
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(key: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """32 random bits per element of shape (*key shape, n): the counts
    0..n-1 hashed, their words xor-ed (JAX's partitionable bits)."""
    k1, k2 = key[0][..., None], key[1][..., None]
    counts = torch.arange(n, dtype=torch.long, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return b1 ^ b2


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 a·b + c with one rounding: the f64 product of f32 values is
    exact, the sum is rounded to f64 and then to f32."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def _f32(v: float) -> float:
    return float(np.float32(v))


_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRT_HALF = _f32(0.707106781186547524)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of f32 ``x`` > 0 (finite, normal or not) as XLA's CPU
    backend computes it: the mantissa normalized to [√½, √2), the Cephes
    polynomial in Horner pairs of fused multiply-adds, then the exponent's
    two-part ln 2 added back."""
    m = torch.clamp(x, min=_TINY).view(torch.int32)
    e = ((m >> 23) - 0x7F).float() + 1.0
    # keep the mantissa and the sign, exponent of 0.5: a value in [0.5, 1)
    m = ((m & -0x7F800001) | 0x3F000000).view(torch.float32)
    low = m < _SQRT_HALF
    z = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - torch.where(low, 1.0, 0.0)
    z2 = z * z
    z3 = z2 * z
    p = _LOG_P
    y = _fma(_fma(z, p[0], p[1]), z, p[2])
    y1 = _fma(_fma(z, p[3], p[4]), z, p[5])
    y2 = _fma(_fma(z, p[6], p[7]), z, p[8])
    y = _fma(_fma(y, z3, y1), z3, y2)
    y = _fma(y, z3, _LOG_Q1 * e)
    z = (z - 0.5 * z2) + y
    return z + _LOG_Q2 * e


def uniform_tiny(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(..., minval=tiny, maxval=1)`` of 32 random bits
    (int64): 23 mantissa bits of a float in [1, 2), minus 1, plus tiny."""
    floats = ((bits >> 9) | 0x3F800000).int().view(torch.float32) - 1.0
    return torch.clamp(floats + _TINY, min=_TINY)


def gumbel(key: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` for each key: (*key shape, n)."""
    return -xla_log(-xla_log(uniform_tiny(random_bits(key, n))))


def sample(logits: torch.Tensor, seed: torch.Tensor, pos: torch.Tensor,
           temperature: torch.Tensor) -> torch.Tensor:
    """The JAX decode's sampled token per row: ``argmax(logits /
    max(t, 1e-6) + g)``, g the Gumbel noise of ``fold_in(PRNGKey(seed),
    pos)``. logits (R, V) f32; seed, pos (R,) int; temperature (R,) f32."""
    g = gumbel(fold_in(prng_key(seed), pos), logits.shape[-1])
    return (logits / torch.clamp(temperature, min=1e-6)[:, None] + g).argmax(dim=-1)
