"""Exact int8 products for the int8 tiers: activation quantization and
int8 × int8 → int32.

The JAX package computes these in XLA (``model._linear``'s int8 branch and
``_logits_head``), outside any Pallas kernel, so the port leaves the product
to a library call, ``torch._int_mm`` (cuBLASLt on the card). Its sums are
exact int32: |q| ≤ 127 on both sides and K ≤ 5120 keep every sum below
2^27. An f32 matmul of the same integers is not exact in general (K = 5120
sums pass 2^24), so it is never used here.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _divisor(device: torch.device) -> torch.Tensor:
    return torch.tensor(127.0, device=device)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row absmax int8 quantization of activations, as the JAX
    package's ``_linear``: (…, K) -> (xq int8 (…, K), sx f32 (…, 1)).

    Both divisions are IEEE f32 divisions on either device. The absmax is
    divided by a 127 that lies on x's device: on the card, torch divides by
    a Python or CPU scalar as a multiply by its rounded reciprocal, which can
    differ in the last bit (the int4 kernel divides, as the JAX package)."""
    x32 = x.float()
    sx = torch.clamp(x32.abs().amax(dim=-1, keepdim=True) / _divisor(x32.device), min=1e-12)
    xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_matmul(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8 × w (N, K) int8 (torch's (out, in) layout) -> xq @ w.T,
    (M, N) int32, exact.

    On the card ``torch._int_mm`` takes more than 16 rows and K and N that
    are multiples of 8. The decode step has M = 1, so the rows are padded
    with zeros to a multiple of 8 above 16; zero rows add nothing to the
    rows kept, so the product stays exact. N and K are the caller's to align
    (the tied head pads its vocabulary rows at load, ``Int8Embedding``)."""
    m, k = xq.shape
    n = w.shape[0]
    if xq.dtype != torch.int8 or w.dtype != torch.int8 or w.shape[1] != k:
        raise TypeError(f"int8_matmul takes int8 (M, K) x (N, K), got {xq.dtype} "
                        f"{tuple(xq.shape)} and {w.dtype} {tuple(w.shape)}")
    if xq.device.type == "cuda":
        if k % 8 or n % 8:
            raise ValueError(f"int8_matmul on the card needs K and N multiples of 8, "
                             f"got K={k}, N={n}")
        rows = max(24, -(-m // 8) * 8)
        if rows != m:
            xq = F.pad(xq, (0, 0, 0, rows - m))
    return torch._int_mm(xq.contiguous(), w.t())[:m]
