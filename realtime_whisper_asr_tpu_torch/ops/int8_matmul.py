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

from realtime_whisper_asr_tpu_torch.device import no_tf32_matmul


@functools.lru_cache(maxsize=None)
def device_constant(value: float, device: torch.device) -> torch.Tensor:
    """``value`` as an f32 tensor on ``device``: a division by it is an IEEE
    f32 division on either device, where torch on the card divides by a
    Python or CPU scalar as a multiply by its rounded reciprocal."""
    return torch.tensor(value, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _reciprocal(device: torch.device) -> torch.Tensor:
    return device_constant(1.0, device) / device_constant(127.0, device)


def quantize_rows(x: torch.Tensor, compiled: bool = False,
                  row_max=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row absmax int8 quantization of activations, as the JAX
    package's ``_linear``: (…, K) -> (xq int8 (…, K), sx f32 (…, 1)).
    ``row_max`` maps the local absmax (…, 1) to the whole row's, where x
    holds a slice of each row (a row-parallel linear's all-reduce MAX).

    The scale is the absmax over 127 and xq is round(x / sx), half to even,
    clipped to ±127. ``compiled=False``: both are IEEE f32 divisions on
    either device (``device_constant``), as the JAX functions compute them
    called eagerly and as the int4 kernel divides. ``compiled=True``: the scale is the absmax times the f32
    reciprocal of 127, as XLA compiles the JAX package's ``/ 127.0`` in its
    jitted decode (it rewrites a division by a constant so; the division by
    sx stays IEEE). The two scales differ in the last bit for some rows,
    and at bf16 activations many x / sx land on exact .5 ties, where that
    bit decides the rounding."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    if row_max is not None:
        amax = row_max(amax)
    sx = (amax * _reciprocal(x32.device) if compiled
          else amax / device_constant(127.0, x32.device))
    sx = torch.clamp(sx, min=1e-12)
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


#: the longest contraction whose int8 × int8 sums an f32 GEMM keeps exact:
#: every partial sum of K products of |q| ≤ 127 is an integer of magnitude
#: at most K · 127² < 2^24 (K · 16,129 ≤ 16,774,160 at K = 1,040)
EXACT_F32_K = (2**24 - 1) // (127 * 127)


def int8_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (…, M, K) int8 @ b (…, K, N) int8 -> (…, M, N) int32, exact, with
    torch.matmul's broadcasting of the leading dims: the JAX package's
    ``dot_general(..., preferred_element_type=int32)`` of ``int8-kv``'s
    attention products.

    torch has no batched int8 product on the card, so this is an f32 GEMM
    of the integer values, exact while every partial sum stays below 2^24:
    the contraction runs in chunks of at most ``EXACT_F32_K`` and the chunk
    sums, exact integers, are added in int32. TF32 would round the operands
    to 10-bit mantissas and a bf16 reduction would round the sums, so the
    GEMM runs with cuBLAS's TF32 switched off (bf16 reductions apply only to
    bf16 operands)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_bmm takes int8 operands, got {a.dtype} and {b.dtype}")
    out = None
    with no_tf32_matmul():
        for k0 in range(0, a.shape[-1], EXACT_F32_K):
            part = torch.matmul(a[..., k0 : k0 + EXACT_F32_K].float(),
                                b[..., k0 : k0 + EXACT_F32_K, :].float()).to(torch.int32)
            out = part if out is None else out + part
    return out
