"""K2's plain version against the JAX package's packed-int4 matmul.

Inputs are seeded numpy: an f32 weight quantized by the JAX package's
``_quantize_weight_int4`` (the port's quantizer gives the same bytes, see
test_torch_quant.py) and random int8 activations.

- Against the Pallas kernel (``ops/int4_matmul.int4_matmul``, interpret mode
  on the CPU): within 2 % of max|ref|, the JAX test's bound
  (tests/test_whisper_model.py): the Pallas kernel folds each group's scale
  into bf16 weight planes, ≤ 0.4 % per weight. It takes N % 128 == 0 only.
- Against the XLA grouped-int32 formulation of ``model._linear`` rebuilt as
  that test does: within 1e-6·max|ref| (both are exact integer sums per
  group; only the f32 scale products and their sum over groups round).
- ``int4_linear_plain`` (the whole int4 linear) against the JAX package's
  ``_linear`` int4 branch: exact, at f32 and bf16 (see below); and against
  the arithmetic ``Int4Linear`` had before it called one entry point.
- ``chip_smoke.py``'s K2 shapes reach every kernel path at large-v3 widths,
  and ``tools/k2_breakdown.py``'s variants apply to the kernel source.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from realtime_whisper_asr_tpu.models.whisper.quant import _quantize_weight_int4
from realtime_whisper_asr_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from realtime_whisper_asr_tpu_torch.ops import int4_matmul as K2
from realtime_whisper_asr_tpu_torch.ops.int8_matmul import quantize_rows

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(m: int, k: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    d = _quantize_weight_int4(jnp.asarray(w))
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    return xq, np.array(d["q"]), np.array(d["s"])


def _plain(xq, wp, s) -> np.ndarray:
    return K2.int4_matmul(torch.from_numpy(xq), torch.from_numpy(wp),
                          torch.from_numpy(s)).numpy()


def _xla_grouped(xq, wp, s) -> np.ndarray:
    """model._linear's XLA int4 branch, as tests/test_whisper_model.py
    rebuilds it."""
    half, dout = wp.shape
    g = s.shape[0]
    w4 = jax.lax.bitcast_convert_type(jnp.asarray(wp), jnp.int4)
    wg = w4.reshape(g, half // g, dout, 2)
    xg = jnp.asarray(xq).reshape(-1, g, half // g, 2)
    p = jax.lax.dot_general(xg, wg, (((2, 3), (1, 3)), ((1,), (0,))),
                            preferred_element_type=jnp.int32)
    return np.asarray((p.astype(jnp.float32) * jnp.asarray(s)[:, None, :]).sum(0))


# (M, K, N): decode M = 1, beam-sized 5, 8, prefill-sized 17 and 64; one to
# ten 128-row groups; the fused-qkv N (3 x 128, 3 x 64 at test-tiny). The
# Pallas kernel's bf16 dot runs in interpret mode on the CPU up to M = 17
# (XLA's CPU dot refuses bf16 x bf16 = f32 at M = 64).
PALLAS_CASES = [(1, 256, 256), (5, 512, 768), (8, 1280, 384), (17, 256, 384)]
XLA_CASES = PALLAS_CASES + [(64, 512, 128), (1, 64, 192), (17, 64, 192), (5, 256, 64),
                            (1, 1280, 3840)]


@pytest.mark.parametrize("m,k,n", PALLAS_CASES)
def test_plain_matches_pallas_kernel_in_interpret_mode(m, k, n):
    xq, wp, s = _case(m, k, n, seed=m * k + n)
    ref = np.asarray(jax_int4_matmul(jnp.asarray(xq), jnp.asarray(wp), jnp.asarray(s),
                                     interpret=True))
    ours = _plain(xq, wp, s)
    assert ours.shape == ref.shape == (m, n)
    assert np.abs(ours - ref).max() / max(np.abs(ref).max(), 1.0) < 0.02


@pytest.mark.parametrize("m,k,n", XLA_CASES)
def test_plain_matches_xla_grouped_int32_path(m, k, n):
    xq, wp, s = _case(m, k, n, seed=m + k * n)
    ref = _xla_grouped(xq, wp, s)
    ours = _plain(xq, wp, s)
    assert ours.shape == ref.shape == (m, n)
    assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max()
    if s.shape[0] == 1:  # one group: the f32 result is one rounding of an exact sum
        np.testing.assert_array_equal(ours, ref)


def test_plain_sums_groups_in_order_like_the_kernel():
    """The plain version is the kernel's arithmetic: per group the exact
    integer sum, times the f32 scale, summed over groups in order in f32."""
    xq, wp, s = _case(3, 640, 128, seed=9)
    w = K2.unpack_int4(torch.from_numpy(wp)).long().view(5, 128, 128)
    x = torch.from_numpy(xq).long().view(3, 5, 128)
    y = torch.zeros(3, 128)
    for g in range(5):
        y = y + (x[:, g] @ w[g]).float() * torch.from_numpy(s)[g]
    assert torch.equal(torch.from_numpy(_plain(xq, wp, s)), y)


def test_wrapper_checks_its_inputs():
    xq, wp, s = (torch.from_numpy(a) for a in _case(2, 256, 128, seed=1))
    with pytest.raises(TypeError):
        K2.int4_matmul(xq.float(), wp, s)
    with pytest.raises(ValueError, match="do not match"):
        K2.int4_matmul(xq[:, :128].contiguous(), wp, s)
    with pytest.raises(ValueError, match="contiguous"):
        K2.int4_matmul(xq, torch.cat([wp, wp], 1)[:, ::2], s)
    with pytest.raises(ValueError, match="cuda or cpu"):
        K2.int4_matmul(xq.to("meta"), wp.to("meta"), s.to("meta"))
    assert K2.int4_launches == 0  # the CPU path never counts a launch


# ---------------------------------------------------------------- int4_linear
#
# ``int4_linear`` is the JAX package's whole int4 ``_linear``: the per-row
# activation quantization, the grouped product, ``* sx``, the cast and the
# bias. With seed-1 inputs the two sides quantize to identical int8 rows and
# scales (checked), the integer products are exact, and the f32 steps are
# the same rounded operations in the same order, so the plain version equals
# the JAX function exactly, at f32 and at bf16.


def _linear_case(m: int, dtype, bias: bool, k: int = 1280, n: int = 256):
    """Seed-1 x (m, k), an int4-g128 weight from the JAX quantizer and a
    bias, as JAX arrays of ``dtype`` and the same values as torch tensors."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    d = _quantize_weight_int4(jnp.asarray(w))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jx = jnp.asarray(x, jdt)
    jb = jnp.asarray(b, jdt) if bias else None

    def torch_of(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)

    return (jx, d, jb), (torch_of(jx), torch.from_numpy(np.array(d["q"])),
                         torch.from_numpy(np.array(d["s"])), torch_of(jb) if bias else None)


@pytest.mark.parametrize("m", [1, 5, 17, 800])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_linear_plain_equals_jax_linear_int4_branch(dtype, bias, m):
    from realtime_whisper_asr_tpu.models.whisper.model import _linear

    (jx, d, jb), (x, wp, s, b) = _linear_case(m, dtype, bias)
    ref = np.asarray(_linear(jx, d, jb).astype(jnp.float32))
    ours = K2.int4_linear_plain(x, wp, s, b)
    assert ours.dtype == dtype and ours.shape == (m, wp.shape[1])
    np.testing.assert_array_equal(ours.float().numpy(), ref)
    # the quantized inputs are identical: _linear's own quantization
    x32 = jx.astype(jnp.float32)
    jsx = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0, 1e-12)
    jxq = jnp.clip(jnp.round(x32 / jsx), -127, 127).astype(jnp.int8)
    xq, sx = quantize_rows(x)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(1, 1280, 256), (17, 256, 192), (3, 64, 64)])
def test_linear_plain_is_the_old_int4linear_arithmetic(m, k, n, dtype):
    """Bit for bit what ``Int4Linear`` computed before the linear became one
    kernel call: ``quantize_rows``, the plain product, ``* sx``, the cast,
    ``+ bias``; and what ``Int4Linear.forward`` computes now."""
    from realtime_whisper_asr_tpu_torch.models.whisper.model import Int4Linear

    _, (x, wp, s, b) = _linear_case(m, dtype, True, k, n)
    xq, sx = quantize_rows(x)
    old = (K2.int4_matmul(xq, wp, s) * sx).to(dtype) + b
    assert torch.equal(K2.int4_linear_plain(x, wp, s, b), old)
    mod = Int4Linear(k, n, dtype=dtype)
    mod.load_state_dict({"q": wp, "s": s, "bias": b})
    with torch.inference_mode():
        assert torch.equal(mod(x[None]), old[None])


def test_linear_wrapper_checks_its_inputs():
    _, (x, wp, s, b) = _linear_case(2, torch.float32, True, k=256, n=128)
    with pytest.raises(TypeError, match="f32 or bf16 x"):
        K2.int4_linear(x.double(), wp, s, b.double())
    with pytest.raises(TypeError, match="f32 or bf16 x"):
        K2.int4_linear(x.to(torch.int8), wp, s)
    with pytest.raises(TypeError, match="bias of x's dtype"):
        K2.int4_linear(x, wp, s, b.bfloat16())
    with pytest.raises(TypeError):
        K2.int4_linear(x, wp.to(torch.int16), s, b)
    with pytest.raises(ValueError, match="do not match"):
        K2.int4_linear(x[:, :128].contiguous(), wp, s, b)
    with pytest.raises(ValueError, match="2-D"):
        K2.int4_linear(x[None], wp, s, b)
    with pytest.raises(ValueError, match="contiguous"):
        K2.int4_linear(x.t().contiguous().t(), wp, s, b)
    with pytest.raises(ValueError, match="bias"):
        K2.int4_linear(x, wp, s, b[:64])
    with pytest.raises(ValueError, match="cuda or cpu"):
        K2.int4_linear(x.to("meta"), wp.to("meta"), s.to("meta"), b.to("meta"))
    assert K2.int4_launches == 0  # the CPU path never counts a launch


@pytest.mark.parametrize("entry", ["int4_matmul", "int4_linear"])
def test_kernel_path_raises_without_a_card(entry):
    """The kernel path launches or raises: on a host without a card it never
    falls back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the kernel path")
    _, (x, wp, s, b) = _linear_case(2, torch.float32, True, k=256, n=128)
    with pytest.raises(Exception):
        if entry == "int4_matmul":
            K2._int4_matmul_kernel(quantize_rows(x)[0], wp, s)
        else:
            K2._int4_linear_kernel(x, wp, s, b)
    assert K2.int4_launches == 0


def test_chip_smoke_holds_every_k2_path_at_large_v3_widths():
    """``chip_smoke.py`` holds each code path of K2 against the plain version
    at large-v3 widths: the decode kernel at each of its row counts and the
    tensor-core product, fc2's 40 groups on both."""
    import runpy

    smoke = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"), run_name="not_main")
    wide = [(m, k) for _, m, k, _ in smoke["INT4_SHAPES"] if k >= 1280]
    assert {smoke["k2_path"](m) for m, _ in wide} == {
        "decode rows<=1", "decode rows<=2", "decode rows<=4", "decode rows<=8", "tensor-core"}
    assert {smoke["k2_path"](m) for m, k in wide if k == 5120} >= {"decode rows<=1",
                                                                   "tensor-core"}


def test_breakdown_tool_variants_apply_to_the_kernel_source():
    """Each variant of ``tools/k2_breakdown.py`` takes its part out of the
    current source exactly once (a kernel edit that moves the text fails
    here, not on the card)."""
    from realtime_whisper_asr_tpu_torch.tools import k2_breakdown as BD

    sources = BD._sources()
    assert list(sources) == [v[0] for v in BD.VARIANTS]
    assert all(sources[name] != sources["base"] for name in sources if name != "base")
