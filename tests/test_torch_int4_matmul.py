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
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from realtime_whisper_asr_tpu.models.whisper.quant import _quantize_weight_int4
from realtime_whisper_asr_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from realtime_whisper_asr_tpu_torch.ops import int4_matmul as K2

torch.set_num_threads(2)


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
