"""The port at bf16 against the JAX package: where each rounds.

The reference's dense ``_linear`` rounds the f32 product to the compute
dtype and then adds the bias in that dtype; its conv stem does the same, and
its exact GELU is evaluated op by op in the compute dtype. The port must
round at the same places. Inputs come from a seeded numpy generator and are
rounded to bf16 once, so both sides multiply the same bf16 values on the CPU.

What may still differ: the f32 sums of a product are taken in another order
by XLA and by torch, so an f32 product that lies near a bf16 rounding
boundary can round to the neighbouring bf16 value on one side. Hence at
least 99.9 % of outputs must be equal, every output that differs must come
from such a flip (the products without bias differ there), and the products
without bias may differ by at most one bf16 step, plus, where a sum of K
terms cancels to a small value, what two orders of an f32 sum may differ by:
2·K·2^-24·Σ|terms|.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu.models.whisper import model as JM
from realtime_whisper_asr_tpu.models.whisper.quant import fuse_qkv
from realtime_whisper_asr_tpu_torch.models.whisper import config as C
from realtime_whisper_asr_tpu_torch.models.whisper import model as PM
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz

torch.set_num_threads(2)

GOLDEN_NPZ = os.path.join(os.path.dirname(__file__), "fixtures", "golden", "params.npz")
#: widths: test-tiny's and large-v3's (with its 128 mels)
WIDTHS = [(64, 80), (1280, 128)]


def _bf16(a: np.ndarray):
    """The same bf16 values for both frameworks."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _order(a: np.ndarray) -> np.ndarray:
    """bf16 values (held in f32) as integers in their order on the line:
    neighbouring bf16 values are one apart, +0 and -0 coincide."""
    bits = (a.astype(np.float32).view(np.int32) >> 16).astype(np.int64)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _check_rounding(ours, ref, ours_nb, ref_nb, terms: int, mag, what: str) -> float:
    """Returns the share of outputs that differ; fails unless it is at most
    0.1 %, each differing output has differing products without bias, and
    those products are everywhere within one bf16 step plus the f32 order
    bound of a sum of ``terms`` terms whose magnitudes sum to ``mag``."""
    ours, ref, ours_nb, ref_nb, mag = map(_np, (ours, ref, ours_nb, ref_nb, mag))
    assert ours.shape == ref.shape and ours_nb.shape == ref_nb.shape == mag.shape
    big = np.maximum(np.abs(ours_nb), np.abs(ref_nb))
    step = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)  # bf16 spacing there
    slack = np.abs(ours_nb - ref_nb) - step - 2 * terms * 2.0 ** -24 * mag
    assert slack.max() <= 0, f"{what}: products without bias apart beyond one bf16 step"
    steps = np.abs(_order(ours_nb) - _order(ref_nb))
    differ = ours != ref
    unexplained = differ & (steps == 0)
    assert not unexplained.any(), (f"{what}: {int(unexplained.sum())} outputs differ though "
                                   f"their products without bias are equal")
    share = float(differ.mean())
    assert share <= 1e-3, f"{what}: {share:.4%} of outputs differ from the reference"
    return share


def _unbiased(mod: torch.nn.Module) -> torch.nn.Module:
    out = copy.deepcopy(mod)
    out.bias = None
    return out


@pytest.mark.parametrize("d", [d for d, _ in WIDTHS])
def test_dense_linear_rounds_as_the_reference(d):
    rng = np.random.default_rng(0)
    x, xj = _bf16(rng.standard_normal((64, d)))
    w, wj = _bf16(rng.standard_normal((d, d)) / np.sqrt(d))  # (in, out), the reference's
    b, bj = _bf16(rng.standard_normal(d))
    lin = PM.Linear(d, d, dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(w.t())
        lin.bias.copy_(b)
        ours, ours_nb = lin(x), _unbiased(lin)(x)
    mag = x.double().abs() @ w.double().abs()
    _check_rounding(ours, JM._linear(xj, wj, bj), ours_nb, JM._linear(xj, wj, None), d, mag,
                    f"linear d={d}")


@pytest.mark.parametrize("d,n_mels", WIDTHS)
def test_conv_stem_rounds_as_the_reference(d, n_mels):
    """``AudioEncoder.stem`` (two convolutions with bias, exact GELU, the
    positional prefix) against ``_encoder_stem``: at least 99.9 % of outputs
    equal. Each convolution, on the same input for both, rounds as the
    reference's (``_check_rounding``); a flip in the first moves the second's
    input, so the stem as a whole is held to the share alone."""
    cfg = dataclasses.replace(C.get_config("test-tiny"), n_audio_state=d, n_mels=n_mels,
                              n_audio_layer=0)
    rng = np.random.default_rng(1)
    w1, w1j = _bf16(rng.standard_normal((3, n_mels, d)) / np.sqrt(3 * n_mels))  # (k, in, out)
    w2, w2j = _bf16(rng.standard_normal((3, d, d)) / np.sqrt(3 * d))
    b1, b1j = _bf16(0.5 * rng.standard_normal(d))
    b2, b2j = _bf16(0.5 * rng.standard_normal(d))
    pos, posj = _bf16(0.1 * rng.standard_normal((cfg.n_audio_ctx, d)))
    mel, melj = _bf16(rng.standard_normal((1, 200, n_mels)))
    enc = PM.AudioEncoder(cfg, dtype=torch.bfloat16)
    with torch.no_grad():
        enc.conv1.weight.copy_(w1.permute(2, 1, 0))
        enc.conv2.weight.copy_(w2.permute(2, 1, 0))
        enc.conv1.bias.copy_(b1)
        enc.conv2.bias.copy_(b2)
        enc.pos_emb.copy_(pos)
        ours = enc.stem(mel)
        h1 = enc.conv1(mel.transpose(1, 2))
        nb1 = _unbiased(enc.conv1)(mel.transpose(1, 2)).transpose(1, 2)
        g1 = PM._gelu(h1)
        h2 = enc.conv2(g1).transpose(1, 2)
        nb2 = _unbiased(enc.conv2)(g1).transpose(1, 2)
        mag1 = F.conv1d(mel.transpose(1, 2).double().abs(), enc.conv1.weight.double().abs(),
                        padding=1).transpose(1, 2)
        mag2 = F.conv1d(g1.double().abs(), enc.conv2.weight.double().abs(), stride=2,
                        padding=1).transpose(1, 2)
    ref = JM._encoder_stem({"conv1": {"w": w1j, "b": b1j}, "conv2": {"w": w2j, "b": b2j},
                            "pos_emb": posj}, melj)
    dn = ("NHC", "HIO", "NHC")
    ref_nb1 = jax.lax.conv_general_dilated(melj, w1j, (1,), [(1, 1)], dimension_numbers=dn)
    g1j = jnp.asarray(g1.float().numpy()).astype(jnp.bfloat16).transpose(0, 2, 1)
    ref_nb2 = jax.lax.conv_general_dilated(g1j, w2j, (2,), [(1, 1)], dimension_numbers=dn)
    _check_rounding(h1.transpose(1, 2), ref_nb1 + b1j, nb1, ref_nb1, 3 * n_mels, mag1,
                    f"conv1 d={d}")
    _check_rounding(h2, ref_nb2 + b2j, nb2, ref_nb2, 3 * d, mag2, f"conv2 d={d}")
    share = float((_np(ours) != _np(ref)).mean())
    assert share <= 1e-3, f"stem d={d}: {share:.4%} of outputs differ from the reference"


def test_gelu_at_bf16_equals_the_reference():
    """The exact GELU at bf16 is the reference's evaluation bit for bit."""
    x, xj = _bf16(3 * np.random.default_rng(2).standard_normal(1 << 16))
    np.testing.assert_array_equal(_np(PM._gelu(x)), _np(jax.nn.gelu(xj, approximate=False)))


def test_f32_linear_and_stem_keep_the_fused_bias():
    """At f32 the dense linear and the convolutions are the fused torch
    calls, bit for bit (the golden f32 parity rests on them)."""
    rng = np.random.default_rng(3)
    lin = PM.Linear(64, 32)
    conv = PM.Conv1d(80, 64, 3, padding=1)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((1, 80, 40)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(lin(x), F.linear(x, lin.weight, lin.bias))
        assert torch.equal(conv(m), F.conv1d(m, conv.weight, conv.bias,
                                                               padding=1))
        assert torch.equal(PM._gelu(x), F.gelu(x))


def test_every_dense_layer_of_the_model_rounds_as_the_reference():
    model = PM.Whisper.empty(C.get_config("test-tiny"), torch.bfloat16, "cpu")
    kinds = [type(m) for m in model.modules() if isinstance(m, (torch.nn.Linear,
                                                                 torch.nn.Conv1d))]
    assert len(kinds) == 2 + 4 * 2 + 8 * 2  # stem, 2 encoder blocks, 2 decoder blocks
    assert set(kinds) == {PM.Linear, PM.Conv1d}


def _golden_bf16():
    """The golden test-tiny weights rounded to bf16 once, for both."""
    state = {k: v.to(torch.bfloat16) for k, v in load_flat_npz(GOLDEN_NPZ).items()}
    model = PM.Whisper.empty(C.get_config("test-tiny"), torch.bfloat16, "cpu")
    model.load_state_dict(state)
    tree: dict = {}
    with np.load(GOLDEN_NPZ) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(data[key], jnp.float32).astype(jnp.bfloat16)
    return model, fuse_qkv(tree)


def test_decode_step_at_bf16_matches_the_reference():
    """A bf16 prefill of 16 tokens, then one ``decode_step``, on the golden
    weights. Tolerance on the f32 logits: 0.02 · max|logit|. The logits are
    f32 products of a bf16 hidden state, so where a bf16 rounding of the
    residual stream goes the other way on one side (the f32 sum order, above)
    the logits move by up to a bf16 step of the hidden state times the
    embedding row's norm: a few 1e-3 of their scale; the tolerance leaves
    room for several such flips and none of a wrong rounding order."""
    model, jparams = _golden_bf16()
    cfg = W.get_config("test-tiny")
    rng = np.random.default_rng(4)
    xa, xaj = _bf16(rng.standard_normal((1, 400, cfg.n_audio_state)))
    tokens = rng.integers(0, cfg.eot, size=(1, 16))
    jcache = W.init_cache(jparams, cfg, xaj, text_ctx=128)
    _, jcache, _ = W.decode_span(jparams, cfg, jnp.asarray(tokens, jnp.int32), jnp.int32(0),
                                 jcache)
    ref, _, _ = W.decode_step(jparams, cfg, jnp.asarray([1234], jnp.int32), jnp.int32(16),
                              jcache)
    with torch.inference_mode():
        cache = model.init_cache(xa, text_ctx=128)
        model.decode_span(torch.from_numpy(tokens), 0, cache)
        ours, _ = model.decode_step(torch.tensor([1234]), torch.tensor(16), cache)
    ours, ref = _np(ours), _np(ref)
    err = float(np.abs(ours - ref).max())
    assert err <= 0.02 * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))
