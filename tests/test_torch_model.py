"""The port's Whisper model against the JAX package's, function by function.

Both run at f32 on the CPU with the same weights — the committed test-tiny
golden fixture, and a seeded test-tiny variant with 128 mels — and the same
inputs drawn from a seeded numpy generator. Tolerance for every float output:
max|Δ| ≤ 1e-4·max|ref| + 1e-5 (f32 sums taken in another order by XLA and
by torch).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu.models.whisper.quant import fuse_qkv
from realtime_whisper_asr_tpu_torch.models.whisper import config as C
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz, params_from_jax
from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper, init_params

torch.set_num_threads(2)

GOLDEN_NPZ = os.path.join(os.path.dirname(__file__), "fixtures", "golden", "params.npz")


def _nested(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _close(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= 1e-4 * np.abs(ref).max() + 1e-5, (err, np.abs(ref).max())


@pytest.fixture(scope="module", params=["golden", "mels128"])
def pair(request):
    """(cfg, JAX params, port model) on the same f32 weights."""
    if request.param == "golden":
        cfg = W.get_config("test-tiny")
        with np.load(GOLDEN_NPZ) as data:
            tree = _nested({k: data[k].astype(np.float32) for k in data.files})
        state = load_flat_npz(GOLDEN_NPZ)
    else:
        cfg = dataclasses.replace(W.get_config("test-tiny"), n_mels=128)
        tree = jax.tree.map(np.asarray, W.init_params(cfg, jax.random.PRNGKey(3)))
        state = params_from_jax(tree)
    model = Whisper.empty(C.get_config("test-tiny") if cfg.n_mels == 80
                          else dataclasses.replace(C.get_config("test-tiny"), n_mels=128),
                          torch.float32, "cpu")
    model.load_state_dict(state)
    jparams = fuse_qkv(jax.tree.map(jnp.asarray, tree))
    return cfg, jparams, model


def _amask(cfg) -> np.ndarray:
    m = np.zeros((cfg.n_text_layer, cfg.n_text_head), np.float32)
    m[cfg.n_text_layer // 2 :] = 1.0
    return m / m.sum()


def _mel(cfg, frames=800, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((1, frames, cfg.n_mels))).astype(np.float32)


def _xa(cfg, jparams) -> np.ndarray:
    return np.array(W.encode(jparams, cfg, jnp.asarray(_mel(cfg))))


def _tokens(cfg, s=16, seed=1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.eot, size=(1, s)).astype(np.int32)


def test_encode_matches_jax(pair):
    cfg, jparams, model = pair
    mel = _mel(cfg)
    _close(model.encode(torch.from_numpy(mel)), W.encode(jparams, cfg, jnp.asarray(mel)))


def test_cross_kv_matches_jax(pair):
    cfg, jparams, model = pair
    xa = _xa(cfg, jparams)
    ck, cv = W.precompute_cross_kv(jparams, cfg, jnp.asarray(xa))
    ok, ov = model.precompute_cross_kv(torch.from_numpy(xa))
    _close(ok, ck)
    _close(ov, cv)


def _spans(cfg, jparams, model):
    """decode_span over 16 tokens on both sides; returns both results and
    the caches they wrote."""
    xa, tokens, amask = _xa(cfg, jparams), _tokens(cfg), _amask(cfg)
    jcache = W.init_cache(jparams, cfg, jnp.asarray(xa), text_ctx=128)
    jl, jcache, jx = W.decode_span(jparams, cfg, jnp.asarray(tokens), jnp.int32(0), jcache,
                                   alignment_mask=jnp.asarray(amask))
    cache = model.init_cache(torch.from_numpy(xa), text_ctx=128)
    with torch.inference_mode():
        ol, ox = model.decode_span(torch.from_numpy(tokens).long(), 0, cache,
                                   alignment_mask=torch.from_numpy(amask))
    return (jl, jx, jcache), (ol, ox, cache), amask


def test_decode_span_matches_jax(pair):
    cfg, jparams, model = pair
    (jl, jx, jcache), (ol, ox, cache), _ = _spans(cfg, jparams, model)
    _close(ol, jl)
    _close(ox, jx)
    _close(cache.self_k, jcache.self_k)
    _close(cache.self_v, jcache.self_v)


def test_decode_step_matches_jax(pair):
    cfg, jparams, model = pair
    (_, _, jcache), (_, _, cache), amask = _spans(cfg, jparams, model)
    tok = np.asarray([1234], np.int32)
    jl, _, jx = W.decode_step(jparams, cfg, jnp.asarray(tok), jnp.int32(16), jcache,
                              alignment_mask=jnp.asarray(amask))
    with torch.inference_mode():
        ol, ox = model.decode_step(torch.from_numpy(tok).long(), 16, cache,
                                   alignment_mask=torch.from_numpy(amask))
    _close(ol, jl)
    _close(ox, jx)


def test_fused_and_unfused_trees_convert_alike():
    with np.load(GOLDEN_NPZ) as data:
        tree = _nested({k: data[k].astype(np.float32) for k in data.files})
    fused = jax.tree.map(np.asarray, fuse_qkv(jax.tree.map(jnp.asarray, tree)))
    a, b = params_from_jax(tree), params_from_jax(fused)
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_init_params_fills_every_entry_of_the_converted_layout():
    cfg = C.get_config("test-tiny")
    model = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    state = model.state_dict()
    assert state.keys() == load_flat_npz(GOLDEN_NPZ).keys()
    assert all(bool(torch.isfinite(v).all()) for v in state.values())
    qkv_b = state["decoder.blocks.0.attn.qkv.bias"]
    assert not qkv_b.any()  # biases start at zero, the key's stays zero
    w = state["encoder.blocks.0.fc2.weight"]
    assert abs(float(w.std()) - (4 * cfg.n_audio_state) ** -0.5) < 0.01


def test_conv_stem_runs_without_tf32_and_restores_the_setting():
    """The stem owns its precision: its convolutions run with cuDNN's TF32
    off whatever the process-wide setting, which it leaves as it found it."""
    model = init_params(C.get_config("test-tiny"), torch.Generator().manual_seed(0),
                        torch.float32, device="cpu")
    seen = []
    for conv in (model.encoder.conv1, model.encoder.conv2):
        conv.register_forward_hook(lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    prev = torch.backends.cudnn.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cudnn.allow_tf32 = setting
            model.encoder.stem(torch.zeros(1, 40, 80))
            assert torch.backends.cudnn.allow_tf32 is setting
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert seen == [False] * 4
