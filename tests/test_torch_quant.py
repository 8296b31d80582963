"""The port's int8 / int4 tiers against the JAX package's.

- Quantizers: ``quant.quantize(state, tier)`` gives, bit for bit, the q and s
  of the JAX package's tier transform followed by ``fuse_qkv`` (the order its
  ASR backend runs them in), on the committed golden test-tiny weights and a
  seeded test-tiny tree.
- Conversion: ``params_from_jax`` of a JAX-quantized tree loads into the
  tier's model, and its buffers give back the JAX values.
- Logits: ``decode_span`` / ``decode_step`` against the JAX package's on the
  same quantized weights and encoder output, and single quantized linears on
  identical inputs, within max|Δ| ≤ 1e-4·max|ref| + 1e-5 (test_torch_model.py's
  tolerance: f32 sums in another order). The quantized paths round x/sx to
  int8, a discontinuous function: an activation within an f32 ulp of a .5
  tie rounds either way depending on the f32 sum order before it, and such a
  flip moves the rows after it by ~1 %. The inputs here have no such tie;
  ``test_int4_tie_flip_explains_the_seed0_span`` locks the one at seed 0.
- Golden rows: ``TorchWhisperASR(device="cpu", quantization=...)``
  reproduces the ``int8all`` and ``int4`` rows of the golden matrix exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu.models.whisper import quant as JQ
from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper import config as C
from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz, params_from_jax
from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
TIERS = {"int8": JQ.quantize_decoder, "int8-all": JQ.quantize_all,
         "int4": JQ.quantize_decoder_int4, "int4-all": JQ.quantize_all_int4}


def _golden_tree() -> dict:
    tree: dict = {}
    with np.load(os.path.join(GOLDEN, "params.npz")) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key].astype(np.float32)
    return tree


def _tree(which: str) -> dict:
    if which == "golden":
        return _golden_tree()
    return jax.tree.map(np.asarray, W.init_params(W.get_config("test-tiny"),
                                                  jax.random.PRNGKey(11)))


def _jax_tier(tree: dict, tier: str) -> dict:
    """The JAX package's tier transform, then fuse_qkv, as its ASR runs them."""
    return JQ.fuse_qkv(TIERS[tier](jax.tree.map(jnp.asarray, tree)))


def _close(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= 1e-4 * np.abs(ref).max() + 1e-5, (err, np.abs(ref).max())


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("which", ["golden", "seeded"])
def test_quantizers_equal_jax_bit_for_bit(which, tier):
    tree = _tree(which)
    ref = params_from_jax(jax.tree.map(np.asarray, _jax_tier(tree, tier)))
    ours = Q.quantize(params_from_jax(tree), tier)
    assert ours.keys() == ref.keys()
    for key in ref:
        assert ours[key].dtype == ref[key].dtype, key
        assert torch.equal(ours[key], ref[key]), key
    quantized = [k for k in ours if k.endswith(".q")]
    n_dec = 8 * 2  # 8 linears x 2 layers, cross-attention included
    n_enc = 4 * 2 if tier.endswith("-all") else 0
    assert len(quantized) == n_dec + n_enc + (tier != "int8")


def test_fused_qkv_quantizes_like_its_parts():
    """Quantizing the port's fused qkv equals fusing the quantized q/k/v."""
    tree = _golden_tree()
    attn = tree["decoder"]["blocks"]["attn"]
    for fn, pack in ((Q.quantize_int8, False), (Q.quantize_int4, True)):
        parts = [fn(torch.from_numpy(attn[k][0].T.copy())) for k in ("wq", "wk", "wv")]
        fused = fn(torch.from_numpy(np.concatenate([attn[k][0] for k in ("wq", "wk", "wv")],
                                                   axis=-1).T.copy()))
        axis = -1 if pack else 0
        assert torch.equal(fused[0], torch.cat([p[0] for p in parts], dim=axis))
        assert torch.equal(fused[1], torch.cat([p[1] for p in parts], dim=-1))


def test_pack_roundtrip_and_dequant_equal_jax():
    rng = np.random.default_rng(5)
    q = rng.integers(-7, 8, (256, 64)).astype(np.int8)
    packed = Q.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(JQ._pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(Q.unpack_int4(packed).numpy(), q)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    for jfn, fn in ((JQ._quantize_weight, Q.quantize_int8),
                    (JQ._quantize_weight_int4, Q.quantize_int4)):
        ref = np.asarray(JQ._dequant(jfn(jnp.asarray(w))))
        ours = Q.dequant(*fn(torch.from_numpy(w.T.copy())))
        np.testing.assert_array_equal(ours.t().numpy(), ref)


@pytest.mark.parametrize("tier", list(TIERS))
def test_converted_tree_loads_and_unpacks_to_jax(tier):
    jtree = jax.tree.map(np.asarray, _jax_tier(_golden_tree(), tier))
    model = Whisper.empty(C.get_config("test-tiny"), torch.float32, "cpu", tier)
    model.load_state_dict(params_from_jax(jtree))
    dec = jtree["decoder"]["blocks"]
    for i in range(2):
        blk = model.decoder.blocks[i]
        for mod, leaf in ((blk.attn.qkv, dec["attn"]["wqkv"]), (blk.fc1, dec["mlp"]["w1"]),
                          (blk.cross.key, dec["cross"]["wk"])):
            jq, js = leaf["q"][i], leaf["s"][i]
            if tier.startswith("int4"):
                np.testing.assert_array_equal(Q.unpack_int4(mod.q).numpy(),
                                              np.asarray(JQ._unpack_int4(jnp.asarray(jq))))
            else:
                np.testing.assert_array_equal(mod.q.t().numpy(), jq)
            np.testing.assert_array_equal(mod.s.numpy(), js)
    if tier != "int8":
        emb = model.decoder.tok_emb
        v = jtree["decoder"]["tok_emb"]["q"].shape[0]
        np.testing.assert_array_equal(emb.q[:v].numpy(), jtree["decoder"]["tok_emb"]["q"])
        assert not emb.q[v:].any()  # the padding rows are zero
        np.testing.assert_array_equal(emb.s.numpy(), jtree["decoder"]["tok_emb"]["s"])
    if tier.endswith("-all"):
        enc = jtree["encoder"]["blocks"]["mlp"]["w2"]
        np.testing.assert_array_equal(model.encoder.blocks[1].fc2.q.t().numpy(), enc["q"][1])


def test_unfused_quantized_tree_converts_like_fused():
    """A JAX-quantized tree with separate wq/wk/wv converts as its fused form
    does (q and s concatenated on the output axis, as ``fuse_qkv``)."""
    tree = jax.tree.map(jnp.asarray, _golden_tree())
    for tier, fn in TIERS.items():
        unfused = params_from_jax(jax.tree.map(np.asarray, fn(tree)))
        fused = params_from_jax(jax.tree.map(np.asarray, JQ.fuse_qkv(fn(tree))))
        assert unfused.keys() == fused.keys()
        assert all(torch.equal(unfused[k], fused[k]) for k in fused), tier


@pytest.fixture(scope="module", params=list(TIERS))
def tier_pair(request):
    """(tier, cfg, JAX quantized params, port model) on the golden weights."""
    tier = request.param
    cfg = W.get_config("test-tiny")
    model = Whisper.empty(C.get_config("test-tiny"), torch.float32, "cpu", tier)
    model.load_state_dict(Q.quantize(load_flat_npz(os.path.join(GOLDEN, "params.npz")), tier))
    return tier, cfg, _jax_tier(_golden_tree(), tier), model


def _amask(cfg) -> np.ndarray:
    m = np.zeros((cfg.n_text_layer, cfg.n_text_head), np.float32)
    m[cfg.n_text_layer // 2 :] = 1.0
    return m / m.sum()


def _inputs(cfg, seed: int = 1):
    rng = np.random.default_rng(seed)
    mel = (0.5 * rng.standard_normal((1, 800, cfg.n_mels))).astype(np.float32)
    tokens = rng.integers(0, cfg.eot, size=(1, 16)).astype(np.int32)
    return mel, tokens


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("m,k,n", [(1, 64, 192), (16, 256, 64), (800, 64, 256)])
def test_quantized_linear_matches_jax(kind, m, k, n):
    """One quantized linear on identical inputs: the JAX package's
    ``_linear`` and the port's module agree to f32 rounding (the integer
    products are exact on both sides)."""
    from realtime_whisper_asr_tpu.models.whisper.model import _linear
    from realtime_whisper_asr_tpu_torch.models.whisper.model import Int4Linear, Int8Linear

    rng = np.random.default_rng(m + k + n)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal((1, m, k)).astype(np.float32)
    jw = (JQ._quantize_weight if kind == "int8" else JQ._quantize_weight_int4)(jnp.asarray(w))
    mod = (Int8Linear if kind == "int8" else Int4Linear)(k, n)
    q, s = (Q.quantize_int8 if kind == "int8" else Q.quantize_int4)(torch.from_numpy(w.T.copy()))
    mod.load_state_dict({"q": q, "s": s, "bias": torch.from_numpy(b)})
    with torch.inference_mode():
        _close(mod(torch.from_numpy(x)), _linear(jnp.asarray(x), jw, jnp.asarray(b)))


def test_int4_tie_flip_explains_the_seed0_span():
    """Why the logits tests use seed 1: the quantized paths round x/sx to
    int8, and at seed 0 one activation entering layer 0's fc2 (row 12) lies
    within ~2 f32 ulps of a .5 tie, so the f32 GELU before it (torch's and
    XLA's differ in the last bit) decides which way it rounds. That one flip
    moves the logits of rows 12-13 by ~1 %; every other row agrees to 1e-6.
    A discontinuity of the function, not a fault of the port."""
    from realtime_whisper_asr_tpu_torch.models.whisper import model as M

    cfg = W.get_config("test-tiny")
    model = Whisper.empty(C.get_config("test-tiny"), torch.float32, "cpu", "int4")
    model.load_state_dict(Q.quantize(load_flat_npz(os.path.join(GOLDEN, "params.npz")), "int4"))
    jparams = _jax_tier(_golden_tree(), "int4")
    mel, tokens = _inputs(cfg, seed=0)
    xa = np.array(W.encode(jparams, cfg, jnp.asarray(mel)))
    jcache = W.init_cache(jparams, cfg, jnp.asarray(xa), text_ctx=128)
    jl, _, _ = W.decode_span(jparams, cfg, jnp.asarray(tokens), jnp.int32(0), jcache)
    ties = []

    def record(_, args):  # per row: distance of x/sx from the nearest .5 tie
        x = args[0].float()
        r = x / M.quantize_rows(x)[1]
        ties.append(((r - torch.floor(r)) - 0.5).abs().amin(-1)[0])

    model.decoder.blocks[0].fc2.register_forward_pre_hook(record)
    with torch.inference_mode():
        ol, _ = model.decode_span(torch.from_numpy(tokens).long(), 0,
                                  model.init_cache(torch.from_numpy(xa), text_ctx=128))
    jl = np.asarray(jl)
    diff = np.abs(ol.numpy() - jl)[0].max(-1)
    tol = 1e-4 * np.abs(jl).max() + 1e-5
    assert set(np.nonzero(diff > tol)[0]) == {12, 13}
    assert int(ties[0].argmin()) == 12 and float(ties[0][12]) < 2e-5


def _spans(cfg, jparams, model):
    mel, tokens = _inputs(cfg)
    xa = np.array(W.encode(jparams, cfg, jnp.asarray(mel)))
    amask = _amask(cfg)
    jcache = W.init_cache(jparams, cfg, jnp.asarray(xa), text_ctx=128)
    jl, jcache, jx = W.decode_span(jparams, cfg, jnp.asarray(tokens), jnp.int32(0), jcache,
                                   alignment_mask=jnp.asarray(amask))
    with torch.inference_mode():
        cache = model.init_cache(torch.from_numpy(xa), text_ctx=128)
        ol, ox = model.decode_span(torch.from_numpy(tokens).long(), 0, cache,
                                   alignment_mask=torch.from_numpy(amask))
    return (jl, jx, jcache), (ol, ox, cache), amask


def test_quantized_decode_span_matches_jax(tier_pair):
    _, cfg, jparams, model = tier_pair
    (jl, jx, jcache), (ol, ox, cache), _ = _spans(cfg, jparams, model)
    _close(ol, jl)
    _close(ox, jx)
    _close(cache.cross_k, jcache.cross_k)
    _close(cache.self_v, jcache.self_v)


def test_quantized_decode_step_matches_jax(tier_pair):
    _, cfg, jparams, model = tier_pair
    (_, _, jcache), (_, _, cache), amask = _spans(cfg, jparams, model)
    tok = np.asarray([1234], np.int32)
    jl, _, jx = W.decode_step(jparams, cfg, jnp.asarray(tok), jnp.int32(16), jcache,
                              alignment_mask=jnp.asarray(amask))
    with torch.inference_mode():
        ol, ox = model.decode_step(torch.from_numpy(tok).long(), torch.tensor(16), cache,
                                   alignment_mask=torch.from_numpy(amask))
    _close(ol, jl)
    _close(ox, jx)


def golden_audio(idx: int, seconds: float = 8.0) -> np.ndarray:
    """tools/golden.py's deterministic synthetic clips."""
    sr = 16000
    rng = np.random.default_rng(1000 + idx)
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(110, 200) + 30 * np.sin(2 * np.pi * rng.uniform(0.3, 0.9) * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t))
    out = sig * env + 0.02 * rng.standard_normal(t.shape)
    return (0.4 * out / np.max(np.abs(out))).astype(np.float32)


@pytest.mark.parametrize("tier,row", [("int8-all", "int8all"), ("int4", "int4")])
def test_golden_quantized_rows_reproduce_exactly(tier, row):
    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        recorded = json.load(f)["matrix"][row]
    asr = TorchWhisperASR(cfg=C.get_config("test-tiny"), dtype=torch.float32, device="cpu",
                          params=load_flat_npz(os.path.join(GOLDEN, "params.npz")),
                          quantization=tier)
    assert asr.quantization == tier
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    res = asr.transcribe(golden_audio(0))
    got = {"tokens": [int(t) for t in res.tokens], "text": "".join(s.text for s in res).strip()}
    assert got == recorded


def test_tier_errors():
    """An unknown tier raises; ``"int8-kv"``, which raised before it was
    ported, builds int8-all's layout with int8 caches."""
    cfg = C.get_config("test-tiny")
    kv = TorchWhisperASR(cfg=cfg, device="cpu", quantization="int8-kv")
    assert kv.quantization == "int8-kv" and kv.model.kv_quant
    assert kv.model.empty_cache(1, 10, 8, torch.float32, "cpu").self_k.dtype == torch.int8
    with pytest.raises(ValueError, match="unknown quantization"):
        TorchWhisperASR(cfg=cfg, device="cpu", quantization="int3")
    assert TorchWhisperASR(cfg=cfg, device="cpu", quantization="none").quantization is None


def test_random_init_tier_quantizes_at_load():
    """With no weights, the tier quantizes the seeded random init: the same
    model as quantizing that init's state dict."""
    cfg = C.get_config("test-tiny")
    dense = TorchWhisperASR(cfg=cfg, device="cpu", dtype=torch.float32, seed=3)
    asr = TorchWhisperASR(cfg=cfg, device="cpu", dtype=torch.float32, seed=3,
                          quantization="int4-all")
    ref = Q.quantize(dense.model.state_dict(), "int4-all")
    state = asr.model.state_dict()
    assert isinstance(asr.model.decoder.blocks[0].fc1.q, torch.Tensor)
    for key, value in ref.items():
        got = state[key][: value.shape[0]] if key == "decoder.tok_emb.q" else state[key]
        assert torch.equal(got, value), key
