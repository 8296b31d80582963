"""The ``int8-kv`` tier: int8 KV caches, the port against the JAX package.

- ``_quantize_kv_rows`` bit-equal to the JAX package's as its jitted decode
  computes it (XLA turns ``/ 127.0`` into a multiply by the f32 reciprocal;
  the division by the scale stays IEEE), and differing from the eager
  (IEEE) scale at bf16 ties, which is why the tier quantizes so.
- The two int32 products of ``_attend_q8`` bit-equal to the JAX package's
  ``dot_general(..., preferred_element_type=int32)``, among them an
  adversarial 1,500-frame w·v whose exact sum is an odd integer above 2^24;
  a single f32 product of the same operands rounds it (the mutation check
  of ``int8_bmm``'s chunking).
- ``_attend_q8``, ``decode_span`` and ``decode_step`` at ``int8-kv`` on the
  golden weights against the JAX ones, within max|Δ| ≤ 1e-4·max|ref| + 1e-5
  (f32 sums in another order, as tests/test_torch_quant.py), and the caches
  they write bit-equal.
- The whole decode of the three golden clips at ``int8-kv`` (the JAX
  package's dense encoder output fed to both decoders), through the
  uncaptured loop at K = 1 and 3: tokens bit-equal to the JAX package's.
- ``TorchWhisperASR(quantization="int8-kv")`` against
  ``TPUWhisperASR(quantization="int8-kv")`` end to end on the golden clips.
- A batched ``int8-kv`` decode equal to each row's own.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu.models.whisper import model as JM
from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper import config as C
from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper import model as M
from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
from realtime_whisper_asr_tpu_torch.ops.int8_matmul import EXACT_F32_K, int8_bmm, quantize_rows
from tests.test_torch_decode_loop import golden_audio

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden")
TOL = (1e-4, 1e-5)  # max|Δ| ≤ 1e-4·max|ref| + 1e-5
_BHQD_BHKD = (((3,), (3,)), ((0, 1), (0, 1)))
_BHQK_BHKD = (((3,), (2,)), ((0, 1), (0, 1)))


def _close(ours, ref):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= TOL[0] * np.abs(ref).max() + TOL[1], (err, np.abs(ref).max())


def _bf16_rows(seed: int, shape) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_kv_rows_equals_jitted_jax(dtype):
    x = _bf16_rows(0, (2, 3, 257, 64))
    jx = jnp.asarray(x).astype(dtype)
    q, s = jax.jit(JM._quantize_kv_rows)(jx)
    ours_q, ours_s = M._quantize_kv_rows(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(ours_q.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ours_s.numpy(), np.asarray(s))
    if dtype == "bfloat16":  # the eager (IEEE) scale rounds other ties
        eager_q, _ = quantize_rows(torch.from_numpy(x).bfloat16())
        assert not torch.equal(eager_q, ours_q)


def _jax_int_products(q8, k8, w8, v8):
    scores = jax.lax.dot_general(jnp.asarray(q8), jnp.asarray(k8), _BHQD_BHKD,
                                 preferred_element_type=jnp.int32)
    out = jax.lax.dot_general(jnp.asarray(w8), jnp.asarray(v8), _BHQK_BHKD,
                              preferred_element_type=jnp.int32)
    return np.asarray(scores), np.asarray(out)


@pytest.mark.parametrize("tk", [400, 800, 1500])
def test_int_products_equal_jax(tk):
    rng = np.random.default_rng(tk)
    q8, k8, w8, v8 = (rng.integers(-127, 128, shape, dtype=np.int8) for shape in
                      ((2, 3, 5, 64), (2, 3, tk, 64), (2, 3, 5, tk), (2, 3, tk, 64)))
    scores, out = _jax_int_products(q8, k8, w8, v8)
    t = [torch.from_numpy(a) for a in (q8, k8, w8, v8)]
    np.testing.assert_array_equal(int8_bmm(t[0], t[1].transpose(-1, -2)).numpy(), scores)
    np.testing.assert_array_equal(int8_bmm(t[2], t[3]).numpy(), out)


def test_adversarial_value_product_needs_the_chunks():
    """w8 = v8 = 127 over 1,500 frames, one frame at 126: the exact sum
    1,499·16,129 + 16,002 = 24,193,373 is odd and above 2^24, where f32
    holds even integers only. The JAX int32 product gives it; ``int8_bmm``
    gives it; a single f32 product of the whole contraction cannot (the
    check that the chunks are needed, with ``EXACT_F32_K`` as long as the
    contraction)."""
    tk = 1500
    w8 = np.full((1, 1, 1, tk), 127, np.int8)
    v8 = np.full((1, 1, tk, 1), 127, np.int8)
    v8[0, 0, 7, 0] = 126
    exact = (tk - 1) * 127 * 127 + 127 * 126
    assert exact > 2**24 and exact % 2
    _, ref = _jax_int_products(np.zeros((1, 1, 1, 1), np.int8), np.zeros((1, 1, 1, 1), np.int8),
                               w8, v8)
    assert int(ref.reshape(-1)[0]) == exact
    ours = int8_bmm(torch.from_numpy(w8), torch.from_numpy(v8))
    assert int(ours.reshape(-1)[0]) == exact
    naive = torch.matmul(torch.from_numpy(w8).float(), torch.from_numpy(v8).float())
    assert int(naive.reshape(-1)[0]) != exact
    assert EXACT_F32_K < tk


#: the JAX side of the decoder-level tests, run in a process of its own with
#: XLA's excess precision off: XLA's CPU compiler otherwise keeps fused bf16
#: chains in f32 (a layer norm reads its residual sum unrounded), where the
#: JAX functions, and the port after them, round at every bf16 op
_REF_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu.models.whisper import decode as JD, model as JM, quant as JQ
from realtime_whisper_asr_tpu.ops import log_mel_spectrogram
from tests.test_torch_decode_loop import _golden_tree, golden_audio
cfg = W.get_config("test-tiny")
tree = _golden_tree()
dense = JQ.fuse_qkv(jax.tree.map(jnp.asarray, tree))
jp = JQ.fuse_qkv(JQ.quantize_all(jax.tree.map(jnp.asarray, tree)))
out = {}
for i in range(3):
    out[f"xa{i}"] = xa = np.array(W.encode(dense, cfg, log_mel_spectrogram(
        jnp.asarray(golden_audio(i)))[None]))
    handle = JD.greedy_decode_dispatch(jp, cfg, jnp.asarray(xa), JD.DecodeOptions(
        timestamps=True, word_timestamps=True, max_new_tokens=24), kv_quant=True)
    out[f"packed{i}"] = np.asarray(handle["packed"])
xa, toks, amask = out["xa0"][:, :400], np.array(SPAN_TOKENS, np.int32), np.array(AMASK)
c = JM.init_cache(jp, cfg, jnp.asarray(xa), text_ctx=128, kv_quant=True)
for name in ("cross_k", "cross_v", "cross_ks", "cross_vs", "self_ks"):
    out["init." + name] = np.asarray(getattr(c, name))
span = jax.jit(JM.decode_span, static_argnames=("cfg",))
step = jax.jit(JM.decode_step, static_argnames=("cfg",))
lg, c, xw = span(jp, cfg, jnp.asarray(toks), jnp.int32(0), c, jnp.asarray(amask))
out["span.logits"], out["span.xattn"] = np.asarray(lg), np.asarray(xw)
for i, tok in enumerate(STEP_TOKENS):
    lg, c, xw = step(jp, cfg, jnp.asarray([tok], jnp.int32), jnp.int32(toks.shape[1] + i), c,
                     jnp.asarray(amask))
    out[f"step{i}.logits"], out[f"step{i}.xattn"] = np.asarray(lg), np.asarray(xw)
for name in ("self_k", "self_v", "self_ks", "self_vs"):
    out["final." + name] = np.asarray(getattr(c, name))
np.savez(sys.argv[1], **out)
"""
SPAN_TOKENS = [[50258, 50259, 50359, 50363, 440, 1000, 2000, 50400]]
STEP_TOKENS = (50400, 7, 51000)


def _amask() -> np.ndarray:
    """The default alignment heads of test-tiny: the top half of the
    decoder layers, normalized."""
    cfg = C.get_config("test-tiny")
    amask = np.zeros((cfg.n_text_layer, cfg.n_text_head), np.float32)
    amask[cfg.n_text_layer // 2:] = 1.0
    return amask / amask.sum()


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """(the JAX side's results, computed in a process with XLA's excess
    precision off, port int8-kv model on the golden weights)."""
    path = str(tmp_path_factory.mktemp("kv8") / "ref.npz")
    script = (_REF_SCRIPT.replace("SPAN_TOKENS", repr(SPAN_TOKENS))
              .replace("STEP_TOKENS", repr(STEP_TOKENS))
              .replace("AMASK", repr(_amask().tolist())))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script, path], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as data:
        ref = {k: data[k] for k in data.files}
    model = M.Whisper.empty(C.get_config("test-tiny"), torch.float32, "cpu", "int8-kv")
    model.load_state_dict(Q.quantize(load_flat_npz(os.path.join(GOLDEN, "params.npz")),
                                     "int8-kv"))
    return ref, model


def test_attend_q8_equals_jax():
    rng = np.random.default_rng(3)
    q = _bf16_rows(4, (1, 2, 6, 32))
    k = rng.standard_normal((1, 2, 40, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 40, 32)).astype(np.float32)
    mask = np.where(np.arange(40)[None, :] > np.arange(6)[:, None] + 30, -1e9, 0.0)
    mask = mask.astype(np.float32)[None, None]
    k8, ks = jax.jit(JM._quantize_kv_rows)(jnp.asarray(k))
    v8, vs = jax.jit(JM._quantize_kv_rows)(jnp.asarray(v))
    ref, rw = jax.jit(lambda *a: JM._attend_q8(*a, return_weights=True))(
        jnp.asarray(q).astype(jnp.bfloat16), k8, v8, ks, vs, jnp.asarray(mask))
    args = [torch.from_numpy(np.asarray(a)) for a in (k8, v8, ks, vs)]
    ours, w = M._attend_q8(torch.from_numpy(q).bfloat16(), *args, torch.from_numpy(mask),
                           return_weights=True)
    assert ours.dtype == torch.bfloat16
    _close(ours, np.asarray(ref.astype(jnp.float32)))
    _close(w, rw)
    # K/V of batch 1 against 3 query rows: the shared-KV branch
    q3 = _bf16_rows(5, (3, 2, 1, 32))
    ref3, _ = jax.jit(JM._attend_q8)(jnp.asarray(q3).astype(jnp.bfloat16), k8, v8, ks, vs)
    ours3, _ = M._attend_q8(torch.from_numpy(q3).bfloat16(), *args)
    _close(ours3, np.asarray(ref3.astype(jnp.float32)))


def test_decode_span_and_step_equal_jax(golden):
    ref, model = golden
    xa = torch.from_numpy(ref["xa0"][:, :400])
    amask = torch.from_numpy(_amask())
    pc = model.init_cache(xa, text_ctx=128)
    assert pc.kv_quant and pc.self_k.dtype == torch.int8 and pc.self_ks.dtype == torch.float32
    for name in ("cross_k", "cross_v", "cross_ks", "cross_vs", "self_ks"):
        np.testing.assert_array_equal(getattr(pc, name).numpy(), ref["init." + name])
    toks = torch.tensor(SPAN_TOKENS)
    logits, xattn = model.decode_span(toks, 0, pc, amask)
    _close(logits, ref["span.logits"])
    _close(xattn, ref["span.xattn"])
    for i, tok in enumerate(STEP_TOKENS):
        logits, xattn = model.decode_step(torch.tensor([tok]), torch.tensor(toks.shape[1] + i),
                                          pc, amask)
        _close(logits, ref[f"step{i}.logits"])
        _close(xattn, ref[f"step{i}.xattn"])
    for name in ("self_k", "self_v", "self_ks", "self_vs"):
        np.testing.assert_array_equal(getattr(pc, name).numpy(), ref["final." + name])


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("clip", [0, 1, 2])
def test_decode_equals_jax_greedy_decode(golden, clip, k):
    """The whole greedy decode at int8-kv, the JAX package's dense encoder
    output of the clip fed to both: the token section of the packed result
    bit-equal, through the uncaptured loop at K = k."""
    ref, model = golden
    opts = D.DecodeOptions(timestamps=True, word_timestamps=True, max_new_tokens=24)
    plan = D.plan_window(model.cfg, opts)
    loop = D.DecodeLoop(k=k)
    ours = D._decode_window(model, opts, torch.from_numpy(ref[f"xa{clip}"]),
                            torch.from_numpy(plan.aux)[None], plan, (), None, loop,
                            captured=False).numpy()
    np.testing.assert_array_equal(ours[: plan.max_new], ref[f"packed{clip}"][: plan.max_new])
    assert loop.stats["eager_steps"] > 0


def test_batched_decode_equals_rows(golden):
    """Three rows at different states in one int8-kv loop: each row's
    tokens are its own decode's at the same prefill bucket."""
    ref, model = golden
    opts = D.DecodeOptions(timestamps=True, word_timestamps=True, max_new_tokens=24)
    requests = [{}, {"prefix_tokens": [50364, 440]}, {"prompt_tokens": [1000, 2000]}]
    xa = torch.from_numpy(np.concatenate([ref[f"xa{i}"] for i in range(3)]))
    batched = D.greedy_decode_batch(model, xa, opts, requests, loop=D.DecodeLoop())
    plan = D.plan_batch_aux(model.cfg, opts, requests)
    for i, (req, res) in enumerate(zip(requests, batched)):
        own = D.plan_window(model.cfg, opts, req.get("prompt_tokens"),
                            req.get("prefix_tokens"), bucket=plan.p)
        one = D.greedy_decode(model, xa[i : i + 1], opts, own, torch.from_numpy(own.aux)[None],
                              loop=D.DecodeLoop())
        np.testing.assert_array_equal(res.tokens, one.tokens)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("clip", [0, 1, 2])
def test_asr_tokens_equal_jax_asr(clip, k):
    """``TorchWhisperASR(quantization="int8-kv")`` against the JAX
    package's ``TPUWhisperASR`` on the golden clips, each from its own
    log-mel and int8 encoder, the port's loop uncaptured at K = k. Clips 0
    and 2: equal tokens. Clip 1: the int8 encoders of both tiers with int8
    encoders (``int8-all`` too) flip a rounding tie apart (ROADMAP queue 3),
    and the transcripts agree through the tokens before it."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from golden import build_asr

    audio = golden_audio(clip)
    ref = build_asr(quantization="int8-kv").transcribe(audio).tokens
    asr = TorchWhisperASR(cfg=C.get_config("test-tiny"), dtype=torch.float32, device="cpu",
                          params=load_flat_npz(os.path.join(GOLDEN, "params.npz")),
                          quantization="int8-kv")
    assert asr.quantization == "int8-kv" and asr.model.kv_quant
    asr.decode_loop = D.DecodeLoop(k=k)
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    got = asr.transcribe(audio).tokens
    if clip == 1:
        assert got[:4] == ref[:4] and got != ref
    else:
        assert got == ref
