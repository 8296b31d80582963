"""Beam search and ``decode_full``: the port against the JAX package, on the
CPU at f32 (``int8-kv``'s JAX side in a process of its own with XLA's excess
precision off, as tests/test_torch_kv8.py).

- ``beam._top_k`` breaks ties as ``jax.lax.top_k`` (the lower index first)
  on rows of -1e9, -inf and repeated values.
- ``_attend_beam`` / ``_attend_beam_q8`` against the JAX package's with a
  non-identity ancestry table, in the port's layout (a stream's beams in one
  block of K·T rows): f32 within 1e-5 of the output's scale; at int8 the
  int32 products bit-equal and the output within 1e-4 of its scale.
- ``Whisper.decode_step(beam_ancestry=)`` over three steps against the JAX
  package's on the golden weights: logits within 1e-4 of their scale, and
  every beam's cache rows (through the ancestry table) equal.
- ``beam_decode`` at beam 3 and 5, with and without a prefix, a prompt, a
  cap and word timestamps, through the uncaptured loop: tokens equal to
  ``realtime_whisper_asr_tpu``'s ``beam_decode``, the score within 1e-4,
  the no-speech probability within 1e-5 and the capture within 1/255
  (tests/test_decode.py's beam cases); the same at ``int8-kv``.
- ``beam_decode_batch`` of three streams at different states equal to each
  stream's own beam search at the same bucket and to the JAX package's
  batched beam (each stream stopping on its own).
- Steps past a stream's end change no buffer: at the cap, past the cache,
  with every beam finished, and a stream that ended while another goes on.
- The golden ``beam5`` row through ``TorchWhisperASR.transcribe``; a
  pipelined exact stream at beam 3 commits as the synchronous one, and an
  async beam stream never takes a device draft.
- ``decode_full`` within 1e-4 of the JAX package's, and of ``decode_span``.
"""

import ast
import inspect
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu.models.whisper import beam as JB
from realtime_whisper_asr_tpu.models.whisper import decode as JD
from realtime_whisper_asr_tpu.models.whisper import model as JM
from realtime_whisper_asr_tpu.models.whisper import quant as JQ
from realtime_whisper_asr_tpu.ops import log_mel_spectrogram as jax_log_mel
from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper import beam as B
from realtime_whisper_asr_tpu_torch.models.whisper import config as C
from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper import model as M
from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
from realtime_whisper_asr_tpu_torch.ops.int8_matmul import int8_bmm
from realtime_whisper_asr_tpu_torch.streaming import OnlineASRProcessor
from tests.test_torch_decode_loop import GOLDEN, _golden_tree, golden_audio

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = W.get_config("test-tiny")
SR = 16000


def _close(ours, ref, rel=1e-4, abs_=1e-5):
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= rel * np.abs(ref).max() + abs_, (err, np.abs(ref).max())


def _to_blocks(x) -> torch.Tensor:
    """The JAX package's one-stream beam rows (K, H, T, X) -> the port's
    block (1, H, K·T, X)."""
    x = np.asarray(x)
    k, h, t, d = x.shape
    return torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2, 3)).reshape(1, h, k * t, d))


# ---------------------------------------------------------------- top-K


@pytest.mark.parametrize("case", range(4))
def test_top_k_breaks_ties_as_jax(case):
    rng = np.random.default_rng(case)
    k, v = 5, 300
    cand = np.full((2, k * v), -1e9, np.float32)
    cand[:, rng.choice(k * v, 40, replace=False)] = -np.inf
    cand[0, :v] = np.float32(-1e9) + rng.standard_normal(v).astype(np.float32)  # rounds to -1e9
    cand[1, rng.choice(k * v, 8, replace=False)] = 0.5  # a tie across the cut
    cand[1, rng.choice(k * v, 3, replace=False)] = 1.0
    if case == 3:
        cand[:] = -np.inf
        cand[:, [7, 3, 900]] = 2.0
    vals, idx = jax.lax.top_k(jnp.asarray(cand), k)
    ours_v, ours_i = B._top_k(torch.from_numpy(cand), k)
    np.testing.assert_array_equal(ours_i.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(ours_v.numpy(), np.asarray(vals))


# ---------------------------------------------------------------- attention


def _ancestry(k: int, t: int, seed: int) -> np.ndarray:
    """A (K, K, T) one-hot ancestry table with random sources."""
    src = np.random.default_rng(seed).integers(0, k, (k, t))
    return np.eye(k, dtype=np.float32)[src].transpose(0, 2, 1).copy()


def test_attend_beam_equals_jax():
    rng = np.random.default_rng(0)
    k, h, t, dh = 3, 2, 40, 32
    q = rng.standard_normal((k, h, 1, dh)).astype(np.float32)
    kc = rng.standard_normal((k, h, t, dh)).astype(np.float32)
    vc = rng.standard_normal((k, h, t, dh)).astype(np.float32)
    anc = _ancestry(k, t, 1)
    mask = np.where(np.arange(t) > 30, -1e9, 0.0).astype(np.float32)
    ref = JM._attend_beam(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(anc),
                          jnp.asarray(mask)[None, None, None])
    ours = M._attend_beam(torch.from_numpy(q), _to_blocks(kc), _to_blocks(vc),
                          torch.from_numpy(anc)[None], torch.from_numpy(mask))
    _close(ours, ref, 1e-5, 1e-6)


def test_attend_beam_q8_equals_jax():
    rng = np.random.default_rng(2)
    k, h, t, dh = 3, 2, 40, 32
    q = rng.standard_normal((k, h, 1, dh)).astype(np.float32)
    quant = jax.jit(JM._quantize_kv_rows)
    k8, ks = quant(jnp.asarray(rng.standard_normal((k, h, t, dh)), jnp.float32))
    v8, vs = quant(jnp.asarray(rng.standard_normal((k, h, t, dh)), jnp.float32))
    anc = _ancestry(k, t, 3)
    mask = np.where(np.arange(t) > 30, -1e9, 0.0).astype(np.float32)
    ref = jax.jit(JM._attend_beam_q8)(jnp.asarray(q).astype(jnp.bfloat16), k8, v8, ks, vs,
                                      jnp.asarray(anc), jnp.asarray(mask)[None, None, None])
    blocks = [_to_blocks(x) for x in (k8, v8, ks, vs)]
    ours = M._attend_beam_q8(torch.from_numpy(q).bfloat16(), *blocks,
                             torch.from_numpy(anc)[None], torch.from_numpy(mask))
    assert ours.dtype == torch.bfloat16
    _close(ours, np.asarray(ref.astype(jnp.float32)))
    # the int32 score product against every physical row, bit-equal
    q8, _ = quant(jnp.asarray(q).astype(jnp.bfloat16)[:, :, 0])
    s_ref = jnp.einsum("bhd,jhtd->bjht", q8, k8, preferred_element_type=jnp.int32)
    ours_q8, _ = M._quantize_kv_rows(M._fold_beams(torch.from_numpy(q).bfloat16(), k))
    s = int8_bmm(ours_q8, blocks[0].transpose(-1, -2))  # (1, H, K, K·T)
    np.testing.assert_array_equal(
        s.numpy()[0].reshape(h, k, k, t).transpose(1, 2, 0, 3), np.asarray(s_ref))


@pytest.fixture(scope="module")
def golden():
    """(JAX params, port model, the JAX package's encoder output of golden
    clips 0-2) on the golden weights at f32."""
    jp = JQ.fuse_qkv(jax.tree.map(jnp.asarray, _golden_tree()))
    model = M.Whisper.empty(C.get_config("test-tiny"), torch.float32, "cpu")
    model.load_state_dict(load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    xa = np.concatenate([np.array(W.encode(jp, CFG, jax_log_mel(jnp.asarray(golden_audio(i)))
                                           [None])) for i in range(3)])
    return jp, model, xa


def test_decode_step_with_ancestry_equals_jax(golden):
    """Three beam steps over one stream's prefill, the third with
    ancestries that cross rows; logits, and each beam's K/V rows of its
    history, against the JAX package's decode_step(beam_ancestry=)."""
    jp, model, xa = golden
    k, t_ctx, p = 3, 32, 5
    xa = xa[:1, :200]
    init = np.array([[CFG.sot, 50259, 50359, 50364, 400]], np.int32)
    jc = JM.init_cache(jp, CFG, jnp.asarray(xa), text_ctx=t_ctx)
    _, jc, _ = JM.decode_span(jp, CFG, jnp.asarray(init), jnp.int32(0), jc)
    jc = JB._tile_beams(jc, k)
    cache = model.empty_cache(1, xa.shape[1], k * t_ctx, torch.float32, "cpu")
    with torch.inference_mode():
        model.fill_cache(torch.from_numpy(xa), cache)
        first = M.DecoderCache(cache.self_k[:, :, :, :t_ctx], cache.self_v[:, :, :, :t_ctx],
                               cache.cross_k, cache.cross_v)
        model.decode_span(torch.from_numpy(init).long(), 0, first)
        B._tile_beams(cache, k, p)
        anc = np.tile(np.eye(k, dtype=np.float32)[:, :, None], (1, 1, t_ctx))
        tokens = np.array([[7, 9, 11], [3, 4, 5], [8, 8, 8]], np.int32)
        amask = D._amask_dev(C.get_config("test-tiny"), None, torch.device("cpu"))
        for step in range(3):
            pos = p + step
            anc[:, :, pos] = np.eye(k)
            if step == 2:
                anc[1, :, p] = np.eye(k)[2]
                anc[2, :, p + 1] = np.eye(k)[0]
            jl, jc, jx = JM.decode_step(jp, CFG, jnp.asarray(tokens[step]), jnp.int32(pos), jc,
                                        alignment_mask=jnp.asarray(amask.numpy()),
                                        beam_ancestry=jnp.asarray(anc))
            tl, tx = model.decode_step(torch.from_numpy(tokens[step]).long(), torch.tensor(pos),
                                       cache, alignment_mask=amask,
                                       beam_ancestry=torch.from_numpy(anc)[None])
            _close(tl, jl)
            _close(tx, jx)
    ref = np.asarray(jc.self_k)  # (L, K, H, T, Dh)
    ours = cache.self_k.numpy()[:, 0].reshape(ref.shape[0], ref.shape[2], k, t_ctx, -1)
    np.testing.assert_allclose(ours.transpose(0, 2, 1, 3, 4)[..., : p + 3, :],
                               ref[..., : p + 3, :], atol=1e-5)


# ---------------------------------------------------------------- beam_decode

CASES = {  # (beam, prompt, prefix, capture, max_total_tokens)
    "k3": (3, None, None, True, None),
    "k5": (5, None, None, True, None),
    "k3-prefix": (3, None, [50364, 40485, 50884], False, None),
    "k5-prefix-cap": (5, None, [50364, 40485], True, 12),
    "k3-prompt": (3, [1000, 2000, 3000], None, True, None),
}


def _beam_opts(beam, capture, total):
    kw = dict(timestamps=True, word_timestamps=capture, max_new_tokens=24, beam_size=beam,
              max_total_tokens=total)
    return JD.DecodeOptions(**kw), D.DecodeOptions(**kw)


def _port_beam(model, xa, opts, prompt=None, prefix=None, k=3):
    plan = D.plan_window(model.cfg, opts, prompt, prefix)
    loop = D.DecodeLoop(k=k)
    res = B.beam_decode(model, torch.from_numpy(xa), opts, plan, torch.from_numpy(plan.aux),
                        loop=loop)
    return res, loop


def _same_result(ours, ref, capture):
    np.testing.assert_array_equal(ours.tokens, ref.tokens)
    np.testing.assert_array_equal(ours.lengths, ref.lengths)
    assert abs(float(ours.sum_logprob[0]) - float(ref.sum_logprob[0])) <= 1e-4 * max(
        1.0, abs(float(ref.sum_logprob[0])))
    assert abs(float(ours.no_speech_prob[0]) - float(ref.no_speech_prob[0])) < 1e-5
    if capture:
        assert ours.xattn.shape == ref.xattn.shape
        assert np.abs(ours.xattn - ref.xattn).max() <= 1.0 / 255.0 + 1e-6


@pytest.mark.parametrize("case", list(CASES))
def test_beam_decode_equals_jax(golden, case):
    jp, model, xa = golden
    beam, prompt, prefix, capture, total = CASES[case]
    jopts, opts = _beam_opts(beam, capture, total)
    ref = JB.beam_decode(jp, CFG, jnp.asarray(xa[:1]), jopts, prompt_tokens=prompt,
                         prefix_tokens=prefix)
    ours, loop = _port_beam(model, xa[:1], opts, prompt, prefix)
    _same_result(ours, ref, capture)
    assert loop.stats["eager_steps"] > 0 and loop.stats["captures"] == 0
    if prefix:
        assert ours.tokens[0][: len(prefix)].tolist() == prefix
    if total:
        body = ours.tokens[0][: ours.lengths[0]]
        assert len(body[body != CFG.eot]) <= total


def test_beam_decode_is_the_same_at_every_k(golden):
    _, model, xa = golden
    opts = _beam_opts(3, True, None)[1]
    runs = [_port_beam(model, xa[1:2], opts, k=k)[0] for k in (1, 4)]
    np.testing.assert_array_equal(runs[0].tokens, runs[1].tokens)
    np.testing.assert_array_equal(runs[0].xattn, runs[1].xattn)


BATCH_REQUESTS = [{}, {"prefix_tokens": [50364, 40485]}, {"prompt_tokens": [1000, 2000]}]


def test_beam_batch_equals_rows_and_jax(golden):
    jp, model, xa = golden
    jopts, opts = _beam_opts(3, True, None)
    ours = B.beam_decode_batch(model, torch.from_numpy(xa), opts, BATCH_REQUESTS,
                               loop=D.DecodeLoop())
    ref = JB.beam_decode_batch(jp, CFG, jnp.asarray(xa), jopts, BATCH_REQUESTS)
    plan = D.plan_batch_aux(model.cfg, opts, BATCH_REQUESTS)
    for i, req in enumerate(BATCH_REQUESTS):
        _same_result(ours[i], ref[i], True)
        own = D.plan_window(model.cfg, opts, req.get("prompt_tokens"), req.get("prefix_tokens"),
                            bucket=plan.p)
        one = B.beam_decode(model, torch.from_numpy(xa[i : i + 1]), opts, own,
                            torch.from_numpy(own.aux), loop=D.DecodeLoop())
        np.testing.assert_array_equal(ours[i].tokens, one.tokens)
        np.testing.assert_array_equal(ours[i].xattn, one.xattn)


_KV8_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu.models.whisper import beam as JB, decode as JD, quant as JQ
from tests.test_torch_decode_loop import _golden_tree
cfg = W.get_config("test-tiny")
jp = JQ.fuse_qkv(JQ.quantize_all(jax.tree.map(jnp.asarray, _golden_tree())))
xa = np.load(sys.argv[1])["xa"]
out = {}
for beam in (3, 5):
    opts = JD.DecodeOptions(timestamps=True, word_timestamps=True, max_new_tokens=24,
                            beam_size=beam)
    for i in range(2):
        r = JB.beam_decode(jp, cfg, jnp.asarray(xa[i : i + 1]), opts, kv_quant=True)
        out[f"{beam}.{i}.tokens"], out[f"{beam}.{i}.score"] = r.tokens, r.sum_logprob
        out[f"{beam}.{i}.xattn"] = r.xattn
rs = JB.beam_decode_batch(jp, cfg, jnp.asarray(xa), JD.DecodeOptions(
    timestamps=True, max_new_tokens=24, beam_size=3), REQUESTS, kv_quant=True)
for i, r in enumerate(rs):
    out[f"batch.{i}.tokens"] = r.tokens
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def kv8(golden, tmp_path_factory):
    """The JAX package's int8-kv beam searches (a process with excess
    precision off) and the port's int8-kv model."""
    _, _, xa = golden
    path = tmp_path_factory.mktemp("beam8")
    np.savez(path / "xa.npz", xa=xa)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=ROOT)
    script = _KV8_SCRIPT.replace("REQUESTS", repr(BATCH_REQUESTS))
    proc = subprocess.run([sys.executable, "-c", script, str(path / "xa.npz"),
                           str(path / "ref.npz")], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path / "ref.npz") as data:
        ref = {k: data[k] for k in data.files}
    model = M.Whisper.empty(C.get_config("test-tiny"), torch.float32, "cpu", "int8-kv")
    model.load_state_dict(Q.quantize(load_flat_npz(os.path.join(GOLDEN, "params.npz")),
                                     "int8-kv"))
    return ref, model, xa


@pytest.mark.parametrize("beam", [3, 5])
@pytest.mark.parametrize("clip", [0, 1])
def test_beam_decode_kv8_equals_jax(kv8, beam, clip):
    ref, model, xa = kv8
    ours, _ = _port_beam(model, xa[clip : clip + 1], _beam_opts(beam, True, None)[1])
    np.testing.assert_array_equal(ours.tokens, ref[f"{beam}.{clip}.tokens"])
    assert abs(float(ours.sum_logprob[0]) - float(ref[f"{beam}.{clip}.score"][0])) <= 1e-4 * max(
        1.0, abs(float(ref[f"{beam}.{clip}.score"][0])))
    assert np.abs(ours.xattn - ref[f"{beam}.{clip}.xattn"]).max() <= 1.0 / 255.0 + 1e-6


def test_beam_batch_kv8_equals_jax(kv8):
    ref, model, xa = kv8
    opts = D.DecodeOptions(timestamps=True, max_new_tokens=24, beam_size=3)
    ours = B.beam_decode_batch(model, torch.from_numpy(xa), opts, BATCH_REQUESTS,
                               loop=D.DecodeLoop())
    for i, res in enumerate(ours):
        np.testing.assert_array_equal(res.tokens, ref[f"batch.{i}.tokens"])


# ---------------------------------------------------------------- the loop


def _snapshot(st: B.BeamState) -> dict:
    out = {f"cache.{name}": getattr(st.cache, name).clone()
           for name in ("self_k", "self_v", "cross_k", "cross_v")}
    for name in ("tokens", "xcap", "anc", "finished", "scores", "last_ts", "pos", "total",
                 "n_prefix"):
        out[name] = getattr(st, name).clone()
    return out


def _run_beam(model, xa, opts, requests, steps):
    """A beam loop's state after its prefill and at most ``steps`` steps."""
    plan = D.plan_batch_aux(model.cfg, opts, requests)
    cpu = torch.device("cpu")
    sup_mask = D._sup_mask_dev(model.cfg, (), cpu)
    amask = D._amask_dev(model.cfg, None, cpu)
    key = D.LoopKey(id(model), xa.shape[1], plan.p, plan.max_new, 128, 0, len(requests), opts,
                    (), None)
    loop = D.DecodeLoop(k=2)
    run = loop.loop(model, key, torch.float32, cpu, sup_mask, amask, captured=False)
    with torch.inference_mode():
        B._prefill(model, opts, torch.from_numpy(xa), torch.from_numpy(plan.aux), sup_mask,
                   amask, run.state, plan.p)
        loop.run(run, steps)
    return run.state, (sup_mask, amask, plan.p)


@pytest.mark.parametrize("where", ["at_the_cap", "past_the_cache", "all_finished"])
def test_steps_past_the_end_change_nothing(golden, where):
    _, model, xa = golden
    opts = D.DecodeOptions(timestamps=True, word_timestamps=True, max_new_tokens=16, beam_size=3)
    st, (sup_mask, amask, p) = _run_beam(model, xa[:1], opts, [{}], 100)
    assert int(st.pos) == int(st.total[0]) and bool(st.ended())
    if where == "past_the_cache":
        st.pos.fill_(st.anc.shape[-1] + 3)
    elif where == "all_finished":
        st.pos.fill_(p + 5)
        st.finished.fill_(True)
    before = _snapshot(st)
    with torch.inference_mode():
        for _ in range(5):
            B._beam_step(model, opts, st, sup_mask, amask, p)
    after = _snapshot(st)
    for name, value in before.items():
        assert torch.equal(after[name], value), name


def test_a_stream_that_ended_stays_as_it_was(golden):
    """Two streams, the first capped at 3 tokens: once it has ended, the
    steps the second takes leave every buffer of the first as it was."""
    _, model, xa = golden
    opts = D.DecodeOptions(timestamps=True, word_timestamps=True, max_new_tokens=16, beam_size=3)
    requests = [{}, {}]
    plan = D.plan_batch_aux(model.cfg, opts, requests)
    plan.rows[0].aux[B.AUX_CAP] = 3
    st, (sup_mask, amask, p) = _run_beam(model, xa[:2], opts, [{}, {}], 0)
    with torch.inference_mode():
        B._prefill(model, opts, torch.from_numpy(xa[:2]), torch.from_numpy(plan.aux), sup_mask,
                   amask, st, p)
        for _ in range(2):
            B._beam_step(model, opts, st, sup_mask, amask, p)
        assert st.going().tolist() == [False, True]
        before = {k: v[:, 0] if k.startswith("cache.self") else v[0]
                  for k, v in _snapshot(st).items() if k not in ("pos",)}
        for _ in range(4):
            B._beam_step(model, opts, st, sup_mask, amask, p)
    assert st.going().tolist() == [False, True]
    after = _snapshot(st)
    for name, value in before.items():
        got = after[name][:, 0] if name.startswith("cache.self") else after[name][0]
        assert torch.equal(got, value), name


_NO_HOST_READS = ("_beam_step", "_expand", "_prefill", "_pack", "_top_k", "_tile_beams",
                  "going", "ended")


def test_the_beam_loop_reads_nothing_back():
    """Between the prefill and the pack a beam search reads nothing back to
    the host: its only reads are ``DecodeLoop.run``'s checks."""
    tree = ast.parse(inspect.getsource(B))
    funcs = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    for name in _NO_HOST_READS:
        for n in ast.walk(funcs[name]):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
                assert n.func.attr not in ("item", "tolist", "cpu", "numpy"), name
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
                assert n.func.id not in ("bool", "int", "float") or isinstance(
                    n.args[0], ast.Constant), name
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


# ---------------------------------------------------------------- the ASR


@pytest.fixture(scope="module")
def asr():
    asr = TorchWhisperASR(cfg=C.get_config("test-tiny"), dtype=torch.float32, device="cpu",
                          params=load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    return asr


def test_golden_beam5_row(asr, monkeypatch):
    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        row = json.load(f)["matrix"]["beam5"]
    monkeypatch.setattr(asr, "beam_size", 5)
    res = asr.transcribe(golden_audio(0))
    assert {"tokens": [int(t) for t in res.tokens],
            "text": "".join(s.text for s in res).strip()} == row


def _stream(asr, audio, pipeline):
    proc = OnlineASRProcessor(asr, pipeline=pipeline, buffer_trimming=("segment", 4.0))
    outs = []
    for pos in range(0, len(audio), SR):
        proc.insert_audio_chunk(audio[pos : pos + SR])
        outs.append(proc.process_iter())
    outs.append(proc.finish())
    return proc, outs


def test_pipelined_beam_stream_equals_sync(asr, monkeypatch):
    """Beam 3: the exact pipelined loop commits what the synchronous one
    does, one call later; an async stream dispatches no device draft after
    a beam tick."""
    monkeypatch.setattr(asr, "beam_size", 3)
    audio = golden_audio(1, seconds=5.0)
    proc_s, sync = _stream(asr, audio, False)
    proc_p, piped = _stream(asr, audio, True)
    assert proc_p.commited == proc_s.commited and proc_s.commited
    assert piped[0] == (None, None, "")
    drafts = []
    dispatch = asr.transcribe_dispatch
    monkeypatch.setattr(asr, "transcribe_dispatch", lambda *a, device_draft=None, **k: (
        drafts.append(device_draft), dispatch(*a, device_draft=device_draft, **k))[1])
    proc = OnlineASRProcessor(asr, pipeline="async", prefix_policy="last")
    for pos in range(0, len(audio), SR):
        proc.insert_audio_chunk(audio[pos : pos + SR])
        proc.process_iter()
        assert proc._inflight is None or proc._inflight[0]["beam"]
    proc.finish()
    assert len(drafts) > 2 and not any(drafts)


# ---------------------------------------------------------------- decode_full


def test_decode_full_equals_jax_and_decode_span(golden):
    jp, model, xa = golden
    rng = np.random.default_rng(4)
    tokens = np.concatenate([[[CFG.sot, 50259, 50359]], rng.integers(0, 50000, (1, 29))], 1)
    ref = JM.decode_full(jp, CFG, jnp.asarray(tokens, jnp.int32), jnp.asarray(xa[:1]))
    with torch.inference_mode():
        ours = model.decode_full(torch.from_numpy(tokens).long(), torch.from_numpy(xa[:1]))
        span, _ = model.decode_span(torch.from_numpy(tokens).long(), 0,
                                    model.init_cache(torch.from_numpy(xa[:1]), text_ctx=32))
    _close(ours, ref)
    _close(ours, span.numpy())
