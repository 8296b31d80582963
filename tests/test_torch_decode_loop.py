"""The decode loop as a step over device state, run uncaptured on the CPU.

On the card ``DecodeLoop`` replays K steps of ``decode._step`` as one CUDA
graph; on the CPU it runs the same step uncaptured, K steps between two host
checks of the loop's end. These tests run that plain version against the
JAX package's ``greedy_decode`` (its packed result, from
``greedy_decode_dispatch``) on the committed golden test-tiny weights at f32,
for every tier, with and without word-timestamp capture and a draft, at
K = 1, 3 (which divides no step count here) and 8:

- the token section of the packed result equals the reference's bit for bit,
  slots after EOT included (a step after the loop's end writes nothing, as
  the reference's ``while_loop`` takes no such step); the sum logprob within
  1e-4 of its size + 1e-3, the no-speech probability within 1e-4 and the
  uint8 capture within one level (f32 sums in another order, as
  tests/test_torch_decode.py, and the int8 tiers' logits within 1e-4 of
  their scale, as tests/test_torch_quant.py);
- the whole packed result is bit-equal across K;
- the host checks stay within ⌈(steps bound)/K⌉.

The golden transcripts reproduce through ``TorchWhisperASR`` at each K, and
steps past the bound are no-ops on every buffer.
"""

import ast
import inspect
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu.models.whisper import decode as JD
from realtime_whisper_asr_tpu.models.whisper import quant as JQ
from realtime_whisper_asr_tpu.ops import log_mel_spectrogram as jax_log_mel
from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper import config as C
from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
TIERS = {None: lambda t: t, "int8": JQ.quantize_decoder, "int8-all": JQ.quantize_all,
         "int4": JQ.quantize_decoder_int4, "int4-all": JQ.quantize_all_int4}
KS = (1, 3, 8)
MAX_NEW_TOKENS = 24  # cap 24 in the 48-step bucket


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


@pytest.fixture(scope="module")
def golden():
    """(JAX cfg, golden tree, encoder output of golden clip 0, cached
    results): xa from the JAX package's dense encoder, fed to both
    decoders."""
    cfg = W.get_config("test-tiny")
    tree = _golden_tree()
    mel = jax_log_mel(jnp.asarray(golden_audio(0)))[None]
    xa = np.array(W.encode(JQ.fuse_qkv(jax.tree.map(jnp.asarray, tree)), cfg, mel))
    return cfg, tree, xa, {}


def _models(golden, tier):
    cfg, tree, _, cache = golden
    if ("models", tier) not in cache:
        model = Whisper.empty(C.get_config("test-tiny"), torch.float32, "cpu", tier)
        model.load_state_dict(Q.quantize(load_flat_npz(os.path.join(GOLDEN, "params.npz")),
                                         tier))
        cache["models", tier] = (model, JQ.fuse_qkv(TIERS[tier](jax.tree.map(jnp.asarray,
                                                                            tree))))
    return cache["models", tier]


def _opts(capture: bool):
    kw = dict(timestamps=True, word_timestamps=capture, max_new_tokens=MAX_NEW_TOKENS)
    return JD.DecodeOptions(**kw), D.DecodeOptions(**kw)


def _jax_packed(golden, tier, capture, prefix=None, draft=None) -> np.ndarray:
    cfg, _, xa, cache = golden
    key = ("jax", tier, capture, tuple(prefix or ()), tuple(draft or ()))
    if key not in cache:
        jparams = _models(golden, tier)[1]
        handle = JD.greedy_decode_dispatch(jparams, cfg, jnp.asarray(xa), _opts(capture)[0],
                                           prefix_tokens=prefix, draft_tokens=draft)
        cache[key] = np.asarray(handle["packed"])
    return cache[key]


def _port_packed(golden, tier, capture, k, prefix=None, draft=None):
    """The port's packed result through the uncaptured loop at K = k, and
    its DecodeLoop."""
    model = _models(golden, tier)[0]
    opts = _opts(capture)[1]
    plan = D.plan_window(model.cfg, opts, None, prefix, draft)
    loop = D.DecodeLoop(k=k)
    xa = torch.from_numpy(golden[2])
    packed = D._decode_window(model, opts, xa, torch.from_numpy(plan.aux)[None], plan, (),
                              None, loop, captured=False)
    return packed.numpy(), plan, loop


def _draft_case(golden, tier, capture):
    """(prefix, draft): the first 3 tokens of the reference's plain decode,
    then its next 5 tokens and a garbage tail, so the verify accepts part of
    the draft and the loop goes on past it."""
    cfg = golden[0]
    packed = _jax_packed(golden, tier, capture)
    plan = D.plan_window(C.get_config("test-tiny"), _opts(capture)[1])
    ids = [int(t) for t in packed.reshape(1, -1)[0, : plan.max_new]]
    assert cfg.eot not in ids[:8], ids
    return ids[:3], ids[3:8] + [5, 7, 11]


def _split(packed: np.ndarray, max_new: int):
    row = packed.reshape(1, -1)[0]
    return row[:max_new], row[max_new], row[max_new + 1], row[max_new + 2 :]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("draft", [False, True], ids=["no_draft", "draft"])
@pytest.mark.parametrize("capture", [False, True], ids=["no_xattn", "xattn"])
@pytest.mark.parametrize("tier", list(TIERS), ids=lambda t: t or "dense")
def test_step_loop_equals_jax_greedy_decode(golden, tier, capture, draft, k):
    prefix, drafted = _draft_case(golden, tier, capture) if draft else (None, None)
    ours, plan, loop = _port_packed(golden, tier, capture, k, prefix, drafted)
    ref = _jax_packed(golden, tier, capture, prefix, drafted)
    assert ours.shape == ref.shape
    tok, lp, nsp, xq = _split(ours, plan.max_new)
    rtok, rlp, rnsp, rxq = _split(ref, plan.max_new)
    np.testing.assert_array_equal(tok, rtok)
    assert abs(float(lp) - float(rlp)) <= 1e-4 * abs(float(rlp)) + 1e-3
    assert abs(float(nsp) - float(rnsp)) < 1e-4
    levels = np.abs(xq.view(np.uint8).astype(int) - rxq.view(np.uint8).astype(int))
    assert levels.max(initial=0) <= 1
    bound = min(int(plan.aux[D.AUX_TOK + 4]), plan.max_new) - 1
    assert 1 <= loop.stats["checks"] <= math.ceil(bound / k)
    assert loop.stats["captures"] == loop.stats["replays"] == 0
    base, _, _ = _port_packed(golden, tier, capture, 1, prefix, drafted)
    np.testing.assert_array_equal(ours.view(np.uint32), base.view(np.uint32))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("tier,row", [(None, None), ("int8-all", "int8all"), ("int4", "int4")],
                         ids=["dense", "int8all", "int4"])
def test_golden_rows_reproduce_at_every_k(tier, row, k):
    """Offline tokens of golden clip 0 (dense) and the quantized matrix rows
    through ``TorchWhisperASR`` on the CPU, its loop at K = k."""
    with open(os.path.join(GOLDEN, "transcripts.json")) as f:
        recorded = json.load(f)
    asr = TorchWhisperASR(cfg=C.get_config("test-tiny"), dtype=torch.float32, device="cpu",
                          params=load_flat_npz(os.path.join(GOLDEN, "params.npz")),
                          quantization=tier)
    asr.decode_loop = D.DecodeLoop(k=k)
    asr.transcribe_kargs["max_total_tokens"] = 24  # random weights never emit EOT
    res = asr.transcribe(golden_audio(0))
    if row is None:
        clip = next(c for c in recorded["clips"] if c["idx"] == 0)
        assert res.tokens == clip["offline_tokens"]
    else:
        got = {"tokens": [int(t) for t in res.tokens],
               "text": "".join(s.text for s in res).strip()}
        assert got == recorded["matrix"][row]
    assert asr.decode_loop.stats["eager_steps"] > 0


def _snapshot(st: D.LoopState) -> dict:
    out = {f"cache.{name}": getattr(st.cache, name).clone()
           for name in ("self_k", "self_v", "cross_k", "cross_v")}
    for name in ("tokens", "xattn", "finished", "sum_lp", "last_ts", "pos", "total",
                 "max_total", "n_prefix"):
        out[name] = getattr(st, name).clone()
    return out


@pytest.mark.parametrize("where", ["at_the_cap", "past_the_cache", "all_finished"])
def test_steps_past_the_bound_change_nothing(golden, where):
    """A window decoded to its cap fills tokens to p + max_new; then steps
    at the cap, with ``pos`` past the self cache's end, or with every row
    finished before the cap, leave every buffer as it was, and index
    nothing out of range (an out-of-range index raises on the CPU)."""
    model = _models(golden, None)[0]
    prefix, drafted = _draft_case(golden, None, True)
    opts = D.DecodeOptions(timestamps=True, word_timestamps=True, max_new_tokens=16)
    plan = D.plan_window(model.cfg, opts, None, prefix, drafted)
    p, max_new = len(plan.init), plan.max_new
    loop = D.DecodeLoop(k=4)
    sup_mask = D._sup_mask_dev(model.cfg, (), torch.device("cpu"))
    amask = D._amask_dev(model.cfg, None, torch.device("cpu"))
    key = D.LoopKey(id(model), golden[2].shape[1], p, max_new, 128, plan.draft_max, 1, opts,
                    (), None)
    run = loop.loop(model, key, torch.float32, torch.device("cpu"), sup_mask, amask,
                    captured=False)
    st = run.state
    with torch.inference_mode():
        D._prefill(model, opts, torch.from_numpy(golden[2]), torch.from_numpy(plan.aux)[None],
                   sup_mask, amask, st, p, plan.draft_max)
        loop.run(run, max_new - 1)
        assert int(st.pos) == p + max_new == int(st.max_total)  # the buffers are full
        assert not bool(st.finished.any())
        if where == "past_the_cache":
            st.pos.fill_(key.cache_len + 3)
        elif where == "all_finished":
            st.pos.fill_(p + 5)
            st.finished.fill_(True)
        before = _snapshot(st)
        for _ in range(5):
            D._step(model, opts, st, sup_mask, amask, p)
    after = _snapshot(st)
    for name, value in before.items():
        assert torch.equal(after[name], value), name


_NO_HOST_READS = ("_step", "_advance", "_keep", "_prefill", "_select_next", "_pack")


def test_the_loop_reads_the_device_once_per_k_steps():
    """Between the prefill and the end of the loop the only host read is
    ``DecodeLoop.run``'s one check per K steps; nothing in decode.py falls
    back from the graph path."""
    tree = ast.parse(inspect.getsource(D))
    funcs = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}

    def reads(node):
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                f = n.func
                if isinstance(f, ast.Attribute) and f.attr in ("item", "tolist", "cpu", "numpy"):
                    yield f.attr
                if (isinstance(f, ast.Name) and f.id in ("bool", "int", "float")
                        and not isinstance(n.args[0], ast.Constant)):
                    yield f.id

    for name in _NO_HOST_READS:
        assert not list(reads(funcs[name])), name
    assert list(reads(funcs["run"])) == ["bool"]
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_asr_has_no_switch_to_an_uncaptured_loop():
    params = inspect.signature(TorchWhisperASR.__init__).parameters
    assert not [p for p in params if "graph" in p or "eager" in p or "loop" in p]
    asr = TorchWhisperASR(cfg=C.get_config("test-tiny"), dtype=torch.float32, device="cpu")
    assert isinstance(asr.decode_loop, D.DecodeLoop)
    assert asr.decode_loop.k == D.STEPS_PER_GRAPH
