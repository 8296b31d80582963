"""The port's batched decode against the JAX package's.

- ``build_initial_tokens(..., bucket=)`` equals the JAX function at several
  buckets, for prompts, prefixes and overflowing content.
- ``plan_batch_aux`` gives the JAX package's aux rows, prefill bucket ``p``,
  loop bound and cap bit for bit, for rows with no prefix, a forced prefix,
  a prompt and a draft.
- ``greedy_decode_batch`` on the committed golden test-tiny weights at f32,
  three rows at different streaming states (``tests/test_decode.py:421``'s
  rows; a group where every row has a draft; a mixed group, whose draft
  bucket is 0): tokens and lengths equal the JAX package's, no-speech
  probability within 1e-5, xattn shapes equal; and each row equals the
  port's own single-row ``greedy_decode`` of that row's plan (bucket ``p``).
  Dense, ``int8-all`` and ``int4`` (K2 is its plain version at M = B here).
  Both decoders read the same encoder output (the JAX package's, per tier).
"""

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
from realtime_whisper_asr_tpu_torch.models.whisper import config as C
from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
TIERS = {None: lambda t: t, "int8-all": JQ.quantize_all, "int4": JQ.quantize_decoder_int4}


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


def _opts(**kw):
    base = dict(timestamps=True, word_timestamps=True, max_new_tokens=16)
    base.update(kw)
    return JD.DecodeOptions(**base), D.DecodeOptions(**base)


JCFG, CFG = W.get_config("test-tiny"), C.get_config("test-tiny")


# ------------------------------------------------------------ the planning


CONTENT = {
    "empty": (None, None),
    "prompt": ([41, 42, 43], None),
    "prefix": (None, [50, 51, 52, 50365, 53]),
    "both": (list(range(100, 120)), [60, 61, 50370]),
    "overflow": (list(range(200, 400)), list(range(1000, 1200))),
}


@pytest.mark.parametrize("bucket", [None, 8, 16, 32, 128])
@pytest.mark.parametrize("content", CONTENT)
def test_build_initial_tokens_bucket_equals_jax(content, bucket):
    prompt, prefix = CONTENT[content]
    jopts, opts = _opts()
    ours = D.build_initial_tokens(CFG, opts, prompt, prefix, bucket=bucket)
    ref = JD.build_initial_tokens(JCFG, jopts, prompt, prefix, bucket=bucket)
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1:] == ref[1:]
    if bucket is not None:
        assert len(ours[0]) == bucket


PLAN_GROUPS = {
    "states": [{}, {"prefix_tokens": [50, 51, 50370, 52]}, {"prompt_tokens": [41, 42, 43]},
               {"prefix_tokens": [60, 61], "draft_tokens": [70, 71, 72]}],
    "long prompt": [{"prompt_tokens": list(range(100, 150))}, {}],
    "drafts": [{"draft_tokens": [5, 6]}, {"prefix_tokens": [9], "draft_tokens": [7]}],
}


@pytest.mark.parametrize("max_total", [None, 6])
@pytest.mark.parametrize("group", PLAN_GROUPS)
def test_plan_batch_aux_equals_jax(group, max_total):
    jopts, opts = _opts(max_total_tokens=max_total)
    requests = PLAN_GROUPS[group]
    plan = D.plan_batch_aux(CFG, opts, requests)
    rows, p, max_new, cap = JD.plan_batch_aux(JCFG, jopts, [dict(r, seed=0) for r in requests])
    assert (plan.p, plan.max_new, plan.cap) == (p, max_new, cap)
    np.testing.assert_array_equal(plan.aux, np.stack([r["aux"] for r in rows]))
    for ours, ref in zip(plan.rows, rows):
        np.testing.assert_array_equal(ours.init, ref["init"])
        np.testing.assert_array_equal(ours.prefix, ref["prefix_arr"])
        assert ours.p == p
    assert plan.draft_max == JD.batch_draft_bucket(rows)
    assert plan.draft_max == (D.DRAFT_MAX if group == "drafts" else 0)


# ------------------------------------------------------------ the decode


@pytest.fixture(scope="module")
def tiers():
    """Per tier: (port model, JAX params, (3, 400, d) JAX encoder output of
    golden clips 0-2 under that tier's weights)."""
    tree = _golden_tree()
    state = load_flat_npz(os.path.join(GOLDEN, "params.npz"))
    mel = jnp.stack([jax_log_mel(jnp.asarray(golden_audio(i))) for i in range(3)])
    out = {}
    for tier, fn in TIERS.items():
        jparams = JQ.fuse_qkv(fn(jax.tree.map(jnp.asarray, tree)))
        model = Whisper.empty(CFG, torch.float32, "cpu", tier)
        model.load_state_dict(Q.quantize(state, tier))
        out[tier] = (model, jparams, np.array(W.encode(jparams, JCFG, mel)))
    return out


def _ids(res):
    return res.tokens[0][: res.lengths[0]].tolist()


def _requests(jparams, xa, group):
    """Three rows at different streaming states, from the JAX package's
    plain decode of each clip (its tokens make the prefixes and drafts)."""
    jopts = _opts()[0]
    base = [_ids(JD.greedy_decode(jparams, JCFG, jnp.asarray(xa[i : i + 1]), jopts))
            for i in range(3)]
    if group == "states":  # tests/test_decode.py:421's rows
        return [{}, {"prefix_tokens": base[1][:6]}, {"prompt_tokens": [41, 42, 43]}]
    if group == "all drafts":
        return [{"prefix_tokens": base[i][:3], "draft_tokens": base[i][3:3 + 4 * (i + 1)]}
                for i in range(3)]
    return [{"prefix_tokens": base[0][:2], "draft_tokens": base[0][2:9]},  # mixed
            {"prompt_tokens": [41, 42]}, {"prefix_tokens": base[2][:4]}]


@pytest.mark.parametrize("group", ["states", "all drafts", "mixed"])
@pytest.mark.parametrize("tier", list(TIERS), ids=lambda t: t or "dense")
def test_batch_decode_equals_jax_and_per_row_decode(tiers, tier, group):
    model, jparams, xa = tiers[tier]
    jopts, opts = _opts()
    requests = _requests(jparams, xa, group)
    ref = JD.greedy_decode_batch(jparams, JCFG, jnp.asarray(xa), jopts,
                                 [dict(r, seed=0) for r in requests])
    xt = torch.from_numpy(xa)
    ours = D.greedy_decode_batch(model, xt, opts, requests)
    plan = D.plan_batch_aux(CFG, opts, requests)
    assert plan.draft_max == (D.DRAFT_MAX if group == "all drafts" else 0)
    assert len(ours) == len(ref) == 3
    for i, (o, r) in enumerate(zip(ours, ref)):
        assert _ids(o) == _ids(r), (i, _ids(o), _ids(r))
        assert int(o.lengths[0]) == int(r.lengths[0])
        assert abs(float(o.no_speech_prob[0]) - float(r.no_speech_prob[0])) <= 1e-5
        assert o.xattn.shape == r.xattn.shape
        # the row alone, decoded from its own plan at the group's bucket
        row = plan.rows[i]
        single = D.greedy_decode(model, xt[i : i + 1], opts, row, torch.from_numpy(row.aux))
        assert _ids(single) == _ids(o), (i, _ids(single), _ids(o))
        assert abs(float(single.no_speech_prob[0]) - float(o.no_speech_prob[0])) <= 1e-5
