"""The port's greedy decode against the JAX package's ``greedy_decode``.

Both decode the same encoder output (the JAX encoder's, from the committed
golden test-tiny weights, on a seeded synthetic clip) at f32 on the CPU with
word-timestamp capture on. Tokens must be equal; the captured
cross-attention, which travels uint8-quantized (x255), within 1.5/255; sum
logprobs within 1e-3. A token mismatch is reported with the top-2 logit
margin at the first divergent step (an argmax flip between two f32
implementations), never hidden by a tolerance.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from realtime_whisper_asr_tpu.models import whisper as W
from realtime_whisper_asr_tpu.models.whisper import decode as JD
from realtime_whisper_asr_tpu.models.whisper.quant import fuse_qkv
from realtime_whisper_asr_tpu_torch.models.whisper import config as C
from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper

torch.set_num_threads(2)

GOLDEN_NPZ = os.path.join(os.path.dirname(__file__), "fixtures", "golden", "params.npz")


@pytest.fixture(scope="module")
def setup():
    cfg = W.get_config("test-tiny")
    tree: dict = {}
    with np.load(GOLDEN_NPZ) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(data[key], jnp.float32)
    jparams = fuse_qkv(tree)
    model = Whisper.empty(C.get_config("test-tiny"), torch.float32, "cpu")
    model.load_state_dict(load_flat_npz(GOLDEN_NPZ))
    rng = np.random.default_rng(11)
    t = np.arange(4 * 16000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 300 * t) + 0.1 * rng.standard_normal(t.shape))
    from realtime_whisper_asr_tpu.ops import log_mel_spectrogram

    padded = np.zeros(8 * 16000, np.float32)
    padded[: len(audio)] = audio
    mel = log_mel_spectrogram(jnp.asarray(padded))[None]
    xa = np.array(W.encode(jparams, cfg, mel))
    return cfg, jparams, model, xa


def _opts(**kw):
    base = dict(timestamps=True, word_timestamps=True, max_new_tokens=24)
    base.update(kw)
    return JD.DecodeOptions(**base), D.DecodeOptions(**base)


def _ids(res):
    return res.tokens[0][: res.lengths[0]].tolist()


def _decode(model, xa, opts, prefix=None, draft=None):
    """The port's greedy decode of one window, planned as the ASR plans it."""
    plan = D.plan_window(model.cfg, opts, None, prefix, draft)
    return D.greedy_decode(model, torch.from_numpy(xa), opts, plan, torch.from_numpy(plan.aux))


def _divergence(model, cfg, xa, opts, prefix, ours, ref) -> str:
    """Top-2 logit margin of the port's model at the first step where the
    two token sequences differ (teacher-forced on the shared history)."""
    i = next(j for j, (a, b) in enumerate(zip(ours, ref)) if a != b)
    init, _, n_prefix = D.build_initial_tokens(cfg, opts, None, prefix)
    hist = list(init) + ref[n_prefix:i]
    with torch.inference_mode():
        cache = model.init_cache(torch.from_numpy(xa), text_ctx=448)
        logits, _ = model.decode_span(torch.tensor([hist]), 0, cache)
    top2 = torch.topk(logits[0, -1], 2).values
    return (f"first divergence at token {i}: port {ours[i]} vs jax {ref[i]}, "
            f"top-2 logit margin {float(top2[0] - top2[1]):.3g}")


def _both(setup, prefix=None, draft=None, **kw):
    cfg, jparams, model, xa = setup
    jopts, opts = _opts(**kw)
    ref = JD.greedy_decode(jparams, cfg, jnp.asarray(xa), jopts, prefix_tokens=prefix,
                           draft_tokens=draft)
    ours = _decode(model, xa, opts, prefix, draft)
    if _ids(ours) != _ids(ref):
        pytest.fail(_divergence(model, cfg, xa, opts, prefix, _ids(ours), _ids(ref)))
    np.testing.assert_allclose(ours.xattn[0][: len(_ids(ours))],
                               ref.xattn[0][: len(_ids(ref))], atol=1.5 / 255)
    assert abs(float(ours.sum_logprob[0]) - float(ref.sum_logprob[0])) < 1e-3
    assert abs(float(ours.no_speech_prob[0]) - float(ref.no_speech_prob[0])) < 1e-4
    return ours


def _base(setup):
    cfg, _, model, xa = setup
    return _ids(_decode(model, xa, _opts()[1]))


def test_tokens_equal_jax_without_prefix(setup):
    _both(setup)


def test_tokens_equal_jax_with_forced_prefix(setup):
    ids = _base(setup)
    _both(setup, prefix=ids[: len(ids) // 2])


def test_tokens_equal_jax_without_timestamps(setup):
    _both(setup, timestamps=False)


@pytest.mark.parametrize("draft_kind", ["true_tail", "garbage", "one_token", "whole"])
def test_draft_is_lossless_and_equals_jax(setup, draft_kind):
    """Self-speculative draft verified in the prefill pass: token-for-token
    the plain loop's result, for a true-tail draft, a garbage draft, a
    one-token draft, and (no prefix) the whole previous hypothesis."""
    cfg, _, model, xa = setup
    base = _base(setup)
    prefix = None if draft_kind == "whole" else base[:3]
    plain = _ids(_decode(model, xa, _opts()[1], prefix))
    draft = {"true_tail": plain[3:12], "garbage": [5, 7, 11, 13], "one_token": plain[3:4],
             "whole": base[:16]}[draft_kind]
    ours = _both(setup, prefix=prefix, draft=draft)
    assert _ids(ours) == plain


def test_single_text_prefix_keeps_timestamp_pairing(setup):
    """A one-token text prefix: history length at step 1 is 2, so the token
    before the first sample is text, not a timestamp (the hist2 rule)."""
    cfg = setup[0]
    ours = _ids(_both(setup, prefix=[100]))
    ts0 = cfg.timestamp_begin
    for i in range(1, len(ours) - 1):
        if ours[i] >= ts0 and ours[i - 1] < cfg.eot:
            assert ours[i + 1] >= ts0 or ours[i + 1] >= cfg.eot


def test_max_total_tokens_cap_is_exact(setup):
    ours = _both(setup, max_total_tokens=7)
    assert int(ours.lengths[0]) <= 8  # 7 sampled + the EOT fill


def test_packed_result_layout_roundtrip():
    """pack_aux places every scalar at the JAX package's offsets."""
    cfg = C.get_config("test-tiny")
    init, sot, n_prefix = D.build_initial_tokens(cfg, D.DecodeOptions(), [1, 2], [3, 4, 5])
    jinit, jsot, jn = JD.build_initial_tokens(W.get_config("test-tiny"), JD.DecodeOptions(),
                                              [1, 2], [3, 4, 5])
    np.testing.assert_array_equal(init, jinit)
    assert (sot, n_prefix) == (jsot, jn)
    ours = D.pack_aux(init, n_prefix, sot, 7, max_new_cap=9, draft=np.asarray([8, 9]))
    ref = JD.pack_aux(jinit, jn, jsot, 7, max_new_cap=9, draft=np.asarray([8, 9]))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(D.suppress_mask(cfg, (11, 12)),
                                  JD.suppress_mask(W.get_config("test-tiny"), (11, 12)))
