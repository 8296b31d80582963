"""The port's batched multi-stream tick (``TorchWhisperASR.transcribe_batch``)
against the JAX package's, on the CPU.

Both ASRs hold the committed golden test-tiny weights at f32 (the JAX one
built by ``tools/golden.py``'s ``build_asr``).

- ``transcribe_batch`` of 3 streams (padded to 4 by repeating the last) at
  different states (none, a prompt, a forced prefix and a draft): each
  row's segment texts, times and tokens equal the JAX package's, over
  three ticks whose uploads are full, grow and shift; and each row's tokens
  equal the port's own ``transcribe`` of that stream alone where its
  bucket is the group's.
- The rings after each tick equal the JAX package's buffers bit for bit,
  the repeated pad row's plan being a ``shift`` in the third tick (its
  stream's ring is shifted once, not twice). Byte counts differ by design:
  the JAX package pads its copy to a power of two.
- One item goes through ``transcribe``; with ``beam_size`` > 1 every row is
  a beam search, equal to its stream's own.
"""

import os
import sys

import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.convert import load_flat_npz
from realtime_whisper_asr_tpu_torch.models.whisper.model import encoder_flops

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden")
SR = 16000


def golden_audio(idx: int, seconds: float = 8.0) -> np.ndarray:
    """tools/golden.py's deterministic synthetic clips."""
    rng = np.random.default_rng(1000 + idx)
    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(110, 200) + 30 * np.sin(2 * np.pi * rng.uniform(0.3, 0.9) * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t))
    out = sig * env + 0.02 * rng.standard_normal(t.shape)
    return (0.4 * out / np.max(np.abs(out))).astype(np.float32)


@pytest.fixture(scope="module")
def asrs():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import golden as G

    ours = TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cpu",
                           params=load_flat_npz(os.path.join(GOLDEN, "params.npz")))
    ours.transcribe_kargs["max_total_tokens"] = 24  # as build_asr: random weights never EOT
    return ours, G.build_asr()


CLIPS = [golden_audio(i, 12.0) for i in range(3)]
#: (start, end) seconds of each stream's buffer at ticks 1-3: 0-2 s (full),
#: 0-3 s (grow), then 1-5 s, 0-4 s, 1-4.5 s (the last a shift, repeated as
#: the pad row)
WINDOWS = [[(0, 2), (0, 2), (0, 2)], [(0, 3), (0, 3), (0, 3)], [(1, 5), (0, 4), (1, 4.5)]]


def _items(tick: int, prev=None) -> list[dict]:
    items = []
    for i, (t0, t1) in enumerate(WINDOWS[tick]):
        it = {"key": f"s{i}", "audio": CLIPS[i][int(t0 * SR) : int(t1 * SR)]}
        if i == 1:
            it["init_prompt"] = "hello there"
        if i == 2 and prev is not None:  # the previous tick's tokens: prefix + draft
            it["prefix_ids"], it["draft_ids"] = prev[2].tokens[:3], prev[2].tokens[3:9]
        items.append(it)
    return items


def _rows(results):
    return [([(round(s.start, 3), round(s.end, 3), s.text) for s in r], list(r.tokens))
            for r in results]


def test_transcribe_batch_and_rings_equal_jax(asrs):
    ours, ref = asrs
    prev = None
    kinds = []
    plan_upload = ours._plan_upload

    def recording(key, audio):
        plan = plan_upload(key, audio)
        kinds.append((key, plan["kind"]))
        return plan

    ours._plan_upload = recording
    try:
        for tick in range(3):
            kinds.clear()
            items = _items(tick, prev)
            got = ours.transcribe_batch(items)
            want = ref.transcribe_batch(items)
            assert len(got) == 3
            assert _rows(got) == _rows(want), tick
            for key in ("s0", "s1", "s2"):
                ring, mirror = ours._buffers[key]
                jring, jmirror = ref._buffers[key]
                np.testing.assert_array_equal(ring.numpy(), np.asarray(jring))
                np.testing.assert_array_equal(mirror, jmirror)
            prev = got
            assert kinds[3] == kinds[2]  # the pad row repeats the last
            assert [k for _, k in kinds] == {0: ["full"] * 4, 1: ["grow"] * 4,
                                             2: ["shift", "grow", "shift", "shift"]}[tick]
    finally:
        del ours._plan_upload


def test_batch_rows_equal_transcribe_of_one_stream(asrs):
    """Where a row's own prefill bucket is the group's, the batch decodes it
    as ``transcribe`` of that stream alone (here: a short prompt in every
    row, so every row's bucket is the same)."""
    from realtime_whisper_asr_tpu_torch.models.whisper import decode as D

    ours, _ = asrs
    prompts = ["hello there", "one two", "good morning"]
    items = [{"key": f"b{i}", "audio": CLIPS[i][: (2 + i) * SR], "init_prompt": prompts[i]}
             for i in range(3)]
    opts = ours._make_opts()
    assert len({D.plan_window(ours.cfg, opts, ours.tokenizer.encode(p)).p for p in prompts}) == 1
    batch = ours.transcribe_batch(items)
    for it, res in zip(items, batch):
        ours.set_active_stream(it["key"] + "-alone")
        alone = ours.transcribe(it["audio"], it["init_prompt"])
        assert list(res.tokens) == list(alone.tokens)
        assert [seg.text for seg in res] == [seg.text for seg in alone]


def test_counters_and_one_item(asrs, monkeypatch):
    """The counters of one padded batch grow as the JAX package's do over
    the same items: ticks and new tokens over the real rows, the encode's
    FLOPs over every row encoded, pad included (h2d bytes differ by design,
    see above)."""
    ours, ref = asrs
    before, ref_before = dict(ours.counters), dict(ref.counters)
    items = [{"key": f"c{i}", "audio": CLIPS[i][: 2 * SR]} for i in range(3)]
    ours.transcribe_batch(items)
    ref.transcribe_batch(items)
    for name in ("ticks", "new_tokens", "encode_flops", "h2d_transfers"):
        assert (ours.counters[name] - before.get(name, 0)
                == ref.counters[name] - ref_before.get(name, 0)), name
    assert ours.counters["ticks"] - before["ticks"] == 3  # the pad row is not counted
    assert ours.counters["h2d_transfers"] - before["h2d_transfers"] == 1
    assert (ours.counters["encode_flops"] - before["encode_flops"]
            == 4 * encoder_flops(ours.cfg, 8 * SR // 320))
    calls = []
    monkeypatch.setattr(ours, "transcribe", lambda *a, **k: calls.append(a) or "one")
    assert ours.transcribe_batch(items[:1]) == ["one"] and len(calls) == 1
    # beam_size 2: every row a beam search, each equal to its stream's own
    # (a prompt in every row, so each row's bucket is the group's)
    monkeypatch.setitem(ours.transcribe_kargs, "beam_size", 2)
    prompts = ["hello there", "one two", "good morning"]
    beam_items = [dict(it, key=f"beam{i}", init_prompt=prompts[i]) for i, it in enumerate(items)]
    st = ours.transcribe_batch_dispatch(beam_items)
    assert st["beam"]
    for it, res in zip(beam_items, ours.transcribe_batch_finalize(st)):
        ours.set_active_stream(it["key"] + "-alone")
        alone = TorchWhisperASR.transcribe(ours, it["audio"], it["init_prompt"])
        assert list(res.tokens) == list(alone.tokens)
        assert [seg.text for seg in res] == [seg.text for seg in alone]
