"""The traffic generators: determinism from the seed, and the bounds of the
utterances and pauses."""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from portbench.core import speech

MIX = speech.UtteranceMix(6.0, 0.6, 1.5, 25.0, 0.6, 2.0, 16)
SEED = 2**31 + 987654321  # past 32 signed bits


def _spans(seed, stream=0, seconds=300.0):
    return speech.schedule(speech.stream_rng(seed, stream), MIX, seconds)


def test_same_seed_same_traffic():
    a = speech.make_stream(SEED, 1, MIX, 20.0, torch.device("cpu"))
    b = speech.make_stream(SEED, 1, MIX, 20.0, torch.device("cpu"))
    assert a.spans == b.spans
    assert np.array_equal(a.audio, b.audio)


def test_other_seed_or_stream_other_traffic():
    base = _spans(SEED)
    assert _spans(SEED + 1) != base
    assert _spans(SEED, stream=1) != base


@pytest.mark.parametrize("seed", [0, 7, SEED, 2**40 + 3])
def test_utterance_and_pause_bounds(seed):
    spans = _spans(seed, seconds=600.0)
    assert spans
    for start, end in spans[:-1]:  # the last may run into the stream's end
        assert 1.5 * 16000 - 1 <= end - start <= 25.0 * 16000 + 1
    gaps = [b0 - a1 for (_, a1), (b0, _) in zip(spans, spans[1:])]
    assert all(0.6 * 16000 - 1 <= g <= 2.0 * 16000 + 1 for g in gaps)
    assert 0.6 * 16000 - 1 <= spans[0][0] <= 2.0 * 16000 + 1


def test_every_seed_deals_the_same_lengths():
    """The lengths are fixed quantiles; seeds only reorder them."""
    def first_cycle(seed):
        spans = _spans(seed, seconds=10_000.0)[: MIX.strata]
        return collections.Counter(round((e - s) / 16000, 3) for s, e in spans)

    assert first_cycle(1) == first_cycle(2) == first_cycle(SEED)
    utts, pauses = MIX.lengths()
    assert min(utts) >= 1.5 and max(utts) <= 25.0
    assert abs(sorted(utts)[len(utts) // 2 - 1] * sorted(utts)[len(utts) // 2] - 36.0) < 1.0


def test_audio_is_speech_where_the_spans_say():
    s = speech.make_stream(SEED, 0, MIX, 30.0, torch.device("cpu"))
    mask = np.zeros(len(s.audio), bool)
    for a, b in s.spans:
        mask[a:b] = True
    assert np.sqrt(np.mean(s.audio[mask] ** 2)) > 50 * np.sqrt(np.mean(s.audio[~mask] ** 2))
    assert np.abs(s.audio).max() <= 1.0


def test_last_speech_of_packets():
    s = speech.Stream(np.zeros(48000, np.float32), [(10000, 20000), (30000, 31000)])
    assert s.last_speech(0, 8000) == -1
    assert s.last_speech(8000, 16000) == 16000
    assert s.last_speech(16000, 24000) == 20000
    assert s.last_speech(24000, 32000) == 31000


def test_a_longer_stream_only_appends():
    """The schedule and each utterance's voice come from their own
    generators, so a longer stream keeps the shorter one's audio."""
    short = speech.make_stream(SEED, 2, MIX, 20.0, torch.device("cpu"))
    long = speech.make_stream(SEED, 2, MIX, 45.0, torch.device("cpu"))
    assert long.spans[: len(short.spans) - 1] == short.spans[:-1]
    end = short.spans[-2][1]
    assert np.array_equal(long.audio[:end], short.audio[:end])
