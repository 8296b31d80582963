"""The encoder's CUDA graphs (``asr.EncodeGraphs``, ``TorchWhisperASR._encode_many``).

On the CPU the encode stays eager and captures nothing; with the capture
stubbed by an eager stand-in whose output, like a graph's, is one tensor
overwritten at every replay, the cache's bookkeeping runs here: a key
(rows, window bucket) captures once, a later encode of it replays, a new
bucket or row count captures anew, and a window's kept encoder output
survives the next window's encode.

On the card (skipped without one; no JAX is imported, so the file runs
there alone: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_encode_graph.py``) a replayed encode is bit-equal to the
eager log-mel and ``model.encode`` at the 8, 16 and 30 s buckets, at 1 and
3 rows, at ``int8-all`` and bf16 with large-v3's widths and 2 encoder
layers, over three windows through each key; K1's launch count advances by
the rows at every encode; and a dispatch's kept ``xa`` is unchanged after
the next dispatch's replay.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu_torch import asr as A
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper
from realtime_whisper_asr_tpu_torch.ops import logmel
from realtime_whisper_asr_tpu_torch.parallel.tp import TensorParallelWhisper

SR = 16000


def _audio(seconds: float, seed: int) -> np.ndarray:
    """A tone in noise, different for every seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = 0.3 * np.sin(2 * np.pi * (180.0 + 40.0 * seed) * t)
    return (tone + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def _eager(asr, keys, n_samples) -> torch.Tensor:
    """The eager encode of the rings' windows at the group's bucket."""
    nb = max(asr._window_bucket(n) for n in n_samples)
    with torch.inference_mode():
        return asr._encode_windows([asr._buffers[k][0][:nb] for k in keys])


def _encode(asr, keys, seconds: float, seed: int) -> tuple[torch.Tensor, list]:
    """Each key's ring filled with ``seconds`` of new audio, then one
    ``_encode_many`` of them -> (its output, the lengths)."""
    for i, k in enumerate(keys):
        asr.prefetch_audio(_audio(seconds, 10 * seed + i), key=k)
    n = [int(seconds * SR)] * len(keys)
    with torch.inference_mode():
        return asr._encode_many(keys, n), n


@pytest.fixture()
def tiny():
    asr = A.TorchWhisperASR(cfg=get_config("test-tiny"), dtype=torch.float32, device="cpu",
                            quantization="int8-all", seed=3)
    asr.transcribe_kargs["max_total_tokens"] = 16  # random weights never emit EOT
    return asr


def _stub_capture(calls: list):
    """An eager stand-in for ``EncodeGraphs._capture``: the first output is
    fresh, and every replay writes one tensor, as a graph's does."""
    def capture(self, inp, encode):
        calls.append(tuple(inp.shape))
        out = encode(inp).clone()

        def replay():
            out.copy_(encode(inp))
            return out

        return out.clone(), replay

    return capture


def test_the_cpu_encode_stays_eager(tiny):
    assert not tiny._encode_captured()
    tiny.set_active_stream("s")
    tiny.transcribe(_audio(3.0, 1))
    xa, n = _encode(tiny, ["s"], 5.0, 2)
    assert torch.equal(xa, _eager(tiny, ["s"], n))
    assert tiny.counters["encode_captures"] == tiny.counters["encode_replays"] == 0
    assert not tiny.encode_graphs._graphs


def test_a_key_captures_once_and_replays_after(tiny, monkeypatch):
    calls: list = []
    monkeypatch.setattr(A.EncodeGraphs, "_capture", _stub_capture(calls))
    monkeypatch.setattr(tiny, "_encode_captured", lambda: True)
    steps = [(["a"], 5.0), (["a"], 6.0), (["a"], 7.5),  # one key, three windows
             (["a"], 12.0),  # a new bucket
             (["a", "b"], 5.0),  # a new row count
             (["a", "b"], 4.0), (["a"], 20.0), (["a"], 3.0), (["a", "b"], 14.0)]
    want_calls = [(1, 8 * SR), (1, 16 * SR), (2, 8 * SR), (1, 30 * SR), (2, 16 * SR)]
    for i, (keys, seconds) in enumerate(steps):
        xa, n = _encode(tiny, keys, seconds, i)
        assert torch.equal(xa, _eager(tiny, keys, n)), (keys, seconds)
    assert calls == want_calls
    assert tiny.counters["encode_captures"] == len(want_calls)
    assert tiny.counters["encode_replays"] == len(steps) - len(want_calls)
    assert len(tiny.encode_graphs._graphs) == len(want_calls)


def test_a_kept_xa_survives_the_next_encode(tiny, monkeypatch):
    """The dispatch's ``xa`` (the quality retry reads it in the finalize,
    after the next dispatch has encoded) is a copy of the graph's output."""
    monkeypatch.setattr(A.EncodeGraphs, "_capture", _stub_capture([]))
    monkeypatch.setattr(tiny, "_encode_captured", lambda: True)
    kept = []
    for i in range(3):
        audio = _audio(4.0, 20 + i)
        st = tiny.transcribe_dispatch(audio, key="s")
        kept.append((st, _eager(tiny, ["s"], [len(audio)])))
    for st, want in kept:
        assert torch.equal(st["xa"], want)
        tiny.transcribe_finalize(st)
    assert tiny.counters["encode_captures"] == 1 and tiny.counters["encode_replays"] == 2


@pytest.mark.parametrize("case", ["card", "separation", "tensor-parallel", "cpu"])
def test_which_encodes_replay_a_graph(tiny, case):
    """The card's encode replays, except under the separation frontend and
    for a subclass of ``Whisper`` (the tensor-parallel model)."""
    model = tiny.model if case != "tensor-parallel" else object.__new__(TensorParallelWhisper)
    fake = types.SimpleNamespace(
        device=torch.device("cpu" if case == "cpu" else "cuda"), model=model,
        _sep_frontend=("net", ((1,),)) if case == "separation" else None)
    assert type(tiny.model) is Whisper
    assert A.TorchWhisperASR._encode_captured(fake) == (case == "card")


# ---- on the card

def _card_asr(quantization):
    if not torch.cuda.is_available():
        pytest.skip("no card: the encode's CUDA graphs run on the card only")
    cfg = dataclasses.replace(get_config("large-v3"), n_audio_layer=2, n_text_layer=2)
    asr = A.TorchWhisperASR(cfg=cfg, dtype=torch.bfloat16, device="cuda",
                            quantization=quantization, seed=5)
    asr.transcribe_kargs["max_total_tokens"] = 16
    return asr


@pytest.mark.parametrize("quantization", ["int8-all", None], ids=["int8-all", "bf16"])
def test_a_replayed_encode_is_bit_equal_to_the_eager_one_on_the_card(quantization):
    asr = _card_asr(quantization)
    assert asr._encode_captured()
    keys = ["a", "b", "c"]
    outputs = []
    for rows in (1, 3):
        for seconds in (6.0, 12.0, 25.0):  # the 8, 16 and 30 s buckets
            for rep in range(3):  # the capture's eager run, then two replays
                before = logmel.logmel_launches
                xa, n = _encode(asr, keys[:rows], seconds - rep, int(100 * rows + seconds) + rep)
                assert logmel.logmel_launches - before == rows
                got = xa.clone()
                assert torch.equal(got, _eager(asr, keys[:rows], n)), (rows, seconds, rep)
                outputs.append(got)
    torch.cuda.synchronize()
    assert asr.counters["encode_captures"] == 6 and asr.counters["encode_replays"] == 12
    assert len({o.float().sum().item() for o in outputs}) == len(outputs)  # all different


def test_a_dispatchs_kept_xa_survives_the_next_replay_on_the_card():
    asr = _card_asr("int8-all")
    for i in range(2):  # the capture, then a replay, before the windows kept
        asr.transcribe_finalize(asr.transcribe_dispatch(_audio(5.0, 40 + i), key="s"))
    kept = []
    for i in range(3):  # async: each dispatch before the previous finalize
        audio = _audio(5.0 + 0.5 * i, 50 + i)
        st = asr.transcribe_dispatch(audio, key="s")
        kept.append((st, _eager(asr, ["s"], [len(audio)])))
    for st, want in kept:
        assert torch.equal(st["xa"], want)
        asr.transcribe_finalize(st)
    assert asr.counters["encode_captures"] == 1 and asr.counters["encode_replays"] == 4
