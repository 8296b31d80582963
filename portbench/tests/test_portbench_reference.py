"""The frozen f32 reference against the program at test-tiny: dense f32 and
``int8-all`` logits of one window and token block. Only this test imports
the program beside the reference."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import tiny_config
from portbench.core import speech
from portbench.core import weights as WT
from portbench.reference import whisper_ref as W

SEED = 2**31 + 5


def _program_logits(state, tier, audio_pad, tokens):
    from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper
    from realtime_whisper_asr_tpu_torch.ops.logmel import log_mel_spectrogram

    st = Q.quantize(dict(state), tier)
    model = Whisper.empty(get_config("test-tiny"), torch.float32, torch.device("cpu"),
                          Q.detect_quantization(st))
    model.load_state_dict(st)
    with torch.no_grad():
        mel = log_mel_spectrogram(torch.from_numpy(audio_pad), n_mels=80)
        xa = model.encode(mel[None])
        return model.decode_full(torch.tensor([tokens]), xa)[0]


#: dense f32: the two differ by summation order alone. int8-all: a per-row
#: activation quantization turns an input that differs in the last bits into
#: a neighbouring integer now and then, so the two drift apart by ~1 % of the
#: logits' spread through the encoder (the decoder alone agrees to 4e-7 given
#: one encoder output)
@pytest.mark.parametrize("tier,bits,tol", [(None, None, 2e-4), ("int8-all", 8, 0.02)])
def test_reference_logits_match_the_program(tier, bits, tol):
    cfg = tiny_config(quantization=tier, weight_bits=bits)
    cpu = torch.device("cpu")
    state = WT.make_state(cfg, SEED, cpu, torch.float32)
    stream = speech.make_stream(SEED, 0, speech.UtteranceMix(3.0, 0.3, 1.5, 6.0, 0.6, 1.0),
                                6.0, cpu)
    bucket = 8 * 16000
    pad = np.zeros(bucket, np.float32)
    pad[: len(stream.audio)] = W.pcm16(stream.audio)
    tokens = [50362, 220, 220, 220, 50258, 50259, 50360] + [50365, 400, 1000, 31, 50380]
    ref = W.window_logits(W.RefWeights(state, cfg, cpu, bits), stream.audio, bucket, tokens, cpu)
    got = _program_logits(state, tier, pad, tokens)
    assert ref.shape == got.shape == (len(tokens), cfg["vocab_size"])
    assert float((ref - got).abs().max()) <= tol
    # the program's choice at every position is the reference's, within tol
    chosen = ref.gather(1, got.argmax(-1)[:, None])[:, 0]
    assert float((ref.max(-1).values - chosen).max()) <= tol


def test_state_layout_is_the_programs():
    """The benchmark's weights load strictly into the program's model."""
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper

    cfg = tiny_config()
    state = WT.make_state(cfg, 3, torch.device("cpu"), torch.float32)
    model = Whisper.empty(get_config("test-tiny"), torch.float32, torch.device("cpu"))
    model.load_state_dict(state, strict=True)
    qkv_bias = state["decoder.blocks.0.attn.qkv.bias"]
    assert torch.count_nonzero(qkv_bias[64:128]) == 0 and torch.count_nonzero(qkv_bias[:64]) > 0


def test_same_seed_same_weights_on_the_device_given():
    cfg = tiny_config()
    a = WT.make_state(cfg, SEED, torch.device("cpu"), torch.float32)
    b = WT.make_state(cfg, SEED, torch.device("cpu"), torch.float32)
    c = WT.make_state(cfg, SEED + 1, torch.device("cpu"), torch.float32)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.tok_emb"], c["decoder.tok_emb"])

