"""The system under test: the program's (``realtime_whisper_asr_tpu_torch``)
entry points that the benchmark builds.

- ``build_asr`` and ``loop_stats``: the program's Whisper ASR backend, with
  the weights that ``core/weights.py`` makes from the seed (the backend
  quantizes them to the configuration's tier), and its decode loop's
  counters. The Whisper family (``families/whisper.py``) calls them; another
  family brings its own build.
- ``build_one_stream``: the streaming processors, which take any backend with
  the port's ASR interface, whatever its family.

Besides this module, ``core/spans.py`` reads the program's ring of spans.
"""

from __future__ import annotations

import torch

from portbench.core import weights as WT

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: the configuration's keys that must equal the program's preset's sizes
_PRESET_KEYS = (("d_model", "n_audio_state"), ("d_model", "n_text_state"),
                ("encoder_layers", "n_audio_layer"), ("decoder_layers", "n_text_layer"),
                ("encoder_attention_heads", "n_audio_head"),
                ("decoder_attention_heads", "n_text_head"), ("num_mel_bins", "n_mels"),
                ("vocab_size", "n_vocab"), ("max_source_positions", "n_audio_ctx"),
                ("max_target_positions", "n_text_ctx"))


def build_asr(cfg: dict, seed: int, device):
    """The program's ASR backend for configuration ``cfg`` with the weights
    of ``seed``: the model preset ``cfg["model"]``, whose sizes must be the
    configuration's, in ``cfg["dtype"]`` at tier ``cfg["quantization"]``,
    with the configuration's caps."""
    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config

    preset = get_config(cfg["model"])
    for ours, theirs in _PRESET_KEYS:
        if int(cfg[ours]) != int(getattr(preset, theirs)):
            raise ValueError(f"configuration {cfg['name']}: {ours}={cfg[ours]} but the "
                             f"program's {cfg['model']} has {theirs}={getattr(preset, theirs)}")
    if cfg["encoder_ffn_dim"] != 4 * cfg["d_model"] or cfg["decoder_ffn_dim"] != 4 * cfg["d_model"]:
        raise ValueError("the program's blocks take an FFN of 4 x d_model")
    dtype = DTYPES[cfg["dtype"]]
    state = WT.make_state(cfg, seed, device, dtype)
    asr = TorchWhisperASR(model_size=cfg["model"], language=cfg.get("language", "en"),
                          params=state, dtype=dtype, device=device,
                          quantization=cfg.get("quantization"), seed=int(seed) & (2**31 - 1))
    del state
    caps = cfg["caps"]
    asr.transcribe_kargs["max_new_tokens"] = int(caps["max_new_tokens"])
    asr.transcribe_kargs["max_total_tokens"] = int(caps["max_total_tokens"])
    asr.max_tokens_per_second = float(caps["max_tokens_per_second"])
    return asr


def build_one_stream(asr, traffic: dict):
    """``VACOnlineASRProcessor`` over an async-pipelined
    ``OnlineASRProcessor`` with ``EnergyVAD``, as the mix states them."""
    from realtime_whisper_asr_tpu_torch.models.vad import EnergyVAD
    from realtime_whisper_asr_tpu_torch.streaming import (
        OnlineASRProcessor,
        VACOnlineASRProcessor,
        VADIterator,
    )

    online = OnlineASRProcessor(asr, buffer_trimming=("segment", float(traffic["trim_s"])),
                                prefix_policy=traffic["prefix_policy"],
                                pipeline=traffic["pipeline"])
    return VACOnlineASRProcessor(
        online, VADIterator(EnergyVAD(), min_silence_duration_ms=int(traffic["min_silence_ms"])),
        online_chunk_size=float(traffic["online_chunk_size"]))


def loop_stats(asr) -> dict:
    """The decode loop's counters (captures, replays, ...)."""
    return dict(asr.decode_loop.stats)

