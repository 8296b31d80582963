"""ConfigManager: JSON config with defaults-merge, validation, dotted paths,
and three-level precedence (language-specific > file > DEFAULT_CONFIG).

Parity with the reference config system (`config_manager.py:13-281`,
`config.json`): recursive default-merge (:94-132), range-clamping validation
with warnings (:134-182), dotted get/set (:184-226), and
``get_language_specific_config`` merging ``language_specific.<lang>`` blocks
over the base config (:252-281). The shipped per-language blocks cover the
same 18 languages the reference tunes.
"""

from __future__ import annotations

import copy
import json
import logging
import os
from typing import Any, Optional

logger = logging.getLogger(__name__)

DEFAULT_CONFIG: dict[str, Any] = {
    "model": {
        "size": "base",
        "checkpoint_dir": None,
        "dtype": "bfloat16",
        "quantization": None,  # None | "int8" (decoder weight-only)
        "beam_size": 1,
        "word_timestamps": True,
        # anti-hallucination guard: cap each window's transcript at
        # 8 + rate x window_seconds tokens (real speech ~3-4 tokens/s);
        # None disables. See asr.TorchWhisperASR.max_tokens_per_second.
        "max_tokens_per_second": None,
    },
    "streaming": {
        "agreement_n": 2,
        "prefix_policy": "agree2",  # agree2 | last (SimulStreaming-style)
        "buffer_trimming_way": "segment",  # segment | sentence
        "buffer_trimming_sec": 15.0,
        "dynamic_buffer": False,
        "prompt_chars": 300,
        "online_chunk_size": 0.5,
        "min_chunk_seconds": 1.0,
        # software-pipelined ticks (dispatch N, finalize N-1; token-exact —
        # online.py): null = RWA_PIPELINE env decides (default off). Right for
        # back-to-back feeds (files, catch-up); a paced mic keeps sync ticks
        # for per-chunk latency.
        "pipeline": None,
    },
    "vad": {
        "enable": True,
        "backend": "silero_like",  # silero_like (trained, default) | energy
        "threshold": 0.5,
        "min_silence_duration_ms": 500,
        "speech_pad_ms": 100,
    },
    "skip_detector": {
        "enable": True,
        "similarity_threshold": 0.85,
        "time_window_s": 10.0,
        "min_length": 2,
        "containment_threshold": 0.8,
    },
    "audio_deduplication": {
        # relative-similarity thresholds: exact repeats (stuck mic buffers)
        # score 1.0, distinct speech chunks <=~0.85 (see ops.features)
        "enable": True,
        "similarity_threshold": 0.98,
        "duplicate_threshold": 0.995,
        "time_window_s": 5.0,
        "history_size": 100,
    },
    "vocal_separation": {
        "enable": False,
        "method": "filter",  # filter | neural | demucs | none
        "low_hz": 85.0,
        "high_hz": 3400.0,
        # filter/neural: run the separation network on the accelerator (True)
        # or on host BLAS (False — wins on tunneled backends where every
        # device round-trip pays ~30 ms)
        "use_device": True,
        # neural: fuse the mask net into the jitted logmel+encode program
        # (separation as an encode prologue on the decode window — zero host
        # cost, zero extra transfers). False restores the reference's
        # separate-before-everything chunk ordering (host VAD/dedup then see
        # separated audio). Ignored for non-neural methods.
        "fuse_encode": True,
        # neural: packaged model variant — default (quality, +13.5 dB held-out)
        # | small/fast (~2.6x fewer MACs, the degraded-CPU / many-stream pick);
        # reference parity with the Demucs model family + VRAM-based pick
        # (vocal_separation.py:98-129, 一键实时识别麦克风.py:766-883)
        "variant": "default",
    },
    "speech_rate_adaptive": {
        "enable": True,
        "initial_silence_ms": 500,
        "min_silence_ms": 200,
        "max_silence_ms": 1000,
        "step_ms": 100,
        "update_interval_s": 2.0,
        "slow_cps": 5.0,
        "fast_cps": 15.0,
    },
    "asr_optimization": {
        "time_stretch_enable": False,
        "adaptive_params_enable": False,
        "normal_cps": 10.0,
    },
    "translation": {
        "enable": False,
        "interval_s": 10.0,
        "target_language": "zh",
    },
    "language_detection": {
        # auto-language streaming: re-detect at utterance boundaries and
        # hot-swap via app.change_language (reference rebuilds the processor
        # on manual language change, 一键…py:2194-2347; this automates it)
        "enable": False,
        "min_prob": 0.5,
        "consecutive": 2,  # switch only after N agreeing detections
        "min_audio_s": 1.0,  # skip detection on very short utterances
        "max_audio_s": 8.0,  # detect on at most the last N seconds
    },
    "diarization": {
        # streaming speaker-turn hooks: embed each finished utterance (VAC
        # voice→nonvoice boundary) and track speakers online; framework
        # extension beyond the reference (docs/ROADMAP.md)
        "enable": False,
        "threshold": None,  # None = the trained EER threshold shipped with the weights
        "max_speakers": 8,
        "min_audio_s": 0.6,  # skip embedding on very short utterances
        "max_audio_s": 10.0,
        "label_results": True,  # prefix recognized text with [S<n>]
    },
    "logging": {
        "enable": False,
        "dir": "logs",
        "console_log_enabled": False,
    },
    "performance": {
        "monitor_enable": True,
        "display_interval_s": 5.0,
        "hard_ratio": 0.4,
        "soft_ratio": 0.6,
    },
    "fallback": {
        # the JAX package's degraded mode (a smaller model on the CPU when no
        # accelerator is found at startup). The port's StreamingApp has no
        # such mode and ignores this key: it takes ``device`` instead and
        # raises without CUDA unless asked for the CPU
        "auto_downgrade": True,
    },
    "language_specific": {},  # filled from _LANGUAGE_TABLE below
}

# Per-language tuning table covering the reference's 18 languages
# (config.json:110-727 tunes skip_detector / speech_rate_adaptive /
# asr_optimization per language; this maps the same dimensions onto this
# schema's sections, with values derived from script + prosody families
# rather than copied):
#
# - sim / min_len (skip_detector): logographic & unspaced scripts (zh/ja,
#   and th which writes without word spaces) carry meaning in 1-2 chars and
#   real repeats are near-identical strings → tighter similarity, short
#   min_length. Alphabet scripts need ~4+ chars before a "duplicate" verdict
#   is meaningful and inflect heavily → looser similarity.
# - agree_n (streaming): scripts without whitespace word boundaries (CJK,
#   th) plus abjads/abugidas with unstable romanization-era tokenizations
#   (ar/hi) destabilize LocalAgreement-2 word matching → require 3-way
#   agreement before commit (reference ships agreement_n=3 for the same set).
# - cps bands (speech_rate_adaptive): chars/sec of COMMITTED TEXT, so the
#   band depends on script density — a zh char ≈ a syllable (normal speech
#   ~5-6 chars/s) while Latin text runs ~12-15 chars/s incl. spaces; slavic/
#   germanic words are longer but speech is slower, landing lower than es/it.
# - silence (vad.min_silence_duration_ms + adaptive band): syllable-timed
#   fast-turnaround languages (zh/ko/es/it) tolerate shorter utterance-final
#   silences; stress-timed languages with long phrase-final lengthening
#   (fr/de/ru/nl/pl) get a longer floor so mid-sentence pauses don't split
#   utterances.
#
# Columns: (sim, min_len, agree_n, slow_cps, fast_cps, min_sil_ms,
#           max_sil_ms, vad_min_sil_ms, vad_threshold)
_LANGUAGE_TABLE: dict[str, tuple] = {
    # CJK / unspaced scripts — dense chars, 3-way agreement, short silences
    "zh": (0.90, 2, 3, 2.5, 8.0, 300, 1000, 400, 0.6),
    "ja": (0.90, 2, 3, 3.0, 9.0, 350, 1100, 450, 0.55),
    "ko": (0.88, 2, 3, 3.0, 9.0, 350, 1100, 450, 0.55),
    "th": (0.88, 2, 3, 3.5, 10.0, 400, 1200, 500, 0.55),
    # abjad / abugida — medium-density scripts, less stable word splits
    "ar": (0.86, 3, 3, 4.0, 11.0, 400, 1300, 500, 0.55),
    "hi": (0.86, 3, 3, 4.0, 11.0, 400, 1300, 500, 0.55),
    # vi: Latin script but syllable-per-word with tone marks — short units
    "vi": (0.86, 3, 3, 4.5, 12.0, 400, 1200, 500, 0.5),
    # romance — fast syllable rate, fairly short pauses
    "en": (0.82, 4, 2, 5.0, 15.0, 400, 1400, 500, 0.5),
    "es": (0.82, 4, 2, 5.5, 16.0, 350, 1300, 450, 0.5),
    "it": (0.82, 4, 2, 5.5, 16.0, 350, 1300, 450, 0.5),
    "pt": (0.82, 4, 2, 5.0, 15.0, 400, 1400, 500, 0.5),
    "id": (0.82, 4, 2, 5.0, 14.0, 400, 1400, 500, 0.5),
    "tr": (0.82, 4, 2, 4.5, 14.0, 400, 1400, 500, 0.5),
    # stress-timed germanic/slavic + fr — longer words, longer pauses
    "fr": (0.82, 4, 2, 4.5, 13.0, 450, 1600, 550, 0.5),
    "de": (0.82, 5, 2, 4.5, 13.0, 450, 1600, 550, 0.5),
    "nl": (0.82, 4, 2, 4.5, 13.0, 450, 1600, 550, 0.5),
    "ru": (0.82, 4, 2, 4.0, 13.0, 450, 1600, 550, 0.5),
    "pl": (0.82, 4, 2, 4.0, 13.0, 450, 1600, 550, 0.5),
}

for _lang, (_sim, _mlen, _an, _scps, _fcps, _mns, _mxs, _vms, _vth) in (
    _LANGUAGE_TABLE.items()
):
    DEFAULT_CONFIG["language_specific"][_lang] = {
        "skip_detector": {"similarity_threshold": _sim, "min_length": _mlen},
        "streaming": {"agreement_n": _an},
        "speech_rate_adaptive": {
            "slow_cps": _scps, "fast_cps": _fcps,
            "min_silence_ms": _mns, "max_silence_ms": _mxs,
            "initial_silence_ms": _vms,
        },
        "vad": {"threshold": _vth, "min_silence_duration_ms": _vms},
    }

# validation ranges: dotted path -> (min, max)
_VALIDATION: dict[str, tuple[float, float]] = {
    "streaming.agreement_n": (2, 6),
    "streaming.buffer_trimming_sec": (3.0, 60.0),
    "streaming.prompt_chars": (0, 1000),
    "vad.threshold": (0.05, 0.95),
    "vad.min_silence_duration_ms": (50, 5000),
    "vad.speech_pad_ms": (0, 1000),
    "skip_detector.similarity_threshold": (0.5, 1.0),
    "skip_detector.time_window_s": (1.0, 120.0),
    "audio_deduplication.similarity_threshold": (0.5, 1.0),
    "audio_deduplication.duplicate_threshold": (0.5, 1.0),
    "speech_rate_adaptive.min_silence_ms": (50, 2000),
    "speech_rate_adaptive.max_silence_ms": (100, 5000),
    "translation.interval_s": (1.0, 120.0),
    "language_detection.min_prob": (0.0, 1.0),
    "language_detection.consecutive": (1, 10),
    "diarization.max_speakers": (1, 64),
    "diarization.min_audio_s": (0.1, 10.0),
    "model.beam_size": (1, 10),
}


def _deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class ConfigManager:
    def __init__(self, config_path: str = "config.json", autoload: bool = True):
        self.config_path = config_path
        self.config = copy.deepcopy(DEFAULT_CONFIG)
        if autoload:
            self.load_config()

    # ------------------------------------------------------------------ io

    def load_config(self) -> dict:
        if os.path.exists(self.config_path):
            try:
                with open(self.config_path, encoding="utf-8") as f:
                    user = json.load(f)
                user = {k: v for k, v in user.items() if not k.startswith("_comment")}
                self.config = _deep_merge(DEFAULT_CONFIG, user)
                logger.info("loaded config from %s", self.config_path)
            except (json.JSONDecodeError, OSError) as e:
                logger.warning("failed to load %s (%s); using defaults", self.config_path, e)
                self.config = copy.deepcopy(DEFAULT_CONFIG)
        self._validate()
        return self.config

    def save_config(self) -> bool:
        try:
            with open(self.config_path, "w", encoding="utf-8") as f:
                json.dump(self.config, f, ensure_ascii=False, indent=2)
            return True
        except OSError as e:
            logger.warning("failed to save config: %s", e)
            return False

    # -------------------------------------------------------------- validation

    def _validate(self):
        for path, (lo, hi) in _VALIDATION.items():
            val = self.get(path)
            if val is None or not isinstance(val, (int, float)):
                continue
            if val < lo or val > hi:
                clamped = min(max(val, lo), hi)
                logger.warning("config %s=%r out of [%s, %s]; clamped to %r",
                               path, val, lo, hi, clamped)
                self.set(path, clamped)
        # cross-field sanity
        mn = self.get("speech_rate_adaptive.min_silence_ms")
        mx = self.get("speech_rate_adaptive.max_silence_ms")
        if mn is not None and mx is not None and mn > mx:
            logger.warning("min_silence_ms > max_silence_ms; swapping")
            self.set("speech_rate_adaptive.min_silence_ms", mx)
            self.set("speech_rate_adaptive.max_silence_ms", mn)

    # ------------------------------------------------------------ dotted paths

    def get(self, path: str, default: Any = None) -> Any:
        node = self.config
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self.config
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    # --------------------------------------------------------- language merge

    def get_language_specific_config(self, language: str) -> dict:
        """base config with language_specific.<lang> merged on top."""
        overrides = self.get(f"language_specific.{language}", {}) or {}
        merged = _deep_merge(self.config, overrides)
        merged.pop("language_specific", None)
        return merged
