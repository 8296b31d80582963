"""Whisper model configuration, size presets, and special-token layout.

Replaces the reference's reliance on faster-whisper/CTranslate2 model metadata
(reference `asr_components.py:232-265`, `一键实时识别麦克风.py:254-330` model
tables). The special-token layout below is the public Whisper vocabulary
convention, computed formulaically from (n_vocab, num_languages) so all model
families (multilingual v1/v2, english-only, large-v3/turbo) share one codepath.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Whisper's language registry in canonical token order (public model card /
# tokenizer convention). Position i maps to token id sot+1+i. "yue" is the
# 100th language added in large-v3-era vocabularies (n_vocab 51866).
LANGUAGES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Static (hashable) architecture config; used as a cache key."""

    name: str = "tiny"
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.n_vocab - 51765 - int(self.is_multilingual)

    # --- special token ids (formulaic; matches the public tokenizer layout) ---
    @property
    def eot(self) -> int:
        return 50257 if self.is_multilingual else 50256

    @property
    def sot(self) -> int:
        return self.eot + 1

    def lang_token(self, lang: str) -> int:
        idx = LANGUAGES.index(lang)
        if idx >= self.num_languages:
            raise ValueError(f"language {lang!r} not in this model's vocabulary")
        return self.sot + 1 + idx

    @property
    def translate(self) -> int:
        return self.sot + 1 + self.num_languages

    @property
    def transcribe(self) -> int:
        return self.translate + 1

    @property
    def sot_lm(self) -> int:
        return self.transcribe + 1

    @property
    def sot_prev(self) -> int:
        return self.sot_lm + 1

    @property
    def no_speech(self) -> int:
        return self.sot_prev + 1

    @property
    def no_timestamps(self) -> int:
        return self.no_speech + 1

    @property
    def timestamp_begin(self) -> int:
        return self.no_timestamps + 1

    def timestamp_to_seconds(self, token_id: int) -> float:
        return (token_id - self.timestamp_begin) * 0.02

    def sot_sequence(
        self, language: Optional[str] = "en", task: str = "transcribe", timestamps: bool = False
    ) -> tuple[int, ...]:
        if not self.is_multilingual:
            seq = (self.sot,)
        else:
            lang = language or "en"
            task_tok = self.transcribe if task == "transcribe" else self.translate
            seq = (self.sot, self.lang_token(lang), task_tok)
        if not timestamps:
            seq = seq + (self.no_timestamps,)
        return seq


def _preset(name, n_mels, d, h, l_enc, l_dec, vocab) -> WhisperConfig:
    return WhisperConfig(
        name=name,
        n_mels=n_mels,
        n_audio_state=d,
        n_audio_head=h,
        n_audio_layer=l_enc,
        n_text_state=d,
        n_text_head=h,
        n_text_layer=l_dec,
        n_vocab=vocab,
    )


# Size table per the public Whisper family (reference surfaces the same sizes
# interactively, `一键实时识别麦克风.py:254-330`).
PRESETS: dict[str, WhisperConfig] = {
    "tiny": _preset("tiny", 80, 384, 6, 4, 4, 51865),
    "tiny.en": _preset("tiny.en", 80, 384, 6, 4, 4, 51864),
    "base": _preset("base", 80, 512, 8, 6, 6, 51865),
    "base.en": _preset("base.en", 80, 512, 8, 6, 6, 51864),
    "small": _preset("small", 80, 768, 12, 12, 12, 51865),
    "small.en": _preset("small.en", 80, 768, 12, 12, 12, 51864),
    "medium": _preset("medium", 80, 1024, 16, 24, 24, 51865),
    "medium.en": _preset("medium.en", 80, 1024, 16, 24, 24, 51864),
    "large-v1": _preset("large-v1", 80, 1280, 20, 32, 32, 51865),
    "large-v2": _preset("large-v2", 80, 1280, 20, 32, 32, 51865),
    "large-v3": _preset("large-v3", 128, 1280, 20, 32, 32, 51866),
    "large": _preset("large", 128, 1280, 20, 32, 32, 51866),
    "large-v3-turbo": _preset("large-v3-turbo", 128, 1280, 20, 32, 4, 51866),
    "turbo": _preset("turbo", 128, 1280, 20, 32, 4, 51866),
    # Tiny non-standard configs for unit tests / CI (fast init & compile).
    "test-tiny": WhisperConfig(
        name="test-tiny",
        n_mels=80,
        n_audio_ctx=1500,
        n_audio_state=64,
        n_audio_head=2,
        n_audio_layer=2,
        n_vocab=51865,
        n_text_ctx=448,
        n_text_state=64,
        n_text_head=2,
        n_text_layer=2,
    ),
}


def get_config(name: str) -> WhisperConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown whisper model {name!r}; options: {sorted(PRESETS)}") from None
