"""Tokenizer abstraction for the Whisper text side.

The reference gets tokenization implicitly through faster-whisper/CTranslate2
(and probes ids in `先看这个，cursor不用看/token_id.py`). Here tokenization is
an explicit protocol with three implementations:

- ``BPETokenizer``: self-contained byte-level BPE (bpe.py) loading
  vocab.json/merges.txt from a checkpoint dir — no transformers needed. The
  preferred real-checkpoint path.
- ``HFTokenizer``: wraps a *locally available* transformers WhisperTokenizer
  (no network). Fallback when only HF tokenizer files exist.
- ``MockTokenizer``: deterministic, dependency-free mapping (id -> "w<id>")
  for random-weight tests, golden streaming tests, and benchmarks. Encoding is
  the inverse, so encode(decode(ids)) == ids for in-vocab words.

All expose the same surface: encode/decode plus ``split_to_word_tokens`` used
by DTW word-timestamp extraction (timestamps.py). Word splitting is
unicode-aware: for space-less scripts (zh/ja/th/lo/my/yue — the languages the
reference tunes hardest, the reference app's `config.json:110-157`) words are
split per decoded unicode group instead of at leading spaces, so word-level
LocalAgreement commits and DTW word times keep word granularity (the openai-
whisper split_tokens_on_unicode semantics).
"""

from __future__ import annotations

import string
from typing import Callable, Optional, Protocol, Sequence

from realtime_whisper_asr_tpu_torch.models.whisper.config import WhisperConfig

#: scripts written without spaces: word = unicode-grouped piece
SPACELESS_LANGUAGES = frozenset({"zh", "ja", "th", "lo", "my", "yue"})


class Tokenizer(Protocol):
    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def split_to_word_tokens(
        self, ids: Sequence[int], language: Optional[str] = None
    ) -> tuple[list[str], list[list[int]]]: ...


def _strip_special(ids: Sequence[int], cfg: WhisperConfig) -> list[int]:
    return [int(i) for i in ids if int(i) < cfg.eot]


# --------------------------------------------------------------- word splitting


def split_tokens_on_unicode(
    ids: list[int], decode: Callable[[Sequence[int]], str]
) -> tuple[list[str], list[list[int]]]:
    """Group token ids at valid-unicode boundaries.

    Byte-level BPE can split one multibyte character across tokens; a group is
    flushed only once it decodes without a dangling-byte replacement char —
    unless the replacement char is genuinely present at that position in the
    full decoded text (openai-whisper's split_tokens_on_unicode rule).
    """
    full = decode(ids)
    rc = "�"
    words: list[str] = []
    word_tokens: list[list[int]] = []
    cur: list[int] = []
    offset = 0
    for tid in ids:
        cur.append(tid)
        text = decode(cur)
        pos = text.find(rc)
        if pos == -1 or (offset + pos < len(full) and full[offset + pos] == rc):
            words.append(text)
            word_tokens.append(cur)
            cur = []
            offset += len(text)
    if cur:
        words.append(decode(cur))
        word_tokens.append(cur)
    return words, word_tokens


def split_words(
    ids: Sequence[int],
    decode: Callable[[Sequence[int]], str],
    language: Optional[str] = None,
) -> tuple[list[str], list[list[int]]]:
    """ids -> (words, tokens-per-word).

    Space-delimited scripts merge unicode groups at leading-space/punctuation
    boundaries (split_tokens_on_spaces); space-less scripts keep each unicode
    group as its own word so a zh/ja segment yields per-character-group words
    instead of collapsing into one (the failure the reference never has
    because faster-whisper applies the same rule).
    """
    pieces, piece_tokens = split_tokens_on_unicode(list(ids), decode)
    if language in SPACELESS_LANGUAGES:
        return pieces, piece_tokens
    words: list[str] = []
    word_tokens: list[list[int]] = []
    for piece, toks in zip(pieces, piece_tokens):
        # a piece starts a new word at a leading space or when it is bare
        # punctuation (whisper's split_tokens_on_spaces rule)
        if piece.startswith(" ") or piece.strip() in string.punctuation or not words:
            words.append(piece)
            word_tokens.append(list(toks))
        else:
            words[-1] += piece
            word_tokens[-1] += toks
    return words, word_tokens


def compute_non_speech_ids(encode: Callable[[str], list[int]]) -> tuple[int, ...]:
    """Standard Whisper non-speech suppress list, computed from the vocab."""
    symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
        "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
    )
    miscellaneous = set("♩♪♫♬♭♮♯")
    # openai-whisper seeds the set with the leading-space hyphen/apostrophe
    # tokens: hyphens/quotes are allowed INSIDE words but a transcript word
    # must not BEGIN with one (tokenizer.py non_speech_tokens upstream)
    result = set()
    for seed_piece in (" -", " '"):
        toks = encode(seed_piece)
        if toks:
            result.add(toks[0])
    for symbol in symbols + list(miscellaneous):
        for tokens in [encode(symbol), encode(" " + symbol)]:
            if len(tokens) == 1 or symbol in miscellaneous:
                if tokens:
                    result.add(tokens[0])
    return tuple(sorted(result))


# ------------------------------------------------------------------ implementations


class MockTokenizer:
    """Deterministic stand-in: token id k (< eot) is the word ``w<k>``."""

    def __init__(self, cfg: WhisperConfig):
        self.cfg = cfg

    def encode(self, text: str) -> list[int]:
        ids = []
        for w in text.split():
            if w.startswith("w") and w[1:].isdigit():
                ids.append(int(w[1:]) % self.cfg.eot)
            else:
                ids.append(sum(ord(c) for c in w) % self.cfg.eot)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        toks = _strip_special(ids, self.cfg)
        return " ".join(f"w{i}" for i in toks)

    def split_to_word_tokens(self, ids: Sequence[int], language: Optional[str] = None):
        toks = _strip_special(ids, self.cfg)
        return [f" w{i}" for i in toks], [[i] for i in toks]


class BPETokenizer:
    """Self-contained byte-level BPE (bpe.py) with the Tokenizer surface."""

    def __init__(self, bpe, cfg: WhisperConfig):
        self.bpe = bpe
        self.cfg = cfg

    @classmethod
    def from_dir(cls, path: str, cfg: WhisperConfig) -> "BPETokenizer":
        from realtime_whisper_asr_tpu_torch.models.whisper.bpe import BPE

        return cls(BPE.from_dir(path), cfg)

    def encode(self, text: str) -> list[int]:
        return self.bpe.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self.bpe.decode(_strip_special(ids, self.cfg))

    def split_to_word_tokens(self, ids: Sequence[int], language: Optional[str] = None):
        return split_words(_strip_special(ids, self.cfg), self.bpe.decode, language)

    def non_speech_ids(self) -> tuple[int, ...]:
        return compute_non_speech_ids(self.bpe.encode)


class HFTokenizer:
    """transformers.WhisperTokenizer(Fast) wrapper (local files only)."""

    def __init__(self, tok, cfg: WhisperConfig):
        self.tok = tok
        self.cfg = cfg

    @classmethod
    def from_dir(cls, path: str, cfg: WhisperConfig) -> "HFTokenizer":
        try:
            from transformers import WhisperTokenizerFast

            return cls(WhisperTokenizerFast.from_pretrained(path, local_files_only=True), cfg)
        except Exception:
            # fast-tokenizer conversion needs tokenizer.json or a full special-
            # token layout; the slow tokenizer loads from bare vocab/merges
            from transformers import WhisperTokenizer

            return cls(WhisperTokenizer.from_pretrained(path, local_files_only=True), cfg)

    def encode(self, text: str) -> list[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(_strip_special(ids, self.cfg))

    def split_to_word_tokens(self, ids: Sequence[int], language: Optional[str] = None):
        return split_words(
            _strip_special(ids, self.cfg),
            lambda g: self.tok.decode(list(g)),
            language,
        )

    def non_speech_ids(self) -> tuple[int, ...]:
        return compute_non_speech_ids(
            lambda s: self.tok.encode(s, add_special_tokens=False)
        )


#: the files of a directory that transformers may build a tokenizer from
HF_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json")


def get_tokenizer(cfg: WhisperConfig, checkpoint_dir: str | None = None) -> Tokenizer:
    """vocab.json/merges.txt → self-contained BPE; else transformers, when the
    directory holds a tokenizer file (some transformers versions build a
    tokenizer from a directory with none, which would stand in for the
    mock); else mock."""
    if checkpoint_dir:
        import os

        if os.path.exists(os.path.join(checkpoint_dir, "vocab.json")) and os.path.exists(
            os.path.join(checkpoint_dir, "merges.txt")
        ):
            try:
                return BPETokenizer.from_dir(checkpoint_dir, cfg)
            except Exception:
                pass
        if any(os.path.exists(os.path.join(checkpoint_dir, f)) for f in HF_TOKENIZER_FILES):
            try:
                return HFTokenizer.from_dir(checkpoint_dir, cfg)
            except Exception:
                pass
    return MockTokenizer(cfg)
