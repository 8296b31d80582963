"""Self-contained byte-level BPE tokenizer (no transformers dependency).

The reference gets GPT-2 BPE implicitly through faster-whisper/CTranslate2
(the reference app's `asr_components.py:291-297` consumes its ts_words contract;
`先看这个，cursor不用看/token_id.py` probes ids). This module makes real-text
tokenization a first-class, dependency-free capability: ``BPETokenizer`` loads
``vocab.json`` + ``merges.txt`` straight from a checkpoint directory and
implements the published GPT-2 byte-level BPE algorithm (byte→unicode table,
regex pre-tokenization, rank-greedy merges). transformers remains an optional
alternative (tokenizer.HFTokenizer); it is no longer required for real
checkpoints.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional, Sequence

# GPT-2 pre-tokenization pattern (contractions, letter runs, number runs,
# symbol runs, whitespace). Uses the `regex` module for \p classes.
_GPT2_PAT = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """The published GPT-2 byte↔unicode table: maps every byte to a printable
    unicode char so BPE can operate on unicode strings losslessly."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class BPE:
    """Byte-level BPE codec over a vocab (token-string → id) + merge ranks."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.vocab = vocab
        self.id_to_token = {v: k for k, v in vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self._cache: dict[str, list[str]] = {}
        import regex

        self._pat = regex.compile(_GPT2_PAT)

    # ------------------------------------------------------------------- load

    @classmethod
    def from_dir(cls, path: str) -> "BPE":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges: list[tuple[str, str]] = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, _, b = line.partition(" ")
                if b:
                    merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def byte_fallback(cls) -> "BPE":
        """A zero-merge BPE whose vocab is exactly the 256 byte tokens: any
        text round-trips without files (ids will NOT match real checkpoints)."""
        table = bytes_to_unicode()
        vocab = {table[b]: b for b in range(256)}
        return cls(vocab, [])

    # -------------------------------------------------------------------- bpe

    def _bpe(self, token: str) -> list[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            bigram = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if bigram not in self.ranks:
                break
            a, b = bigram
            out: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        pieces = list(word)
        if len(self._cache) < 16384:
            self._cache[token] = pieces
        return pieces

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for chunk in self._pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            for piece in self._bpe(mapped):
                tid = self.vocab.get(piece)
                if tid is not None:
                    ids.append(tid)
                else:
                    # unknown merge result (partial vocab): fall back to bytes
                    ids.extend(
                        self.vocab[ch] for ch in piece if ch in self.vocab
                    )
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.id_to_token.get(int(i), "") for i in ids)
        data = bytes(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")


def write_vocab_files(path: str, vocab: dict[str, int],
                      merges: Optional[list[tuple[str, str]]] = None) -> None:
    """Write vocab.json/merges.txt in the standard layout (fixtures, tools)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges or []:
            f.write(f"{a} {b}\n")
