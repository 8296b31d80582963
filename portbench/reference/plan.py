"""A window's decode plan, worked out again from the request: the initial
token block, the caps and the forced tokens.

Plain restatement of what a Whisper streaming decode plans for one window
(and of what the measured program documents for its own plan): the initial
tokens are ``[sot_prev] + blanks + prompt + sot_sequence + prefix`` padded
inside the conditioning region to a prefill bucket shared by a batch; the
sampled tokens are capped by ``max_new_tokens``, by ``max_total_tokens`` less
the prefix, by the positions left in the text context, and by
``8 + tokens_per_second x window seconds`` less the prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

PROMPT_BUCKETS = (8, 16, 32, 64, 128, 192, 256, 384)
AUX_TOKENS = 384  # the longest initial block a window carries
DRAFT_MAX = 16
LOOP_BOUNDS = (16, 48, 96, 224)


@dataclasses.dataclass(frozen=True)
class Vocab:
    """Whisper's special-token layout for a vocabulary of ``n_vocab``."""

    n_vocab: int
    n_text_ctx: int = 448

    @property
    def multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.n_vocab - 51765 - int(self.multilingual)

    @property
    def eot(self) -> int:
        return 50257 if self.multilingual else 50256

    @property
    def sot(self) -> int:
        return self.eot + 1

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

    def sot_sequence(self, language_index: int = 0) -> list[int]:
        """Transcription with timestamps: [sot, language, transcribe]."""
        if not self.multilingual:
            return [self.sot]
        return [self.sot, self.sot + 1 + language_index, self.transcribe]


BLANK = 220  # GPT-2's " "


def bucket(n: int) -> int:
    for b in PROMPT_BUCKETS:
        if n <= b:
            return b
    return PROMPT_BUCKETS[-1]


def initial_tokens(v: Vocab, prompt: list, prefix: list,
                   forced_len: Optional[int] = None) -> tuple[list[int], int, int]:
    """(tokens, sot_index, n_prefix) of a window: the prompt's newest
    n_text_ctx/2 - 1 tokens; the prefix's tail shed first, then the prompt's
    oldest, to fit; blanks after sot_prev up to the bucket (``forced_len``,
    a batch's shared length, or the block's own bucket)."""
    sot_seq = v.sot_sequence()
    prefix, prompt = list(prefix), list(prompt)
    if prompt:
        prompt = prompt[-(v.n_text_ctx // 2 - 1):]
    if not prompt and not prefix and forced_len is None:
        return sot_seq, 0, 0

    def shed(limit: int) -> int:
        nonlocal prefix, prompt
        overflow = 1 + len(prompt) + len(sot_seq) + len(prefix) - limit
        if overflow > 0:
            drop = min(overflow, len(prefix))
            prefix = prefix[: len(prefix) - drop]
            prompt = prompt[overflow - drop:]
        return 1 + len(prompt) + len(sot_seq) + len(prefix)

    base = shed(min(v.n_text_ctx - 64, PROMPT_BUCKETS[-1], AUX_TOKENS))
    target = bucket(base) if forced_len is None else forced_len
    base = shed(target)
    tokens = [v.sot_prev] + [BLANK] * (target - base) + prompt + sot_seq + prefix
    return tokens, len(tokens) - len(prefix) - len(sot_seq), len(prefix)


def batch_length(v: Vocab, rows: list[tuple[list, list]]) -> int:
    """The prefill length the rows of one batched decode share (also a
    batch of one): the bucket of the longest row's own block."""
    return bucket(max(len(initial_tokens(v, pr, px)[0]) for pr, px in rows))


WINDOW_BUCKETS = (8 * 16000, 16 * 16000, 30 * 16000)


def window_bucket(n_samples: int) -> int:
    """The encoder window a window of ``n_samples`` is padded to."""
    return next((b for b in WINDOW_BUCKETS if n_samples <= b), WINDOW_BUCKETS[-1])


def cap(v: Vocab, caps: dict, p: int, n_prefix: int, window_samples: int) -> tuple[int, int]:
    """(loop bound, exact cap on sampled tokens) of a window."""
    budget = v.n_text_ctx - p
    c = min(int(caps["max_new_tokens"]), budget)
    if caps.get("max_total_tokens") is not None:
        c = max(min(c, int(caps["max_total_tokens"]) - n_prefix), 1)
    bound = min(next((q for q in LOOP_BOUNDS if c <= q), LOOP_BOUNDS[-1]), budget)
    rate = caps.get("max_tokens_per_second")
    if rate is not None:
        total = int(8 + float(rate) * window_samples / 16000)
        c = max(1, min(c, total - n_prefix))
    return bound, c


def forced_draft(prev_sampled: list, prev_bound: int, offset: int, eot: int,
                 safety: int) -> list:
    """The tokens a window forces from the previous window's sampled tokens
    (prefix policy "last" in the async pipeline): from ``offset`` on, up to
    ``DRAFT_MAX``, through the first EOT, less that EOT and the last
    ``safety`` tokens. ``prev_sampled``: the previous window's sampled slots
    (``prev_bound`` of them, EOT past its end)."""
    slots = list(prev_sampled[:prev_bound]) + [eot] * (prev_bound - len(prev_sampled))
    ends = [i for i, t in enumerate(slots) if t == eot]
    n_valid = ends[0] + 1 if ends else prev_bound
    start = min(max(offset, 0), prev_bound - 1)
    n = max(0, min(n_valid - start, DRAFT_MAX))
    n = max(0, min((n - 1 if ends else n) - safety, DRAFT_MAX))
    return slots[start: start + n]
