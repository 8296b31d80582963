"""Word-level hypothesis stabilization: LocalAgreement-n.

Re-provides the HypothesisBuffer contract the reference consumes from
whisper_streaming and extends in `enhanced_asr_processor.py:32-156`
(SURVEY.md §2.2): a stream of (beg, end, word) hypotheses is committed once the
last ``n`` consecutive ASR hypotheses agree on a word prefix (n=2 is classic
LocalAgreement-2; the reference exposes n∈{2,3,4} via set_agreement_n).

Also implements the n-gram overlap dedup on insert: when a new hypothesis
overlaps already-committed words near the buffer boundary, the FIRST (shortest)
matching 1..5-gram suffix/prefix pair is dropped from the new words — upstream
whisper_streaming's exact rule, kept for transcript parity (a repeated word on
the boundary can therefore survive once, same as the reference stack).

Pure host logic; deliberately allocation-light (it runs every process_iter).
"""

from __future__ import annotations

import logging
from collections import deque

logger = logging.getLogger(__name__)

Word = tuple[float, float, str]  # (begin_s, end_s, text)


class HypothesisBuffer:
    def __init__(self, agreement_n: int = 2, logfile=None):
        if agreement_n < 2:
            raise ValueError("agreement_n must be >= 2")
        self.agreement_n = agreement_n
        self.commited_in_buffer: list[Word] = []
        self.buffer: list[Word] = []  # previous hypothesis (tail not yet committed)
        self.new: list[Word] = []  # incoming hypothesis
        # hypothesis history for n > 2 (reference keeps a ring of the last n)
        self.history: deque[list[Word]] = deque(maxlen=agreement_n)
        self.last_commited_time = 0.0
        self.last_commited_word: str | None = None

    # ------------------------------------------------------------------ insert

    def insert(self, words: list[Word], offset: float) -> None:
        """Add a new hypothesis, time-shifted by ``offset``.

        Keeps only words starting after the last committed time (with 0.1 s
        slack), and strips an n-gram (n≤5) that duplicates the committed tail.
        """
        new = [(b + offset, e + offset, t) for b, e, t in words]
        self.new = [(b, e, t) for b, e, t in new if b > self.last_commited_time - 0.1]
        if not self.new:
            return
        b0 = self.new[0][0]
        if abs(b0 - self.last_commited_time) < 1.0 and self.commited_in_buffer:
            # overlap region: drop the FIRST (shortest) committed-suffix ==
            # new-prefix n-gram, matching upstream whisper_streaming exactly —
            # with a repeated word on the boundary ("...the the" + "the the
            # cat") the 1-gram wins and one duplicate can survive; kept as-is
            # for transcript parity with the reference stack
            cn = len(self.commited_in_buffer)
            nn = len(self.new)
            for i in range(1, min(min(cn, nn), 5) + 1):
                committed_tail = [w[2] for w in self.commited_in_buffer[-i:]]
                new_prefix = [w[2] for w in self.new[:i]]
                if committed_tail == new_prefix:
                    for _ in range(i):
                        removed = self.new.pop(0)
                        logger.debug("removing repeated word: %s", removed)
                    break

    # ------------------------------------------------------------------- flush

    def flush(self) -> list[Word]:
        """Commit the agreed word prefix of the last ``agreement_n`` hypotheses."""
        if self.agreement_n == 2:
            commit = self._flush_agreement2()
        else:
            commit = self._flush_agreement_n()
        if commit:
            self.last_commited_word = commit[-1][2]
            self.last_commited_time = commit[-1][1]
            self.commited_in_buffer.extend(commit)
        return commit

    def _flush_agreement2(self) -> list[Word]:
        commit: list[Word] = []
        while self.new:
            nb, ne, nt = self.new[0]
            if not self.buffer:
                break
            if nt == self.buffer[0][2]:
                commit.append((nb, ne, nt))
                self.buffer.pop(0)
                self.new.pop(0)
            else:
                break
        self.buffer = self.new
        self.new = []
        return commit

    def _flush_agreement_n(self) -> list[Word]:
        """Common word-prefix across the last n distinct hypotheses (reference
        enhanced_asr_processor.py:108-135), preserving n=2 bookkeeping."""
        self.history.append(list(self.new))
        commit: list[Word] = []
        if len(self.history) == self.agreement_n:
            hyps = list(self.history)
            min_len = min(len(h) for h in hyps)
            agree = 0
            for i in range(min_len):
                w0 = hyps[-1][i][2]
                if all(h[i][2] == w0 for h in hyps[:-1]):
                    agree += 1
                else:
                    break
            commit = self.new[:agree]
            # remove committed prefix everywhere
            self.new = self.new[agree:]
            self.history = deque(
                [h[agree:] for h in self.history], maxlen=self.history.maxlen
            )
        self.buffer = self.new
        self.new = []
        return commit

    # ----------------------------------------------------------------- helpers

    def set_agreement_n(self, n: int) -> None:
        if n < 2:
            raise ValueError("agreement_n must be >= 2")
        self.agreement_n = n
        self.history = deque(self.history, maxlen=n)

    def pop_commited(self, time: float) -> None:
        """Forget committed words ending at/before ``time`` (buffer trim)."""
        while self.commited_in_buffer and self.commited_in_buffer[0][1] <= time:
            self.commited_in_buffer.pop(0)

    def complete(self) -> list[Word]:
        """The uncommitted tail (returned by finish())."""
        return self.buffer
