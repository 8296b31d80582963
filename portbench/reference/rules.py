"""Whisper's logit rules for one position, and how far a served token lies
below the reference's choice under them.

The rules (OpenAI Whisper's ``SuppressTokens``, ``SuppressBlank`` and
``ApplyTimestampRules``, as a streaming decode with a forced prefix applies
them): the special tokens and ``no_timestamps`` never; blank and EOT not
first; timestamps in pairs, never decreasing, the first one at most 1 s in;
and when the timestamps' summed probability beats every text token, a
timestamp. The prefix counts as history for the pair rule.

The structural rules depend on the history alone, which the served tokens
fix for both sides. The last rule compares two numbers of the logits, so
the judge scores it as a decision: a served token pays the margin by which
the reference's timestamps-versus-text comparison went the other way, plus
its own shortfall below the best token of its side.
"""

from __future__ import annotations

import torch

from portbench.reference.plan import BLANK, Vocab

NEG = float("-inf")
MAX_INITIAL_TIMESTAMP_INDEX = 50  # 1.0 s / 0.02 s


def always_suppressed(v: Vocab) -> list[int]:
    ids = {v.sot, v.sot_prev, v.sot_lm, v.no_speech, v.transcribe, v.translate,
           v.no_timestamps}
    if v.multilingual:
        ids |= {v.sot + 1 + i for i in range(v.num_languages)}
    return sorted(ids)


def structural_mask(v: Vocab, history: list, n_prefix: int, step: int,
                    last_ts: int, device) -> torch.Tensor:
    """(n_vocab,) bool: True where the structural rules forbid a token at
    the position after ``history`` (the whole token block so far), the
    ``step``-th sampled position of a window with ``n_prefix`` forced
    tokens; ``last_ts`` the last timestamp so far or -1."""
    ids = torch.arange(v.n_vocab, device=device)
    ts0 = v.timestamp_begin
    is_ts = ids >= ts0
    kill = torch.zeros(v.n_vocab, dtype=torch.bool, device=device)
    kill[always_suppressed(v)] = True
    first = step == 0 and n_prefix == 0
    if first:
        kill[BLANK] = True
        kill[v.eot] = True
    hist = step + n_prefix
    last = history[-1] if history else 0
    prev = history[-2] if len(history) >= 2 else 0
    last_was_ts = hist >= 1 and last >= ts0
    prev_was_ts = hist < 2 or prev >= ts0
    pair_open = last_was_ts and not prev_was_ts
    if last_was_ts and prev_was_ts:
        kill |= is_ts
    if pair_open:
        kill |= ids < v.eot
    if last_ts >= ts0:
        bound = last_ts if pair_open else last_ts + 1
        kill |= is_ts & (ids < bound)
    if first:
        kill |= (ids < ts0) | (ids > ts0 + MAX_INITIAL_TIMESTAMP_INDEX)
    return kill


def decision_gap(v: Vocab, logits: torch.Tensor, kill: torch.Tensor, token: int) -> float:
    """How far ``token`` lies below the reference's choice at a position:
    0 when the reference would choose it; inf when a structural rule
    forbids it; otherwise in logit units, the shortfall below the best
    allowed token of its side (text or timestamp), plus the margin of the
    timestamps-versus-text rule where the reference's comparison picks the
    other side."""
    if bool(kill[token]):
        return float("inf")
    lg = logits.double().masked_fill(kill, NEG)
    ts0 = v.timestamp_begin
    lp = torch.log_softmax(lg, dim=-1)
    ts_lp = torch.logsumexp(lp[ts0:], dim=-1)
    text_lp = lp[:ts0].max()
    margin = float(ts_lp - text_lp)  # > 0: the rule keeps timestamps only
    best_all = float(lg.max())
    tok = float(lg[token])
    if token >= ts0:
        best_ts = float(lg[ts0:].max())
        via_ts = max(-margin, 0.0) + (best_ts - tok)
        via_all = max(margin, 0.0) + (best_all - tok)
        return max(0.0, min(via_ts, via_all))
    return max(0.0, max(margin, 0.0) + (best_all - tok))
