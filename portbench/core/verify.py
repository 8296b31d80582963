"""The Whisper family's comparison that decides ``correct``
(``families/whisper.py``'s ``check``): served tokens against the plain
reference.

Once the window has closed, a sample of the requests the program finished,
drawn from the seed with the longest among them, is run through the
reference (``reference/whisper_ref.py``) over the request's own window and
token block: the initial tokens worked out again from its prompt and prefix
(``reference/plan.py``), then every token the program served. At each
position the program chose a token greedily (not a prefix or a forced
draft), ``reference/rules.py`` scores the choice: how far the served token's
logit lies below the reference's choice. The widest such gap is compared
with the configuration's limit. Structural faults (a token the rules
forbid, more tokens than the cap, a prefix or a forced draft that is not
what the request forced) are counted, and their limit is 0.

With ``control`` the same positions are also read with the reference in the
next lower precision (int4 weights in place of int8): the gap of the token
the control puts first.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from portbench.reference import plan as P
from portbench.reference import rules as R
from portbench.reference import whisper_ref as W


@dataclasses.dataclass
class Case:
    """One request as the reference sees it."""

    rid: int
    audio: np.ndarray
    bucket: int
    init: list
    p: int
    n_prefix: int
    sampled: list
    n_forced: int
    cap: int
    faults: list

    @property
    def judged(self) -> int:
        extra = 1 if len(self.sampled) < self.cap else 0
        return max(0, min(len(self.sampled), self.cap) - self.n_forced) + extra


def _prefix_of(v: P.Vocab, r, rows) -> tuple[list, int, int]:
    init, _, n_prefix = P.initial_tokens(v, r.prompt, r.prefix, rows)
    return init, len(init), n_prefix


def build_case(v: P.Vocab, caps: dict, rec, r) -> Case:
    """The reference's view of request ``r`` of recorder ``rec``."""
    d = rec.dispatches[r.dispatch]
    group = [rec.reqs[i] for i in d.rids]
    faults = []
    forced_len = (P.batch_length(v, [(g.prompt, g.prefix) for g in group])
                  if d.kind == "batch" else None)
    init, p, n_prefix = _prefix_of(v, r, forced_len)
    bucket = max(P.window_bucket(len(g.audio)) for g in group)
    bound = max(P.cap(v, caps, p, _prefix_of(v, g, forced_len)[2], len(g.audio))[0]
                for g in group)
    _, cap = P.cap(v, caps, p, n_prefix, len(r.audio))
    full = list(r.tokens)
    if full[:n_prefix] != init[p - n_prefix:]:
        faults.append("prefix")
    sampled = full[n_prefix:]
    if len(sampled) > cap:
        faults.append("past_cap")
    n_forced = 0
    dd = r.device_draft
    if dd is not None and dd.get("force") and dd.get("prev") is not None:
        prev = rec.reqs[dd["prev"]]
        if prev.tokens is not None:
            prev_sampled = prev.tokens[len(prev.prefix):]
            forced = P.forced_draft(prev_sampled, dd["max_new"], dd["offset"], v.eot,
                                    dd["safety"])
            n_forced = min(len(forced), cap, bound - 1)
            if sampled[:n_forced] != forced[:n_forced]:
                faults.append("forced")
    return Case(r.rid, r.audio, bucket, init, p, n_prefix, sampled, n_forced, cap, faults)


def candidates(rec) -> list:
    """Requests finished with a result, one window each, audio kept."""
    return [r for r in rec.reqs
            if r.t_apply is not None and r.tokens is not None and r.dispatch is not None
            and not r.multi_window and r.audio is not None and r.counted]


def sample(v: P.Vocab, caps: dict, rec, seed: int, min_tokens: int = 300,
           max_requests: int = 48) -> list[Case]:
    """Cases drawn from the seed: the request with the most judged tokens,
    the one with the longest window, then others in the seed's order until
    ``min_tokens`` positions are judged or ``max_requests`` are taken."""
    cands = candidates(rec)
    if not cands:
        return []
    cases = {r.rid: build_case(v, caps, rec, r) for r in cands}
    first = [max(cands, key=lambda r: cases[r.rid].judged).rid,
             max(cands, key=lambda r: len(r.audio)).rid]
    order = np.random.default_rng([int(seed) & (2**64 - 1), 7]).permutation(len(cands))
    picked: list[int] = []
    for rid in first + [cands[i].rid for i in order]:
        if rid in picked:
            continue
        picked.append(rid)
        if (sum(cases[i].judged for i in picked) >= min_tokens
                or len(picked) >= max_requests):
            break
    return [cases[i] for i in picked]


def _last_ts(v: P.Vocab, prefix: list) -> int:
    ts = [t for t in prefix if t >= v.timestamp_begin]
    return ts[-1] if ts else -1


def _control_choice(v: P.Vocab, logits: torch.Tensor, kill: torch.Tensor) -> int:
    """The token a decode with ``logits`` chooses under the rules."""
    lg = logits.double().masked_fill(kill, R.NEG)
    ts0 = v.timestamp_begin
    lp = torch.log_softmax(lg, dim=-1)
    if float(torch.logsumexp(lp[ts0:], dim=-1)) > float(lp[:ts0].max()):
        lg[:ts0] = R.NEG
    return int(lg.argmax())


def judge_case(v: P.Vocab, w: W.RefWeights, case: Case, device,
               control: Optional[W.RefWeights] = None) -> tuple[list, list]:
    """(the reference's gaps, the control's gaps) at each judged position."""
    tokens = case.init + case.sampled
    logits = W.window_logits(w, case.audio, case.bucket, tokens, device)
    ctrl = (W.window_logits(control, case.audio, case.bucket, tokens, device)
            if control is not None else None)
    gaps, cgaps = [], []
    lts = _last_ts(v, case.init[case.p - case.n_prefix:])
    ts0 = v.timestamp_begin
    n = min(len(case.sampled), case.cap)
    for j in range(n + (1 if len(case.sampled) < case.cap else 0)):
        tok = case.sampled[j] if j < len(case.sampled) else v.eot
        if j >= case.n_forced:
            history = tokens[: case.p + j]
            kill = R.structural_mask(v, history, case.n_prefix, j, lts, device)
            row = logits[case.p + j - 1]
            gaps.append(R.decision_gap(v, row, kill, tok))
            if ctrl is not None:
                choice = _control_choice(v, ctrl[case.p + j - 1], kill)
                cgaps.append(R.decision_gap(v, row, kill, choice))
        if tok >= ts0:
            lts = max(lts, tok) if j < case.n_forced else tok
    return gaps, cgaps


def check(rec, cfg: dict, seed: int, state: dict, device, control: bool = False) -> dict:
    """Readings of a run: widest gap, structural faults, positions and
    requests judged (and the control's widest gap)."""
    v = P.Vocab(cfg["vocab_size"], cfg["max_target_positions"])
    cases = sample(v, cfg["caps"], rec, seed)
    w = W.RefWeights(state, cfg, device, weight_bits=cfg.get("weight_bits"))
    cw = None
    if control:
        bits = cfg.get("weight_bits")
        cw = W.RefWeights(state, cfg, device, weight_bits=4 if bits == 8 else 8)
    gaps, cgaps, faults, notes = [], [], 0, []
    for case in cases:
        g, c = judge_case(v, w, case, device, cw)
        found = case.faults + [f"forbidden@{j}" for j, x in enumerate(g) if x == float("inf")]
        if found:
            faults += len(found)
            notes.append(f"request {case.rid}: {found} p {case.p} n_prefix {case.n_prefix} "
                         f"cap {case.cap} forced {case.n_forced} sampled {case.sampled} "
                         f"init {case.init}")
        gaps += [x for x in g if x != float("inf")]
        cgaps += c
    out = {"widest_gap": max(gaps) if gaps else float("nan"), "structure_faults": faults,
           "fault_notes": notes, "positions": len(gaps), "requests": len(cases)}
    if control:
        out["control_widest_gap"] = max(cgaps) if cgaps else float("nan")
    return out
