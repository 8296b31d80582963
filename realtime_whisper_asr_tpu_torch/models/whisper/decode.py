"""Single-stream greedy decoding under Whisper's logit rules.

Port of the greedy path of ``realtime_whisper_asr_tpu/models/whisper/decode.py``:
one prefill pass (``decode_span``) over prompt + SOT sequence + forced prefix
+ self-speculative draft, a lossless verify of the draft from that pass, then
one ``decode_step`` per new token with the same selection function
(``_select_next``: suppress lists, blank/EOT rule, timestamp grammar with
monotonicity and the timestamp-probability rule, argmax). Per-row boundaries
and caps ride in the same aux bundle as the JAX package's (``pack_aux``,
planned by ``plan_window``), and the result comes back as the same packed
buffer — tokens, sum logprob, no-speech probability and the uint8-quantized
cross-attention capture — in one device→host copy.

Loop control runs on the host: eager PyTorch has no ``while_loop``, so every
step syncs once to test ``all(finished)``; the decode position is a host int.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.models.whisper.config import WhisperConfig
from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Decoding options of the greedy path."""

    task: str = "transcribe"
    language: Optional[str] = "en"
    max_new_tokens: int = 224
    max_total_tokens: Optional[int] = None  # cap on prefix+generated transcript length
    timestamps: bool = True
    max_initial_timestamp: float = 1.0
    suppress_blank: bool = True
    blank_id: int = 220  # GPT2 " " token
    word_timestamps: bool = False


@dataclasses.dataclass
class DecodeResult:
    tokens: np.ndarray  # (B, n_prefix + ≤max_new) prefix + sampled ids
    lengths: np.ndarray  # (B,) valid length incl. EOT
    sum_logprob: np.ndarray  # (B,) over sampled tokens
    avg_logprob: np.ndarray  # (B,)
    no_speech_prob: np.ndarray  # (B,)
    xattn: Optional[np.ndarray]  # (B, n_prefix + ≤max_new, audio_ctx) or None


_PROMPT_BUCKETS = (8, 16, 32, 64, 128, 192, 256, 384)


def _bucket(n: int) -> int:
    for b in _PROMPT_BUCKETS:
        if n <= b:
            return b
    return _PROMPT_BUCKETS[-1]


# aux bundle layout (the JAX package's, so one upload carries the initial
# tokens and every per-row scalar):
#   [tokens_f32(AUX_TOK) | n_prefix | sot_index | last_ts | sampling_seed |
#    max_new_cap | n_draft | draft_f32(DRAFT_MAX) | temperature]
# The greedy path leaves the seed and temperature slots at 0.
AUX_TOK = 384
DRAFT_MAX = 16
AUX_TEMP = AUX_TOK + 6 + DRAFT_MAX
AUX_LEN = AUX_TEMP + 1


def build_initial_tokens(
    cfg: WhisperConfig,
    opts: DecodeOptions,
    prompt_tokens: Optional[list[int]] = None,
    prefix_tokens: Optional[list[int]] = None,
) -> tuple[np.ndarray, int, int]:
    """[sot_prev + pad + prompt?] + sot_seq + prefix?, bucketed.
    -> (tokens, sot_index, n_prefix).

    The bucket padding lives INSIDE the conditioning region ([sot_prev] +
    blanks), which Whisper treats as prior context — blank padding there is
    semantically inert, unlike padding the forced prefix would be.
    """
    sot_seq = list(cfg.sot_sequence(opts.language, opts.task, timestamps=opts.timestamps))
    prefix = list(prefix_tokens or [])
    prompt = list(prompt_tokens or [])
    if prompt:
        prompt = prompt[-(cfg.n_text_ctx // 2 - 1) :]
    if not prompt and not prefix:
        return np.asarray(sot_seq, np.int32), 0, 0
    # reserve space: [sot_prev] + pad + prompt + sot_seq + prefix
    max_p = min(cfg.n_text_ctx - 64, _PROMPT_BUCKETS[-1], AUX_TOK)
    base = 1 + len(prompt) + len(sot_seq) + len(prefix)
    if base > max_p:
        # shed the prefix TAIL first (the head must stay aligned with the
        # audio window start — dropping it would make the model re-emit early
        # content as duplicates), then shed the prompt's oldest tokens
        overflow = base - max_p
        drop = min(overflow, len(prefix))
        prefix = prefix[: len(prefix) - drop]
        overflow -= drop
        if overflow > 0:
            prompt = prompt[overflow:]
        base = 1 + len(prompt) + len(sot_seq) + len(prefix)
    pad = _bucket(base) - base
    tokens = [cfg.sot_prev] + [opts.blank_id] * pad + prompt + sot_seq + prefix
    sot_index = len(tokens) - len(prefix) - len(sot_seq)
    return np.asarray(tokens, np.int32), sot_index, len(prefix)


def suppress_mask(cfg: WhisperConfig, extra_suppress: tuple[int, ...] = ()) -> np.ndarray:
    """(n_vocab,) additive f32 mask: -inf at always-suppressed ids."""
    m = np.zeros((cfg.n_vocab,), np.float32)
    ids = {cfg.sot, cfg.sot_prev, cfg.sot_lm, cfg.no_speech, cfg.transcribe, cfg.translate}
    if cfg.is_multilingual:
        ids |= {cfg.sot + 1 + i for i in range(cfg.num_languages)}
    ids |= {int(i) for i in extra_suppress if 0 <= int(i) < cfg.n_vocab}
    m[sorted(ids)] = -np.inf
    return m


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def plan_decode_budget(
    cfg: WhisperConfig, opts: DecodeOptions, p: int, n_prefix: int
) -> tuple[int, int]:
    """(loop bound, exact cap). The bound is bucket-quantized (it sizes the
    token and capture buffers); the cap (≤ bound) rides in the aux bundle."""
    budget = cfg.n_text_ctx - p
    cap = min(opts.max_new_tokens, budget)
    if opts.max_total_tokens is not None:
        cap = max(min(cap, opts.max_total_tokens - n_prefix), 1)
    static = next((q for q in (16, 48, 96, 224) if cap <= q), 224)
    return min(static, budget), cap


def pack_aux(
    init: np.ndarray,
    n_prefix: int,
    sot_index: int,
    last_ts: int,
    max_new_cap: int = 10**6,
    draft: Optional[np.ndarray] = None,
) -> np.ndarray:
    aux = np.zeros(AUX_LEN, np.float32)
    aux[: len(init)] = init.astype(np.float32)
    aux[AUX_TOK] = n_prefix
    aux[AUX_TOK + 1] = sot_index
    aux[AUX_TOK + 2] = last_ts
    aux[AUX_TOK + 4] = max_new_cap
    if draft is not None and len(draft):
        d = np.asarray(draft, np.float32)[:DRAFT_MAX]
        aux[AUX_TOK + 5] = len(d)
        aux[AUX_TOK + 6 : AUX_TOK + 6 + len(d)] = d
    return aux


def _unpack_xattn(
    row: np.ndarray, off: int, b: int, max_new: int, p: int, audio_ctx: int
) -> np.ndarray:
    """Decode the uint8-quantized xattn section (4 values per f32 word) back
    to float32: (b, max_new + p, audio_ctx) — sampled rows then prefill."""
    n_xa = (max_new + p) * audio_ctx  # divisible by 4 (audio_ctx is)
    sec = np.ascontiguousarray(row[:, off : off + n_xa // 4], np.float32)
    q = sec.view(np.uint8)
    return (q.astype(np.float32) / 255.0).reshape(b, max_new + p, audio_ctx)


@functools.lru_cache(maxsize=64)
def _sup_mask_dev(cfg: WhisperConfig, extra_suppress: tuple[int, ...], device: torch.device):
    return torch.from_numpy(suppress_mask(cfg, extra_suppress)).to(device)


@functools.lru_cache(maxsize=16)
def _amask_dev(cfg: WhisperConfig, heads_key: Optional[bytes], device: torch.device):
    """(L, H) alignment-head weights, normalized to sum 1; by default the
    heads of the top half of the decoder layers."""
    if heads_key is None:
        amask = np.zeros((cfg.n_text_layer, cfg.n_text_head), np.float32)
        amask[cfg.n_text_layer // 2 :] = 1.0
    else:
        amask = np.frombuffer(heads_key, np.float32).reshape(cfg.n_text_layer, cfg.n_text_head)
    amask = amask / max(amask.sum(), 1e-6)
    return torch.from_numpy(np.ascontiguousarray(amask, np.float32)).to(device)


def _select_next(cfg, opts, logits, tokens, pos, last_ts, n_prefix, p, sup_mask):
    """All Whisper logit rules + argmax at per-row positions ``pos`` (R,).
    logits (R, V) f32; tokens (R, T) the history; last_ts, n_prefix (R,).
    Returns (next token (R,), its logprob (R,))."""
    neg = float("-inf")
    vocab_ids = torch.arange(cfg.n_vocab, device=logits.device)
    ts0 = cfg.timestamp_begin
    is_ts = vocab_ids >= ts0
    step = pos - p
    # rows with no forced prefix get whisper's initial-position rules
    first = (step == 0) & (n_prefix == 0)
    flogits = logits + sup_mask
    flogits[:, cfg.no_timestamps] = neg
    if opts.suppress_blank:
        blank = torch.where(first, neg, 0.0)
        flogits[:, opts.blank_id] += blank
        flogits[:, cfg.eot] += blank
    if opts.timestamps:
        last = tokens.gather(1, (pos - 1).clamp(min=0)[:, None])[:, 0]
        prev = tokens.gather(1, (pos - 2).clamp(min=0)[:, None])[:, 0]
        # prefix tokens count as stream history: history length is
        # step + n_prefix
        hist = step + n_prefix
        last_was_ts = (hist >= 1) & (last >= ts0)
        prev_was_ts = (hist < 2) | (prev >= ts0)
        pair_open = last_was_ts & ~prev_was_ts
        kill_ts = (last_was_ts & prev_was_ts)[:, None] & is_ts
        kill_text = pair_open[:, None] & (vocab_ids < cfg.eot)
        bound = torch.where(pair_open, last_ts, last_ts + 1)
        kill_mono = (last_ts >= ts0)[:, None] & is_ts & (vocab_ids[None, :] < bound[:, None])
        max_initial_index = round(opts.max_initial_timestamp / 0.02)
        kill_init = first[:, None] & ((vocab_ids < ts0) | (vocab_ids > ts0 + max_initial_index))
        flogits = flogits.masked_fill(kill_ts | kill_text | kill_mono | kill_init, neg)
        logprobs = torch.log_softmax(flogits, dim=-1)
        ts_lp = torch.logsumexp(logprobs.masked_fill(~is_ts, neg), dim=-1)
        max_text_lp = logprobs.masked_fill(is_ts, neg).amax(dim=-1)
        flogits = flogits.masked_fill((ts_lp > max_text_lp)[:, None] & ~is_ts, neg)
    else:
        flogits = flogits.masked_fill(is_ts, neg)
    nxt = flogits.argmax(dim=-1)  # first maximum, as jnp.argmax
    lp = torch.log_softmax(flogits, dim=-1).gather(1, nxt[:, None])[:, 0]
    return nxt, lp


def _advance(cfg, tokens, pos: int, total, finished, sum_lp, last_ts, nxt, lp):
    """Write the token at ``pos``; rows at their cap freeze like EOT'd rows."""
    done = finished | (pos >= total)
    nxt = torch.where(done, cfg.eot, nxt)
    sum_lp = sum_lp + torch.where(done, 0.0, lp)
    last_ts = torch.where((nxt >= cfg.timestamp_begin) & ~done, nxt, last_ts)
    tokens[:, pos] = nxt
    return finished | (nxt == cfg.eot), sum_lp, last_ts


@torch.inference_mode()
def _greedy_loop(
    model: Whisper,
    opts: DecodeOptions,
    xa: torch.Tensor,  # (B, audio_ctx, d)
    aux: torch.Tensor,  # (B, AUX_LEN) f32 bundles (see pack_aux), one per row
    sup_mask: torch.Tensor,  # (n_vocab,) additive
    alignment_mask: torch.Tensor,  # (L, H)
    prompt_len: int,
    capture_xattn: bool,
    max_new: int,
    cache_len: int,
    draft_max: int = 0,
) -> torch.Tensor:
    """The decode of one window, returning the packed result (flat f32).

    Self-speculative decode (draft_max > 0): the prefill span is
    init || draft, where draft is the previous tick's hypothesis tail beyond
    the forced prefix. That one pass yields the model's choice at every draft
    position under the same rules as the loop, so the longest agreeing draft
    prefix (+1 bonus token from the first divergent position) is accepted
    wholesale and the loop starts past it. Lossless: the verifier IS the
    loop's own selection function."""
    cfg = model.cfg
    b, p, dev = xa.shape[0], prompt_len, xa.device
    aux = aux.long()  # every slot read here holds an integer
    initial_tokens = aux[:, :p]
    n_prefix = aux[:, AUX_TOK]
    sot_index = aux[:, AUX_TOK + 1]
    last_ts_init = aux[:, AUX_TOK + 2]
    total = torch.clamp(p + aux[:, AUX_TOK + 4], max=p + max_new)  # exact per-row cap
    n_draft = aux[:, AUX_TOK + 5]
    draft_tok = aux[:, AUX_TOK + 6 : AUX_TOK + 6 + draft_max]
    # pad rows beyond each row's draft with EOT (never matches a real choice,
    # and keeps the span's token ids in-vocab)
    draft_tok = torch.where(torch.arange(draft_max, device=dev)[None, :] < n_draft[:, None],
                            draft_tok, cfg.eot)
    ts0 = cfg.timestamp_begin
    audio_ctx = xa.shape[1]
    select = functools.partial(_select_next, cfg, opts, p=p, sup_mask=sup_mask)

    cache = model.init_cache(xa, text_ctx=cache_len)
    amask = alignment_mask if capture_xattn else None
    span = torch.cat([initial_tokens, draft_tok], dim=1)
    pre_logits, pre_xattn = model.decode_span(span, 0, cache, alignment_mask=amask)
    sot_logits = pre_logits[torch.arange(b, device=dev), sot_index]
    no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, cfg.no_speech]

    tokens = torch.cat([initial_tokens, draft_tok,
                        torch.full((b, max_new - draft_max), cfg.eot, device=dev)], dim=1)
    xattn = torch.zeros((b, max_new if capture_xattn else 1, audio_ctx), device=dev)
    if capture_xattn and draft_max:
        # accepted draft tokens' capture rows come from the prefill span;
        # slots past acceptance are overwritten as the loop re-decodes them
        slots = min(draft_max, max_new - 1)
        xattn[:, 1 : slots + 1] = pre_xattn[:, p : p + slots]

    # verify + seed from the prefill span's logits: row p-1+i of pre_logits
    # predicts position p+i, so one batched pass of the selection rules over
    # positions p..p+draft_max gives the choice at every draft slot and the
    # bonus token at the first divergence (with no draft: just the first token)
    if draft_max:
        cm = torch.cummax(torch.where(draft_tok >= ts0, draft_tok, -1), dim=1).values
        lts_all = torch.cat([last_ts_init[None], torch.maximum(last_ts_init[None], cm.t())])
    else:
        lts_all = last_ts_init[None]  # (draft_max+1, B): last_ts BEFORE each position
    k = draft_max + 1
    positions = p + torch.arange(k, device=dev)
    lg = pre_logits[:, p - 1 : p + draft_max].transpose(0, 1)  # (k, B, V)
    choices, lps = select(lg.reshape(k * b, -1), tokens.repeat(k, 1),
                          positions.repeat_interleave(b), lts_all.reshape(-1),
                          n_prefix.repeat(k))
    choices, lps = choices.view(k, b), lps.view(k, b)

    if draft_max:
        iidx = torch.arange(draft_max, device=dev)[:, None]
        match = (((choices[:draft_max] == draft_tok.t()) | (n_draft < 0)[None, :])
                 & (iidx < n_draft.abs()[None, :]) & ((p + iidx) < total[None, :]))
        acc_row = torch.cumprod(match.long(), dim=0).sum(dim=0)  # (B,)
        # one shared position: accept the min across rows, keep a slot free
        # for the bonus token
        n_acc_t = torch.clamp(acc_row.min(), max=max_new - 1)
    else:
        n_acc_t = torch.zeros((), dtype=torch.long, device=dev)
    n_acc, max_total = torch.stack([n_acc_t, total.max()]).tolist()  # one host sync
    sum_lp = (lps[:n_acc].sum(dim=0) if n_acc
              else torch.zeros(b, device=dev))
    finished, sum_lp, last_ts = _advance(
        cfg, tokens, p + n_acc, total, torch.zeros(b, dtype=torch.bool, device=dev),
        sum_lp, lts_all[n_acc], choices[n_acc], lps[n_acc])

    pos = p + 1 + n_acc
    while pos < max_total and not bool(finished.all()):  # one host sync per step
        logits, xw = model.decode_step(tokens[:, pos - 1], pos - 1, cache, alignment_mask=amask)
        nxt, lp = select(logits, tokens, torch.full((b,), pos, device=dev), last_ts, n_prefix)
        if capture_xattn:
            xattn[:, pos - p] = xw
        finished, sum_lp, last_ts = _advance(
            cfg, tokens, pos, total, finished, sum_lp, last_ts, nxt, lp)
        pos += 1

    # ONE flat f32 buffer for the host: token ids (< 2^24, exact in f32),
    # sum logprob, no-speech probability and the capture — softmax weights in
    # [0, 1] quantized to uint8 (x255), four per f32 word: sampled rows, then
    # the init prefill block (draft span rows were folded into the slots)
    parts = [tokens[:, p:].float(), sum_lp[:, None], no_speech_prob[:, None]]
    if capture_xattn:
        xa_all = torch.cat([xattn.reshape(b, -1), pre_xattn[:, :p].reshape(b, -1)], dim=1)
        q = torch.clamp(torch.round(xa_all * 255.0), 0, 255).to(torch.uint8)
        parts.append(q.view(torch.float32))
    return torch.cat(parts, dim=1).reshape(-1)


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """One window's decode plan: the initial token block, the loop bound, and
    the aux bundle that carries the per-row scalars to the device."""

    init: np.ndarray  # (p,) initial tokens (see build_initial_tokens)
    n_prefix: int  # forced-prefix tokens at the end of ``init``
    max_new: int  # loop bound (bucketed; sizes the token and capture buffers)
    draft_max: int  # draft slots in the prefill span (0 without a draft)
    aux: np.ndarray  # (AUX_LEN,) f32, see pack_aux

    @property
    def prefix(self) -> np.ndarray:
        return self.init[len(self.init) - self.n_prefix :]


def plan_window(
    cfg: WhisperConfig,
    opts: DecodeOptions,
    prompt_tokens: Optional[list[int]] = None,
    prefix_tokens: Optional[list[int]] = None,
    draft_tokens: Optional[list[int]] = None,
) -> WindowPlan:
    """Initial tokens, budget and aux bundle of one window. ``draft_tokens``
    (the previous hypothesis's tail beyond the forced prefix) enables the
    lossless self-speculative fast path."""
    init, sot_index, n_prefix = build_initial_tokens(cfg, opts, prompt_tokens, prefix_tokens)
    ts_in_prefix = [int(t) for t in init[len(init) - n_prefix :] if t >= cfg.timestamp_begin]
    max_new, max_new_cap = plan_decode_budget(cfg, opts, int(init.shape[0]), n_prefix)
    aux = pack_aux(
        init, n_prefix, sot_index, ts_in_prefix[-1] if ts_in_prefix else -1,
        max_new_cap=max_new_cap, draft=np.asarray(draft_tokens or [], np.int32),
    )
    return WindowPlan(init, n_prefix, max_new, DRAFT_MAX if draft_tokens else 0, aux)


def greedy_decode(
    model: Whisper,
    xa: torch.Tensor,
    opts: DecodeOptions,
    plan: WindowPlan,
    aux: torch.Tensor,
    extra_suppress: tuple[int, ...] = (),
    alignment_heads: Optional[np.ndarray] = None,
) -> DecodeResult:
    """Run the decode loop of one planned window and unpack its result with
    one device→host copy. ``aux`` is ``plan.aux`` on xa's device (the ASR
    uploads it with the audio). Returns tokens = prefix + sampled (xattn rows
    aligned), so callers parse one transcript regardless of how much was
    forced."""
    cfg = model.cfg
    b, p = xa.shape[0], int(plan.init.shape[0])
    heads_key = (None if alignment_heads is None
                 else np.ascontiguousarray(alignment_heads, np.float32).tobytes())
    packed = _greedy_loop(
        model, opts, xa, aux.reshape(-1, AUX_LEN).expand(b, AUX_LEN),
        _sup_mask_dev(cfg, tuple(extra_suppress), xa.device),
        _amask_dev(cfg, heads_key, xa.device),
        prompt_len=p, capture_xattn=opts.word_timestamps, max_new=plan.max_new,
        cache_len=min(cfg.n_text_ctx, _round_up(p + plan.max_new, 128)),
        draft_max=plan.draft_max,
    )
    rows = _unpack_packed_rows(
        packed.cpu().numpy(), cfg, b, p, plan.max_new, opts.word_timestamps,
        int(xa.shape[1]), [plan.prefix] * b,
    )
    lengths = np.array([r[1] for r in rows], np.int64)
    sum_lp = np.array([r[2] for r in rows], np.float64)
    return DecodeResult(
        tokens=np.stack([r[0] for r in rows]),
        lengths=lengths,
        sum_logprob=sum_lp,
        avg_logprob=sum_lp / np.maximum(lengths - plan.n_prefix, 1),
        no_speech_prob=np.array([r[3] for r in rows]),
        xattn=np.stack([r[4] for r in rows]) if opts.word_timestamps else None,
    )


def _unpack_packed_rows(flat, cfg, b, p, max_new, capture, audio_ctx, prefix_rows):
    """Host-side parse of the packed decode buffer: layout offsets, EOT length
    scan, and the xattn realignment.

    Returns per-row (full_tokens, length, sum_lp, no_speech_prob, xattn).
    """
    row = flat.reshape(b, -1)
    off = 0
    tokens = row[:, off : off + max_new].astype(np.int32); off += max_new
    sum_lp = row[:, off].astype(np.float64); off += 1
    nsp = row[:, off]; off += 1
    xa_full = _unpack_xattn(row, off, b, max_new, p, audio_ctx) if capture else None
    out = []
    for i in range(b):
        prefix_arr = np.asarray(prefix_rows[i], np.int32)
        n_prefix = len(prefix_arr)
        full = np.concatenate([prefix_arr, tokens[i]])
        eots = np.nonzero(full == cfg.eot)[0]
        length = int(eots[0] + 1) if eots.size else len(full)
        xattn_i = None
        if capture:
            stored = xa_full[i, :max_new]
            # decode_step at position pos captures the query row of token
            # pos-1 and stores it at index pos-p, so sampled token j's row
            # sits at stored[j+1] (stored[0] duplicates the last prefill
            # row). Realign; repeat-pad the final row, which only matters
            # when the loop hits its bound.
            gen = np.concatenate([stored[1:], stored[-1:]], axis=0)
            if n_prefix:
                xattn_i = np.concatenate(
                    [xa_full[i, max_new:][p - n_prefix :], gen], axis=0
                )
            else:
                xattn_i = gen
        out.append((full, length, sum_lp[i], nsp[i], xattn_i))
    return out
