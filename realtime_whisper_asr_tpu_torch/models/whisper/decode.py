"""Greedy and sampled decoding under Whisper's logit rules, of one window or
of B streams'; the loop that beam search (``beam.py``) runs on too.

Port of the greedy path of ``realtime_whisper_asr_tpu/models/whisper/decode.py``:
one prefill pass (``decode_span``) over prompt + SOT sequence + forced prefix
+ self-speculative draft, a lossless verify of the draft from that pass, then
one ``decode_step`` per new token with the same selection function
(``_select_next``: suppress lists, blank/EOT rule, timestamp grammar with
monotonicity and the timestamp-probability rule, then argmax, or with
``temperature > 0`` the JAX package's seeded Gumbel-max sample,
``ops/threefry.py``). Per-row boundaries, caps, seeds and temperatures ride
in the same aux bundle as the JAX package's (``pack_aux``,
planned by ``plan_window``), and the result comes back as the same packed
buffer — tokens, sum logprob, no-speech probability and the uint8-quantized
cross-attention capture — in one device→host copy.

The reference runs the loop as one compiled ``jax.lax.while_loop``. Here
the loop body is one step over device state (``_step`` on a ``LoopState``:
the position is a device tensor, and a step past the loop's end is a no-op),
and ``DecodeLoop`` runs it K steps at a time between two host checks of the
end: on the card as a CUDA graph of K steps, captured once per loop shape
and replayed; on the CPU uncaptured, the plain version of the same loop.
The temperature's value rides in the aux bundle and the loop shape keeps only
whether it samples, so the quality-retry ladder's rungs replay one graph. A
beam search's loop shape (``LoopKey.beam_size``) runs ``beam._beam_step`` on
its own state, in the same ``DecodeLoop`` and graph pool.
The prefill reads nothing back, so a window costs at most ⌈(max_new − 1)/K⌉
host syncs plus one wait for the copy of its result.

``greedy_decode`` is ``greedy_decode_finalize(greedy_decode_dispatch(...))``,
as in the reference: the dispatch runs the prefill and the loop and starts
the device→host copy of the packed result on a copy stream, into pinned
memory, without waiting for it; the finalize waits for that copy and
unpacks. The pipelined streaming loop (``streaming/online.py``) puts the
next tick's work between the two, and its async mode reads the previous
tick's packed result on the card as the next draft
(``patch_aux_device_draft``).

``greedy_decode_batch`` (``plan_batch_aux``, then the dispatch and finalize
halves) decodes B streams' windows in one loop of batch B: each row's
prefix, cap and draft ride in its own aux row, every row at one prefill
bucket, as the multi-stream server (``serving.py``) needs.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from realtime_whisper_asr_tpu_torch.models.whisper.config import WhisperConfig
from realtime_whisper_asr_tpu_torch.models.whisper.model import DecoderCache, Whisper
from realtime_whisper_asr_tpu_torch.ops import int4_matmul, threefry
from realtime_whisper_asr_tpu_torch.utils.profiling import span

#: decode steps in one CUDA graph, and between two host checks of the loop's
#: end. A check idles the card ~0.1 ms, while the steps of the last replay
#: after EOT, ~(K - 1)/2 of ~5 ms each, change nothing but run (large-v3 on an
#: H100, tools/decode_k.py): 2 stays within half a step of K = 1's time
#: with half its checks
STEPS_PER_GRAPH = 2
#: loop shapes whose graphs a DecodeLoop keeps (the least recently used goes)
MAX_GRAPHS = 8


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Decoding options of the greedy path."""

    task: str = "transcribe"
    language: Optional[str] = "en"
    beam_size: int = 1
    max_new_tokens: int = 224
    max_total_tokens: Optional[int] = None  # cap on prefix+generated transcript length
    temperature: float = 0.0  # > 0 samples; the value rides per row in the aux bundle
    timestamps: bool = True
    max_initial_timestamp: float = 1.0
    suppress_blank: bool = True
    blank_id: int = 220  # GPT2 " " token
    word_timestamps: bool = False
    length_penalty: float = 1.0  # beam search's pick: score / length ** penalty


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
AUX_TOK = 384
DRAFT_MAX = 16
AUX_TEMP = AUX_TOK + 6 + DRAFT_MAX
AUX_LEN = AUX_TEMP + 1


def build_initial_tokens(
    cfg: WhisperConfig,
    opts: DecodeOptions,
    prompt_tokens: Optional[list[int]] = None,
    prefix_tokens: Optional[list[int]] = None,
    bucket: Optional[int] = None,
) -> tuple[np.ndarray, int, int]:
    """[sot_prev + pad + prompt?] + sot_seq + prefix?, bucketed.
    -> (tokens, sot_index, n_prefix).

    The bucket padding lives INSIDE the conditioning region ([sot_prev] +
    blanks), which Whisper treats as prior context — blank padding there is
    semantically inert, unlike padding the forced prefix would be.
    ``bucket`` forces the length (a batched decode needs every row at one
    prefill length); content longer than it sheds as an overflow does.
    """
    sot_seq = list(cfg.sot_sequence(opts.language, opts.task, timestamps=opts.timestamps))
    prefix = list(prefix_tokens or [])
    prompt = list(prompt_tokens or [])
    if prompt:
        prompt = prompt[-(cfg.n_text_ctx // 2 - 1) :]
    if not prompt and not prefix and bucket is None:
        return np.asarray(sot_seq, np.int32), 0, 0

    def shed(limit: int) -> int:
        """Shed the prefix TAIL first (the head must stay aligned with the
        audio window start — dropping it would make the model re-emit early
        content as duplicates), then the prompt's oldest tokens, until
        [sot_prev] + prompt + sot_seq + prefix fits ``limit``."""
        nonlocal prefix, prompt
        overflow = 1 + len(prompt) + len(sot_seq) + len(prefix) - limit
        if overflow > 0:
            drop = min(overflow, len(prefix))
            prefix = prefix[: len(prefix) - drop]
            prompt = prompt[overflow - drop :]
        return 1 + len(prompt) + len(sot_seq) + len(prefix)

    # reserve space: [sot_prev] + pad + prompt + sot_seq + prefix
    base = shed(min(cfg.n_text_ctx - 64, _PROMPT_BUCKETS[-1], AUX_TOK))
    target = _bucket(base) if bucket is None else bucket
    base = shed(target)
    pad = target - base
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
    seed: int = 0,
    max_new_cap: int = 10**6,
    draft: Optional[np.ndarray] = None,
    temperature: float = 0.0,
) -> np.ndarray:
    aux = np.zeros(AUX_LEN, np.float32)
    aux[: len(init)] = init.astype(np.float32)
    aux[AUX_TOK] = n_prefix
    aux[AUX_TOK + 1] = sot_index
    aux[AUX_TOK + 2] = last_ts
    aux[AUX_TOK + 3] = seed
    aux[AUX_TOK + 4] = max_new_cap
    if draft is not None and len(draft):
        d = np.asarray(draft, np.float32)[:DRAFT_MAX]
        aux[AUX_TOK + 5] = len(d)
        aux[AUX_TOK + 6 : AUX_TOK + 6 + len(d)] = d
    aux[AUX_TEMP] = temperature
    return aux


def patch_aux_device_draft(
    aux: torch.Tensor,
    prev_packed: torch.Tensor,
    offset: int,
    prev_max_new: int,
    prev_row_len: int,
    eot: int,
    force: bool = False,
    safety: int = 4,
) -> None:
    """Write the previous tick's sampled tokens, still on the card in its
    packed result, into the draft slots of this tick's aux bundle ``aux``
    (B, AUX_LEN), in place: the device-side draft of the async-pipelined
    streaming loop, with no read back to the host.

    In async mode tick N is dispatched before tick N−1's result reaches the
    host, so the host can force a prefix only from hypothesis N−2. The draft
    is hypothesis N−1's continuation beyond this tick's prefix (``offset`` =
    len(prefix_N) − len(prefix_{N−1}), known on the host), up to and
    including its first EOT; slots past it are zeroed. The prefill verifies
    it (lossless: a revised hypothesis rejects from its first mismatch).

    ``force`` (prefix policy "last"): the draft minus its EOT and its last
    ``safety`` tokens is forced rather than verified, the policy's own
    semantics applied to hypothesis N−1; the length is then stored negative
    (``_prefill`` reads the sign)."""
    b = aux.shape[0]
    dev = prev_packed.device
    tokens = prev_packed.reshape(b, prev_row_len)[:, :prev_max_new]  # f32 ids
    is_eot = tokens == eot
    any_eot = is_eot.any(dim=1)
    # the valid length: through the first EOT (argmax returns the first maximum)
    n_valid = torch.where(any_eot, is_eot.long().argmax(dim=1) + 1, prev_max_new)
    start = min(max(offset, 0), prev_max_new - 1)
    slots = torch.arange(DRAFT_MAX, device=dev)
    draft = tokens.index_select(1, (start + slots).clamp(max=prev_max_new - 1))
    n_avail = (n_valid - start).clamp(0, DRAFT_MAX)
    if force:  # never force the EOT or the unstable tail
        n_avail = (torch.where(any_eot, n_avail - 1, n_avail) - safety).clamp(0, DRAFT_MAX)
    aux[:, AUX_TOK + 5] = (-n_avail if force else n_avail).to(aux.dtype)
    aux[:, AUX_TOK + 6 : AUX_TOK + 6 + DRAFT_MAX] = torch.where(
        slots[None, :] < n_avail[:, None], draft, 0.0)


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


def _filter_logits(cfg, opts, logits, tokens, pos, last_ts, n_prefix, p, sup_mask):
    """All Whisper logit rules at per-row positions ``pos`` (R,): logits
    (R, V) f32 -> the filtered logits, -inf where a rule forbids a token.
    tokens (R, T) the history; last_ts, n_prefix (R,)."""
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
    return flogits


def _select_next(cfg, opts, logits, tokens, pos, last_ts, n_prefix, p, sup_mask, seed, temp):
    """``_filter_logits``, then the next token: argmax, or with
    ``opts.temperature > 0`` the seeded Gumbel-max sample of each row's
    ``seed`` and temperature ``temp`` (R,) at its position
    (``threefry.sample``). Returns (next token (R,), its logprob (R,))."""
    flogits = _filter_logits(cfg, opts, logits, tokens, pos, last_ts, n_prefix, p, sup_mask)
    if opts.temperature > 0:
        nxt = threefry.sample(flogits, seed, pos, temp)
    else:
        nxt = flogits.argmax(dim=-1)  # first maximum, as jnp.argmax
    lp = torch.log_softmax(flogits, dim=-1).gather(1, nxt[:, None])[:, 0]
    return nxt, lp


@dataclasses.dataclass
class LoopState:
    """The device state of one window's decode loop: every tensor the step
    reads or writes, each updated in place (a captured loop replays on these
    very buffers). Rows share one position."""

    cache: DecoderCache
    tokens: torch.Tensor  # (B, p + max_new) long: initial tokens, draft, then sampled
    xattn: Optional[torch.Tensor]  # (B, max_new, audio_ctx) f32 capture rows, or None
    finished: torch.Tensor  # (B,) bool
    sum_lp: torch.Tensor  # (B,) f32 over sampled tokens
    last_ts: torch.Tensor  # (B,) long: the last timestamp token so far, or -1
    pos: torch.Tensor  # () long: the position the next step writes
    total: torch.Tensor  # (B,) long: each row's exact cap, ≤ p + max_new
    max_total: torch.Tensor  # () long: the loop's end
    n_prefix: torch.Tensor  # (B,) long
    seed: torch.Tensor  # (B,) long: each row's sampling seed
    temp: torch.Tensor  # (B,) f32: each row's temperature (read only when sampling)

    def ended(self) -> torch.Tensor:
        """() bool on the device: every row finished, or ``pos`` at the end."""
        return self.finished.all() | (self.pos >= self.max_total)


@dataclasses.dataclass(frozen=True)
class LoopKey:
    """What a captured loop bakes in: the model (and so its tier, dtype and
    cache kind: ``int8-kv``'s int8 rows and scales are another state),
    the window bucket (audio_ctx), the prompt length p, the loop bound
    max_new, the self cache length, the draft slots, batch rows (streams, for
    a beam search), and what the step reads from outside its state (the
    selection options, with the temperature collapsed to 0 or 1 and the beam
    size, the suppressed ids, the alignment heads when capturing)."""

    model_id: int
    audio_ctx: int
    p: int
    max_new: int
    cache_len: int
    draft_max: int
    batch: int
    opts: DecodeOptions
    extra_suppress: tuple[int, ...]
    heads_key: Optional[bytes]

    @property
    def beam_size(self) -> int:
        return self.opts.beam_size


def _new_state(model: Whisper, key: LoopKey, dtype, device) -> LoopState:
    b = key.batch

    def zeros(*shape, dtype=torch.long):
        return torch.zeros(shape, dtype=dtype, device=device)

    return LoopState(
        cache=model.empty_cache(b, key.audio_ctx, key.cache_len, dtype, device),
        tokens=zeros(b, key.p + key.max_new),
        xattn=(zeros(b, key.max_new, key.audio_ctx, dtype=torch.float32)
               if key.opts.word_timestamps else None),
        finished=zeros(b, dtype=torch.bool), sum_lp=zeros(b, dtype=torch.float32),
        last_ts=zeros(b), pos=zeros(), total=zeros(b), max_total=zeros(), n_prefix=zeros(b),
        seed=zeros(b), temp=zeros(b, dtype=torch.float32),
    )


def _keep(go: torch.Tensor, new: torch.Tensor, buf: torch.Tensor, dim: int,
          index: torch.Tensor) -> None:
    """buf's slice at ``index`` along ``dim`` becomes ``new`` where ``go``,
    and keeps its value elsewhere (a masked write with no host branch)."""
    buf.index_copy_(dim, index, torch.where(go, new, buf.index_select(dim, index)))


def _advance(cfg, st: LoopState, at: torch.Tensor, go: torch.Tensor, nxt, lp) -> None:
    """Write the token at position ``at`` and move ``pos`` on, where ``go``;
    rows at their cap freeze like EOT'd rows (they write EOT)."""
    done = st.finished | (at >= st.total)
    nxt = torch.where(done, cfg.eot, nxt)
    _keep(go, nxt[:, None], st.tokens, 1, at.view(1))
    st.sum_lp.copy_(torch.where(go, st.sum_lp + torch.where(done, 0.0, lp), st.sum_lp))
    st.last_ts.copy_(torch.where(go & (nxt >= cfg.timestamp_begin) & ~done, nxt, st.last_ts))
    st.finished.copy_(st.finished | (go & (nxt == cfg.eot)))
    st.pos.add_(go.long())


def _step(model: Whisper, opts: DecodeOptions, st: LoopState, sup_mask: torch.Tensor,
          amask: Optional[torch.Tensor], p: int) -> None:
    """One step of the loop, in place on ``st`` and on device tensors only
    (no host value changes from step to step: this is what a CUDA graph
    captures): decode the token before ``pos``, select the next under the
    logit rules, write it and its capture row.

    A step taken after the loop's end (every row finished, or ``pos`` at the
    largest cap: the reference's ``while_loop`` condition) is a no-op on
    every buffer: its indices are clamped into range and each write keeps
    the old value, so the K steps between two host checks may overrun the
    end harmlessly."""
    cfg = model.cfg
    t = st.tokens.shape[1]
    go = ~st.finished.all() & (st.pos < st.max_total)
    at = st.pos.clamp(1, t - 1)  # equals pos wherever go
    prev = (at - 1).view(1)
    bufs = st.cache.self_buffers()  # self K/V, and their scales under int8-kv
    old = [buf.index_select(3, prev) for buf in bufs]
    logits, xw = model.decode_step(st.tokens.index_select(1, prev)[:, 0], at - 1, st.cache,
                                   alignment_mask=amask)
    for buf, kept in zip(bufs, old):  # undo the write where not go
        buf.index_copy_(3, prev, torch.where(go, buf.index_select(3, prev), kept))
    nxt, lp = _select_next(cfg, opts, logits, st.tokens, at.expand(st.tokens.shape[0]),
                           st.last_ts, st.n_prefix, p, sup_mask, st.seed, st.temp)
    if st.xattn is not None:
        _keep(go, xw[:, None], st.xattn, 1, (at - p).clamp(0, st.xattn.shape[1] - 1).view(1))
    _advance(cfg, st, at, go, nxt, lp)


def _prefill(model: Whisper, opts: DecodeOptions, xa: torch.Tensor, aux: torch.Tensor,
             sup_mask: torch.Tensor, amask: Optional[torch.Tensor], st: LoopState,
             p: int, draft_max: int) -> tuple[Optional[torch.Tensor], torch.Tensor]:
    """The window's prefill, eager, into the loop state ``st``: cross K/V
    and a zeroed self cache, one ``decode_span`` over the initial tokens and
    the draft, the draft's verify, and the first sampled token. Reads
    nothing back to the host: the accepted draft length stays on the device
    and seeds ``pos``. Returns (prefill capture rows or None, no-speech
    probability).

    Self-speculative decode (draft_max > 0): the prefill span is
    init || draft, where draft is the previous tick's hypothesis tail beyond
    the forced prefix. That one pass yields the model's choice at every draft
    position under the same rules as the loop, so the longest agreeing draft
    prefix (+1 bonus token from the first divergent position) is accepted
    wholesale and the loop starts past it. Lossless: the verifier IS the
    loop's own selection function."""
    cfg = model.cfg
    b, dev = xa.shape[0], xa.device
    max_new = st.tokens.shape[1] - p
    st.temp.copy_(aux[:, AUX_TEMP])
    aux = aux.long()  # every other slot read here holds an integer
    st.seed.copy_(aux[:, AUX_TOK + 3])
    initial_tokens = aux[:, :p]
    n_prefix = aux[:, AUX_TOK]
    sot_index = aux[:, AUX_TOK + 1]
    last_ts_init = aux[:, AUX_TOK + 2]
    total = torch.clamp(p + aux[:, AUX_TOK + 4], max=p + max_new)  # exact per-row cap
    n_draft = aux[:, AUX_TOK + 5]
    draft_tok = aux[:, AUX_TOK + 6 : AUX_TOK + 6 + draft_max]
    # pad rows beyond each row's draft with EOT (never matches a real choice,
    # and keeps the span's token ids in-vocab); a negative n_draft is a
    # forced draft of |n_draft| tokens (patch_aux_device_draft)
    draft_tok = torch.where(
        torch.arange(draft_max, device=dev)[None, :] < n_draft.abs()[:, None], draft_tok, cfg.eot)
    ts0 = cfg.timestamp_begin

    model.fill_cache(xa, st.cache)
    span = torch.cat([initial_tokens, draft_tok], dim=1)
    pre_logits, pre_xattn = model.decode_span(span, 0, st.cache, alignment_mask=amask)
    sot_logits = pre_logits[torch.arange(b, device=dev), sot_index]
    no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, cfg.no_speech]

    st.tokens[:, : p + draft_max] = span
    st.tokens[:, p + draft_max :] = cfg.eot
    if st.xattn is not None:
        st.xattn.zero_()
        # accepted draft tokens' capture rows come from the prefill span;
        # slots past acceptance are overwritten as the loop re-decodes them
        slots = min(draft_max, max_new - 1)
        st.xattn[:, 1 : slots + 1] = pre_xattn[:, p : p + slots]

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
    choices, lps = _select_next(cfg, opts, lg.reshape(k * b, -1), st.tokens.repeat(k, 1),
                                positions.repeat_interleave(b), lts_all.reshape(-1),
                                n_prefix.repeat(k), p, sup_mask, st.seed.repeat(k),
                                st.temp.repeat(k))
    choices, lps = choices.view(k, b), lps.view(k, b)

    if draft_max:
        iidx = torch.arange(draft_max, device=dev)[:, None]
        match = (((choices[:draft_max] == draft_tok.t()) | (n_draft < 0)[None, :])
                 & (iidx < n_draft.abs()[None, :]) & ((p + iidx) < total[None, :]))
        acc_row = torch.cumprod(match.long(), dim=0).sum(dim=0)  # (B,)
        # one shared position: accept the min across rows, keep a slot free
        # for the bonus token
        n_acc = torch.clamp(acc_row.min(), max=max_new - 1)
        st.sum_lp.copy_(torch.where(iidx < n_acc, lps[:draft_max], 0.0).sum(dim=0))
    else:
        n_acc = torch.zeros((), dtype=torch.long, device=dev)
        st.sum_lp.zero_()
    acc = n_acc.view(1)
    st.total.copy_(total)
    st.max_total.copy_(total.max())
    st.n_prefix.copy_(n_prefix)
    st.finished.zero_()
    st.last_ts.copy_(lts_all.index_select(0, acc)[0])
    at = p + n_acc
    st.pos.copy_(at)
    _advance(cfg, st, at, torch.ones((), dtype=torch.bool, device=dev),
             choices.index_select(0, acc)[0], lps.index_select(0, acc)[0])
    return pre_xattn, no_speech_prob


def _pack(st: LoopState, pre_xattn: Optional[torch.Tensor], no_speech_prob: torch.Tensor,
          p: int) -> torch.Tensor:
    """ONE flat f32 buffer for the host: token ids (< 2^24, exact in f32),
    sum logprob, no-speech probability and the capture — softmax weights in
    [0, 1] quantized to uint8 (x255), four per f32 word: sampled rows, then
    the init prefill block (draft span rows were folded into the slots)."""
    b = st.tokens.shape[0]
    parts = [st.tokens[:, p:].float(), st.sum_lp[:, None], no_speech_prob[:, None]]
    if st.xattn is not None:
        xa_all = torch.cat([st.xattn.reshape(b, -1), pre_xattn[:, :p].reshape(b, -1)], dim=1)
        q = torch.clamp(torch.round(xa_all * 255.0), 0, 255).to(torch.uint8)
        parts.append(q.view(torch.float32))
    return torch.cat(parts, dim=1).reshape(-1)


@dataclasses.dataclass
class _Loop:
    """One loop shape's state and how K steps run on it."""

    state: LoopState
    run_k: Callable[[], None]
    reads: tuple  # what the step reads besides its state, kept alive with a graph


def _state_bytes(st) -> int:
    """The bytes of a loop state's tensors (greedy or beam), cache included."""
    tensors = [getattr(st.cache, f.name) for f in dataclasses.fields(st.cache)]
    tensors += [getattr(st, f.name) for f in dataclasses.fields(st)][1:]
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _loop_parts(model: Whisper, key: LoopKey, dtype, device, sup_mask: torch.Tensor,
                amask: Optional[torch.Tensor]):
    """(new state, its step) of ``key``'s loop: the greedy ``_step`` on a
    ``LoopState``, or beam search's ``beam._beam_step`` on a ``BeamState``."""
    if key.beam_size > 1:
        from realtime_whisper_asr_tpu_torch.models.whisper import beam

        st = beam.new_state(model, key, dtype, device)
        return st, functools.partial(beam._beam_step, model, key.opts, st, sup_mask, amask,
                                     key.p)
    st = _new_state(model, key, dtype, device)
    return st, functools.partial(_step, model, key.opts, st, sup_mask, amask, key.p)


class DecodeLoop:
    """Runs windows' decode loops: the step (``_step``, or a beam search's
    ``beam._beam_step``) K times between two host checks of the loop's end,
    so one window's loop costs at most
    ⌈(max_new − 1)/K⌉ host syncs (the prefill none).

    On the card the K steps are one CUDA graph, captured once per loop shape
    (``LoopKey``) on that shape's own state buffers, after one warm-up step
    on a side stream, and replayed; the ``MAX_GRAPHS`` most recently used
    shapes are kept, their scratch memory in one shared pool. On the CPU
    the same step runs uncaptured: the plain version of the captured loop.
    Pass one ``DecodeLoop`` to every window of a model: a new one captures
    anew.

    ``stats``: captures, their seconds, the graph pool's bytes after the
    last capture, the state bytes the captures allocated, replays, warm-up
    steps, uncaptured steps and host checks, loop shapes dropped past
    ``MAX_GRAPHS`` (``evictions``) and captures of a shape captured before
    and dropped (``recaptures``), since construction."""

    def __init__(self, k: int = STEPS_PER_GRAPH):
        if k < 1:
            raise ValueError(f"DecodeLoop takes k >= 1, got {k}")
        self.k = k
        self._graphs: collections.OrderedDict[LoopKey, _Loop] = collections.OrderedDict()
        # one pool and one capture stream for all graphs: the allocator reuses
        # a block only on the stream that freed it, so a capture on a stream of
        # its own could not reuse the scratch the earlier captures freed
        self._pool = self._stream = self._copy_stream = None
        self._captured: set[LoopKey] = set()  # every shape captured so far
        self.stats = {"captures": 0, "capture_s": 0.0, "graph_bytes": 0, "state_bytes": 0,
                      "replays": 0, "warmup_steps": 0, "eager_steps": 0, "checks": 0,
                      "evictions": 0, "recaptures": 0}

    def copy_stream(self, device: torch.device) -> torch.cuda.Stream:
        """The stream the windows' results are copied to the host on."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        return self._copy_stream

    def loop(self, model: Whisper, key: LoopKey, dtype, device, sup_mask: torch.Tensor,
             amask: Optional[torch.Tensor], captured: bool) -> _Loop:
        """The loop of ``key``: on the card (``captured``) its graph, captured
        at first use; otherwise new state and K uncaptured steps."""
        if not captured:
            st, step = _loop_parts(model, key, dtype, device, sup_mask, amask)

            def run_k():
                for _ in range(self.k):
                    step()
                self.stats["eager_steps"] += self.k

            return _Loop(st, run_k, ())
        hit = self._graphs.get(key)
        if hit is not None:
            self._graphs.move_to_end(key)
            return hit
        if key in self._captured:
            self.stats["recaptures"] += 1
        self._captured.add(key)
        loop = self._graphs[key] = self._capture(model, key, dtype, device, sup_mask, amask)
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
            self.stats["evictions"] += 1
        return loop

    def _capture(self, model, key, dtype, device, sup_mask, amask) -> _Loop:
        """K steps captured in one CUDA graph on new state buffers. A capture
        that fails raises; nothing falls back to the uncaptured loop."""
        with span("decode.capture") as timed:
            st, step = _loop_parts(model, key, dtype, device, sup_mask, amask)
            st.finished.fill_(True)  # the warm-up step is then a no-op on every buffer
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(device)
            side = self._stream
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):  # first-use allocations and library handles
                step()
            torch.cuda.current_stream(device).wait_stream(side)
            self.stats["warmup_steps"] += 1
            graph = torch.cuda.CUDAGraph()
            launched = int4_matmul.int4_launches
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                for _ in range(self.k):
                    step()
            # a capture records K2's launches; each replay makes them
            per_replay = int4_matmul.int4_launches - launched
            int4_matmul.int4_launches = launched

        def run_k():
            graph.replay()
            int4_matmul.int4_launches += per_replay
            self.stats["replays"] += 1

        self.stats["captures"] += 1
        self.stats["capture_s"] += timed.t1 - timed.t0
        self.stats["graph_bytes"] = sum(  # the shared pool's segments, now
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == tuple(self._pool))
        self.stats["state_bytes"] += _state_bytes(st)
        return _Loop(st, run_k, (model, sup_mask, amask))

    def run(self, loop: _Loop, steps_max: int) -> None:
        """At most ``steps_max`` steps (the host's bound from the plan), K at
        a time, with one host check of the loop's end before each K: the only
        device reads of the loop."""
        st = loop.state
        with span("decode.loop"):
            while steps_max > 0:
                self.stats["checks"] += 1
                with span("decode.check"):
                    ended = bool(st.ended())  # one sync per K steps
                if ended:
                    return
                loop.run_k()
                steps_max -= self.k


@torch.inference_mode()
def _decode_window(model: Whisper, opts: DecodeOptions, xa: torch.Tensor, aux: torch.Tensor,
                   plan: "WindowPlan | BatchPlan", extra_suppress: tuple[int, ...],
                   alignment_heads: Optional[np.ndarray], loop: DecodeLoop,
                   captured: bool) -> torch.Tensor:
    """The decode of one planned window, or of B streams' windows at one
    bucket (prefill, then the loop: captured on the card, uncaptured where
    ``captured`` is false), returning the packed result (flat f32) on xa's
    device. ``aux`` (B, AUX_LEN) on xa's device. A beam search
    (``opts.beam_size`` > 1) runs ``beam.py``'s prefill and pack around the
    same loop, and ignores any draft."""
    cfg = model.cfg
    p = plan.p
    # the loop shape keeps only whether it samples: the value is in aux
    opts = dataclasses.replace(opts, temperature=1.0 if opts.temperature > 0 else 0.0)
    beam_size = opts.beam_size
    heads_key = (None if alignment_heads is None
                 else np.ascontiguousarray(alignment_heads, np.float32).tobytes())
    sup_mask = _sup_mask_dev(cfg, tuple(extra_suppress), xa.device)
    amask = _amask_dev(cfg, heads_key, xa.device) if opts.word_timestamps else None
    draft_max = 0 if beam_size > 1 else plan.draft_max
    key = LoopKey(id(model), int(xa.shape[1]), p, plan.max_new,
                  min(cfg.n_text_ctx, _round_up(p + plan.max_new, 128)), draft_max,
                  int(xa.shape[0]), opts, tuple(extra_suppress), heads_key)
    run = loop.loop(model, key, xa.dtype, xa.device, sup_mask, amask, captured)
    # the host's bound on the loop's steps: the first token came from the
    # prefill, and no row goes past its cap (the plan's, ≤ max_new)
    steps_max = min(plan.cap, plan.max_new) - 1
    if beam_size > 1:
        from realtime_whisper_asr_tpu_torch.models.whisper import beam

        with span("decode.prefill"):
            pre_xattn, no_speech_prob = beam._prefill(model, opts, xa, aux, sup_mask, amask,
                                                      run.state, p)
        loop.run(run, steps_max)
        with span("decode.pack"):
            return beam._pack(run.state, pre_xattn, no_speech_prob, p, cfg.eot,
                              opts.length_penalty)
    with span("decode.prefill"):
        pre_xattn, no_speech_prob = _prefill(model, opts, xa, aux, sup_mask, amask, run.state,
                                             p, draft_max)
    loop.run(run, steps_max)
    with span("decode.pack"):
        return _pack(run.state, pre_xattn, no_speech_prob, p)


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

    @property
    def p(self) -> int:
        return int(self.init.shape[0])

    @property
    def cap(self) -> int:
        """The exact cap on sampled tokens, as the aux bundle holds it now."""
        return int(self.aux[AUX_TOK + 4])


def plan_window(
    cfg: WhisperConfig,
    opts: DecodeOptions,
    prompt_tokens: Optional[list[int]] = None,
    prefix_tokens: Optional[list[int]] = None,
    draft_tokens: Optional[list[int]] = None,
    force_draft_bucket: bool = False,
    bucket: Optional[int] = None,
    seed: int = 0,
) -> WindowPlan:
    """Initial tokens, budget and aux bundle of one window. ``draft_tokens``
    (the previous hypothesis's tail beyond the forced prefix) enables the
    lossless self-speculative fast path. ``force_draft_bucket``: the
    DRAFT_MAX draft span with no host draft, for a caller that writes a
    device-side draft into the uploaded aux (``patch_aux_device_draft``).
    ``bucket``: the prefill length (``build_initial_tokens``). ``seed`` and
    ``opts.temperature`` go into the aux bundle for a sampled decode."""
    init, sot_index, n_prefix = build_initial_tokens(cfg, opts, prompt_tokens, prefix_tokens,
                                                     bucket)
    ts_in_prefix = [int(t) for t in init[len(init) - n_prefix :] if t >= cfg.timestamp_begin]
    max_new, max_new_cap = plan_decode_budget(cfg, opts, int(init.shape[0]), n_prefix)
    if force_draft_bucket:
        draft_tokens = None
    aux = pack_aux(
        init, n_prefix, sot_index, ts_in_prefix[-1] if ts_in_prefix else -1, seed=seed,
        max_new_cap=max_new_cap, draft=np.asarray(draft_tokens or [], np.int32),
        temperature=opts.temperature,
    )
    draft_max = DRAFT_MAX if (draft_tokens or force_draft_bucket) else 0
    return WindowPlan(init, n_prefix, max_new, draft_max, aux)


def batch_draft_bucket(rows: list[WindowPlan]) -> int:
    """The draft slots of one batched decode: DRAFT_MAX only when EVERY row
    carries a draft. Acceptance is the batch minimum (``_prefill``), so one
    draft-less row (a new or reset stream, common in serving groups) would
    accept nothing for the whole group while every row still paid the
    DRAFT_MAX prefill span."""
    return DRAFT_MAX if all(row.aux[AUX_TOK + 5] > 0 for row in rows) else 0


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """The decode plan of B streams' windows at one prefill bucket ``p``:
    each row's own plan (its initial tokens at length p, forced prefix, cap
    and draft in its aux row), and the loop bound ``max_new``, the largest
    of the rows'."""

    rows: list[WindowPlan]
    p: int
    max_new: int

    @property
    def draft_max(self) -> int:
        return batch_draft_bucket(self.rows)

    @property
    def cap(self) -> int:
        """The largest of the rows' exact caps, as their aux rows hold them now."""
        return max(row.cap for row in self.rows)

    @property
    def aux(self) -> np.ndarray:
        """(B, AUX_LEN) f32: the rows' aux bundles."""
        return np.stack([row.aux for row in self.rows])


def plan_batch_aux(cfg: WhisperConfig, opts: DecodeOptions, requests: list[dict]) -> BatchPlan:
    """The host half of a batched decode: each request's window plan at one
    common prefill bucket (the largest of the rows' own). A request is
    ``{"prompt_tokens", "prefix_tokens", "draft_tokens", "seed"}``, each
    optional; the rows may be at different streaming states."""
    p = _bucket(max(build_initial_tokens(cfg, opts, r.get("prompt_tokens"),
                                         r.get("prefix_tokens"))[0].shape[0] for r in requests))
    rows = [plan_window(cfg, opts, r.get("prompt_tokens"), r.get("prefix_tokens"),
                        r.get("draft_tokens"), bucket=p, seed=int(r.get("seed", 0)))
            for r in requests]
    return BatchPlan(rows, p, max(row.max_new for row in rows))


@dataclasses.dataclass
class DecodeHandle:
    """A dispatched window's decode: its packed result on the card (kept
    alive: the next async tick reads it as its draft), the pinned host
    buffer its copy is filling, the event after the copy (``done``, on the
    copy stream; None on the CPU, where the result is already on the host),
    and what the unpack needs."""

    packed: torch.Tensor
    host: torch.Tensor
    done: Optional[torch.cuda.Event]
    cfg: WhisperConfig
    plan: "WindowPlan | BatchPlan"  # a window's, or a batched decode's
    b: int
    audio_ctx: int
    capture: bool


def _copy_to_host(packed: torch.Tensor, loop: DecodeLoop):
    """Start the device→host copy of ``packed`` without waiting for it:
    into pinned memory, on ``loop``'s copy stream, after the compute
    stream's work so far. -> (host buffer, event after the copy).
    ``record_stream`` keeps the allocator from reusing ``packed`` under the
    pending copy; the pinned buffer's own allocator records the copy's event
    and reuses the buffer only after it, however early the handle is
    dropped. A CPU tensor is the host buffer itself."""
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    stream = loop.copy_stream(packed.device)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(packed.device))
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        host.copy_(packed, non_blocking=True)
    packed.record_stream(stream)
    done = torch.cuda.Event()
    done.record(stream)
    return host, done


def greedy_decode_dispatch(
    model: Whisper,
    xa: torch.Tensor,
    opts: DecodeOptions,
    plan: WindowPlan,
    aux: torch.Tensor,
    extra_suppress: tuple[int, ...] = (),
    alignment_heads: Optional[np.ndarray] = None,
    loop: Optional[DecodeLoop] = None,
) -> DecodeHandle:
    """The decode of one planned window up to its result's copy: the
    prefill, the loop (its host checks are the only waits) and the pack,
    then the copy of the packed result to the host started, not waited for.
    ``aux`` is ``plan.aux`` on xa's device (the ASR uploads it with the
    audio). On the card the loop runs as ``loop``'s CUDA graphs (a new
    ``DecodeLoop`` when None: pass the same one to every window of a model
    to reuse its graphs), on the CPU uncaptured."""
    b = xa.shape[0]
    return _dispatch(model, xa, dataclasses.replace(opts, beam_size=1), plan,
                     aux.reshape(-1, AUX_LEN).expand(b, AUX_LEN), extra_suppress,
                     alignment_heads, loop)


def _dispatch(model, xa, opts, plan, aux, extra_suppress, alignment_heads, loop) -> DecodeHandle:
    loop = loop or DecodeLoop()
    packed = _decode_window(model, opts, xa, aux, plan, tuple(extra_suppress), alignment_heads,
                            loop, captured=xa.device.type == "cuda")
    with span("decode.pack"):
        host, done = _copy_to_host(packed, loop)
    return DecodeHandle(packed, host, done, model.cfg, plan, xa.shape[0], xa.shape[1],
                        opts.word_timestamps)


def _fetch(handle: DecodeHandle) -> np.ndarray:
    """Wait for a dispatched decode's result copy (its one wait, the
    ``asr.fetch_wait`` span; nothing else touches the card) -> the packed
    result on the host."""
    with span("asr.fetch_wait"):
        if handle.done is not None:
            handle.done.synchronize()
    return handle.host.numpy()


def greedy_decode_finalize(handle: DecodeHandle) -> DecodeResult:
    """Wait for the dispatched window's result copy and unpack it
    (``_fetch``). Returns tokens = prefix + sampled (xattn rows aligned), so
    callers parse one transcript regardless of how much was forced."""
    plan, b = handle.plan, handle.b
    flat = _fetch(handle)
    with span("asr.parse"):
        rows = _unpack_packed_rows(flat, handle.cfg, b, plan.p, plan.max_new,
                                   handle.capture, handle.audio_ctx, [plan.prefix] * b)
    lengths = np.array([r[1] for r in rows], np.int64)
    sum_lp = np.array([r[2] for r in rows], np.float64)
    return DecodeResult(
        tokens=np.stack([r[0] for r in rows]),
        lengths=lengths,
        sum_logprob=sum_lp,
        avg_logprob=sum_lp / np.maximum(lengths - plan.n_prefix, 1),
        no_speech_prob=np.array([r[3] for r in rows]),
        xattn=np.stack([r[4] for r in rows]) if handle.capture else None,
    )


def greedy_decode(
    model: Whisper,
    xa: torch.Tensor,
    opts: DecodeOptions,
    plan: WindowPlan,
    aux: torch.Tensor,
    extra_suppress: tuple[int, ...] = (),
    alignment_heads: Optional[np.ndarray] = None,
    loop: Optional[DecodeLoop] = None,
) -> DecodeResult:
    """Run the decode of one planned window and unpack its result:
    ``greedy_decode_finalize(greedy_decode_dispatch(...))``."""
    return greedy_decode_finalize(greedy_decode_dispatch(
        model, xa, opts, plan, aux, extra_suppress, alignment_heads, loop))


def greedy_decode_batch_dispatch(
    model: Whisper,
    xa: torch.Tensor,
    opts: DecodeOptions,
    plan: BatchPlan,
    aux: Optional[torch.Tensor] = None,
    extra_suppress: tuple[int, ...] = (),
    alignment_heads: Optional[np.ndarray] = None,
    loop: Optional[DecodeLoop] = None,
) -> DecodeHandle:
    """The dispatch half of a batched decode: B streams' windows, one row
    each of ``xa`` (B, audio_ctx, d), decoded in one loop (one graph of
    batch B on the card) up to the start of the result's copy. ``aux``
    (B, AUX_LEN) on xa's device holds the rows' own aux bundles (the ASR
    uploads them with the audio); ``plan.aux`` is uploaded when None."""
    if len(plan.rows) != xa.shape[0]:
        raise ValueError(f"{len(plan.rows)} planned rows for a batch of {xa.shape[0]}")
    if aux is None:
        aux = torch.from_numpy(plan.aux).to(xa.device)
    return _dispatch(model, xa, dataclasses.replace(opts, beam_size=1), plan, aux,
                     extra_suppress, alignment_heads, loop)


def greedy_decode_batch_finalize(handle: DecodeHandle) -> list[DecodeResult]:
    """The finalize half of a batched decode: wait for the result's copy
    (``_fetch``) and unpack one ``DecodeResult`` (batch 1) per row, each
    with the row's own prefix."""
    plan = handle.plan
    flat = _fetch(handle)
    with span("asr.parse"):
        rows = _unpack_packed_rows(flat, handle.cfg, handle.b, plan.p, plan.max_new,
                                   handle.capture, handle.audio_ctx, [r.prefix for r in plan.rows])
    results = []
    for (full, length, lp, nsp, xattn), row in zip(rows, plan.rows):
        results.append(DecodeResult(
            tokens=full[None], lengths=np.array([length], np.int64),
            sum_logprob=np.array([lp], np.float64),
            avg_logprob=np.array([lp / max(length - row.n_prefix, 1)], np.float64),
            no_speech_prob=np.asarray([nsp]), xattn=None if xattn is None else xattn[None]))
    return results


def greedy_decode_batch(
    model: Whisper,
    xa: torch.Tensor,
    opts: DecodeOptions,
    requests: list[dict],
    **kw,
) -> list[DecodeResult]:
    """Batched multi-stream greedy decode: B streams' windows in one loop.

    Each request (``plan_batch_aux``) may be at a different streaming state:
    per-row prefixes, initial-rule gating and caps ride in the (B, AUX_LEN)
    aux rows, and every row shares one prefill bucket (bucket padding is
    inert, ``build_initial_tokens``). The rows share one position, so the
    draft acceptance is the batch minimum. The capacity lever: a decode step
    at batch 1 streams all the decoder's weights for one row, so B rows cost
    little more than one."""
    plan = plan_batch_aux(model.cfg, opts, requests)
    return greedy_decode_batch_finalize(greedy_decode_batch_dispatch(model, xa, opts, plan, **kw))


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
