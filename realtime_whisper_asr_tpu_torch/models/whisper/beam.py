"""Beam search over B streams' windows, on the greedy path's decode loop.

Port of ``realtime_whisper_asr_tpu/models/whisper/beam.py``. Each stream's
prompt and prefix go through one prefill at batch 1 a stream, whose self K/V
every beam then starts from, and its last logits row seeds the first
expansion. A step decodes the K beams of each stream at once and re-selects
them: finished beams extend only with EOT at zero cost, the K best of the
K·V candidates are taken with JAX's tie order (the lower flat index first),
and each beam takes its parent's tokens, last timestamp, finished flag and
ancestry. The winner is picked by score / length ** length_penalty, the EOT
counted only where one was sampled, and comes back in one packed row a
stream: tokens, score, length, no-speech probability and, with word
timestamps, its cross-attention capture uint8-packed.

Rows stay physical. A stream's K beams keep their self K/V in one block of
K·T positions (``Whisper.decode_step``'s ``beam_ancestry``): beam j writes
row j, and a beam reads each position of its history from the row an
ancestry table (B, K, K, T) names, so nothing is ever reordered. The capture
rows stay physical as well: a step stores each row's cross-attention row in
that row's own buffer, and the pack reads the winner's rows through the same
table (position t's row holds the capture of the query at t), the same
values a per-step gather of the capture buffer would give. The cross K/V is
the stream's, read once for its K beams.

The loop runs like the greedy one: ``_beam_step`` is one step over device
state (``BeamState``), in place, a no-op on every buffer of a stream that has
ended (all its beams finished, or at its cap: each stream of a batch stops on
its own, as the JAX package's ``vmap`` of per-stream loops), and
``decode.DecodeLoop`` runs it K steps between two host checks, as CUDA graphs
on the card (one per loop shape, ``LoopKey.beam_size`` in the shape) and
uncaptured on the CPU. The temperature, the seed and any draft play no part
in a beam search.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper.model import DecoderCache, Whisper
from realtime_whisper_asr_tpu_torch.utils.profiling import span

AUX_CAP = D.AUX_TOK + 4  # the exact cap's slot of the aux bundle


@dataclasses.dataclass
class BeamState:
    """The device state of a beam search over B streams of K beams, each
    tensor updated in place (a captured loop replays on these buffers).
    Streams share one position while they run."""

    cache: DecoderCache  # self (L, B, H, K·T, Dh): a block of K rows a stream; cross at B
    tokens: torch.Tensor  # (B, K, p + max_new) long
    xcap: Optional[torch.Tensor]  # (B, K, max_new, audio_ctx) f32, physical rows, or None
    anc: torch.Tensor  # (B, K, K, T) f32 0/1: anc[b, k, j, t] = 1 iff row j holds k's t
    finished: torch.Tensor  # (B, K) bool
    scores: torch.Tensor  # (B, K) f32 cumulative logprob
    last_ts: torch.Tensor  # (B, K) long: the last timestamp token so far, or -1
    pos: torch.Tensor  # () long: the position the next step writes
    total: torch.Tensor  # (B,) long: each stream's exact cap, ≤ p + max_new
    n_prefix: torch.Tensor  # (B,) long

    def going(self) -> torch.Tensor:
        """(B,) bool: the streams whose search goes on (the JAX package's
        per-stream ``while_loop`` condition)."""
        return ~self.finished.all(dim=1) & (self.pos < self.total)

    def ended(self) -> torch.Tensor:
        return ~self.going().any()


def new_state(model: Whisper, key: D.LoopKey, dtype, device) -> BeamState:
    b, k, t_ctx = key.batch, key.beam_size, key.cache_len

    def zeros(*shape, dtype=torch.long):
        return torch.zeros(shape, dtype=dtype, device=device)

    return BeamState(
        cache=model.empty_cache(b, key.audio_ctx, k * t_ctx, dtype, device),
        tokens=zeros(b, k, key.p + key.max_new),
        xcap=(zeros(b, k, key.max_new, key.audio_ctx, dtype=torch.float32)
              if key.opts.word_timestamps else None),
        anc=zeros(b, k, k, t_ctx, dtype=torch.float32),
        finished=zeros(b, k, dtype=torch.bool), scores=zeros(b, k, dtype=torch.float32),
        last_ts=zeros(b, k), pos=zeros(), total=zeros(b), n_prefix=zeros(b),
    )


def _tile_beams(cache: DecoderCache, k: int, p: int) -> None:
    """Every beam's block starts as the prefill's rows: positions 0..p-1 of
    block 0 copied into blocks 1..K-1, self buffers only (the cross K/V is
    the stream's, one for its K beams). The rest of each block is as
    ``fill_cache`` left it."""
    for buf in cache.self_buffers():
        blocks = buf.view(*buf.shape[:3], k, buf.shape[3] // k, buf.shape[4])
        blocks[:, :, :, 1:, :p] = blocks[:, :, :, :1, :p]


def _top_k(cand: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, ties to the lower index
    first, as ``jax.lax.top_k`` (``torch.topk`` promises no tie order; ties
    are common here: -1e9 + a logprob rounds to -1e9, and finished beams
    leave rows of -inf)."""
    vals, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _expand(cfg, opts: D.DecodeOptions, st: BeamState, logits: torch.Tensor,
            at: torch.Tensor, go: torch.Tensor, sup_mask: torch.Tensor, p: int) -> None:
    """One beam expansion from logits (B, K, V) at position ``at`` (0-d),
    committed only for the streams where ``go`` (B,)."""
    b, k, t = st.tokens.shape
    v = logits.shape[-1]
    rows = b * k
    flogits = D._filter_logits(cfg, opts, logits.reshape(rows, v), st.tokens.view(rows, t),
                               at.expand(rows), st.last_ts.view(rows),
                               st.n_prefix.repeat_interleave(k), p, sup_mask)
    logprobs = torch.log_softmax(flogits, dim=-1).view(b, k, v)
    # finished beams may only extend with EOT, at zero cost
    eot_only = torch.where(torch.arange(v, device=logits.device) == cfg.eot, 0.0, float("-inf"))
    logprobs = torch.where(st.finished[..., None], eot_only, logprobs)
    top, flat = _top_k((st.scores[..., None] + logprobs).view(b, k * v), k)
    parent, tok = flat // v, flat % v
    tokens = st.tokens.gather(1, parent[..., None].expand(b, k, t))
    last_ts = st.last_ts.gather(1, parent)
    finished = st.finished.gather(1, parent)
    anc = st.anc.gather(1, parent[..., None, None].expand(st.anc.shape))
    tok = torch.where(finished, cfg.eot, tok)
    tokens.index_copy_(2, at.view(1), tok[..., None])
    last_ts = torch.where((tok >= cfg.timestamp_begin) & ~finished, tok, last_ts)
    finished = finished | (tok == cfg.eot)
    g = go[:, None]
    st.tokens.copy_(torch.where(g[..., None], tokens, st.tokens))
    st.anc.copy_(torch.where(g[..., None, None], anc, st.anc))
    st.last_ts.copy_(torch.where(g, last_ts, st.last_ts))
    st.finished.copy_(torch.where(g, finished, st.finished))
    st.scores.copy_(torch.where(g, top, st.scores))


def _beam_step(model: Whisper, opts: D.DecodeOptions, st: BeamState, sup_mask: torch.Tensor,
               amask: Optional[torch.Tensor], p: int) -> None:
    """One beam step, in place on ``st`` and on device tensors only (a CUDA
    graph captures it): every beam decodes the token before ``pos`` into its
    own row (the ancestry column of that position first set to the
    identity), stores its capture row, then the expansion re-selects the
    beams. A stream that has ended keeps every buffer as it was: its K/V
    rows are restored, and its ancestry, capture, tokens and scores are
    written only where it goes on."""
    cfg = model.cfg
    b, k, t = st.tokens.shape
    t_ctx = st.anc.shape[-1]
    go = st.going()
    at = st.pos.clamp(1, t - 1)  # equals pos wherever a stream goes
    prev = (at - 1).view(1)
    eye = torch.eye(k, device=at.device)[None, :, :, None]
    D._keep(go[:, None, None, None], eye, st.anc, 3, prev)
    rows = torch.arange(k, device=at.device) * t_ctx + prev  # each beam's row of prev
    bufs = st.cache.self_buffers()
    old = [buf.index_select(3, rows) for buf in bufs]
    logits, xw = model.decode_step(st.tokens.index_select(2, prev).reshape(b * k), at - 1,
                                   st.cache, alignment_mask=amask, beam_ancestry=st.anc)
    for buf, kept in zip(bufs, old):  # undo the write of the streams that ended
        buf.index_copy_(3, rows, torch.where(go.view(1, b, 1, 1, 1), buf.index_select(3, rows),
                                             kept))
    if st.xcap is not None:
        slot = (at - p).clamp(0, st.xcap.shape[2] - 1).view(1)
        D._keep(go[:, None, None, None], xw.view(b, k, 1, -1), st.xcap, 2, slot)
    _expand(cfg, opts, st, logits.view(b, k, -1), at, go, sup_mask, p)
    st.pos.add_(go.any().long())


def _prefill(model: Whisper, opts: D.DecodeOptions, xa: torch.Tensor, aux: torch.Tensor,
             sup_mask: torch.Tensor, amask: Optional[torch.Tensor], st: BeamState,
             p: int) -> tuple[Optional[torch.Tensor], torch.Tensor]:
    """The beam search's prefill, eager, into ``st``: cross K/V and zeroed
    self blocks, one ``decode_span`` over each stream's initial tokens at
    batch 1 a stream (into beam 0's block), its rows tiled to every beam, and
    the first expansion from the prefill's last logits row (beam 0 live, the
    others at -1e9 so it diversifies). Reads nothing back to the host.
    Returns (prefill capture rows or None, no-speech probability)."""
    cfg = model.cfg
    b, k, t = st.tokens.shape
    t_ctx = st.anc.shape[-1]
    dev = xa.device
    aux = aux.long()  # every slot read here holds an integer
    initial_tokens = aux[:, :p]
    total = torch.clamp(p + aux[:, AUX_CAP], max=t)

    c = st.cache
    model.fill_cache(xa, c)

    def block0(buf):
        return None if buf is None else buf[:, :, :, :t_ctx]

    first = DecoderCache(block0(c.self_k), block0(c.self_v), c.cross_k, c.cross_v,
                         block0(c.self_ks), block0(c.self_vs), c.cross_ks, c.cross_vs)
    pre_logits, pre_xattn = model.decode_span(initial_tokens, 0, first, alignment_mask=amask)
    sot_logits = pre_logits[torch.arange(b, device=dev), aux[:, D.AUX_TOK + 1]]
    no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, cfg.no_speech]
    _tile_beams(c, k, p)

    st.tokens[:, :, :p] = initial_tokens[:, None]
    st.tokens[:, :, p:] = cfg.eot
    st.scores.fill_(-1e9)
    st.scores[:, 0] = 0.0
    st.finished.zero_()
    st.last_ts.copy_(aux[:, D.AUX_TOK + 2, None].expand(b, k))
    # identity ancestry: each beam's history so far is its own block's copy
    st.anc.copy_(torch.eye(k, device=dev)[None, :, :, None].expand(st.anc.shape))
    if st.xcap is not None:
        st.xcap.zero_()
    st.total.copy_(total)
    st.n_prefix.copy_(aux[:, D.AUX_TOK])
    st.pos.fill_(p)
    logits0 = pre_logits[:, p - 1, None, :].expand(b, k, pre_logits.shape[-1])
    _expand(cfg, opts, st, logits0, st.pos, total > p, sup_mask, p)
    st.pos.fill_(p + 1)
    return pre_xattn, no_speech_prob


def _pack(st: BeamState, pre_xattn: Optional[torch.Tensor], no_speech_prob: torch.Tensor,
          p: int, eot: int, length_penalty: float) -> torch.Tensor:
    """Each stream's winner as one packed f32 row, the JAX package's layout:
    [sampled (max_new), score, length, no-speech probability, capture]. The
    pick is score / length ** length_penalty, the EOT counted only where one
    was sampled. The capture covers the span init (p) ++ sampled (max_new):
    the prefill's rows, then sampled token j's row (the query row of the
    position after it, found through the ancestry table), the last one
    repeated; uint8 (x255), four a word. Returns the rows flattened."""
    b = st.tokens.shape[0]
    sampled = st.tokens[:, :, p:]
    is_eot = sampled == eot
    lengths = (is_eot.cumsum(dim=-1) == 0).sum(dim=-1) + is_eot.any(dim=-1)
    norm = st.scores / lengths.float().pow(length_penalty)
    best = norm.argmax(dim=1)  # the first maximum, as jnp.argmax
    r = torch.arange(b, device=best.device)
    parts = [sampled[r, best].float(), st.scores[r, best, None], lengths[r, best, None].float(),
             no_speech_prob[:, None]]
    if st.xcap is not None:
        max_new, audio_ctx = st.xcap.shape[2:]
        # slot s holds the query row of position p - 1 + s (slot 0 is never
        # written: position p - 1's row is the prefill's)
        src = st.anc[r, best][:, :, p - 1 : p - 1 + max_new].argmax(dim=1)  # (B, max_new)
        w = st.xcap.gather(1, src[:, None, :, None].expand(b, 1, max_new, audio_ctx))[:, 0]
        cap = torch.cat([pre_xattn[:, :p], w[:, 1:], w[:, -1:]], dim=1).reshape(b, -1)
        q = torch.clamp(torch.round(cap * 255.0), 0, 255).to(torch.uint8)
        q = F.pad(q, (0, (-q.shape[1]) % 4))
        parts.append(q.view(torch.float32))
    return torch.cat(parts, dim=1).reshape(-1)


def _parse_beam_rows(cfg, out: np.ndarray, max_new: int,
                     prefixes: list[np.ndarray]) -> list[D.DecodeResult]:
    """One ``DecodeResult`` (batch 1) per packed row: tokens = prefix +
    sampled, the length through the first EOT, the score and its mean over
    the sampled tokens, the no-speech probability."""
    results = []
    for row, prefix in zip(out, prefixes):
        sampled = row[:max_new].astype(np.int32)
        score = float(row[max_new])
        n_sampled = int(row[max_new + 1])
        full = np.concatenate([np.asarray(prefix, np.int32), sampled])[None]
        eots = np.nonzero(full[0] == cfg.eot)[0]
        length = int(eots[0] + 1) if eots.size else full.shape[1]
        results.append(D.DecodeResult(
            tokens=full, lengths=np.array([length], np.int64), sum_logprob=np.array([score]),
            avg_logprob=np.array([score / max(n_sampled, 1)]),
            no_speech_prob=np.array([float(row[max_new + 2])]), xattn=None))
    return results


def _unpack_capture_rows(out: np.ndarray, p: int, max_new: int, audio_ctx: int,
                         prefixes: list[np.ndarray], results: list[D.DecodeResult]) -> None:
    """Each row's uint8 capture into ``result.xattn`` (1, length, audio_ctx):
    the span init (p) ++ sampled (max_new), from position p - n_prefix (the
    forced prefix's first token)."""
    base = max_new + 3
    span = p + max_new
    for row, prefix, r in zip(out, prefixes, results):
        q = np.ascontiguousarray(row[base:], np.float32).view(np.uint8)[: span * audio_ctx]
        cap = (q.astype(np.float32) / 255.0).reshape(span, audio_ctx)
        p0 = p - len(prefix)
        r.xattn = cap[None, p0 : p0 + int(r.lengths[0])]


def _finalize(handle: D.DecodeHandle, prefixes: list[np.ndarray]) -> list[D.DecodeResult]:
    plan = handle.plan
    out = D._fetch(handle).reshape(handle.b, -1)
    with span("asr.parse"):
        results = _parse_beam_rows(handle.cfg, out, plan.max_new, prefixes)
        if handle.capture:
            _unpack_capture_rows(out, plan.p, plan.max_new, handle.audio_ctx, prefixes, results)
    return results


def _check(opts: D.DecodeOptions) -> None:
    if opts.beam_size < 2:
        raise ValueError(f"beam search takes beam_size >= 2, got {opts.beam_size}")


def beam_decode_dispatch(
    model: Whisper,
    xa: torch.Tensor,
    opts: D.DecodeOptions,
    plan: D.WindowPlan,
    aux: torch.Tensor,
    extra_suppress: tuple[int, ...] = (),
    alignment_heads: Optional[np.ndarray] = None,
    loop: Optional[D.DecodeLoop] = None,
) -> D.DecodeHandle:
    """The beam search of one planned window (xa (1, audio_ctx, d), ``aux``
    its aux bundle on xa's device) up to the start of its result's copy, as
    ``decode.greedy_decode_dispatch``: the loop replays ``loop``'s CUDA
    graphs on the card and runs uncaptured on the CPU. A draft in the plan
    is ignored."""
    _check(opts)
    if xa.shape[0] != 1:
        raise ValueError(f"one window's beam search takes xa of batch 1, got {xa.shape[0]}; "
                         "use beam_decode_batch_dispatch")
    return D._dispatch(model, xa, opts, plan, aux.reshape(1, D.AUX_LEN), extra_suppress,
                       alignment_heads, loop)


def beam_decode_finalize(handle: D.DecodeHandle) -> D.DecodeResult:
    """Wait for the dispatched beam search's result copy and unpack the
    winner."""
    (result,) = _finalize(handle, [handle.plan.prefix])
    return result


def beam_decode(model: Whisper, xa: torch.Tensor, opts: D.DecodeOptions, plan: D.WindowPlan,
                aux: torch.Tensor, **kw) -> D.DecodeResult:
    """``beam_decode_finalize(beam_decode_dispatch(...))``."""
    return beam_decode_finalize(beam_decode_dispatch(model, xa, opts, plan, aux, **kw))


def beam_decode_batch_dispatch(
    model: Whisper,
    xa: torch.Tensor,
    opts: D.DecodeOptions,
    plan: D.BatchPlan,
    aux: Optional[torch.Tensor] = None,
    extra_suppress: tuple[int, ...] = (),
    alignment_heads: Optional[np.ndarray] = None,
    loop: Optional[D.DecodeLoop] = None,
) -> D.DecodeHandle:
    """B streams' beam searches (xa (B, audio_ctx, d), one planned row
    each) in one loop, up to the start of the result's copy, as
    ``decode.greedy_decode_batch_dispatch``. Each stream stops on its own."""
    _check(opts)
    if len(plan.rows) != xa.shape[0]:
        raise ValueError(f"{len(plan.rows)} planned rows for a batch of {xa.shape[0]}")
    if aux is None:
        aux = torch.from_numpy(plan.aux).to(xa.device)
    return D._dispatch(model, xa, opts, plan, aux, extra_suppress, alignment_heads, loop)


def beam_decode_batch_finalize(handle: D.DecodeHandle) -> list[D.DecodeResult]:
    """Wait for the result's copy and unpack one ``DecodeResult`` (batch 1)
    a stream, each with its own prefix."""
    return _finalize(handle, [row.prefix for row in handle.plan.rows])


def beam_decode_batch(model: Whisper, xa: torch.Tensor, opts: D.DecodeOptions,
                      requests: list[dict], **kw) -> list[D.DecodeResult]:
    """Batched beam search: ``decode.plan_batch_aux`` of the requests, then
    the dispatch and finalize halves."""
    plan = D.plan_batch_aux(model.cfg, opts, requests)
    return beam_decode_batch_finalize(beam_decode_batch_dispatch(model, xa, opts, plan, **kw))
