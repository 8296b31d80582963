"""The Whisper family: the port's encoder-decoder, as the configurations that
name ``"family": "whisper"`` run it.

The five calls the harness and the traffic kinds make for the model go
through here, to the code where it stands: the build of the program's ASR
backend (``core/system.py``), the recorder's wraps of its ASR interface
(``core/record.py``), the weights made from the seed (``core/weights.py``)
and the comparison with the plain f32 reference (``core/verify.py`` over
``reference/``). Whisper's work count lives here.

The work a dispatch needs, from the configuration and its rows, steps and
tokens: model FLOPs, and the operations and bytes of its int8 products and
its log-mel launches. What the work needs, whatever implements it.

A dispatch encodes its rows at one window bucket, computes each row's cross
K/V, runs one prefill over the initial block (and the draft span, when every
row carries a draft), and then one decode step a token the loop produces:
the rows share the loop's steps, each row needing its own tokens. Rows that
only pad a batch to a power of two count as encoded (K1 runs for them) but
not as needed model work.
"""

from __future__ import annotations

from portbench.core import system
from portbench.core import verify as V
from portbench.core import weights as WT
from portbench.core.work import DispatchWork, Gemm
from portbench.reference import plan as P


def encoder_flops(cfg: dict, t: int) -> int:
    """Matmul FLOPs of one encode of ``t`` output positions: per layer the
    four attention projections, the MLP and the two attention products; the
    conv stem's two k = 3 convolutions at 2t and t positions."""
    d, ff, n_layer = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["encoder_layers"]
    per_layer = 4 * 2 * t * d * d + 2 * 2 * t * d * ff + 2 * 2 * t * t * d
    stem = 2 * (2 * t) * 3 * cfg["num_mel_bins"] * d + 2 * t * 3 * d * d
    return n_layer * per_layer + stem


def _decoder_position_flops(cfg: dict, t: int, a: int) -> int:
    """One decoder position at index ``t`` over ``a`` encoder positions:
    linears, self-attention over t + 1 keys, cross-attention over a."""
    d, ff = cfg["d_model"], cfg["decoder_ffn_dim"]
    per_layer = 2 * (6 * d * d) + 2 * 2 * d * ff + 4 * (t + 1) * d + 4 * a * d
    return cfg["decoder_layers"] * per_layer


def _decoder_gemms(cfg: dict, m: int) -> list:
    d, ff = cfg["d_model"], cfg["decoder_ffn_dim"]
    shapes = [(d, 3 * d), (d, d), (d, d), (d, d), (d, ff), (ff, d)]
    return [Gemm(m, k, n) for _ in range(cfg["decoder_layers"]) for k, n in shapes]


def dispatch_work(cfg: dict, rec, d) -> DispatchWork:
    """The work of dispatch ``d`` (its rows' results must be known)."""
    v = P.Vocab(cfg["vocab_size"], cfg["max_target_positions"])
    rows = [rec.reqs[i] for i in d.rids]
    cases = [V.build_case(v, cfg["caps"], rec, r) for r in rows]
    bucket = max(P.window_bucket(len(r.audio)) for r in rows)
    frames = bucket // 320
    a, dm, ff, vocab = frames, cfg["d_model"], cfg["encoder_ffn_dim"], cfg["vocab_size"]
    n = len(rows)
    every_draft = all(r.draft for r in rows) or all(r.device_draft for r in rows)
    draft_max = P.DRAFT_MAX if every_draft and rows else 0
    p = cases[0].p if cases else 0
    produced = [min(len(c.sampled), c.cap) + (1 if len(c.sampled) < c.cap else 0)
                for c in cases]
    accepted = []
    for r, c in zip(rows, cases):
        if c.n_forced:
            accepted.append(c.n_forced)
            continue
        k = 0
        while k < min(len(r.draft), len(c.sampled)) and r.draft[k] == c.sampled[k]:
            k += 1
        accepted.append(k)
    n_acc = min(accepted) if draft_max and accepted else 0
    steps = max([t - n_acc - 1 for t in produced] + [0])
    new_tokens = sum(t - c.n_forced for t, c in zip(produced, cases))
    # FLOPs: encode, cross K/V, prefill span, the head at the span's choice
    # positions, then each row's own decode steps
    span = p + draft_max
    flops = n * encoder_flops(cfg, frames)
    flops += n * cfg["decoder_layers"] * 2 * 2 * a * dm * dm
    flops += n * sum(_decoder_position_flops(cfg, t, a) for t in range(span))
    flops += n * (draft_max + 1) * 2 * dm * vocab
    for t_row in produced:
        for j in range(n_acc + 1, t_row):
            flops += _decoder_position_flops(cfg, p + j - 1, a) + 2 * dm * vocab
    gemms = []
    for _ in range(cfg["encoder_layers"]):
        m = n * frames
        gemms += [Gemm(m, dm, 3 * dm), Gemm(m, dm, dm), Gemm(m, dm, ff), Gemm(m, ff, dm)]
    for _ in range(cfg["decoder_layers"]):
        gemms += [Gemm(n * a, dm, dm), Gemm(n * a, dm, dm)]
    gemms += _decoder_gemms(cfg, n * span) + [Gemm(n * (draft_max + 1), dm, vocab)]
    for s in range(steps):
        active = sum(1 for t_row in produced if t_row - n_acc - 1 > s)
        gemms += _decoder_gemms(cfg, active) + [Gemm(active, dm, vocab)]
    n_mels = cfg["num_mel_bins"]
    mel_bytes = 4 * bucket + 4 * (bucket // 160) * n_mels
    return DispatchWork(d.did, n, d.rows_encoded, frames, new_tokens, steps, flops, gemms,
                        d.rows_encoded * mel_bytes)


# ------------------------------------------------- the family's five calls


def build(cfg: dict, seed: int, device):
    """The program's ASR backend with the weights of ``seed``, checked
    against the configuration's preset."""
    return system.build_asr(cfg, seed, device)


def attach(rec, asr) -> None:
    """The recorder's wraps of the backend's dispatches, encodes and
    finalizes."""
    rec.attach_asr(asr)


def loop_stats(asr) -> dict:
    """The decode loop's counters (``captures``, ``recaptures``, ...)."""
    return system.loop_stats(asr)


def work(cfg: dict, rec, dispatch) -> DispatchWork:
    """Whisper's work count of one dispatch (``dispatch_work``)."""
    return dispatch_work(cfg, rec, dispatch)


def check(rec, cfg: dict, seed: int, device, control: bool = False) -> dict:
    """The reference's readings of the run's served tokens (``verify.check``),
    over the dense weights of ``seed`` made again."""
    state = WT.make_state(cfg, seed, device, system.DTYPES[cfg["dtype"]])
    return V.check(rec, cfg, seed, state, device, control=control)
