"""The Whisper family's readings, pinned: the weights made from one seed (the
sha256 of every tensor, in f32 and in bf16), the work of hand-built
dispatches (a host draft, a batch of two, a forced device draft) and the
reference check of their served tokens, with and without the control.

``whisper_pins.json`` holds what the benchmark read from these inputs
before the harness took its model-specific calls from the family, so a
change to how the family is found cannot change a reading unseen. The
inputs are built by hand: no closed loop, so nothing depends on timing.
The check's gaps, sums of f32 logits, are held to a millionth of their size;
every other reading exactly.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os

import numpy as np
import pytest
import torch

from conftest import REPO, tiny_config
from portbench.core import spec
from portbench.core.record import SR, Dispatch, Recorder, Req
from portbench.reference import plan as P

SEED = 2**31 + 97531
PINS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "whisper_pins.json")


def state_hashes(state: dict) -> dict:
    return {k: hashlib.sha256(t.detach().contiguous().flatten().view(torch.uint8)
                              .numpy().tobytes()).hexdigest()
            for k, t in sorted(state.items())}


def _pairs(first_ts: int, n: int) -> list:
    """``n`` served tokens of timestamped segments from ``first_ts``: a
    timestamp, three text tokens, the closing timestamp, the next opening
    one at the same time, and so on (what Whisper's rules allow)."""
    text = [400, 1000, 31, 600, 700, 812, 95, 3000]
    out, t, i = [], first_ts, 0
    while len(out) < n:
        out += [t] + [text[(i + j) % len(text)] for j in range(3)]
        t += 12
        out.append(t)
        i += 3
    return out[:n]


def recorder(cfg: dict) -> Recorder:
    """Three dispatches as a run records them: a window with a prompt, a
    prefix and a host draft (rid 0); a batch of two rows (rids 1, 2); a
    window forcing the previous window's tokens as a device draft (rid 3)."""
    ts0 = P.Vocab(cfg["vocab_size"], cfg["max_target_positions"]).timestamp_begin
    rec = Recorder(clock=lambda: 0.0)

    def req(rid, dispatch, seconds, prompt, prefix, sampled, **kw):
        audio = (0.05 * np.random.default_rng([SEED, rid]).standard_normal(
            int(seconds * SR))).astype(np.float32)
        r = Req(rid, rid, 0.0, 0, audio, dispatch=dispatch, prompt=prompt, prefix=prefix,
                t_apply=1.0, tokens=prefix + sampled, counted=True, **kw)
        rec.reqs.append(r)
        rec.dispatches[dispatch].rids.append(rid)
        return r

    rec.dispatches += [Dispatch(0, "window", 0.0, 1.0, rows_real=1, rows_encoded=1),
                       Dispatch(1, "batch", 1.0, 2.0, rows_real=2, rows_encoded=2),
                       Dispatch(2, "window", 2.0, 3.0, rows_real=1, rows_encoded=1)]
    s0 = _pairs(ts0 + 10, 18)
    req(0, 0, 5.0, [400, 401, 402, 403, 404], [ts0, 1000, 31, ts0 + 10], s0,
        draft=s0[:2] + [5, 6])
    req(1, 1, 6.0, [410, 411], [], _pairs(ts0 + 2, 20))
    req(2, 1, 11.0, [], [], _pairs(ts0, 30))
    forced = P.forced_draft(s0, 24, 4, P.Vocab(cfg["vocab_size"]).eot, 1)
    req(3, 2, 7.0, [], [], forced + [810, 820, ts0 + 58, ts0 + 58, 830],
        device_draft={"offset": 4, "max_new": 24, "force": True, "safety": 1, "prev": 0})
    return rec


def work_reading(w) -> dict:
    """A dispatch's work as plain numbers; its products by a digest."""
    out = {k: v for k, v in dataclasses.asdict(w).items() if k != "gemms"}
    triples = [[g.m, g.k, g.n] for g in w.gemms]
    out.update(n_gemms=len(triples), gemm_ops=sum(g.ops for g in w.gemms),
               gemm_bytes=sum(g.bytes for g in w.gemms),
               gemms_sha256=hashlib.sha256(json.dumps(triples).encode()).hexdigest())
    return out


@pytest.fixture(scope="module")
def pins() -> dict:
    with open(PINS) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def whisper():
    return spec.model_family(REPO, tiny_config())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_weights_of_the_seed_are_pinned(pins, dtype):
    """Every tensor that the family's build and check make from the seed is
    what the benchmark made before, bit for bit."""
    from portbench.core import weights as WT

    state = WT.make_state(tiny_config(), SEED, torch.device("cpu"), getattr(torch, dtype))
    assert state_hashes(state) == pins["state"][dtype]


def test_the_work_of_hand_built_dispatches_is_pinned(pins, whisper):
    cfg = tiny_config()
    rec = recorder(cfg)
    got = [work_reading(whisper.work(cfg, rec, d)) for d in rec.dispatches]
    assert got == pins["work"]


#: the check's readings that are sums of f32 logits: the CPU's BLAS may
#: order those sums otherwise on another machine
GAPS = ("widest_gap", "control_widest_gap")


@pytest.mark.parametrize("control", [False, True])
def test_the_check_of_fixed_served_tokens_is_pinned(pins, whisper, control):
    """The counts and notes exactly; the gaps to a millionth of their size,
    far below any change to what the check compares."""
    cfg = tiny_config()
    got = whisper.check(recorder(cfg), cfg, SEED, torch.device("cpu"), control)
    want = pins["check_control" if control else "check"]
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in GAPS} == \
        {k: v for k, v in want.items() if k not in GAPS}
    for k in GAPS:
        if k in want:
            assert math.isclose(got[k], want[k], rel_tol=1e-6), (k, got[k], want[k])
