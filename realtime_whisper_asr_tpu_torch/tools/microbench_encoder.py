"""Encoder microbenchmark on the card: launch cost, matmul throughput, the
fused matmul chain (K3) and the real large-v3 encoder.

Counterpart of the JAX package's ``tools/microbench_encoder.py`` at its
shapes (T = 800 frames, the 16 s bucket; D = 1280, FF = 5120, large-v3):

  1. per-launch cost: a chain of k bf16 matmuls (one launch each here, as
     eager PyTorch issues them) and a chain of k elementwise ops;
  2. single-matmul throughput: one big bf16 matmul (800 x 1280 @ 1280 x
     40960) and the same product in int8 through the port's exact int8
     product (``ops/int8_matmul.py``);
  3. the fused chain: the k products in ONE launch (``ops/matmul_chain.py``,
     kernel K3) against the chain of k launches;
  4. the real encoder at the 16 s bucket in bf16 and ``int8-all``, with the
     hand-counted FLOPs and MFU against the H100's dense peaks (989 TFLOP/s
     bf16, 1,979 TOP/s int8; NVIDIA's data sheet, at the 700 W limit).

Times are CUDA events around ``reps`` back-to-back calls after a warm-up,
divided by ``reps``: the card's time where it is busy, the host's launch
cost where that is longer.

    python -m realtime_whisper_asr_tpu_torch.tools.microbench_encoder [--out FILE]

Needs a CUDA card; prints one JSON line of results.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

T, D, FF = 800, 1280, 5120  # large-v3 encoder shapes at the 16 s bucket
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32)).cuda().bfloat16()
    w = torch.from_numpy((rng.standard_normal((D, D)) * D ** -0.5).astype(np.float32))
    return rng, x, w.cuda().bfloat16()


def section_launch_chains(x, w, results: dict) -> None:
    flop1 = 2 * T * D * D

    def chain(ws):
        h = x
        for wk in ws:
            h = torch.matmul(h, wk)  # bf16 in and out, f32 accumulation (cuBLAS)
        return h

    for k in (8, 32, 64):
        ws = torch.stack([w] * k)
        per = time_ms(lambda: chain(ws)) / k
        results[f"chain_matmul_k{k}_us"] = per * 1e3
        results[f"chain_matmul_k{k}_tflops"] = flop1 / (per * 1e-3) / 1e12
    c = torch.tensor(1.0, dtype=torch.bfloat16, device="cuda")

    def echain(k):
        h = x
        for _ in range(k):
            h = h * c + 0.1
        return h

    for k in (32, 128):
        results[f"chain_eltwise_k{k}_us"] = time_ms(lambda: echain(k)) / k * 1e3


def section_big_matmul(rng, x, results: dict) -> None:
    from realtime_whisper_asr_tpu_torch.models.whisper.quant import quantize_int8
    from realtime_whisper_asr_tpu_torch.ops.int8_matmul import int8_matmul, quantize_rows

    n = 32 * D
    wbig = torch.from_numpy((rng.standard_normal((D, n)) * D ** -0.5).astype(np.float32)).cuda()
    flops = 2 * T * D * n
    wb = wbig.bfloat16()
    ms = time_ms(lambda: torch.matmul(x, wb))
    results["big_matmul_bf16_tflops"] = flops / (ms * 1e-3) / 1e12
    q, s = quantize_int8(wbig.t())  # (N, K) int8, per-output scales

    def mm_int8():
        xq, sx = quantize_rows(x)
        return (int8_matmul(xq, q).float() * sx * s).to(torch.bfloat16)

    ms = time_ms(mm_int8)
    results["big_matmul_int8_tops"] = flops / (ms * 1e-3) / 1e12


def section_fused_chain(x, w, results: dict) -> None:
    from realtime_whisper_asr_tpu_torch.ops import matmul_chain as MC

    flop1 = 2 * T * D * D
    for k in (8, 32):
        ws = torch.stack([w] * k).contiguous()
        ref = MC.matmul_chain_plain(x, ws)
        got = MC.matmul_chain(x, ws)
        results[f"fused_chain_k{k}_max_err"] = float((got.float() - ref.float()).abs().max())
        per = time_ms(lambda: MC.matmul_chain(x, ws)) / k
        results[f"fused_chain_k{k}_us"] = per * 1e3
        results[f"fused_chain_k{k}_tflops"] = flop1 / (per * 1e-3) / 1e12


def section_encoder(results: dict, reps: int = 10) -> None:
    """The real large-v3 encoder at the 16 s bucket, bf16 and int8-all,
    seeded random weights."""
    from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.model import (
        Whisper, encoder_flops, init_params)

    cfg = get_config("large-v3")
    rng = np.random.default_rng(1)
    mel = torch.from_numpy(rng.standard_normal((1, 2 * T, cfg.n_mels)).astype(np.float32))
    mel = mel.cuda().bfloat16()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16,
                        "cuda")
    flops = encoder_flops(cfg, T)
    results["encoder_hand_gflop"] = flops / 1e9
    with torch.inference_mode():
        results["encoder_bf16_ms"] = time_ms(lambda: model.encode(mel), reps=reps)
        qmodel = Whisper.empty(cfg, torch.bfloat16, "cuda", "int8-all")
        qmodel.load_state_dict(Q.quantize(model.state_dict(), "int8-all"))
        del model
        results["encoder_int8_ms"] = time_ms(lambda: qmodel.encode(mel), reps=reps)
    del qmodel
    results["encoder_bf16_mfu"] = flops / (results["encoder_bf16_ms"] * 1e-3) / PEAK_BF16
    results["encoder_int8_mfu"] = flops / (results["encoder_int8_ms"] * 1e-3) / PEAK_INT8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench_encoder: CUDA is not available", file=sys.stderr)
        return 2
    results = {"device": torch.cuda.get_device_name(0)}
    rng, x, w = _inputs()
    section_launch_chains(x, w, results)
    section_big_matmul(rng, x, results)
    section_fused_chain(x, w, results)
    section_encoder(results)
    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
