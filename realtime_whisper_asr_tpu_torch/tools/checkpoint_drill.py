"""Checkpoint-readiness drill: take an HF-layout Whisper directory through
every step a production checkpoint needs, and write a report.

    python -m realtime_whisper_asr_tpu_torch.tools.checkpoint_drill HF_DIR \\
        --work WORK_DIR [--quantize int8|int8-all|none] [--report drill.json] \\
        [--manifest manifest.jsonl] [--cpu]

Port of the JAX package's ``tools/checkpoint_drill.py``, the same steps in
the same order and the same report keys:

  1. convert            HF dir -> the port's native checkpoint
                        (``tools/convert_checkpoint.py``)
  2. reload             ``TorchWhisperASR`` boots from the native dir; flags a
                        mock tokenizer (no vocab.json / merges.txt) and missing
                        alignment heads
  3. decode_parity      two seeded noise clips through the HF dir and the
                        converted dir: the tokens must match
  4. prequant_artifact  an ``int8-all`` artifact: detected as such on load,
                        its tokens equal to quantizing at load
  5. beam5              beam 5 through both dirs: the tokens must match
  6. stream             a short ``StreamingApp`` session over a simulated mic
  7. wer                with ``--manifest`` ({"wav", "text"} lines): the word
                        error rate through ``eval.evaluate_offline``

On the card unless ``--cpu``; without CUDA and without ``--cpu`` it raises.
Exits 0 when every step is ok.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

SR = 16000


def run_drill(src: str, work: str, quantize: str = "none", manifest: str | None = None,
              device="cuda", dtype=None) -> tuple[dict, list]:
    """The drill on ``device``, its ASRs in ``dtype`` (the ASR's default,
    bf16, when None) -> (report, the tokens the native checkpoint decoded:
    each clip greedy, then each clip at beam 5)."""
    from realtime_whisper_asr_tpu_torch.app import StreamingApp
    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.config import ConfigManager
    from realtime_whisper_asr_tpu_torch.device import resolve_device
    from realtime_whisper_asr_tpu_torch.io import SimulatedMicStream
    from realtime_whisper_asr_tpu_torch.models.whisper.quant import detect_quantization
    from realtime_whisper_asr_tpu_torch.models.whisper.tokenizer import MockTokenizer
    from realtime_whisper_asr_tpu_torch.tools import convert_checkpoint

    dev = resolve_device(device)
    report: dict = {"src": src, "steps": {}}
    decoded: list = []

    def step(name: str):
        t0 = time.perf_counter()

        def done(ok: bool, **info):
            report["steps"][name] = {"ok": ok, "seconds": round(time.perf_counter() - t0, 2),
                                     **info}
            print(f"[{'ok' if ok else 'FAIL'}] {name} "
                  f"({report['steps'][name]['seconds']}s) {info or ''}", flush=True)
            return ok

        return done

    def asr_of(path: str, quantization=None):
        kw = {} if dtype is None else {"dtype": dtype}
        return TorchWhisperASR(checkpoint_dir=path, language="en", quantization=quantization,
                               device=dev, **kw)

    # -- 1. convert
    native = os.path.join(work, "native_ckpt")
    done = step("convert")
    convert_checkpoint.main([src, native, "--quantize", quantize, "--device", str(dev)])
    done(True, out=native)

    # -- 2. reload
    done = step("reload")
    asr = asr_of(native)
    mock_tok = isinstance(asr.tokenizer, MockTokenizer)
    heads = asr.alignment_heads is not None
    done(True, model=asr.cfg.name, real_tokenizer=not mock_tok, alignment_heads=heads)
    if mock_tok:
        print("  no vocab.json/merges.txt in the checkpoint dir: text output will use the "
              "mock tokenizer (token ids are still exact)")
    if not heads:
        print("  no generation_config.json alignment_heads: word timestamps fall back to the "
              "default head set")

    # -- 3. decode parity, HF dir vs the converted dir
    done = step("decode_parity")
    rng = np.random.default_rng(0)
    clips = [(0.1 * rng.standard_normal(int(s * SR))).astype(np.float32) for s in (2.0, 3.5)]
    asr_hf = asr_of(src, None if quantize == "none" else quantize)
    match = True
    for clip in clips:
        ids_native = list(asr.transcribe(clip).tokens)
        decoded.append(ids_native)
        match = match and ids_native == list(asr_hf.transcribe(clip).tokens)
    done(match, clips=len(clips))

    # -- 4. the pre-quantized int8-all artifact: detected on load, and its
    # tokens equal to quantizing the same weights at load
    done = step("prequant_artifact")
    native_q = os.path.join(work, "native_ckpt_int8all")
    convert_checkpoint.main([src, native_q, "--quantize", "int8-all", "--device", str(dev)])
    asr_pq = asr_of(native_q)
    detected = detect_quantization(asr_pq.model.state_dict())
    asr_qal = asr_of(src, "int8-all")
    qmatch = all(list(asr_pq.transcribe(c).tokens) == list(asr_qal.transcribe(c).tokens)
                 for c in clips)
    done(qmatch and detected == "int8-all", detected=detected)

    # -- 5. beam 5 through the native and the HF dirs
    done = step("beam5")
    asr.beam_size = asr_hf.beam_size = 5
    bmatch = True
    for clip in clips:
        ids_native = list(asr.transcribe(clip).tokens)
        decoded.append(ids_native)
        bmatch = bmatch and ids_native == list(asr_hf.transcribe(clip).tokens)
    asr.beam_size = asr_hf.beam_size = 1
    done(bmatch, beams=5)

    # -- 6. a streaming session
    done = step("stream")
    cm = ConfigManager(autoload=False)
    cm.set("audio_deduplication.enable", False)
    app = StreamingApp(config=cm, asr=asr, language="en", device=dev)
    stream = SimulatedMicStream((0.1 * rng.standard_normal(4 * SR)).astype(np.float32))
    stats = app.record_session(stream, chunk_seconds=0.5, use_protector=False)
    app.shutdown()
    done(True, chunks=stats.chunks, results=stats.results)

    # -- 7. the word error rate over a labeled manifest
    if manifest:
        from realtime_whisper_asr_tpu_torch.eval import evaluate_offline
        from realtime_whisper_asr_tpu_torch.io import read_wav
        from realtime_whisper_asr_tpu_torch.train.data import read_manifest

        done = step("wer")
        triples = [(e.wav, read_wav(e.wav), e.text) for e in read_manifest(manifest)]
        evals = evaluate_offline(asr, triples)
        done(True, mean_wer=round(float(np.mean([r.wer for r in evals])), 4), clips=len(evals))

    report["ok"] = all(s["ok"] for s in report["steps"].values())
    return report, decoded


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="HF-layout checkpoint dir")
    ap.add_argument("--work", required=True, help="working dir for the native checkpoints")
    ap.add_argument("--quantize", choices=["int8", "int8-all", "none"], default="none")
    ap.add_argument("--report", default=None, help="write the drill report JSON here")
    ap.add_argument("--manifest", default=None,
                    help="optional labeled manifest for the word error rate")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card; raises without one)")
    args = ap.parse_args(argv)

    report, _ = run_drill(args.src, args.work, args.quantize, args.manifest,
                          "cpu" if args.cpu else "cuda")
    print(json.dumps(report))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(f"\nnext: the port on the card, from the repository's root:\n"
          f"  python3 chip_smoke.py\n"
          f"and this checkpoint: TorchWhisperASR(checkpoint_dir="
          f"{os.path.join(args.work, 'native_ckpt')!r})")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
