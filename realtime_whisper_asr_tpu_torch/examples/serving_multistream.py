"""Multi-stream serving: N concurrent sessions over one shared model.

    python -m realtime_whisper_asr_tpu_torch.examples.serving_multistream \\
        [--model tiny] [--checkpoint DIR] [--streams 2] [--cpu]

Port of the JAX package's ``examples/serving_multistream.py``: two-speaker
synthetic conversations, one a stream, through the batched, pipelined
``StreamServer`` (int8 decoder weights, bf16, VAD, diarization), printing
each stream's speaker-labeled results. Without a checkpoint the weights are
random, so the text is placeholder tokens: the point is the serving
surface (create_stream / feed / step / poll / close_stream) and the
speaker labels. On the card unless ``--cpu``; without CUDA and without
``--cpu`` it raises.
"""

from __future__ import annotations

import argparse

import numpy as np

SR = 16000


def speaker_audio(seed: int, turns: int = 3) -> np.ndarray:
    """``turns`` exchanges of two synthetic speakers, 2 s an utterance, a
    second of near-silence after each."""
    from realtime_whisper_asr_tpu_torch.models.vad.synthetic import (
        sample_speaker,
        synth_speaker_utterance,
    )

    rng = np.random.default_rng(seed)
    a, b = sample_speaker(rng), sample_speaker(rng)
    gap = (0.002 * rng.standard_normal(SR)).astype(np.float32)
    pieces = []
    for t in range(turns * 2):
        spk = a if t % 2 == 0 else b
        utt = synth_speaker_utterance(rng, spk, seconds=2.0)
        pieces += [utt * (0.5 / (np.abs(utt).max() + 1e-6)), gap.copy()]
    return np.concatenate(pieces)


def main(argv=None) -> int:
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.serving import StreamServer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card; raises without one)")
    args = ap.parse_args(argv)

    asr = TorchWhisperASR(
        model_size=args.model, checkpoint_dir=args.checkpoint, dtype=torch.bfloat16,
        quantization="int8", device="cpu" if args.cpu else "cuda",
    )
    asr.transcribe_kargs.update(max_new_tokens=48, max_total_tokens=48)
    server = StreamServer(asr, use_vad=True, diarize=True, online_chunk_size=0.5,
                          min_silence_duration_ms=300)

    sids = [server.create_stream() for _ in range(args.streams)]
    feeds = [speaker_audio(seed=10 + i) for i in range(args.streams)]
    chunk = SR // 2
    pos = 0
    while any(pos < len(f) for f in feeds):
        for sid, f in zip(sids, feeds):
            if pos < len(f):
                server.feed(sid, f[pos : pos + chunk])
        pos += chunk
        while server.step():
            pass
        for sid in sids:
            for r in server.poll(sid):
                spk = f"[{r.speaker}] " if r.speaker else ""
                print(f"stream {r.stream_id} {r.begin:6.2f}-{r.end:6.2f}  {spk}{r.text}")
    for sid in sids:
        for r in server.close_stream(sid):
            spk = f"[{r.speaker}] " if r.speaker else ""
            print(f"stream {r.stream_id} {r.begin:6.2f}-{r.end:6.2f}  {spk}{r.text} (final)")
    print("stats:", server.get_stats())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
