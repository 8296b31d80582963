"""Offline file transcription on the CUDA card.

    python -m realtime_whisper_asr_tpu_torch.examples.offline_transcribe audio.wav \\
        [--model tiny] [--language en] [--checkpoint DIR] [--beam-size 1] \\
        [--dtype bfloat16|float32] [--cpu]

Port of the JAX package's ``examples/offline_transcribe.py``: one
``TorchWhisperASR`` (bf16 by default), one ``transcribe`` of the whole file,
a line a segment. On the card unless ``--cpu``; without CUDA and without
``--cpu`` it raises.
"""

import argparse

import torch

from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
from realtime_whisper_asr_tpu_torch.io import read_wav


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("file")
    p.add_argument("--model", default="tiny")
    p.add_argument("--language", default="en")
    p.add_argument("--checkpoint", default=None, help="local HF or native checkpoint dir")
    p.add_argument("--beam-size", type=int, default=1)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card; raises without one)")
    args = p.parse_args(argv)

    asr = TorchWhisperASR(
        model_size=args.model,
        language=args.language,
        checkpoint_dir=args.checkpoint,
        beam_size=args.beam_size,
        dtype=getattr(torch, args.dtype),
        device="cpu" if args.cpu else "cuda",
    )
    audio = read_wav(args.file)
    for seg in asr.transcribe(audio):
        print(f"[{seg.start:7.2f} --> {seg.end:7.2f}] {seg.text.strip()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
