"""Streaming transcription of a WAV as a simulated microphone (1 s chunks,
VAD in front: VAC mode).

    python -m realtime_whisper_asr_tpu_torch.examples.streaming_from_wav audio.wav \\
        [--model base] [--checkpoint DIR] [--language en] [--realtime] \\
        [--separation] [--cpu]

Port of the JAX package's ``examples/streaming_from_wav.py``: one
``StreamingApp`` session over ``SimulatedMicStream.from_wav``;
``--checkpoint`` loads a local HF or native checkpoint (the CLI's ``stream``
flag), ``--separation`` turns on the config's vocal separation. On the card unless
``--cpu``; without CUDA and without ``--cpu`` it raises.
"""

import argparse

from realtime_whisper_asr_tpu_torch.app import StreamingApp
from realtime_whisper_asr_tpu_torch.config import ConfigManager
from realtime_whisper_asr_tpu_torch.io import SimulatedMicStream


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("file")
    p.add_argument("--model", default="base")
    p.add_argument("--checkpoint", default=None, help="local HF or native checkpoint dir")
    p.add_argument("--language", default="en")
    p.add_argument("--realtime", action="store_true", help="pace to wall clock")
    p.add_argument("--separation", action="store_true", help="vocal isolation in front")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card; raises without one)")
    args = p.parse_args(argv)

    cm = ConfigManager(autoload=False)
    cm.set("model.size", args.model)
    cm.set("model.checkpoint_dir", args.checkpoint)
    if args.separation:
        cm.set("vocal_separation.enable", True)
    app = StreamingApp(config=cm, language=args.language,
                       device="cpu" if args.cpu else "cuda")
    stream = SimulatedMicStream.from_wav(args.file, realtime=args.realtime)
    try:
        stats = app.record_session(stream, chunk_seconds=1.0)
        print(f"\n{stats.results} results, {stats.skipped} skips, "
              f"{stats.duration_s:.1f}s audio")
    finally:
        app.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
