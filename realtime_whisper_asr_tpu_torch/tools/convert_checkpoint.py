"""Convert a Whisper checkpoint into the port's native format, optionally
pre-quantized: the deployment artifact, which loads with no quantization
pass (the counterpart of the JAX package's ``tools/convert_checkpoint.py``).

    python -m realtime_whisper_asr_tpu_torch.tools.convert_checkpoint SRC DST \\
        [--quantize int8|int8-all|int4|none] [--dtype bfloat16|float32] \\
        [--device cuda|cpu]

``SRC`` is an HF-layout directory (config.json + *.safetensors) or a native
checkpoint of the port (re-saved with the requested quantization). The
floats are cast to ``--dtype`` before quantizing; the quantization runs on
``--device`` (the card by default; the card's and the CPU's quantizers agree
bit for bit). Scales stay f32 in the artifact and on load, so an artifact
decodes token-identically to quantizing at load. The sidecar files the ASR
reads from a checkpoint directory (alignment heads, tokenizer files) are
copied. Prints the tier detected in what was written.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

#: the files beside the weights that the ASR reads from a checkpoint directory
SIDECARS = ("generation_config.json", "tokenizer.json", "vocab.json", "merges.txt",
            "tokenizer_config.json", "special_tokens_map.json", "added_tokens.json",
            "normalizer.json")


def convert(src: str, dst: str, quantize: str = "none", dtype: str = "bfloat16",
            device: str = "cuda") -> tuple:
    """Load ``src``, cast, quantize to ``quantize`` on ``device``, write
    ``dst`` with its sidecars -> (config, the tier detected in the written
    state, the state file's bytes)."""
    import torch

    from realtime_whisper_asr_tpu_torch.asr import load_model_dir
    from realtime_whisper_asr_tpu_torch.device import resolve_device
    from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
    from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import save_checkpoint

    dev = resolve_device(device)
    cfg, state = load_model_dir(src, getattr(torch, dtype))
    state = Q.quantize({k: v.to(dev) for k, v in state.items()},
                       None if quantize == "none" else quantize)
    nbytes = save_checkpoint(dst, state, cfg)
    for name in SIDECARS:
        if os.path.exists(os.path.join(src, name)):
            shutil.copy2(os.path.join(src, name), os.path.join(dst, name))
    return cfg, Q.detect_quantization(state), nbytes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help="HF-layout directory or the port's native checkpoint")
    p.add_argument("dst", help="output directory (the port's native checkpoint)")
    p.add_argument("--quantize", choices=["int8", "int8-all", "int4", "none"],
                   default="none")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--device", default="cuda", help="where to quantize (cuda or cpu)")
    args = p.parse_args(argv)
    cfg, tier, nbytes = convert(args.src, args.dst, args.quantize, args.dtype, args.device)
    print(f"saved {cfg.name} ({args.dtype}, quantization={tier}, {nbytes} bytes) -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
