"""CLI: non-interactive flags (for CI/benchmarks) + interactive wizard.

Port of ``realtime_whisper_asr_tpu/cli.py`` over ``TorchWhisperASR`` and the
port's ``StreamingApp``. The reference is wizard-only (`一键实时识别麦克风.py:
511-1089`); SURVEY.md §7 requires a flags path too. Subcommands:

    transcribe FILE [--model SIZE] [--language L] [--task T] [--cpu]   offline file
    stream [--wav FILE | --mic] [--model SIZE] [--cpu] [...]           streaming
    separate FILE [--variant V] [--cpu]                                stem WAVs
    devices                                                            list inputs
    wizard [--cpu]                                                     interactive setup
    detect                                                             hardware report

The commands that compute run on the CUDA card; ``--cpu`` runs them on the
CPU. Without ``--cpu`` on a host without CUDA they exit with status 2 and
``device.resolve_device``'s message. ``stream --device`` is the audio input
index, as in the JAX package.

Run as ``python -m realtime_whisper_asr_tpu_torch.cli``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from realtime_whisper_asr_tpu_torch.config import ConfigManager
from realtime_whisper_asr_tpu_torch.device import resolve_device
from realtime_whisper_asr_tpu_torch.models.whisper.config import LANGUAGES, PRESETS


def _add_cpu_arg(p: argparse.ArgumentParser, what: str):
    p.add_argument("--cpu", action="store_true",
                   help=f"{what} on the CPU (default: the CUDA card; without one "
                        "the command exits with status 2)")


def _add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--model", default=None, help=f"model size ({', '.join(sorted(PRESETS))})")
    p.add_argument("--checkpoint", default=None,
                   help="local checkpoint dir (HF layout or the port's native format)")
    p.add_argument("--language", default="en", choices=list(LANGUAGES) + ["auto"])
    p.add_argument("--task", default="transcribe", choices=["transcribe", "translate"])
    p.add_argument("--beam-size", type=int, default=None)
    p.add_argument("--config", default="config.json", help="config file path")
    p.add_argument("--dtype", default=None, choices=["bfloat16", "float32"])
    p.add_argument("--quantization", default=None,
                   choices=["int8", "int8-all", "int8-kv", "int4", "int4-all",
                            "none"],
                   help="int8 = decoder weights; int8-all = +encoder+logits "
                        "head (single-stream recommendation); int8-kv = +KV "
                        "caches (int8 rows, half the cache memory a stream); "
                        "int4 = decoder int4-g128 + int8 head (half the int8 "
                        "weight bytes); int4-all = +int8 encoder")
    p.add_argument("--prefix-policy", default=None, choices=["agree2", "last"],
                   help="incremental decode mode (last = SimulStreaming-style)")
    p.add_argument("--diarize", action="store_true",
                   help="speaker-turn tracking at utterance boundaries ([S<n>] labels)")
    _add_cpu_arg(p, "run the model")


def _build_config(args) -> ConfigManager:
    cm = ConfigManager(args.config)
    if args.model:
        cm.set("model.size", args.model)
    if args.checkpoint:
        cm.set("model.checkpoint_dir", args.checkpoint)
    if args.beam_size:
        cm.set("model.beam_size", args.beam_size)
    if args.dtype:
        cm.set("model.dtype", args.dtype)
    if args.quantization:
        cm.set("model.quantization", None if args.quantization == "none" else args.quantization)
    if getattr(args, "prefix_policy", None):
        cm.set("streaming.prefix_policy", args.prefix_policy)
    if getattr(args, "diarize", False):
        cm.set("diarization.enable", True)
    return cm


def cmd_detect(args) -> int:
    from realtime_whisper_asr_tpu_torch.utils.hardware import detect_hardware, recommend_config

    hw = detect_hardware()
    rec = recommend_config(hw)
    print(json.dumps({"hardware": hw, "recommendation": rec}, indent=2, default=str))
    return 0


def cmd_devices(args) -> int:
    from realtime_whisper_asr_tpu_torch.io import list_audio_devices

    devs = list_audio_devices()
    if not devs:
        print("no audio input devices (PortAudio/sounddevice unavailable)")
        return 0
    for d in devs:
        print(f"[{d['index']}] {d['name']} ({d['channels']} ch)")
    return 0


def cmd_separate(args) -> int:
    """Stem extraction to WAV files — the reference's Demucs/Spleeter stem
    output as a first-class command (vocal_separation.py:187-213 separates
    drums/bass/other/vocals; its 2-stem paths return vocals+accompaniment).
    1-stem (sigmoid) variants write vocals + accompaniment; the 4stem variant
    writes all four named stems (+ accompaniment for 2-stem compatibility).
    ``--cpu`` runs the host path (numpy STFT + CPU convolutions)."""
    from realtime_whisper_asr_tpu_torch.io import read_wav
    from realtime_whisper_asr_tpu_torch.io.wav import write_wav
    from realtime_whisper_asr_tpu_torch.models.separation_nn import NeuralSeparator

    audio = read_wav(args.audio)
    sep = NeuralSeparator(variant=args.variant, use_device=not args.cpu, device=args.device)
    stems = sep.separate_stems(audio)
    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.audio))[0]
    for name, wav in stems.items():
        path = os.path.join(args.out_dir, f"{base}.{name}.wav")
        write_wav(path, wav)
        print(f"🎵 {name}: {path}")
    return 0


def cmd_transcribe(args) -> int:
    import torch

    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.io import read_wav
    from realtime_whisper_asr_tpu_torch.io.subtitles import FORMATTERS, format_segments

    cm = _build_config(args)
    audio = read_wav(args.file)
    fmt = getattr(args, "output_format", None)
    out_path = getattr(args, "output", None)
    if out_path and not fmt:
        # --output without --output-format: infer from the file extension so
        # the file is never silently skipped
        ext = os.path.splitext(out_path)[1].lstrip(".").lower()
        if ext not in FORMATTERS:
            print(f"error: cannot infer --output-format from {out_path!r}; "
                  f"pass --output-format {{{'|'.join(sorted(FORMATTERS))}}}",
                  file=sys.stderr)
            return 2
        fmt = ext
    asr = TorchWhisperASR(
        model_size=cm.get("model.size"),
        language=None if args.language == "auto" else args.language,
        checkpoint_dir=cm.get("model.checkpoint_dir"),
        dtype=torch.bfloat16 if cm.get("model.dtype") == "bfloat16" else torch.float32,
        quantization=cm.get("model.quantization"),
        beam_size=cm.get("model.beam_size") or 1,
        device=args.device,
    )
    if args.task == "translate":
        asr.set_translate_task()
    if args.language == "auto":
        lang, prob = asr.detect_language(audio)
        # stderr: with --output-format the stdout payload is machine-consumed
        # (an SRT/JSON stream must not start with a diagnostic line)
        print(f"detected language: {lang} (p={prob:.2f})",
              file=sys.stderr if fmt else sys.stdout)
        asr.original_language = lang
    segments = asr.transcribe(audio)
    if fmt:
        text = format_segments(segments, fmt)
        if out_path:
            with open(out_path, "w", encoding="utf-8") as f:
                f.write(text + ("\n" if not text.endswith("\n") else ""))
            print(f"wrote {out_path}")
        else:
            print(text)
        return 0
    for seg in segments:
        print(f"[{seg.start:7.2f} --> {seg.end:7.2f}] {seg.text.strip()}")
    return 0


def cmd_stream(args) -> int:
    from realtime_whisper_asr_tpu_torch import io
    from realtime_whisper_asr_tpu_torch.app import StreamingApp

    cm = _build_config(args)
    app = StreamingApp(
        config=cm,
        language=None if args.language == "auto" else args.language,
        task=args.task,
        device=args.device,
    )
    if args.wav:
        stream = io.SimulatedMicStream.from_wav(args.wav, realtime=args.realtime)
    else:
        stream = io.MicrophoneStream(device=args.device_index)
    try:
        # multi-session outer loop (reference 一键…py:2184-2396): Ctrl+C ends
        # a session, then an interactive menu restarts or switches language —
        # the loaded model is REUSED across sessions (only streaming state and
        # per-language config rebuild). WAV feeds and non-TTY runs stay
        # single-session.
        while True:
            stats = app.record_session(stream, chunk_seconds=args.chunk_seconds,
                                       max_seconds=args.max_seconds,
                                       until_exhausted=bool(args.wav))
            print(f"\nsession: {stats.results} results, {stats.skipped} text-skips, "
                  f"{stats.dedup_skipped} dedup-skips, {stats.recoveries} recoveries, "
                  f"{stats.duration_s:.1f}s audio")
            if args.wav or not sys.stdin.isatty():
                break
            try:
                ans = input("new session? [Enter=restart / language code to "
                            "switch / q=quit]: ").strip().lower()
            except (EOFError, KeyboardInterrupt):
                break
            if ans in ("q", "quit", "n", "no"):
                break
            if ans and ans not in ("y", "yes"):
                if ans in LANGUAGES:
                    app.change_language(ans)
                    print(f"language → {ans}")
                else:
                    print(f"unknown language {ans!r}; keeping {app.language}")
            app.processor.init()  # fresh streaming state per session (:1268)
    finally:
        app.shutdown()
    return 0


def cmd_wizard(args) -> int:
    """Interactive setup (reference main() wizard, `一键实时识别麦克风.py:
    511-1089`): hardware detect → model/language/task → separation depth
    (recommend_demucs_config analog :332-430, asked at :766-883) →
    quantization → streaming mode, with choices persisted to the config file
    the way the reference writes back the demucs pick (:824-828). With
    ``--cpu`` the recommendations are a CPU session's and the stream runs on
    the CPU."""
    from realtime_whisper_asr_tpu_torch.utils import hardware

    hw = dict(hardware.CPU) if args.cpu else hardware.detect_hardware()
    rec = hardware.recommend_config(hw)
    print(f"🔍 hardware: {hw['platform']} ({hw.get('device_kind')}) ×{hw['n_devices']}")
    print(f"💡 recommended model: {rec['model']} ({rec['reason']})")
    model = input(f"model [{rec['model']}]: ").strip() or rec["model"]
    lang = input("language (en/zh/... or auto) [en]: ").strip() or "en"
    task = input("task (transcribe/translate) [transcribe]: ").strip() or "transcribe"

    music = (input("background music/noise in the audio? (y/n) [n]: ").strip().lower()
             in ("y", "yes"))
    sep = hardware.recommend_separation_config(hw, model, music_expected=music)
    print(f"💡 separation: {sep['method']} ({sep['reason']})")
    sep_method = input(f"separation (none/filter/neural/demucs) [{sep['method']}]: "
                       ).strip() or sep["method"]

    q = hardware.recommend_quantization(hw, model)
    q_default = q["quantization"] or "none"
    print(f"💡 quantization: {q_default} ({q['reason']})")
    quant = input(f"quantization (int8-all/int8/none) [{q_default}]: ").strip() or q_default

    # large models stream best with the SimulStreaming-style incremental mode
    # (the reference's own advice, 先看这个，cursor不用看/先看这个.txt)
    pp_default = "last" if model.startswith(("large", "medium")) else "agree2"
    policy = input(f"streaming mode (agree2=conservative / last=low-latency) "
                   f"[{pp_default}]: ").strip() or pp_default

    wav = input("stream a wav file (path) or mic [mic]: ").strip()

    # persist the choices (reference writes the demucs pick back, :824-828)
    cm = ConfigManager(args.config, autoload=True)
    cm.set("model.size", model)
    cm.set("model.quantization", None if quant == "none" else quant)
    cm.set("streaming.prefix_policy", policy)
    cm.set("vocal_separation.enable", sep_method != "none")
    if sep_method != "none":
        cm.set("vocal_separation.method", sep_method)
        # the recommender's variant/use_device picks ride along when the user
        # kept its method (reference demucs-variant write-back, :824-828)
        if sep_method == sep["method"]:
            for k in ("variant", "use_device", "fuse_encode"):
                if k in sep:
                    cm.set(f"vocal_separation.{k}", sep[k])
    cm.save_config()
    print(f"💾 saved choices to {args.config}")

    argv = ["stream", "--model", model, "--language", lang, "--task", task,
            "--config", args.config, "--quantization", quant,
            "--prefix-policy", policy]
    if wav:
        argv += ["--wav", wav, "--realtime"]
    if args.cpu:
        argv.append("--cpu")
    print(f"▶ running: {' '.join(argv)}")
    return main(argv)


def main(argv=None) -> int:
    from realtime_whisper_asr_tpu_torch.utils.log_filter import install as install_log_filter

    install_log_filter()
    p = argparse.ArgumentParser(prog="realtime_whisper_asr_tpu_torch",
                                description="Realtime Whisper streaming ASR on a CUDA card")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("transcribe", help="offline transcribe a WAV file")
    pt.add_argument("file")
    _add_model_args(pt)
    pt.add_argument("--output-format", default=None,
                    choices=["srt", "vtt", "json", "txt"],
                    help="write the transcript in this format instead of the "
                         "console listing")
    pt.add_argument("--output", default=None,
                    help="output file path (default: stdout); without "
                         "--output-format the format is inferred from the "
                         "extension")
    pt.set_defaults(fn=cmd_transcribe)

    ps = sub.add_parser("stream", help="streaming transcription")
    _add_model_args(ps)
    ps.add_argument("--wav", default=None, help="simulated mic feed from a WAV")
    ps.add_argument("--mic", action="store_true", help="use the microphone")
    ps.add_argument("--device", dest="device_index", type=int, default=None,
                    help="input device index")
    ps.add_argument("--realtime", action="store_true", help="pace simulated feed to wall clock")
    ps.add_argument("--chunk-seconds", type=float, default=0.25)
    ps.add_argument("--max-seconds", type=float, default=None)
    ps.set_defaults(fn=cmd_stream)

    pd = sub.add_parser("devices", help="list audio input devices")
    pd.set_defaults(fn=cmd_devices)

    px = sub.add_parser("separate", help="extract stems from a WAV file")
    px.add_argument("audio", help="input WAV path")
    px.add_argument("--variant", default="4stem",
                    choices=["default", "small", "4stem", "quality", "fast"],
                    help="separator variant (4stem = drums/bass/other/vocals)")
    px.add_argument("--out-dir", default=".", help="where stem WAVs are written")
    _add_cpu_arg(px, "separate on the host path")
    px.set_defaults(fn=cmd_separate)

    ph = sub.add_parser("detect", help="hardware detection report")
    ph.set_defaults(fn=cmd_detect)

    pw = sub.add_parser("wizard", help="interactive setup")
    pw.add_argument("--config", default="config.json")
    _add_cpu_arg(pw, "recommend for and stream")
    pw.set_defaults(fn=cmd_wizard)

    args = p.parse_args(argv)
    if hasattr(args, "cpu"):  # a command that computes: the card unless --cpu
        try:
            args.device = resolve_device("cpu" if args.cpu else "cuda")
        except RuntimeError as e:
            print(f"error: {e} (or pass --cpu)", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
