"""Pipeline stages around the ASR core that the port has: the text-level
skip detector the multi-stream server runs on every result."""

from realtime_whisper_asr_tpu_torch.pipeline.skip_detector import SkipDetector
