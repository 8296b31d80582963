"""JSON config system with per-language overrides."""

from realtime_whisper_asr_tpu_torch.config.manager import ConfigManager, DEFAULT_CONFIG
