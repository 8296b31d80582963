"""Side services: async output, translation, performance monitor and
display, logging."""

from realtime_whisper_asr_tpu_torch.services.async_output import AsyncOutput
from realtime_whisper_asr_tpu_torch.services.translation import TranslationManager
from realtime_whisper_asr_tpu_torch.services.perf_monitor import PerformanceMonitor
from realtime_whisper_asr_tpu_torch.services.perf_display import PerformanceDisplay
from realtime_whisper_asr_tpu_torch.services.log_manager import LogManager
