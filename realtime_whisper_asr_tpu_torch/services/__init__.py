"""Side services that the port has: the performance monitor whose
load-shedding predicates the multi-stream server applies per stream."""

from realtime_whisper_asr_tpu_torch.services.perf_monitor import PerformanceMonitor
