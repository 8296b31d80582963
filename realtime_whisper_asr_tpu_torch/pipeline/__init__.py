"""Pipeline stages around the ASR core: vocal separation → audio-dedup gate
→ VAC → ASR → timestamp validation → skip detector, with speech-rate
adaptation (the silence controller, the time stretch, the adaptive decode
parameters)."""

from realtime_whisper_asr_tpu_torch.pipeline.skip_detector import SkipDetector
from realtime_whisper_asr_tpu_torch.pipeline.dedup_audio import AudioDeduplicator
from realtime_whisper_asr_tpu_torch.pipeline.speech_rate import (
    SpeechRateDetector,
    AdaptiveSilenceController,
    SpeechRateAdaptiveProcessor,
)
from realtime_whisper_asr_tpu_torch.pipeline.stretch import (
    SpeechRateAudioProcessor,
    AdaptiveWhisperParams,
)
from realtime_whisper_asr_tpu_torch.pipeline.separation import (
    VocalSeparator,
    BandpassSeparator,
    DemucsSeparator,
    create_separator,
)
