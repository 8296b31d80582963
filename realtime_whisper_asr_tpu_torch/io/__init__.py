"""Audio I/O edge (SURVEY.md §1 L0): WAV files, mic capture, device recovery."""

from realtime_whisper_asr_tpu_torch.io.wav import read_wav, write_wav
from realtime_whisper_asr_tpu_torch.io.mic import (
    SimulatedMicStream,
    MicrophoneStream,
    list_audio_devices,
)
from realtime_whisper_asr_tpu_torch.io.protector import AudioDeviceProtector
