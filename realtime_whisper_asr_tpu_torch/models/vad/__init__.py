"""Streaming VAD models: DSP energy VAD (host, numpy) and the Silero-like
LSTM VAD (torch, on the card by default)."""

from realtime_whisper_asr_tpu_torch.models.vad.energy import EnergyVAD
from realtime_whisper_asr_tpu_torch.models.vad.silero_like import SileroLikeVAD
