"""Host streaming core: the online ASR protocol (LocalAgreement-n
HypothesisBuffer and OnlineASRProcessor with buffer trimming + prompt carry)
and the VAD-controlled (VAC) wrapper with its VADIterator, run on top of the
port's ASR backend."""

from realtime_whisper_asr_tpu_torch.streaming.hypothesis import HypothesisBuffer
from realtime_whisper_asr_tpu_torch.streaming.online import OnlineASRProcessor
from realtime_whisper_asr_tpu_torch.streaming.vac import VACOnlineASRProcessor, VADIterator
