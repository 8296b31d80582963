"""Host streaming core: the online ASR protocol (LocalAgreement-n
HypothesisBuffer and OnlineASRProcessor with buffer trimming + prompt carry),
run on top of the port's ASR backend."""

from realtime_whisper_asr_tpu_torch.streaming.hypothesis import HypothesisBuffer
from realtime_whisper_asr_tpu_torch.streaming.online import OnlineASRProcessor
