"""PyTorch/CUDA port of realtime_whisper_asr_tpu: streaming Whisper ASR on an
NVIDIA H100.

The port runs on the card by default; its hand-written kernels live under
``csrc/`` and are built with ``nvcc`` at first use. It imports nothing of the
JAX package.
"""

from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
