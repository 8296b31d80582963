"""Whisper in PyTorch: config, model, weight conversion and checkpoint
loading, decoding, tokenizer, word timestamps."""

from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import (
    is_native_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from realtime_whisper_asr_tpu_torch.models.whisper.config import (
    LANGUAGES,
    PRESETS,
    WhisperConfig,
    get_config,
)
from realtime_whisper_asr_tpu_torch.models.whisper.load import (
    config_from_hf,
    load_checkpoint_dir,
    params_from_hf_state_dict,
)
from realtime_whisper_asr_tpu_torch.models.whisper.model import (
    DecoderCache,
    Whisper,
    init_params,
)
from realtime_whisper_asr_tpu_torch.models.whisper.quant import detect_quantization
