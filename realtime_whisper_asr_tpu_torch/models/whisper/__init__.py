"""Whisper in PyTorch: config, model, weight conversion, decoding, tokenizer,
word timestamps."""
