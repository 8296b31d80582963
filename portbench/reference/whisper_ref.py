"""Plain Whisper in float32: log-mel, encoder, and the teacher-forced decoder.

The reference the benchmark holds the program against. It reads a dense
state dict (the benchmark's ``core/weights.py`` layout: torch's (out, in)
linears, q/k/v fused as ``attn.qkv``) and computes, with plain torch
operations in IEEE float32 (TF32 off):

- the log-mel of a window: a centred 400-point STFT with a periodic Hann
  window, hop 160, the last frame dropped, power, a Slaney mel filterbank,
  log10 floored at 1e-10, clamped to the maximum less 8, then (x + 4) / 4;
- the encoder: two k = 3 convolutions with exact GELU, sinusoidal positions,
  pre-LN blocks (self-attention, MLP), a final layer norm;
- the decoder over a whole token block at once: token and position
  embeddings, pre-LN blocks (causal self-attention, cross-attention on the
  encoder's output, MLP), a final layer norm, the tied head.

A quantization tier is worked out from the dense weights, not taken from
the program: ``weight_bits`` 8 quantizes every block linear and the tied
embedding (its rows for the embedding and the head) per output row,
absmax over 127, round half to even; ``weight_bits`` 4 does so over groups
of 128 inputs, absmax over 7, the control's lower precision. A quantized
linear also quantizes its input per row (absmax over 127) before the
product, as a tier with int8 activations computes. The products of the
integers are then taken in float32.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

N_FFT = 400
HOP = 160
SR = 16000
NEG_MASK = -1e9


@contextlib.contextmanager
def ieee_f32():
    """IEEE float32 matmuls and convolutions inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------- log-mel


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log_step = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / log_step, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    log_step = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(log_step * (m - 15.0)), m * 200.0 / 3)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-normalised triangular filters, (n_mels, 201) float32 (the
    filterbank of librosa's ``filters.mel(norm="slaney")`` at 16 kHz)."""
    fft_f = np.linspace(0.0, SR / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_f[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2: n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(n,) f32 window -> (n // 160, n_mels) f32 normalised log-mel."""
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32, device=audio.device)
    spec = torch.stft(audio, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[:, :-1]
    power = spec.real ** 2 + spec.imag ** 2
    filt = torch.from_numpy(mel_filters(n_mels)).to(audio.device)
    mel = torch.log10(torch.clamp(filt @ power, min=1e-10)).t()
    mel = torch.maximum(mel, mel.max() - 8.0)
    return (mel + 4.0) / 4.0


# -------------------------------------------------------------- weights

_QUANT_STEMS = ("attn.qkv", "attn.out", "cross.query", "cross.key", "cross.value", "cross.out",
                "fc1", "fc2")


def quantize_dense(w: torch.Tensor, bits: int, group: Optional[int] = None) -> torch.Tensor:
    """f32 (out, in) -> its dequantized f32 values: absmax scales over each
    row (``group`` None) or each group of ``group`` inputs, round half to
    even, clipped to the signed range of ``bits`` (less its lowest code)."""
    levels = float(2 ** (bits - 1) - 1)
    w = w.float()
    out, din = w.shape
    g = din if group is None or din % group else group
    wg = w.reshape(out, din // g, g)
    s = torch.clamp(wg.abs().amax(dim=-1, keepdim=True) / levels, min=1e-12)
    return (torch.clamp(torch.round(wg / s), -levels, levels) * s).reshape(out, din)


def quantize_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row int8 quantization of activations, dequantized."""
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    return torch.clamp(torch.round(x / s), -127.0, 127.0) * s


class RefWeights:
    """The reference's weights of one tier, f32 on ``device``: a dense
    state dict, its block linears and tied embedding quantized as
    ``weight_bits`` says (None: dense)."""

    def __init__(self, state: dict, cfg: dict, device, weight_bits: Optional[int] = None):
        self.cfg = cfg
        self.bits = weight_bits
        group = 128 if weight_bits == 4 else None
        self.w: dict[str, torch.Tensor] = {}
        for key, t in state.items():
            t = t.to(device=device, dtype=torch.float32)
            stem = key.rsplit(".", 1)[0]
            quant = weight_bits is not None and (
                (key.endswith(".weight") and stem.split(".", 3)[-1] in _QUANT_STEMS
                 and ".blocks." in key)
                or key == "decoder.tok_emb")
            self.w[key] = quantize_dense(t, weight_bits, group) if quant else t

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w = self.w[f"{name}.weight"]
        b = self.w.get(f"{name}.bias")
        if self.bits is not None:
            x = quantize_rows(x)
        return F.linear(x, w, b)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits is not None:
            x = quantize_rows(x)
        return x @ self.w["decoder.tok_emb"].t()


# ---------------------------------------------------------------- model


def _ln(w: RefWeights, x: torch.Tensor, name: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w.w[f"{name}.weight"], w.w[f"{name}.bias"], 1e-5)


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.view(b, t, n, d // n).transpose(1, 2)


def _attend(q, k, v, mask=None) -> torch.Tensor:
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        s = s + mask
    o = torch.softmax(s, dim=-1) @ v
    b, h, t, dh = o.shape
    return o.transpose(1, 2).reshape(b, t, h * dh)


def encode(w: RefWeights, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, n_mels) -> (B, T/2, d)."""
    cfg, n = w.cfg, w.cfg["encoder_attention_heads"]
    x = F.gelu(F.conv1d(mel.transpose(1, 2), w.w["encoder.conv1.weight"],
                        w.w["encoder.conv1.bias"], padding=1))
    x = F.gelu(F.conv1d(x, w.w["encoder.conv2.weight"], w.w["encoder.conv2.bias"],
                        stride=2, padding=1)).transpose(1, 2)
    x = x + w.w["encoder.pos_emb"][: x.shape[1]]
    for i in range(cfg["encoder_layers"]):
        p = f"encoder.blocks.{i}"
        q, k, v = w.linear(_ln(w, x, f"{p}.attn_ln"), f"{p}.attn.qkv").chunk(3, dim=-1)
        x = x + w.linear(_attend(_heads(q, n), _heads(k, n), _heads(v, n)), f"{p}.attn.out")
        h = _ln(w, x, f"{p}.mlp_ln")
        x = x + w.linear(F.gelu(w.linear(h, f"{p}.fc1")), f"{p}.fc2")
    return _ln(w, x, "encoder.ln_post")


def decode(w: RefWeights, tokens: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) from position 0 over xa (B, A, d) -> logits (B, T, V)."""
    cfg, n = w.cfg, w.cfg["decoder_attention_heads"]
    t = tokens.shape[1]
    emb = w.w["decoder.tok_emb"]
    x = emb[tokens] + w.w["decoder.pos_emb"][:t]
    causal = torch.triu(torch.full((t, t), NEG_MASK, device=x.device), diagonal=1)
    for i in range(cfg["decoder_layers"]):
        p = f"decoder.blocks.{i}"
        q, k, v = w.linear(_ln(w, x, f"{p}.attn_ln"), f"{p}.attn.qkv").chunk(3, dim=-1)
        x = x + w.linear(_attend(_heads(q, n), _heads(k, n), _heads(v, n), causal),
                         f"{p}.attn.out")
        q = w.linear(_ln(w, x, f"{p}.cross_ln"), f"{p}.cross.query")
        k = w.linear(xa, f"{p}.cross.key")
        v = w.linear(xa, f"{p}.cross.value")
        x = x + w.linear(_attend(_heads(q, n), _heads(k, n), _heads(v, n)), f"{p}.cross.out")
        h = _ln(w, x, f"{p}.mlp_ln")
        x = x + w.linear(F.gelu(w.linear(h, f"{p}.fc1")), f"{p}.fc2")
    return w.head(_ln(w, x, "decoder.ln"))


def pcm16(audio: np.ndarray) -> np.ndarray:
    """The samples as 16-bit PCM carries them (the program's transfer
    encoding to the device), back in f32."""
    q = np.clip(np.round(np.asarray(audio, np.float32) * 32768.0), -32768, 32767)
    return (q / 32768.0).astype(np.float32)


def window_logits(w: RefWeights, audio: np.ndarray, bucket_samples: int,
                  tokens: list, device) -> torch.Tensor:
    """Logits (T, V) of a token block over one window: the audio (as 16-bit
    PCM), zero-padded to ``bucket_samples``, its log-mel, encoder, decoder."""
    pad = np.zeros(bucket_samples, np.float32)
    a = pcm16(audio)[:bucket_samples]
    pad[: len(a)] = a
    with torch.no_grad(), ieee_f32():
        mel = log_mel(torch.from_numpy(pad).to(device), w.cfg["num_mel_bins"])
        xa = encode(w, mel[None])
        tok = torch.tensor([tokens], dtype=torch.long, device=device)
        return decode(w, tok, xa)[0]

