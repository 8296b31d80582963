"""Silero-class streaming VAD in torch: STFT → encoder → causal conv → LSTM.

Port of ``realtime_whisper_asr_tpu/models/vad/silero_like.py``. The model is
one ``nn.Module`` (``SileroLikeNet``) whose submodules carry the torch
layouts the JAX package's ``params_from_torch_state_dict`` reads: ``proj``
(Linear 257→64), ``conv`` (Conv1d 64→64, k = 3, causal), ``lstm`` (LSTM 64,
gate order i, f, g, o) and ``head`` (Linear 64→1). Its ``forward(frames,
state)`` runs a batch of 512-sample frames with the carried state (the last
two projected frames and the LSTM's h and c) in one call, as the JAX
package's ``vad_scan`` does; ``SileroLikeVAD`` is the streaming adapter the
VAC loop calls, ``prob_fn(frames (N, 512) numpy) -> (N,) numpy``.
``SileroLikeNet.sequence_logits`` is the JAX package's
``vad_sequence_logits`` batched: (B, T, 512) frames from a zero state to
(B, T) logits, the training forward (``tools/train_vad.py``).

The trained weights ship with the port (``weights/silero_like.npz``, the JAX
package's file in its layout) and load by default; ``params_from_jax`` maps
that layout onto the module's state dict. cuDNN runs the conv and the LSTM
in IEEE f32 (``device.no_tf32_cudnn``): TF32 would move the probabilities by
~1e-3, enough to move a VAD event.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from realtime_whisper_asr_tpu_torch.device import no_tf32_cudnn, resolve_device

FRAME = 512
N_FREQ = FRAME // 2 + 1  # 257
ENC = 64
HIDDEN = 64
CONV_K = 3

_PACKAGED_WEIGHTS = os.path.join(os.path.dirname(__file__), "weights", "silero_like.npz")


def params_from_jax(params: dict) -> dict:
    """The JAX package's VAD pytree (numpy leaves: linear weights (in, out),
    conv (time, in, out), one LSTM bias) -> ``SileroLikeNet``'s state dict.
    The LSTM bias goes to ``bias_ih_l0``; ``bias_hh_l0`` is zero."""

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, np.float32, order="C"))

    return {
        "proj.weight": t(np.asarray(params["proj_w"]).T),
        "proj.bias": t(params["proj_b"]),
        "conv.weight": t(np.asarray(params["conv_w"]).transpose(2, 1, 0)),
        "conv.bias": t(params["conv_b"]),
        "lstm.weight_ih_l0": t(np.asarray(params["lstm_wx"]).T),
        "lstm.weight_hh_l0": t(np.asarray(params["lstm_wh"]).T),
        "lstm.bias_ih_l0": t(params["lstm_b"]),
        "lstm.bias_hh_l0": torch.zeros(4 * HIDDEN),
        "head.weight": t(np.asarray(params["head_w"]).T),
        "head.bias": t(params["head_b"]),
    }


def params_to_jax(state: dict) -> dict:
    """``SileroLikeNet``'s state dict -> the JAX package's VAD pytree (numpy
    f32 leaves), the layout of the packaged npz; the LSTM's two biases
    summed into ``lstm_b``."""

    def t(name: str) -> np.ndarray:
        return state[name].detach().to("cpu", torch.float32).numpy()

    return {
        "proj_w": t("proj.weight").T.copy(),
        "proj_b": t("proj.bias"),
        "conv_w": t("conv.weight").transpose(2, 1, 0).copy(),
        "conv_b": t("conv.bias"),
        "lstm_wx": t("lstm.weight_ih_l0").T.copy(),
        "lstm_wh": t("lstm.weight_hh_l0").T.copy(),
        "lstm_b": t("lstm.bias_ih_l0") + t("lstm.bias_hh_l0"),
        "head_w": t("head.weight").T.copy(),
        "head_b": t("head.bias"),
    }


def load_packaged_params() -> dict:
    """The trained weights shipped with the port, in the JAX package's layout."""
    with np.load(_PACKAGED_WEIGHTS) as data:
        return {k: data[k] for k in data.files}


class SileroLikeNet(nn.Module):
    """The VAD model on ``device`` (the card unless asked otherwise; raises
    without CUDA). Its weights start as the JAX package's initializer draws
    them (normal with variance 2/fan, zero biases), from a
    ``torch.Generator`` seeded with ``seed``; load trained ones with
    ``load_state_dict(params_from_jax(...))``."""

    def __init__(self, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        with torch.device("meta"):
            self.proj = nn.Linear(N_FREQ, ENC)
            self.conv = nn.Conv1d(ENC, ENC, CONV_K)
            self.lstm = nn.LSTM(ENC, HIDDEN)
            self.head = nn.Linear(HIDDEN, 1)
        self.to_empty(device=dev)
        self.register_buffer(
            "window", torch.from_numpy(np.hanning(FRAME).astype(np.float32)).to(dev),
            persistent=False)  # symmetric, as the JAX package's (not torch.hann_window)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if "bias" in name:
                    p.zero_()
                    continue
                fan = sum(p.shape) if p.dim() == 2 else p.shape[0] + p.shape[1]
                p.copy_(torch.randn(p.shape, generator=gen) * (2.0 / fan) ** 0.5)

    def init_state(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(conv tail (CONV_K - 1, ENC), LSTM h (HIDDEN,), LSTM c (HIDDEN,)), zero."""
        dev = self.window.device
        return (torch.zeros(CONV_K - 1, ENC, device=dev), torch.zeros(HIDDEN, device=dev),
                torch.zeros(HIDDEN, device=dev))

    def forward(self, frames: torch.Tensor, state: tuple) -> tuple[torch.Tensor, tuple]:
        """(N, 512) f32 frames + carried state -> ((N,) speech probabilities,
        new state), the JAX package's ``vad_scan``."""
        conv_tail, h, c = state
        with no_tf32_cudnn():
            spec = torch.fft.rfft(frames * self.window, dim=-1).abs()
            x = torch.relu(self.proj(torch.log1p(spec * 8.0)))  # (N, ENC)
            xt = torch.cat([conv_tail, x])  # causal context: (N + CONV_K - 1, ENC)
            y = torch.relu(self.conv(xt.t()[None]))[0].t()  # (N, ENC)
            out, (h, c) = self.lstm(y[:, None], (h[None, None], c[None, None]))
            probs = torch.sigmoid(self.head(out[:, 0]))[:, 0]
        return probs, (xt[-(CONV_K - 1):], h[0, 0], c[0, 0])

    def sequence_logits(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, 512) f32 frames -> (B, T) pre-sigmoid logits from a zero
        state: the JAX package's ``vad_sequence_logits`` (under
        ``jax.vmap``), the same network as ``forward``. Differentiable; a
        training step runs it and its backward under
        ``device.exact_kernels``, and keeps ``lstm.bias_hh_l0`` frozen at 0
        (``params_from_jax`` puts the JAX tree's one LSTM bias in
        ``bias_ih_l0``: training both would move the summed bias twice)."""
        spec = torch.fft.rfft(frames * self.window, dim=-1).abs()
        x = torch.relu(self.proj(torch.log1p(spec * 8.0)))  # (B, T, ENC)
        xt = F.pad(x.transpose(1, 2), (CONV_K - 1, 0))  # causal context, zero
        y = torch.relu(self.conv(xt)).permute(2, 0, 1)  # (T, B, ENC)
        out, _ = self.lstm(y)  # zero (h, c)
        return self.head(out)[..., 0].t()


class SileroLikeVAD:
    """Stateful streaming adapter: ``prob_fn(frames (N, 512)) -> (N,)``.

    ``params``: the JAX package's VAD pytree (numpy leaves, as the npz holds
    them); the packaged trained weights when None. Runs on the card unless
    ``device`` says otherwise, and raises when CUDA is absent. ``net``: a
    loaded ``SileroLikeNet`` to share with other VADs in place of loading
    one (``params`` and ``device`` are then unused); each VAD keeps its own
    state, so N streams hold one copy of the weights."""

    def __init__(self, params: dict | None = None, device="cuda",
                 net: SileroLikeNet | None = None):
        self.trained = params is None
        if net is None:
            net = SileroLikeNet(device)
            net.load_state_dict(params_from_jax(
                load_packaged_params() if params is None else params))
        self.net = net
        self.reset()

    @property
    def device(self) -> torch.device:
        return self.net.window.device

    def reset(self):
        self.state = self.net.init_state()

    @torch.inference_mode()
    def __call__(self, frames: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(self.device)
        probs, self.state = self.net(x, self.state)
        return probs.cpu().numpy()
