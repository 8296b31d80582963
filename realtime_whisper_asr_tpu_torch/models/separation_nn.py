"""Neural vocal separation: the spectral-mask network in PyTorch.

Port of ``realtime_whisper_asr_tpu/models/separation_nn.py``: STFT
magnitude → dilated 3×3 convolutions over (time, freq) → sigmoid vocal mask
(or a softmax stem partition) → masked iSTFT. On the device
(``separate_vocals``, ``separate_stems_device``) the STFT is ``torch.fft``
and the convolutions ``F.conv2d`` (cuDNN on the card, run with TF32 off);
the host mirror (``separate_vocals_np``) is the JAX package's numpy STFT
over the same torch CPU convolutions, copied.

Weights: the packaged npz files (copied byte for byte from the JAX package)
hold the JAX layout, numpy HWIO convolution kernels. ``params_from_jax``
carries such a dict to the port's layout: torch tensors with OIHW kernels on
a device. ``arch_of`` and ``n_stems_of`` read either layout.

Deliberate difference: an error on the card propagates. The JAX separator
catches every exception and returns the input unseparated; here only the
length rule (``n < N_FFT`` returns the input) is kept.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from realtime_whisper_asr_tpu_torch.device import no_tf32_cudnn, resolve_device

N_FFT = 1024
HOP = 256
F_BINS = N_FFT // 2 + 1  # 513

#: v2 architecture: 2-channel input (log-magnitude ‖ normalized frequency
#: coordinate), four dilated conv layers whose (time, freq) dilations grow
#: the receptive field to ~±8 frames × ±26 bins
V2_DIL = ((1, 1), (1, 4), (2, 8), (2, 4), (1, 1))  # per layer + output conv

_WEIGHTS = os.path.join(os.path.dirname(__file__), "weights")
_PACKAGED_WEIGHTS = os.path.join(_WEIGHTS, "separation_nn.npz")

#: packaged model variants: "default" is the full-width v2 net, "small"
#: trades ~2.6× fewer MACs for a few dB, "4stem" partitions the mixture
VARIANT_WEIGHTS = {
    "default": _PACKAGED_WEIGHTS,
    "small": os.path.join(_WEIGHTS, "separation_nn_small.npz"),
    "4stem": os.path.join(_WEIGHTS, "separation_nn_4stem.npz"),
}
VARIANT_ALIASES = {"quality": "default", "hq": "default", "fast": "small"}

#: 4-stem head order: vocals lead, so every n-stem net's channel 0 is the
#: ASR frontend's target
STEM_NAMES = ("vocals", "drums", "bass", "other")

#: the separator's padded input lengths (its bucket set)
BUCKETS = (16384, 65536, 262144, 524288)


def _in_out(w) -> tuple[int, int]:
    """(input, output) channels of a conv kernel: a torch tensor is the
    port's OIHW, anything else the JAX package's HWIO."""
    if isinstance(w, torch.Tensor):
        return int(w.shape[1]), int(w.shape[0])
    return int(w.shape[2]), int(w.shape[3])


def _n_layers(params: dict) -> int:
    return len([k for k in params if k.startswith("enc") and k.endswith("_w")])


def n_stems_of(params: dict) -> int:
    """1 = sigmoid vocal mask; >1 = softmax stem partition (shape-only)."""
    return _in_out(params["out_w"])[1]


def arch_of(params: dict) -> tuple[tuple[tuple[int, int], ...], int]:
    """(dilations per conv incl. output, input channels): v1 weights
    (1 input channel) use dilation 1 everywhere; v2 weights (2) use
    V2_DIL."""
    n_layers = _n_layers(params)
    in_ch = _in_out(params["enc0_w"])[0]
    if in_ch >= 2:
        return V2_DIL[: n_layers + 1], in_ch
    return ((1, 1),) * (n_layers + 1), in_ch


#: v1 channels (1-channel input, dilation 1 everywhere)
_CH = (16, 32, 16)
V2_CHANNELS = (16, 24, 32, 24)
#: the "small" variant: the same dilations, ~2.6x fewer MACs
V2_SMALL_CHANNELS = (8, 12, 16, 12)


def _conv_init(generator: torch.Generator, c_in: int, c_out: int, scale: float) -> torch.Tensor:
    """A 3x3 kernel of standard normals times ``scale``, drawn in the JAX
    layout's (3, 3, c_in, c_out) order, returned OIHW."""
    w = torch.randn((3, 3, c_in, c_out), generator=generator) * scale
    return w.permute(3, 2, 0, 1).contiguous()


def init_separator_params(generator: torch.Generator, device="cuda") -> dict:
    """v1 weights in the port's layout on ``device``: the JAX package's
    ``init_separator_params`` shapes and scale (normal x 0.1, zero biases).
    The draws are ``torch.randn``'s from ``generator``, not
    ``jax.random.normal``'s: the same distribution, other numbers."""
    dev = resolve_device(device)
    params, c_in = {}, 1
    for i, c in enumerate(_CH):
        params[f"enc{i}_w"] = _conv_init(generator, c_in, c, 0.1).to(dev)
        params[f"enc{i}_b"] = torch.zeros(c, device=dev)
        c_in = c
    params["out_w"] = _conv_init(generator, c_in, 1, 0.1).to(dev)
    params["out_b"] = torch.zeros(1, device=dev)
    return params


def init_separator_params_v2(generator: torch.Generator, channels: tuple = V2_CHANNELS,
                             n_stems: int = 1, device="cuda") -> dict:
    """v2 trunk and mask head in the port's layout on ``device``: the JAX
    package's ``init_separator_params_v2`` shapes and scales (normal x
    (9·c_in)^-1/2, zero biases; a 2-channel input; ``n_stems`` 1 for the
    sigmoid vocal mask, 4 for the softmax stem partition). The draws are
    ``torch.randn``'s from ``generator``, not ``jax.random.normal``'s."""
    dev = resolve_device(device)
    params, c_in = {}, 2
    for i, c in enumerate(channels):
        params[f"enc{i}_w"] = _conv_init(generator, c_in, c, (9 * c_in) ** -0.5).to(dev)
        params[f"enc{i}_b"] = torch.zeros(c, device=dev)
        c_in = c
    params["out_w"] = _conv_init(generator, c_in, n_stems, (9 * c_in) ** -0.5).to(dev)
    params["out_b"] = torch.zeros(n_stems, device=dev)
    return params


def params_to_jax(params: dict) -> dict:
    """The inverse of ``params_from_jax``: numpy f32 arrays, HWIO kernels,
    the layout of the packaged npz files that both packages load."""
    out = {}
    for k, v in params.items():
        t = v.detach().float().cpu()
        if k.endswith("_w"):
            t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
        out[k] = np.ascontiguousarray(t.numpy())
    return out


def params_from_jax(params: dict, device="cuda") -> dict:
    """The JAX package's separator params (numpy or jax arrays, HWIO
    kernels) as the port's: f32 tensors on ``device``, OIHW kernels."""
    out = {}
    for k, v in params.items():
        t = torch.from_numpy(np.array(v, np.float32))
        if k.endswith("_w"):
            t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
        out[k] = t.to(device)
    return out


@functools.lru_cache(maxsize=4)
def _window_np() -> np.ndarray:
    return np.hanning(N_FFT).astype(np.float32)


def _window(device) -> torch.Tensor:
    return torch.from_numpy(_window_np()).to(device)


_R = N_FFT // HOP


def _stft(audio: torch.Tensor) -> torch.Tensor:
    """(..., N) f32 -> (..., T, F) complex64, frames of the reflect-padded
    signal (numpy's reflect), the symmetric Hann window."""
    lead, n = audio.shape[:-1], audio.shape[-1]
    pad = N_FFT // 2
    x = F.pad(audio.reshape(-1, n), (pad, pad), mode="reflect")
    frames = x.unfold(-1, N_FFT, HOP)
    spec = torch.fft.rfft(frames * _window(audio.device), dim=-1)
    return spec.reshape(*lead, *spec.shape[-2:])


def _istft(spec: torch.Tensor, out_len: int) -> torch.Tensor:
    """(..., T, F) -> (..., out_len): windowed overlap-add over R shifted
    slices of a (rows, HOP) grid, added for p = 0 .. R-1 as the JAX package
    adds them, divided by the summed squared window."""
    window = _window(spec.device)
    frames = torch.fft.irfft(spec, N_FFT, dim=-1) * window
    lead, n_frames = frames.shape[:-2], frames.shape[-2]
    n_rows = n_frames + _R - 1
    fr = frames.reshape(*lead, n_frames, _R, HOP)
    w2 = (window * window).reshape(_R, HOP)
    out = frames.new_zeros(*lead, n_rows, HOP)
    acc = frames.new_zeros(n_rows, HOP)
    for p in range(_R):
        out[..., p : p + n_frames, :] += fr[..., p, :]
        acc[p : p + n_frames] += w2[p]
    res = out.reshape(*lead, -1) / torch.clamp(acc.reshape(-1), min=1e-6)
    pad = N_FFT // 2
    return res[..., pad : pad + out_len]


def _mask_logits(params: dict, audio: torch.Tensor, dil=None):
    """Shared trunk: (B, N) f32 -> (spec (B, T, F), logits (B, C, T, F)).

    ``params``: the port's layout (``params_from_jax``). v2 nets take a
    2-channel input whose channel 1 is the normalized frequency coordinate.
    Each conv is ``F.conv2d`` with padding and dilation (dt, df), then the
    bias added and the ReLU applied in place (the JAX order: conv, + bias,
    ReLU), inside ``no_tf32_cudnn``."""
    n_layers = _n_layers(params)
    if dil is None:
        dil, _ = arch_of(params)
    in_ch = _in_out(params["enc0_w"])[0]
    spec = _stft(audio.float())
    mag = torch.log1p(spec.abs())  # (B, T, F)
    if in_ch >= 2:
        fcoord = torch.linspace(0.0, 1.0, mag.shape[-1], device=mag.device).expand_as(mag)
        x = torch.stack([mag, fcoord], dim=1)  # (B, 2, T, F)
    else:
        x = mag[:, None]
    with no_tf32_cudnn():
        for i in range(n_layers):
            dt, df = dil[i]
            x = F.conv2d(x, params[f"enc{i}_w"], None, padding=(dt, df), dilation=(dt, df))
            x = x.add_(params[f"enc{i}_b"][:, None, None]).relu_()
        dt, df = dil[n_layers]
        x = F.conv2d(x, params["out_w"], None, padding=(dt, df), dilation=(dt, df))
    return spec, x.add_(params["out_b"][:, None, None])


def _masks(logits: torch.Tensor) -> torch.Tensor:
    """(B, C, T, F) logits -> (B, C, T, F) masks: a sigmoid for one
    channel, a softmax over the stems otherwise."""
    if logits.shape[1] == 1:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=1)


def separate_vocals(params: dict, audio: torch.Tensor, dil=None) -> torch.Tensor:
    """(N,) or (B, N) float32 on a device -> vocals of the same shape.

    1-stem nets apply a sigmoid vocal mask; n-stem nets take the softmax
    partition's vocals channel (STEM_NAMES[0]). Callers pad to a bucket;
    the zero tail enters the STFT."""
    rows = audio.reshape(-1, audio.shape[-1])
    spec, logits = _mask_logits(params, rows, dil)
    mask = _masks(logits)[:, 0]
    return _istft(spec * mask, rows.shape[-1]).reshape(audio.shape)


def separate_stems_device(params: dict, audio: torch.Tensor, dil=None) -> torch.Tensor:
    """(N,) float32 on a device -> (C, N) stems. Softmax masks sum to 1 per
    TF bin, so the stems partition the mixture up to overlap-add error."""
    spec, logits = _mask_logits(params, audio.reshape(1, -1), dil)
    masks = _masks(logits)[0]  # (C, T, F)
    return _istft(spec[0][None] * masks, audio.shape[-1])


def separation_bytes(params: dict, n_samples: int) -> int:
    """Peak bytes of the device separation of one row of ``n_samples``:
    the widest conv's input and output activations at once (the bias and
    ReLU run in place), beside the complex spectrum, its log-magnitude and
    the mask, all (T, F) f32 planes (a complex plane counts 2)."""
    t = 1 + n_samples // HOP
    widths = [_in_out(params[f"enc{i}_w"]) for i in range(_n_layers(params))]
    widths.append(_in_out(params["out_w"]))
    widest = max(c_in + c_out for c_in, c_out in widths)
    return t * F_BINS * 4 * (widest + 4)


# ---------------------------------------------------------------- host mirror


def _conv_stack_torch(params: dict, h0: np.ndarray, dil) -> np.ndarray:
    """(T, F, Cin) -> mask logits (T, F, Cout) via torch's CPU conv2d."""
    n_layers = _n_layers(params)
    h = torch.from_numpy(np.ascontiguousarray(h0.transpose(2, 0, 1))[None])  # (1,C,T,F)
    for i in range(n_layers):
        w = torch.from_numpy(params[f"enc{i}_w"]).permute(3, 2, 0, 1)  # HWIO->OIHW
        b = torch.from_numpy(params[f"enc{i}_b"])
        dt, df = dil[i]
        h = F.relu(F.conv2d(h, w, b, padding=(dt, df), dilation=(dt, df)))
    w = torch.from_numpy(params["out_w"]).permute(3, 2, 0, 1)
    dt, df = dil[n_layers]
    h = F.conv2d(h, w, None, padding=(dt, df), dilation=(dt, df))
    return h[0].permute(1, 2, 0).numpy() + params["out_b"]


def _mask_logits_np(params: dict, x: np.ndarray):
    """Host trunk mirror: (N,) f32 -> (spec (T,F), logits (T,F,C))."""
    window = _window_np()
    pad = N_FFT // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(xp) - N_FFT) // HOP
    idx = np.arange(n_frames)[:, None] * HOP + np.arange(N_FFT)[None, :]
    spec = np.fft.rfft(xp[idx] * window, axis=-1)  # (T, F)
    mag = np.log1p(np.abs(spec)).astype(np.float32)
    dil, in_ch = arch_of(params)
    if in_ch >= 2:
        fcoord = np.broadcast_to(
            np.linspace(0.0, 1.0, mag.shape[1], dtype=np.float32)[None, :], mag.shape
        )
        h = np.stack([mag, fcoord], axis=-1)  # (T, F, 2)
    else:
        h = mag[:, :, None]  # (T, F, 1)
    p = {k: np.asarray(v, np.float32) for k, v in params.items()}
    with torch.inference_mode():
        return spec, _conv_stack_torch(p, h, dil)


def _istft_np(spec_masked: np.ndarray, out_len: int) -> np.ndarray:
    window = _window_np()
    pad = N_FFT // 2
    n_frames = spec_masked.shape[0]
    frames = np.fft.irfft(spec_masked, N_FFT, axis=-1).astype(np.float32) * window
    grid = np.zeros((n_frames + _R, HOP), np.float32)
    accg = np.zeros((n_frames + _R, HOP), np.float32)
    w2 = (window * window).reshape(_R, HOP)
    for p in range(_R):
        grid[p : p + n_frames] += frames[:, p * HOP : (p + 1) * HOP]
        accg[p : p + n_frames] += w2[p]
    out = grid.reshape(-1) / np.maximum(accg.reshape(-1), 1e-6)
    return out[pad : pad + out_len]


def _softmax_np(z: np.ndarray) -> np.ndarray:
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def separate_vocals_np(params: dict, audio: np.ndarray) -> np.ndarray:
    """Host mirror of separate_vocals, on the JAX-layout params: numpy
    STFT, torch's CPU convolutions, numpy iSTFT — the JAX package's host
    mirror, copied."""
    x = np.asarray(audio, np.float32)
    spec, logits = _mask_logits_np(params, x)
    if logits.shape[-1] == 1:
        mask = 1.0 / (1.0 + np.exp(-logits[:, :, 0]))  # (T, F)
    else:
        mask = _softmax_np(logits)[:, :, 0]
    return _istft_np(spec * mask, len(x))


def separate_stems_np(params: dict, audio: np.ndarray) -> np.ndarray:
    """Host mirror of separate_stems_device: (N,) -> (C, N)."""
    x = np.asarray(audio, np.float32)
    spec, logits = _mask_logits_np(params, x)
    if logits.shape[-1] == 1:
        masks = (1.0 / (1.0 + np.exp(-logits)))
    else:
        masks = _softmax_np(logits)
    return np.stack(
        [_istft_np(spec * masks[:, :, c], len(x)) for c in range(masks.shape[-1])]
    )


def _padded(seg: np.ndarray, buckets) -> np.ndarray:
    nb = next(b for b in buckets if len(seg) <= b)
    padded = np.zeros(nb, np.float32)
    padded[: len(seg)] = seg
    return padded


class NeuralSeparator:
    """pipeline.separation-compatible vocal separator (method name: neural).

    ``params``: the JAX layout (numpy HWIO), kept on the host for the host
    mirror and ``save_npz``; the packaged ``variant``'s trained weights when
    None (the JAX package's random initialization for missing weights is not
    ported: every variant's weights ship with the port). With ``use_device``
    (the default) ``separate`` runs on ``device`` (the card unless asked
    otherwise; raises without CUDA), each chunk padded to its bucket;
    otherwise the host mirror runs."""

    name = "neural"

    def __init__(self, params: dict | None = None, use_device: bool = True,
                 variant: str = "default", device="cuda"):
        self.variant = VARIANT_ALIASES.get(variant, variant)
        if self.variant not in VARIANT_WEIGHTS:
            raise ValueError(
                f"unknown separator variant {variant!r} "
                f"(one of {sorted(VARIANT_WEIGHTS) + sorted(VARIANT_ALIASES)})"
            )
        self.trained = params is None
        if params is None:
            data = np.load(VARIANT_WEIGHTS[self.variant])
            params = {k: np.asarray(data[k]) for k in data.files}
        self.params = params
        self.use_device = use_device
        self.device = resolve_device(device) if use_device else None
        self._params_dev = None  # the port's layout on the device, at first use
        self.stats = {"processed": 0, "errors": 0}
        self._buckets = list(BUCKETS)

    def _device_params(self) -> dict:
        if self._params_dev is None:
            self._params_dev = params_from_jax(self.params, self.device)
        return self._params_dev

    @torch.inference_mode()
    def separate(self, audio: np.ndarray) -> np.ndarray:
        self.stats["processed"] += 1
        x = np.asarray(audio, np.float32)
        n = len(x)
        if n < N_FFT:
            return audio
        if not self.use_device:
            return separate_vocals_np(self.params, x)
        params = self._device_params()

        def one(seg: np.ndarray) -> np.ndarray:
            padded = torch.from_numpy(_padded(seg, self._buckets)).to(self.device)
            return separate_vocals(params, padded).cpu().numpy()[: len(seg)]

        if n <= self._buckets[-1]:
            return one(x)
        # beyond the largest bucket (long offline files): windowed with
        # crossfaded joins, every device call inside the bucket set
        from realtime_whisper_asr_tpu_torch.pipeline.separation import overlap_windowed

        return overlap_windowed(one, x, self._buckets[-1])

    def separate_stems(self, audio: np.ndarray) -> dict:
        """Named stems. 1-stem (sigmoid) nets return {"vocals",
        "accompaniment"}, the accompaniment the time-domain complement
        ``mix − vocals``; 4-stem nets return {"vocals","drums","bass",
        "other"} from the softmax partition plus "accompaniment"."""
        x = np.asarray(audio, np.float32)
        n_stems = n_stems_of(self.params)
        if n_stems == 1 or len(x) < N_FFT:
            vocals = np.asarray(self.separate(x), np.float32)
            return {"vocals": vocals, "accompaniment": x - vocals}
        stems = self._stems_array(x)  # (C, N)
        out = {name: stems[i] for i, name in enumerate(STEM_NAMES[:n_stems])}
        out["accompaniment"] = x - out["vocals"]
        return out

    @torch.inference_mode()
    def _stems_array(self, x: np.ndarray) -> np.ndarray:
        """(N,) -> (C, N) with the same bucket/window discipline as
        ``separate``; windows crossfade per stem."""
        n = len(x)
        if not self.use_device:
            one = lambda seg: separate_stems_np(self.params, seg)  # noqa: E731
        else:
            params = self._device_params()

            def one(seg: np.ndarray) -> np.ndarray:
                padded = torch.from_numpy(_padded(seg, self._buckets)).to(self.device)
                return separate_stems_device(params, padded).cpu().numpy()[:, : len(seg)]

        if n <= self._buckets[-1]:
            return one(x)
        block, overlap = self._buckets[-1], 4096
        n_stems = n_stems_of(self.params)
        out = np.zeros((n_stems, n), np.float32)
        acc = np.zeros(n, np.float32)
        ramp = np.linspace(0.0, 1.0, overlap, dtype=np.float32)
        step = block - overlap
        for start in range(0, n, step):
            piece = one(x[start : start + block])  # (C, m)
            m = piece.shape[1]
            w = np.ones(m, np.float32)
            if start > 0:
                w[: min(overlap, m)] = ramp[: min(overlap, m)]
            if start + m < n and m > overlap:
                w[-overlap:] *= ramp[::-1]
            out[:, start : start + m] += piece * w[None, :]
            acc[start : start + m] += w
            if start + block >= n:
                break
        return out / np.maximum(acc, 1e-9)[None, :]

    def save_npz(self, path: str):
        np.savez(path, **{k: np.asarray(v) for k, v in self.params.items()})

    @classmethod
    def load_npz(cls, path: str, use_device: bool = True, device="cuda") -> "NeuralSeparator":
        data = np.load(path)
        return cls(params={k: np.asarray(data[k]) for k in data.files},
                   use_device=use_device, device=device)

    def get_stats(self) -> dict:
        return self.stats
