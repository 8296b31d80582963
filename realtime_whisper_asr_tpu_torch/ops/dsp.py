"""DSP on the device of the input: FIR band-pass and phase-vocoder stretch.

Port of ``realtime_whisper_asr_tpu/ops/dsp.py``:

- band-pass: a linear-phase windowed-sinc FIR applied by FFT convolution
  (zero phase like the reference's ``filtfilt``);
- time-stretch: an STFT phase vocoder, with the synthesis phase optionally
  carried across consecutive chunks.

Both are ``torch.fft`` library calls on the input's device; neither has a
kernel of its own (the JAX versions are plain XLA ops too). Windows are the
symmetric ``np.hanning`` table, not ``torch.hann_window``'s periodic one.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

SR = 16000


@functools.lru_cache(maxsize=8)
def fir_bandpass(low_hz: float, high_hz: float, numtaps: int = 513, sampling_rate: int = SR) -> np.ndarray:
    """Linear-phase band-pass FIR via windowed sinc (Hann)."""
    assert numtaps % 2 == 1
    m = np.arange(numtaps) - (numtaps - 1) / 2
    def lowpass(fc):
        x = 2 * fc / sampling_rate
        h = x * np.sinc(x * m)
        return h
    h = lowpass(high_hz) - lowpass(low_hz)
    h *= np.hanning(numtaps)
    # normalize passband gain at the geometric center frequency
    fc = np.sqrt(low_hz * high_hz)
    gain = np.abs(np.sum(h * np.exp(-2j * np.pi * fc / sampling_rate * m)))
    return (h / max(gain, 1e-9)).astype(np.float32)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy's ``mode="reflect"`` pad of a 1-D tensor (edge not repeated)."""
    return F.pad(x[None], (pad, pad), mode="reflect")[0]


def bandpass_filter(audio: torch.Tensor, low_hz: float = 85.0, high_hz: float = 3400.0,
                    numtaps: int = 513) -> torch.Tensor:
    """(N,) float32 -> band-passed (N,), zero-phase, via FFT convolution."""
    h = torch.from_numpy(fir_bandpass(low_hz, high_hz, numtaps)).to(audio.device)
    n = audio.shape[0]
    pad = numtaps // 2
    x = _reflect_pad(audio.float(), pad)
    fft_len = int(2 ** np.ceil(np.log2(x.shape[0] + numtaps)))
    X = torch.fft.rfft(x, fft_len)
    H = torch.fft.rfft(h, fft_len)
    y = torch.fft.irfft(X * H, fft_len)
    # linear-phase FIR delay = pad; plus the reflect pad offset
    return y[2 * pad : 2 * pad + n]


@functools.lru_cache(maxsize=4)
def _hann(n: int) -> np.ndarray:
    return np.hanning(n).astype(np.float32)


def _expected_advance(n_fft: int, hop: int) -> np.ndarray:
    """(F,) f32 ``2 pi hop rfftfreq(n_fft)``, rounded as the JAX package's
    f32 program rounds it: the constant to f32, ``k / n_fft`` in f32, one
    f32 product."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float32) / np.float32(n_fft)
    return np.float32(2 * np.pi * hop) * k


def cumsum_blocked(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive cumulative sum along ``dim`` in XLA's CPU order, which the
    JAX package's ``jnp.cumsum`` compiles to: blocks of 16 summed left to
    right, each block's total carried by the same scan over the block
    totals, one level up. ``torch.cumsum`` sums in another order (in f64 on
    the CPU, as a parallel scan on the card), which moves a phase of a few
    thousand radians by several f32 ulps."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    pad = (-n) % 16 if n > 16 else 0
    blocks = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]).view(-1, min(n, 16), *x.shape[1:])
    run = [blocks[:, 0]]
    for i in range(1, blocks.shape[1]):
        run.append(run[-1] + blocks[:, i])
    inner = torch.stack(run, 1)
    if blocks.shape[0] > 1:
        carry = cumsum_blocked(inner[:, -1])[:-1]
        inner = torch.cat([inner[:1], inner[1:] + carry[:, None]])
    return inner.reshape(-1, *x.shape[1:])[:n].movedim(0, dim)


def time_stretch(audio: torch.Tensor, rate: float, n_fft: int = 1024, hop: int = 256,
                 phase_in: torch.Tensor | None = None, carry_phase: bool = False,
                 phase_at: int | None = None):
    """Phase-vocoder time stretch; rate>1 speeds up (shorter output).

    Output length ``int(len(audio) / rate)``, pitch-preserving (librosa's
    ``effects.time_stretch`` semantics). ``carry_phase``: streaming mode —
    the synthesis phase starts from ``phase_in`` ((n_fft//2+1,) f32)
    instead of the chunk's own analysis phase, and the call returns
    ``(out, phase_out)``, ``phase_out`` being the accumulated phase
    ``pad // hop`` frames before the join frame ``phase_at`` (default: where
    the output ends), which the next chunk's call takes as its
    ``phase_in``.

    The index math runs in f32 in the JAX package's order (``steps =
    arange * rate``, truncation to ``lo``, the clamped ``frac``, the
    wrapped deviation rounded half to even, XLA's blocked cumulative sum),
    and the overlap-add sums each output sample's frames in ascending frame
    order through ``n_fft / hop`` shifted slices, as the JAX scatter-add
    does, with no atomics.
    """
    dev = audio.device
    audio = audio.float()
    n = audio.shape[0]
    window = torch.from_numpy(_hann(n_fft)).to(dev)
    pad = n_fft // 2
    x = _reflect_pad(audio, pad)
    n_frames = 1 + (x.shape[0] - n_fft) // hop
    frames = x.unfold(0, n_fft, hop)[:n_frames] * window
    stft = torch.fft.rfft(frames, dim=-1)  # (T, F)

    # resample frame positions at the new rate; synthesize extra tail frames
    # so the cropped [pad, pad+target) region has full overlap-add coverage
    # (partial coverage divides by a small win_acc: a click)
    target = int(n / rate)
    out_frames = max(int(n_frames / rate), (pad + target + hop - 1) // hop + 1)
    steps = torch.arange(out_frames, device=dev, dtype=torch.float32) * torch.tensor(
        rate, dtype=torch.float32, device=dev)
    lo = steps.to(torch.int64).clamp(0, n_frames - 2)
    # clamp: tail steps can exceed lo+1 once lo saturates at n_frames-2
    frac = (steps - lo.float()).clamp(0.0, 1.0)[:, None]
    s_lo, s_hi = stft[lo], stft[lo + 1]
    mag = (1 - frac) * s_lo.abs() + frac * s_hi.abs()

    # phase accumulation: expected per-hop advance + wrapped deviation
    expected = torch.from_numpy(_expected_advance(n_fft, hop)).to(dev)[None, :]
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device=dev)
    dphi = s_hi.angle() - s_lo.angle() - expected
    dphi = dphi - two_pi * torch.round(dphi / two_pi)
    advance = expected + dphi  # (out_frames, F)
    if carry_phase:
        phase0 = phase_in.to(device=dev, dtype=torch.float32)[None, :]
    else:
        phase0 = s_lo[:1].angle()
    phases = phase0 + torch.cat([torch.zeros_like(phase0), cumsum_blocked(advance[:-1])])
    spec = torch.polar(mag, phases)

    # overlap-add inverse STFT: frame j covers rows j..j+R-1 of a (rows, hop)
    # grid; adding the slices from p = R-1 down to 0 sums each sample's
    # frames in ascending order
    r = n_fft // hop
    wave = torch.fft.irfft(spec, n_fft, dim=-1) * window
    n_rows = out_frames + r
    out = torch.zeros(n_rows, hop, dtype=torch.float32, device=dev)
    win_acc = torch.zeros(n_rows, hop, dtype=torch.float32, device=dev)
    w2 = (window * window).view(r, hop)
    fr = wave.view(out_frames, r, hop)
    for p in reversed(range(r)):
        out[p : p + out_frames] += fr[:, p]
        win_acc[p : p + out_frames] += w2[p]
    out = out.view(-1) / torch.clamp(win_acc.view(-1), min=1e-6)
    if carry_phase:
        # the next chunk's frame pad//hop is the one centered on its emitted
        # start, and its own advances re-accumulate the hops in between: hand
        # over the phase pad//hop frames before this chunk's join frame
        k_join = phase_at if phase_at is not None else min((pad + target) // hop, out_frames - 1)
        k_ret = min(max(int(k_join) - pad // hop, 0), out_frames - 1)
        return out[pad : pad + target], phases[k_ret]
    return out[pad : pad + target]
