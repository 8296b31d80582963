"""The port's log-mel frontend against the JAX package's.

On the CPU the port's ``log_mel_spectrogram`` runs its plain torch version;
it is held against the JAX package's Pallas kernel (interpret mode on the
CPU) and the f64 numpy oracle with the energy-aware tolerances of
tests/test_logmel.py. The CUDA kernel itself is held against the same plain
version on the card by chip_smoke.py; here its FFT (the 8 x 25 split, the
radix-8 and radix-5 butterflies, the real split) is rebuilt in numpy f32
from the module's own tables with csrc/logmel.cu's index arithmetic, and held
against ``np.fft.rfft``, and the kernel's source itself runs on the CPU
(compiled by the host compiler against tests/cuda_on_cpu.h: one thread per
CUDA thread, a barrier for ``__syncthreads``).
"""

import ctypes
import os
import re
import runpy
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from realtime_whisper_asr_tpu.ops import log_mel_spectrogram as jax_log_mel_spectrogram
from realtime_whisper_asr_tpu.ops import log_mel_spectrogram_reference
from realtime_whisper_asr_tpu.ops import mel as jax_mel
from realtime_whisper_asr_tpu_torch.ops import logmel
from realtime_whisper_asr_tpu_torch.ops import mel

torch.set_num_threads(2)

SR = 16000


def _speechy_audio(seconds: float, seed: int = 0) -> np.ndarray:
    """Synthetic speech-ish signal: AM-modulated harmonics + noise bursts."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 2.3 * t))
    sig = sig * env + 0.05 * rng.standard_normal(t.shape)
    return (0.5 * sig / np.max(np.abs(sig))).astype(np.float32)


def _assert_logmel_close(ours: np.ndarray, golden: np.ndarray):
    """tests/test_logmel.py's tolerances: tight on bins within ~4 decades of
    the peak, bounded near the clamp floor where f32 DFTs disagree."""
    diff = np.abs(ours - golden)
    hot = golden > 0.3
    assert hot.any()
    assert diff[hot].max() < 2e-2, f"hot-bin max diff {diff[hot].max()}"
    assert diff.mean() < 3e-3, f"mean diff {diff.mean()}"
    assert diff.max() < 0.5, f"overall max diff {diff.max()}"


@pytest.mark.parametrize("seconds,n_mels", [(1.0, 80), (1.0, 128), (30.0, 80)])
def test_plain_matches_jax_and_f64_oracle(seconds, n_mels):
    audio = _speechy_audio(seconds)
    ours = logmel.log_mel_spectrogram(torch.from_numpy(audio), n_mels=n_mels).numpy()
    assert ours.shape == (len(audio) // logmel.HOP_LENGTH, n_mels)
    _assert_logmel_close(ours, log_mel_spectrogram_reference(audio, n_mels=n_mels))
    jax_out = np.asarray(jax_log_mel_spectrogram(jnp.asarray(audio), n_mels=n_mels))
    _assert_logmel_close(ours, jax_out)


def test_silence_is_constant_floor():
    out = logmel.log_mel_spectrogram(torch.zeros(SR)).numpy()
    assert np.allclose(out, out.flat[0])


def test_cpu_tensor_takes_plain_version_without_launch():
    audio = torch.from_numpy(_speechy_audio(1.0, seed=3))
    before = logmel.logmel_launches
    out = logmel.log_mel_spectrogram(audio, n_mels=80)
    assert logmel.logmel_launches == before
    torch.testing.assert_close(out, logmel.log_mel_spectrogram_plain(audio, n_mels=80),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(16000, dtype=torch.float64), TypeError),
    (torch.zeros(16001), ValueError),
    (torch.zeros(160), ValueError),
    (torch.zeros(2, 16000), ValueError),
    (torch.zeros(32000)[::2], ValueError),
])
def test_rejects_windows_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        logmel.log_mel_spectrogram(bad)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_tables_equal_jax_package(n_mels):
    np.testing.assert_array_equal(mel.mel_filterbank(n_mels, 400),
                                  jax_mel.mel_filterbank(n_mels, 400))
    np.testing.assert_array_equal(mel.hann_window(400), jax_mel.hann_window(400))
    for ours, ref in zip(mel.dft_matrices(400), jax_mel.dft_matrices(400)):
        np.testing.assert_array_equal(ours, ref)


# ---- the kernel's FFT, pass by pass as csrc/logmel.cu computes it

def _rev3(k: int) -> int:
    return ((k & 1) << 2) | (k & 2) | (k >> 2)


def _cplx(w: np.ndarray) -> np.ndarray:
    return (w[..., 0] + 1j * w[..., 1]).astype(np.complex64)


def _dft8(a: np.ndarray, w8: np.ndarray) -> list:
    """dft8 of the kernel on axis 1 of ``a`` (F, 8, ...): three radix-2
    decimation-in-frequency stages; bin k is left at position rev3(k)."""
    a = [a[:, n] for n in range(8)]
    for n in range(4):
        a[n], a[n + 4] = a[n] + a[n + 4], (a[n] - a[n + 4]) * w8[n]
    for h in (0, 4):
        for n in range(2):
            a[h + n], a[h + n + 2] = a[h + n] + a[h + n + 2], (a[h + n] - a[h + n + 2]) * w8[2 * n]
    for n in range(0, 8, 2):
        a[n], a[n + 1] = a[n] + a[n + 1], a[n] - a[n + 1]
    return a


def _dft5(u: list, w5: np.ndarray) -> list:
    """dft5 of the kernel: the pairs (1, 4) and (2, 3) share their cosines."""
    c1, s1, c2, s2 = w5[1].real, -w5[1].imag, w5[2].real, -w5[2].imag
    a1, b1, a2, b2 = u[1] + u[4], u[1] - u[4], u[2] + u[3], u[2] - u[3]
    t1, t2 = u[0] + c1 * a1 + c2 * a2, u[0] + c2 * a1 + c1 * a2
    q1, q2 = s1 * b1 + s2 * b2, s2 * b1 - s1 * b2
    return [u[0] + a1 + a2, t1 - 1j * q1, t2 - 1j * q2, t2 + 1j * q2, t1 + 1j * q1]


def _kernel_fft(frames: np.ndarray) -> np.ndarray:
    """Z = the 200-point FFT of each frame's packed, windowed samples
    z[n] = w[2n]·x[2n] + i·w[2n+1]·x[2n+1], (F, 200) complex64, by the
    kernel's passes from ``logmel.fft_tables`` and stored where the kernel's
    passes store it."""
    t = logmel.fft_tables()
    w8, w200, w5, w25 = (_cplx(t[k]) for k in ("w8", "w200", "w5", "w25"))
    x = (frames * t["window"]).astype(np.float32)
    f = len(frames)
    s_in = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)
    # radix 8, thread (f, n2): z[25·n1 + n2] -> s_a[k1·25 + n2]
    a = _dft8(s_in[:, 25 * np.arange(8)[:, None] + np.arange(25)[None, :]], w8)
    s_a = np.zeros((f, 200), np.complex64)
    for k1 in range(8):
        s_a[:, 25 * k1 + np.arange(25)] = a[_rev3(k1)] * w200[k1]
    # radix 5 over a, thread (f, k1, b): s_a[k1·25 + 5·a + b] -> s_b[k1·25 + 5·c + b]
    s_b = np.zeros((f, 200), np.complex64)
    for k1 in range(8):
        for b in range(5):
            u = _dft5([s_a[:, 25 * k1 + 5 * a + b] for a in range(5)], w5)
            for c in range(5):
                s_b[:, 25 * k1 + 5 * c + b] = u[c] * w25[c, b]
    # radix 5 over b, thread (f, k1, c): s_b[k1·25 + 5·c + b] -> s_a[k1 + 8·c + 40·d]
    s_a = np.full((f, 200), np.nan, np.complex64)
    for k1 in range(8):
        for c in range(5):
            u = _dft5([s_b[:, 25 * k1 + 5 * c + b] for b in range(5)], w5)
            for d in range(5):
                s_a[:, k1 + 8 * c + 40 * d] = u[d]
    return s_a


def _kernel_power(z: np.ndarray) -> np.ndarray:
    """The kernel's real split and power: (F, 201) float32 from Z (F, 200)."""
    w400 = _cplx(logmel.fft_tables()["w400"])
    power = np.full((len(z), 201), np.nan, np.float32)
    for k in range(101):
        zk, zm = z[:, k], z[:, 0 if k == 0 else 200 - k]
        e = np.complex64(0.5) * (zk + np.conj(zm))
        d = np.complex64(0.5) * (zk - np.conj(zm))
        p = w400[k] * d
        power[:, k] = np.abs(e - 1j * p) ** 2
        if k < 100:
            power[:, 200 - k] = np.abs(e + 1j * p) ** 2
    return power


def _test_frames() -> np.ndarray:
    """Speech-like frames, then white noise with a DC offset and tones at
    bins 100 (4 kHz) and 200 (8 kHz), so every bin the tests read has energy."""
    speech = _speechy_audio(1.0, seed=5)[: 40 * 400].reshape(40, 400)
    rng = np.random.default_rng(6)
    n = np.arange(400)
    noise = (0.05 * rng.standard_normal((40, 400)) + 0.3 + 0.2 * np.cos(np.pi * n / 2)
             + 0.1 * np.cos(np.pi * n)).astype(np.float32)
    return np.concatenate([speech, noise])


def _rel_err_on_energy(got: np.ndarray, ref: np.ndarray) -> float:
    """Largest |got − ref| / ref over the bins whose power is at least 1e-3 of
    their frame's peak."""
    hot = ref >= 1e-3 * ref.max(axis=-1, keepdims=True)
    return float((np.abs(got - ref) / ref)[hot].max())


def test_fft_8x25_split_from_the_kernel_tables():
    frames = _test_frames()
    z = _kernel_fft(frames)
    assert np.isfinite(z).all()  # the last pass stores every bin
    k1, c, d = np.meshgrid(np.arange(8), np.arange(5), np.arange(5), indexing="ij")
    assert sorted((k1 + 8 * c + 40 * d).ravel()) == list(range(200))
    x = frames.astype(np.float64) * logmel.fft_tables()["window"].astype(np.float64)
    ref = np.fft.fft(x[:, 0::2] + 1j * x[:, 1::2], axis=-1)
    assert _rel_err_on_energy(np.abs(z.astype(np.complex128)) ** 2, np.abs(ref) ** 2) <= 1e-5


@pytest.mark.parametrize("k", [0, 100, 200, None], ids=["k0", "k100", "k200", "all"])
def test_real_split_recovers_rfft_bins(k):
    frames = _test_frames()
    power = _kernel_power(_kernel_fft(frames)).astype(np.float64)
    assert np.isfinite(power).all()
    x = frames.astype(np.float64) * logmel.fft_tables()["window"].astype(np.float64)
    ref = np.abs(np.fft.rfft(x, axis=-1)) ** 2
    if k is None:
        assert _rel_err_on_energy(power, ref) <= 1e-5
    else:
        assert (ref[40:, k] >= 1e-3 * ref[40:].max(axis=-1)).all()  # the tones give it energy
        assert float((np.abs(power[:, k] - ref[:, k]) / ref[:, k])[40:].max()) <= 1e-5


def test_fft_tables_are_the_twiddles_rounded_once():
    t = logmel.fft_tables()
    k1, n2 = np.meshgrid(np.arange(8), np.arange(25), indexing="ij")
    c, b = np.meshgrid(np.arange(5), np.arange(5), indexing="ij")
    for name, j, n in (("w8", np.arange(8), 8), ("w200", k1 * n2, 200), ("w5", np.arange(5), 5),
                       ("w25", c * b, 25), ("w400", np.arange(201), 400)):
        w = np.exp(-2j * np.pi * j / n)
        ref = np.stack([w.real, w.imag], -1)
        ref[np.abs(ref) < 1e-12] = 0.0  # cos and sin at multiples of pi/2
        assert t[name].dtype == np.float32
        np.testing.assert_array_equal(t[name], ref.astype(np.float32))
    np.testing.assert_array_equal(t["window"], mel.hann_window(400))
    assert t["w8"][2].tolist() == [0.0, -1.0] and t["w400"][200].tolist() == [-1.0, 0.0]


def test_kernel_table_layout_matches_the_source():
    """csrc/logmel.cu's kTab* offsets are where ``fft_table`` puts each table."""
    with open(logmel._CU_SRC) as f:
        consts = dict((m[0], int(m[1])) for m in re.findall(r"constexpr int (kTab\w+) = (\d+);",
                                                            f.read()))
    offsets, pos = {}, 0
    for name, size in logmel.FFT_TABLE_LAYOUT:
        assert logmel.fft_tables()[name].size == size
        offsets[name], pos = pos, pos + size
    assert consts == {"kTabWindow": offsets["window"], "kTabW8": offsets["w8"],
                      "kTabW200": offsets["w200"], "kTabW5": offsets["w5"],
                      "kTabW25": offsets["w25"], "kTabW400": offsets["w400"], "kTabSize": pos}
    assert logmel.fft_table().shape == (pos,) and logmel.fft_table().dtype == np.float32


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_table_is_the_filterbank_without_its_zeros(n_mels):
    weights, index = logmel.mel_table(n_mels)
    lo, offsets = index[:n_mels], index[n_mels:]
    assert weights.dtype == np.float32 and index.dtype == np.int32
    assert offsets[0] == 0 and offsets[-1] == len(weights) <= 1024 and n_mels <= 128
    dense = np.zeros((n_mels, 201), np.float32)
    for m in range(n_mels):
        dense[m, lo[m]:lo[m] + offsets[m + 1] - offsets[m]] = weights[offsets[m]:offsets[m + 1]]
    np.testing.assert_array_equal(dense, mel.mel_filterbank(n_mels, 400))
    assert (weights != 0).all()


def test_kernel_path_raises_without_a_card():
    """The kernel path launches or raises: on a host without a card it never
    falls back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs the kernel path")
    before = logmel.logmel_launches
    with pytest.raises(Exception):
        logmel._log10_mel_kernel(torch.zeros(16000), 80)
    assert logmel.logmel_launches == before


# ---- csrc/logmel.cu itself, compiled for the CPU

def _build_on_cpu(src: str, build) -> ctypes.CDLL:
    """The kernel library built from the CUDA source ``src`` by the host C++
    compiler against tests/cuda_on_cpu.h, in the directory ``build``, bound
    as the wrapper binds the card's."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    launch = "logmel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>("
    assert src.count(launch) == 1
    shutil.copy(os.path.join(os.path.dirname(__file__), "cuda_on_cpu.h"),
                build / "cuda_runtime.h")
    (build / "logmel.cpp").write_text(
        src.replace(launch, "emulate_launch(grid, kThreads, logmel_kernel, "))
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(build), "-o", str(build / "lib.so"),
                    str(build / "logmel.cpp")], check=True, capture_output=True, timeout=300)
    return logmel._bind(str(build / "lib.so"))


@pytest.fixture(scope="module")
def kernel_on_cpu(tmp_path_factory):
    """csrc/logmel.cu compiled for the CPU."""
    with open(logmel._CU_SRC) as f:
        return _build_on_cpu(f.read(), tmp_path_factory.mktemp("logmel_on_cpu"))


def _run_on_cpu(lib, audio: np.ndarray, n_mels: int) -> tuple[int, np.ndarray]:
    tab = logmel.fft_table()
    weights, index = logmel.mel_table(n_mels)
    out = np.full((len(audio) // 160, n_mels), np.nan, np.float32)
    rc = lib.rtwa_logmel(audio.ctypes.data, len(audio), tab.ctypes.data, weights.ctypes.data,
                         index.ctypes.data, n_mels, len(weights), out.ctypes.data, 0, None)
    return rc, out


@pytest.mark.parametrize("n,n_mels", [(16000, 80), (32160, 128), (320, 80)],
                         ids=["1s", "ragged-201-frames", "2-frames"])
def test_kernel_source_on_the_cpu_matches_the_oracle(kernel_on_cpu, n, n_mels):
    """The kernel's own indexing, staging, reflect padding, ragged last block
    and barriers, run on the CPU. Beside the energy-aware tolerances, the hot
    bins must be within 1e-4 of the f64 oracle: the FFT's f32 rounding reads
    ~1e-6 there, so an index error confined to a few bins still fails."""
    audio = _speechy_audio(-(-n // SR), seed=7)[:n].copy()
    rc, out = _run_on_cpu(kernel_on_cpu, audio, n_mels)
    assert rc == 0 and np.isfinite(out).all()
    ours = logmel._normalize(torch.from_numpy(out)).numpy()
    oracle = log_mel_spectrogram_reference(audio, n_mels=n_mels)
    _assert_logmel_close(ours, oracle)
    _assert_logmel_close(ours, logmel.log_mel_spectrogram_plain(torch.from_numpy(audio),
                                                                n_mels).numpy())
    assert np.abs(ours - oracle)[oracle > 0.3].max() < 1e-4


def test_kernel_source_on_the_cpu_gives_silence_a_constant_floor(kernel_on_cpu):
    rc, out = _run_on_cpu(kernel_on_cpu, np.zeros(SR, np.float32), 80)
    assert rc == 0 and np.allclose(out, out.flat[0]) and abs(out.flat[0] + 10.0) < 1e-5


def test_kernel_library_refuses_more_mels_than_it_holds(kernel_on_cpu):
    rc, out = _run_on_cpu(kernel_on_cpu, _speechy_audio(1.0), 129)
    assert rc != 0 and np.isnan(out).all()
    assert kernel_on_cpu.rtwa_cuda_error_string(rc) == b"invalid argument"


def test_breakdown_tool_cases_and_variants_apply_to_the_kernel_source():
    """``tools/k1_breakdown.py`` times chip_smoke.py's cases, and each of its
    variants changes the current source (a kernel edit that moves the text
    fails here, not on the card)."""
    from realtime_whisper_asr_tpu_torch.tools import k1_breakdown as BD

    smoke = runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                        "chip_smoke.py"), run_name="not_main")
    assert BD.CASES == smoke["LOGMEL_CASES"]
    sources = BD._sources()
    assert list(sources) == [v[0] for v in BD.VARIANTS]
    assert all(sources[name] != sources["kernel"] for name in sources if name != "kernel")


@pytest.mark.parametrize("name", ["serial staging", "2 frames a block", "6 frames a block",
                                  "mel loop, no division", "real split unrolled"])
def test_breakdown_tool_variants_compute_the_function_on_the_cpu(name, tmp_path):
    """The breakdown's variants that claim to compute the whole function do,
    run on the CPU as the kernel's own source is (ragged last block)."""
    from realtime_whisper_asr_tpu_torch.tools import k1_breakdown as BD

    assert dict((v[0], v[2]) for v in BD.VARIANTS)[name]
    lib = _build_on_cpu(BD._sources()[name], tmp_path)
    audio = _speechy_audio(3.0, seed=8)[:32160].copy()
    rc, out = _run_on_cpu(lib, audio, 128)
    assert rc == 0 and np.isfinite(out).all()
    ours = logmel._normalize(torch.from_numpy(out)).numpy()
    oracle = log_mel_spectrogram_reference(audio, n_mels=128)
    _assert_logmel_close(ours, oracle)
    assert np.abs(ours - oracle)[oracle > 0.3].max() < 1e-4
