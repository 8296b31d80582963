"""Where the time of K2's tensor-core path goes, on one CUDA card.

    python -m realtime_whisper_asr_tpu_torch.tools.k2_breakdown [--m 800] [--k 1280] [--n 1280]

K2's ``int4_linear`` runs above 8 rows as two launches: the row quantization
(``k2_quantize``) and the tensor-core product (``k2_wgmma``). This tool
builds variants of ``csrc/int4_matmul.cu`` (one ``nvcc`` each, all at once)
with one part of the product taken out: the in-loop weight unpack, the
per-group fold, the in-loop slice loads, the ``wgmma`` products; and one
whose product launch does not overlap the quantization (no programmatic
stream serialization). A variant with a part taken out computes a wrong
result, so only its time means anything. Each variant's kernels are timed
with ``torch.profiler`` (device time per call, mean of 20 calls, warm L2)
through its ``rtwa_int4_linear`` entry at one shape, bf16 x with bias,
beside bf16 ``F.linear`` of x with the dequantized weight. The whole span of
the two launches (CUDA events, which the profiler's per-kernel sums miss
when the launches overlap) is printed too. One line per variant.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from realtime_whisper_asr_tpu_torch.models.whisper import quant as Q
from realtime_whisper_asr_tpu_torch.native.build import BUILD_DIR, build_library
from realtime_whisper_asr_tpu_torch.ops import int4_matmul as K2

#: (variant, text of k2_wgmma / its launch to take out, what replaces it)
VARIANTS = (
    ("base", None, None),
    ("no unpack", "      unpack(st);\n", ""),
    ("no fold", "    if (pending >= 0) fold(st, pending);\n", ""),
    ("no slice loads",
     "        load_w(next % kWStages, next);\n"
     "        load_a(next % kWStages, next);\n", ""),
    ("no wgmma",
     "      wgmma_s8_m64n64k32(acc, sw128_desc(a_s + 32 * ks), sw128_desc(b_s + 32 * ks),\n"
     "                         step == 0 ? 0 : 1);\n", ""),
    ("no launch overlap", "cfg.numAttrs = after_quantize ? 1 : 0;", "cfg.numAttrs = 0;"),
)


def _build(name: str, source: str) -> ctypes.CDLL:
    tag = name.replace(" ", "_")
    cu = os.path.join(BUILD_DIR, f"k2_{tag}.cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    if not os.path.exists(cu) or open(cu).read() != source:
        with open(cu, "w") as f:
            f.write(source)
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    path = build_library(
        f"libk2_{tag}.so", [cu],
        lambda out: [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                     "-shared", "-Xcompiler", "-fPIC", "-o", out, cu])
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rtwa_int4_linear.restype = i
    lib.rtwa_int4_linear.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, p]
    return lib


def _sources() -> dict[str, str]:
    with open(K2._CU_SRC) as f:
        base = f.read()
    out = {}
    for name, old, new in VARIANTS:
        if old is not None and base.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: its text is not in the source once")
        out[name] = base if old is None else base.replace(old, new)
    return out


def _linear(lib: ctypes.CDLL, x, wp, s, bias, work, y) -> None:
    m, k = x.shape
    g, n = s.shape
    index = x.get_device()
    rc = lib.rtwa_int4_linear(x.data_ptr(), 1, wp.data_ptr(), s.data_ptr(), bias.data_ptr(),
                              y.data_ptr(), work.data_ptr(), m, k, n, g, index,
                              torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"rtwa_int4_linear returned {rc}")


def _profile(fn, calls: int = 20) -> dict[str, float]:
    """Device µs per call of each kernel fn launches (warm L2)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _span_us(fn, calls: int = 50) -> float:
    """Median µs from before the first launch to after the last (CUDA
    events, warm L2, the card kept busy while the host enqueues)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(calls):
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(1e3 * start.elapsed_time(end))
    return float(np.median(times))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=800)
    ap.add_argument("--k", type=int, default=1280)
    ap.add_argument("--n", type=int, default=1280)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_breakdown needs a CUDA card")
    if args.m <= K2.DECODE_MAX_M:
        raise SystemExit(f"k2_breakdown times the path above {K2.DECODE_MAX_M} rows")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no reading")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip([v[0] for v in VARIANTS],
                        pool.map(lambda kv: _build(*kv), _sources().items())))
    m, k, n = args.m, args.k, args.n
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)).cuda()
    wp, s = Q.quantize_int4(w)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).cuda().bfloat16()
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda().bfloat16()
    work = torch.empty(-(-m * k // 16) * 16 + 4 * m, dtype=torch.int8, device="cuda")
    y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    wd = Q.dequant(wp, s).to(torch.bfloat16)
    print(f"K2 int4_linear, M={m} K={k} N={n} G={s.shape[0]}, bf16 x with bias; device us per "
          f"call (torch.profiler, mean of 20, warm L2); span: CUDA events around both launches")
    for name, lib in libs.items():
        def fn(lib=lib):
            _linear(lib, x, wp, s, bias, work, y)

        kernels = _profile(fn)
        parts = "; ".join(f"{key[key.find('k2_'):].split('<')[0] if 'k2_' in key else key[:12]} "
                          f"{us:.2f}" for key, us in kernels.items())
        print(f"  {name:18s} kernels {sum(kernels.values()):6.2f} us ({parts}); span "
              f"{_span_us(fn):6.2f} us")
    lib_k = _profile(lambda: F.linear(x, wd, bias))
    print(f"  {'bf16 F.linear':18s} kernels {sum(lib_k.values()):6.2f} us; span "
          f"{_span_us(lambda: F.linear(x, wd, bias)):6.2f} us")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
