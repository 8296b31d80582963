"""The harness's arithmetic: percentiles, failures in the tail, audio
throughput, FLOP and byte counts, and the look for JAX."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import REPO
from portbench.core import harness, spec, window, work
from portbench.core.record import Packet, Recorder, Req

#: the Whisper family's work count
whisper = spec.model_family(REPO, {"family": "whisper"})


@pytest.mark.parametrize("q", [50, 95, 99, 0, 100])
def test_percentile_is_numpys_linear(q):
    v = list(np.random.default_rng(3).normal(300, 80, size=257))
    assert window.percentile(v, q) == pytest.approx(float(np.percentile(v, q)))


def _rec_with(applies):
    """A recorder with one stream whose requests were prepared after
    ``drained`` samples and applied at ``t`` (None: never)."""
    rec = Recorder(clock=lambda: 0.0)
    for i, (drained, t) in enumerate(applies):
        rec.reqs.append(Req(i, 0, t_prepare=float(i), drained=drained, audio=None, dispatch=i,
                            t_apply=t))
    return rec


def test_latency_runs_from_due_to_the_covering_apply():
    rec = _rec_with([(8000, 1.2), (16000, 2.1), (24000, None)])
    pk = [Packet(0, 1.0, 0, 8000, 8000, fed=1.0, counted=True),
          Packet(0, 1.5, 8000, 16000, 12000, fed=1.5, counted=True),
          Packet(0, 2.0, 16000, 24000, 24000, fed=2.0, counted=True),
          Packet(0, 2.5, 24000, 32000, -1, fed=2.5, counted=True)]
    lat, failed = window.latencies_ms(rec, pk, t_end=9.0)
    # the third packet's covering request never applied: failed, in the tail at t_end
    assert failed == 1
    assert lat == pytest.approx([200.0, 600.0, 7000.0])
    assert window.percentile(lat, 95) > 6000.0


def test_uncounted_packets_stay_out():
    rec = _rec_with([(8000, 1.2)])
    pk = [Packet(0, 1.0, 0, 8000, 8000, fed=1.0, counted=False)]
    assert window.latencies_ms(rec, pk, 5.0) == ([], 0)


def test_audio_throughput_counts_work_done_in_the_window():
    rec = _rec_with([(16000, 1.5), (32000, 4.5)])
    pk = [Packet(0, 1.0, 0, 16000, 16000, fed=1.0, counted=True),
          Packet(0, 2.0, 16000, 32000, 32000, fed=2.0, counted=True),  # applied after t_w1
          Packet(0, 3.0, 32000, 48000, -1, fed=3.0, counted=True)]  # silence: done when fed
    assert window.throughput(rec, pk, 0.0, 4.0) == pytest.approx((1.0 + 1.0) / 4.0)


TINY = {"d_model": 64, "encoder_layers": 2, "decoder_layers": 2, "encoder_ffn_dim": 256,
        "decoder_ffn_dim": 256, "num_mel_bins": 80, "vocab_size": 51865}


@pytest.mark.parametrize("frames", [400, 800, 1500])
def test_encoder_flops_equals_the_programs(frames):
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.models.whisper.model import encoder_flops

    assert whisper.encoder_flops(TINY, frames) == encoder_flops(get_config("test-tiny"), frames)


def test_gemm_ops_and_bytes():
    g = work.Gemm(3, 64, 192)
    assert g.ops == 2 * 3 * 64 * 192
    assert g.bytes == 64 * 192 + 3 * 64 + 4 * 3 * 192
    # one row at full widths is bound by bytes, a long encode by operations
    assert work.roofline_s([work.Gemm(1, 1280, 5120)], 1.979e15, 3.35e12) == pytest.approx(
        work.Gemm(1, 1280, 5120).bytes / 3.35e12)
    big = work.Gemm(8 * 1500, 5120, 1280)  # fc2 over 8 rows of 30 s
    assert work.roofline_s([big], 1.979e15, 3.35e12) == pytest.approx(big.ops / 1.979e15)


def _dispatch_of(n_rows: int, sampled: int):
    """A recorder holding one batched dispatch of ``n_rows`` rows of 5 s
    windows with no prompt or prefix, each served ``sampled`` tokens."""
    from portbench.core.record import Dispatch

    rec = Recorder(clock=lambda: 0.0)
    d = Dispatch(0, "batch", 0.0, 1.0, rows_real=n_rows, rows_encoded=n_rows)
    rec.dispatches.append(d)
    for i in range(n_rows):
        rec.reqs.append(Req(i, i, 0.0, 0, np.zeros(5 * 16000, np.float32), dispatch=0,
                            t_apply=1.0, tokens=[50365 + j for j in range(sampled)]))
        d.rids.append(i)
    return rec, d


CAPS = {"max_new_tokens": 96, "max_total_tokens": 96, "max_tokens_per_second": 4.0}


def test_int8_products_are_part_of_the_model_flops():
    cfg = dict(TINY, max_target_positions=448, caps=CAPS)
    rec, d = _dispatch_of(2, 10)
    w = whisper.dispatch_work(cfg, rec, d)
    frames = 400  # the 8 s bucket
    assert w.frames == frames and w.rows_real == 2
    assert w.new_tokens == 2 * 11  # 10 tokens and the EOT before the cap of 28
    assert w.steps == 10  # the prefill gives the first token
    assert sum(g.ops for g in w.gemms) < w.flops
    d_, ff = TINY["d_model"], TINY["encoder_ffn_dim"]
    enc_linear = sum(g.ops for g in w.gemms[: 4 * TINY["encoder_layers"]])
    assert enc_linear == 2 * TINY["encoder_layers"] * frames * (8 * d_ * d_ + 4 * d_ * ff)
    assert w.logmel_bytes == 2 * (4 * 8 * 16000 + 4 * 800 * 80)


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "realtime_whisper_asr_tpu", "realtime_whisper_asr_tpu.models.whisper",
            "realtime_whisper_asr_tpu_torch", "realtime_whisper_asr_tpu_torch.asr",
            "jaxtyping", "flaxen", "portbench.core"]
    assert harness.forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "realtime_whisper_asr_tpu",
         "realtime_whisper_asr_tpu.models.whisper"])


def test_the_harness_and_the_program_load_no_jax():
    """The harness's modules and the program's entry points it drives load
    nothing of JAX or the JAX package (a fresh interpreter)."""
    import subprocess
    import sys

    from conftest import REPO

    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.core.harness, portbench.core.system, portbench.core.trace\n"
            "import realtime_whisper_asr_tpu_torch.asr, realtime_whisper_asr_tpu_torch.serving\n"
            "import realtime_whisper_asr_tpu_torch.streaming\n"
            "from portbench.core.harness import forbidden_modules\n"
            "print(forbidden_modules())" % REPO)
    env = {k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    import ast
    import os

    from conftest import REPO

    ref = os.path.join(REPO, "portbench", "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            for top in tops:
                assert top in ("__future__", "contextlib", "dataclasses", "math", "typing",
                               "numpy", "torch", "portbench"), (name, top)
            if isinstance(node, ast.ImportFrom) and node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), (name, node.module)


def _imported_tops(tree) -> list:
    """Top-level names a module imports: its import statements and its
    ``importlib.import_module`` / ``__import__`` calls of a literal name."""
    import ast

    tops = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.append((node.module or "").split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            tops.append(node.args[0].value.split(".")[0])
    return tops


@pytest.mark.parametrize("part", ["families", "core", "metrics", "reference", "traffic", "."])
def test_no_file_of_the_benchmark_imports_jax(part):
    """No file of the benchmark, the model families among them, imports JAX
    or the JAX package (names compared whole: the port's own name begins with
    the JAX package's)."""
    import ast
    import os

    base = os.path.join(REPO, "portbench", part)
    files = []
    for d, _, names in os.walk(base):
        if part == "." and d != base:
            continue
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert files
    for path in files:
        with open(path) as f:
            tops = _imported_tops(ast.parse(f.read()))
        assert not set(tops) & set(spec.FORBIDDEN), (path, sorted(set(tops) & set(spec.FORBIDDEN)))


def test_the_import_scan_sees_what_it_forbids():
    import ast

    src = ("import jax.numpy as jnp\nfrom flax import linen\nimport importlib\n"
           "importlib.import_module('realtime_whisper_asr_tpu.models')\n__import__('jaxlib')\n"
           "import realtime_whisper_asr_tpu_torch\nfrom . import spec\n")
    assert set(_imported_tops(ast.parse(src))) & set(spec.FORBIDDEN) == set(spec.FORBIDDEN)
