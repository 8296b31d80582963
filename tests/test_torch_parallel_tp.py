"""The port's tensor-parallel decode and sharding on the CPU, in gloo ranks.

Ranks are ``torch.multiprocessing`` spawn processes (2 to 4) joined over a
``FileStore`` under the test's ``tmp_path``, each with one thread and a 60 s
collective timeout; the parent joins them within ``RANKS_TIMEOUT_S``, kills
them on expiry and fails with each rank's traceback (``run_ranks``; the
other ``test_torch_parallel_*`` files use it too). jax is imported inside
the test functions only, so a spawned rank never loads it. The widths are
``tests/test_parallel.py``'s ``_tiny_cfg(tp)``, the weights the JAX
package's ``init_params`` converted, so each case holds the port's ranks
against the port's single process and the JAX package's single-device and
8-virtual-device sharded decodes, with the JAX tests' tolerances:

- the mesh factorization, and the sharding table: a rule for every entry of
  the dense, ``int8`` and ``int8-all`` state dicts, splitting where the JAX
  package's ``whisper_param_shardings`` splits (the conv stem and the
  positional embeddings replicated on purpose), the fused qkv per head;
- tp = 4 (mesh 1 × 4), f32 with word timestamps: tokens equal to the single
  process and to JAX's single and sharded decodes, ``no_speech_prob``
  within 1e-4, the capture within 1e-3 of the single process (it travels as
  uint8 ×255: 1.5/255 against JAX, as tests/test_torch_decode.py); a
  batched decode of 2 rows equal to each row's own;
- ``int8-all`` weights with int8 KV caches at tp = 4: tokens equal, and the
  prefill's and a decode step's logits bit-equal to the single process
  (every cross-rank sum there is an int32 sum);
- the model-only ``int8`` tier at tp = 4: tokens equal; its logits are not
  bit-equal, and are held to 1e-5: its encoder is dense f32 (row-parallel
  f32 partial sums) and so is its tied head (ROADMAP queue 3);
- dp 2 × tp 2: each data rank decodes its own row of a 2-row batch, tokens
  equal to that row's single decode and the JAX package's (no-speech
  probability within 1e-4, the capture within 1e-3 of the single
  process); ``load_checkpoint_sharded`` gives each rank exactly
  ``shard_params``' tensors, and a model built on them decodes the same
  tokens; an orbax-only checkpoint raises ``ValueError``.
"""

import contextlib
import dataclasses
import os
import queue
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from realtime_whisper_asr_tpu_torch.models.whisper import decode as D
from realtime_whisper_asr_tpu_torch.models.whisper import model as M
from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import (
    load_checkpoint_sharded,
    save_checkpoint,
)
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper
from realtime_whisper_asr_tpu_torch.models.whisper.quant import quantize
from realtime_whisper_asr_tpu_torch.parallel import mesh as PM
from realtime_whisper_asr_tpu_torch.parallel import sharding as S

torch.set_num_threads(2)

#: the parent's limit on one group of ranks, start to finish
RANKS_TIMEOUT_S = 150


# ------------------------------------------------------------------ harness


def _rank_main(fn, rank: int, world: int, store: str, results, args: tuple) -> None:
    torch.set_num_threads(1)
    try:
        PM.init_distributed("cpu", rank, world, store=dist.FileStore(store, world))
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = RANKS_TIMEOUT_S) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned gloo ranks; returns
    their results in rank order. A rank's exception, or the time limit,
    fails the test with every traceback received; no rank outlives the
    call."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = str(tmp_path / f"store-{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store, results, args))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < world and time.monotonic() < deadline:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                continue
            (got if ok else errors)[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        pytest.fail("\n".join(f"rank {r}:\n{tb}" for r, tb in sorted(errors.items())))
    if len(got) < world:
        pytest.fail(f"ranks {sorted(set(range(world)) - set(got))} gave no result within "
                    f"{timeout} s")
    return [got[r] for r in range(world)]


def tiny_cfg(tp: int, cfg=None):
    """``tests/test_parallel.py``'s ``_tiny_cfg(tp)`` of a config (the port's
    by default; pass the JAX package's to get its)."""
    return dataclasses.replace(
        cfg or get_config("test-tiny"), name=f"par-{tp}", n_audio_ctx=64,
        n_audio_state=16 * tp, n_audio_head=tp, n_text_state=16 * tp, n_text_head=tp,
        n_text_ctx=16)


def jax_state(tp: int, seed: int):
    """(JAX config, JAX f32 params, the port's state dict of them as numpy)."""
    import jax
    import jax.numpy as jnp

    from realtime_whisper_asr_tpu.models import whisper as W
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import params_from_jax

    jcfg = tiny_cfg(tp, W.get_config("test-tiny"))
    params = W.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    state = params_from_jax(jax.tree.map(np.asarray, params))
    return jcfg, params, {k: v.numpy() for k, v in state.items()}


def torch_state(state_np: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in state_np.items()}


def _mel(cfg, b: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 2 * cfg.n_audio_ctx, cfg.n_mels)) * 0.3).astype(np.float32)


def single_model(cfg, state_np: dict, tier=None) -> Whisper:
    model = Whisper.empty(cfg, torch.float32, "cpu", tier)
    model.load_state_dict(quantize(torch_state(state_np), tier))
    return model


@torch.inference_mode()
def decode_readings(model, mel: np.ndarray, opts: D.DecodeOptions) -> dict:
    """Tokens, no-speech probability and capture of one window's decode, and
    the logits of its prefill and of the first decode step."""
    xa = model.encode(torch.from_numpy(mel))
    plan = D.plan_window(model.cfg, opts)
    res = D.greedy_decode(model, xa, opts, plan, torch.from_numpy(plan.aux))
    cache = model.init_cache(xa)
    init = torch.from_numpy(plan.init[None].astype(np.int64))
    pre, _ = model.decode_span(init, 0, cache)
    step, _ = model.decode_step(pre[:, -1].argmax(-1), torch.tensor(plan.p), cache)
    n = int(res.lengths[0])
    return {"tokens": res.tokens[0][:n].tolist(), "nsp": float(res.no_speech_prob[0]),
            "xattn": None if res.xattn is None else res.xattn[0][:n],
            "prefill": pre.numpy(), "step": step.numpy()}


# ------------------------------------------------------------------ ranks


def _rank_tp4(rank, world, cases, batch_case):
    mesh = PM.make_mesh(model_parallel=world)
    assert (mesh.data, mesh.model, mesh.model_rank) == (1, world, rank)
    out = {}
    for name, tier, state_np, mel, opts in cases:
        model = S.shard_model(torch_state(state_np), tiny_cfg(world), mesh, quantization=tier)
        out[name] = decode_readings(model, mel, opts)
    state_np, mel, opts, requests = batch_case
    model = S.shard_model(torch_state(state_np), tiny_cfg(world), mesh)
    with torch.inference_mode():
        res = D.greedy_decode_batch(model, model.encode(torch.from_numpy(mel)), opts, requests)
    out["batch"] = [r.tokens[0][: int(r.lengths[0])].tolist() for r in res]
    return out


def _rank_dp_tp(rank, world, state_np, mel, opts, ckpt):
    mesh = PM.make_mesh(model_parallel=2)
    row = S.data_sharding(mesh)({"mel": mel})["mel"]
    whole = S.shard_model(torch_state(state_np), tiny_cfg(2), mesh)
    cfg, local = load_checkpoint_sharded(ckpt, mesh)
    expect = S.shard_params(torch_state(state_np), mesh)
    same = sorted(local) == sorted(expect) and all(torch.equal(local[k], expect[k])
                                                   for k in expect)
    loaded = S.shard_model(local, cfg, mesh, local=True)
    got = decode_readings(whole, row, opts)
    return {"data_rank": mesh.data_rank, "shards_equal": same,
            "whole": {k: got[k] for k in ("tokens", "nsp", "xattn")},
            "loaded": decode_readings(loaded, row, opts)["tokens"]}


def _rank_sp(rank, world, state_np, mel, tokens):
    """Encode and teacher-forced decode of each tier, plain tp and inside
    ``activation_sharding`` (sequence parallelism)."""
    mesh = PM.make_mesh(model_parallel=world)
    out = {}
    for tier in (None, "int8", "int8-all"):
        model = S.shard_model(torch_state(state_np), tiny_cfg(world), mesh, quantization=tier)
        with torch.inference_mode():
            readings = []
            for scope in (contextlib.nullcontext(),
                          M.activation_sharding(S.sequence_sharding(mesh))):
                with scope:
                    xa = model.encode(torch.from_numpy(mel))
                    logits = model.decode_full(torch.from_numpy(tokens), xa)
                readings.append((xa.numpy(), logits.numpy()))
        out[tier] = readings
    out["scope_restored"] = M._ACT_SHARDING is None
    return out


# ------------------------------------------------------------------ tests


def test_mesh_factorization():
    from realtime_whisper_asr_tpu.parallel import make_mesh

    assert PM.mesh_shape(8) == (2, 4) == tuple(make_mesh(8).shape.values())
    assert PM.mesh_shape(1) == (1, 1) == tuple(make_mesh(1).shape.values())
    assert PM.mesh_shape(2) == (1, 2) and PM.mesh_shape(6) == (3, 2)
    assert PM.mesh_shape(8, model_parallel=8) == (1, 8)
    with pytest.raises(ValueError, match="not divisible by model_parallel=4"):
        PM.mesh_shape(6, model_parallel=4)


#: the port's name of each JAX leaf the JAX rules split over "model", and how
#: the JAX spec splits it ("out": the last axis of an (L, in, out) weight or
#: an (L, out) bias; "in": the in axis)
_JAX_SPLITS = {
    ("attn", "wq"): ("attn.qkv.weight", "out"), ("attn", "bq"): ("attn.qkv.bias", "out"),
    ("attn", "wk"): ("attn.qkv.weight", "out"), ("attn", "wv"): ("attn.qkv.weight", "out"),
    ("attn", "bv"): ("attn.qkv.bias", "out"), ("attn", "wo"): ("attn.out.weight", "in"),
    ("cross", "wq"): ("cross.query.weight", "out"), ("cross", "bq"): ("cross.query.bias", "out"),
    ("cross", "wk"): ("cross.key.weight", "out"), ("cross", "wv"): ("cross.value.weight", "out"),
    ("cross", "bv"): ("cross.value.bias", "out"), ("cross", "wo"): ("cross.out.weight", "in"),
    ("mlp", "w1"): ("fc1.weight", "out"), ("mlp", "b1"): ("fc1.bias", "out"),
    ("mlp", "w2"): ("fc2.weight", "in"),
}


@pytest.mark.parametrize("tier", [None, "int8", "int8-all"])
def test_sharding_table_covers_the_state_dict(tier):
    """Every entry has a rule; the shards of all ranks rebuild it (the fused
    qkv per head: rank r's rows are heads r of q, k and v); a block linear
    splits where the JAX package's spec splits it; the int4 tiers refuse."""
    from jax.sharding import PartitionSpec as P

    from realtime_whisper_asr_tpu.parallel import make_mesh, whisper_param_shardings

    jcfg, _, state_np = jax_state(4, 0)
    state = quantize(torch_state(state_np), tier)
    table = S.whisper_param_shardings(state)
    assert table.keys() == state.keys()
    tp, d = 4, tiny_cfg(4).n_text_state
    for name, t in state.items():
        parts = [S.shard_tensor(t, table[name], r, tp) for r in range(tp)]
        if table[name] == S.REPLICATED:
            continue
        if table[name] == S.QKV:
            q, k, v = t.chunk(3)
            for r, part in enumerate(parts):
                rows = slice(r * d // tp, (r + 1) * d // tp)
                assert torch.equal(part, torch.cat([q[rows], k[rows], v[rows]]))
        else:
            assert torch.equal(torch.cat(parts, 0 if table[name] == S.OUT else t.dim() - 1), t)
    jspecs = whisper_param_shardings(make_mesh(8))
    for part in ("encoder", "decoder"):
        for (sub, leaf), (suffix, axis) in _JAX_SPLITS.items():
            if sub == "cross" and part == "encoder":
                continue
            spec = jspecs[part]["blocks"][sub][leaf].spec
            want = P(None, "model") if leaf.startswith("b") else (
                P(None, None, "model") if axis == "out" else P(None, "model", None))
            assert spec == want, (part, sub, leaf, spec)
            for q_or_w in {suffix, suffix.replace(".weight", ".q")}:
                name = f"{part}.blocks.0.{q_or_w}"
                if name in table:
                    port = {"out": (S.OUT, S.QKV), "in": (S.IN,)}[axis]
                    assert table[name] in port, (name, table[name])
    assert jspecs["decoder"]["tok_emb"].spec == P(None, "model")
    assert table.get("decoder.tok_emb", table.get("decoder.tok_emb.q")) == S.IN
    if tier is None:
        with pytest.raises(ValueError, match="int4"):
            S.shard_params(quantize(state, "int4"), None)


def test_tp4_decode_matches_single_and_jax(tmp_path):
    """tp = 4 in 4 ranks: f32 (word timestamps), ``int8-all`` with int8 KV
    caches and model-only ``int8`` against the single process and the JAX
    package; a batched decode against each row's own."""
    import jax.numpy as jnp

    from realtime_whisper_asr_tpu.models import whisper as W
    from realtime_whisper_asr_tpu.models.whisper import decode as JD
    from realtime_whisper_asr_tpu.models.whisper.quant import quantize_all, quantize_decoder
    from realtime_whisper_asr_tpu.parallel import make_mesh, shard_params

    cfg = tiny_cfg(4)
    kw = dict(timestamps=True, word_timestamps=True, max_new_tokens=16)
    cases = []
    jax_refs = {}
    jmesh = make_mesh(8)
    for name, seed, mel_seed, tier, jquant, opt in (
            ("f32", 1, 0, None, None, kw),
            ("int8-kv", 3, 2, "int8-kv", quantize_all, kw),
            ("int8", 4, 3, "int8", quantize_decoder, dict(timestamps=True, max_new_tokens=12))):
        jcfg, params, state_np = jax_state(4, seed)
        mel = _mel(cfg, 1, mel_seed)
        jp = params if jquant is None else jquant(params)
        jopts = JD.DecodeOptions(**opt)
        kvq = dict(kv_quant=True) if tier == "int8-kv" else {}
        ref = JD.greedy_decode(jp, jcfg, W.encode(jp, jcfg, jnp.asarray(mel)), jopts, **kvq)
        with jmesh:
            sp = shard_params(jp, jmesh)
            sharded = JD.greedy_decode(sp, jcfg, W.encode(sp, jcfg, jnp.asarray(mel)), jopts,
                                       **kvq)
        jax_refs[name] = (ref, sharded)
        cases.append((name, tier, state_np, mel, D.DecodeOptions(**opt)))
    _, _, batch_state = jax_state(4, 2)
    mel2 = _mel(cfg, 2, 1)
    bopts = D.DecodeOptions(timestamps=True, max_new_tokens=16)
    requests = [{"prompt_tokens": None, "prefix_tokens": None, "seed": 0},
                {"prompt_tokens": [50, 60], "prefix_tokens": None, "seed": 0}]

    ranks = run_ranks(_rank_tp4, 4, tmp_path, cases, (batch_state, mel2, bopts, requests))

    for name, tier, state_np, mel, opts in cases:
        single = decode_readings(single_model(cfg, state_np, tier), mel, opts)
        for rank, got in enumerate(ranks):
            got = got[name]
            assert got["tokens"] == single["tokens"], (name, rank)
            assert abs(got["nsp"] - single["nsp"]) < 1e-4
            if single["xattn"] is not None:
                np.testing.assert_allclose(got["xattn"], single["xattn"], atol=1e-3)
            if tier == "int8-kv":  # every cross-rank sum is an int32 sum
                np.testing.assert_array_equal(got["prefill"], single["prefill"])
                np.testing.assert_array_equal(got["step"], single["step"])
            else:  # f32 partial sums reduced in another order
                np.testing.assert_allclose(got["prefill"], single["prefill"], atol=1e-5)
                np.testing.assert_allclose(got["step"], single["step"], atol=1e-5)
        for ref in jax_refs[name]:
            n = int(ref.lengths[0])
            assert ranks[0][name]["tokens"] == ref.tokens[0][:n].tolist(), name
            assert abs(ranks[0][name]["nsp"] - float(ref.no_speech_prob[0])) < 1e-4
            if ref.xattn is not None:
                np.testing.assert_allclose(ranks[0][name]["xattn"], ref.xattn[0][:n],
                                           atol=1.5 / 255)

    single = single_model(cfg, batch_state)
    p = D.plan_batch_aux(cfg, bopts, requests).p
    with torch.inference_mode():
        xa = single.encode(torch.from_numpy(mel2))
        for i, req in enumerate(requests):
            plan = D.plan_window(cfg, bopts, req["prompt_tokens"], bucket=p)
            ref = D.greedy_decode(single, xa[i : i + 1], bopts, plan, torch.from_numpy(plan.aux))
            want = ref.tokens[0][: int(ref.lengths[0])].tolist()
            assert all(r["batch"][i] == want for r in ranks), i


def test_dp2_tp2_decode_and_sharded_checkpoint(tmp_path):
    """A 2 × 2 mesh: each data rank's own row decoded by its tensor-parallel
    pair as that row's single decode and the JAX package's; the sharded
    load gives each rank its shards of the checkpoint and the same tokens."""
    import jax.numpy as jnp

    from realtime_whisper_asr_tpu.models import whisper as W
    from realtime_whisper_asr_tpu.models.whisper import decode as JD

    cfg = tiny_cfg(2)
    jcfg, params, state_np = jax_state(2, 5)
    mel = _mel(cfg, 2, 4)
    kw = dict(timestamps=True, word_timestamps=True, max_new_tokens=16)
    opts = D.DecodeOptions(**kw)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, torch_state(state_np), cfg)

    ranks = run_ranks(_rank_dp_tp, 4, tmp_path, state_np, mel, opts, ckpt)

    single = single_model(cfg, state_np)
    for got in ranks:
        i = got["data_rank"]
        want = decode_readings(single, mel[i : i + 1], opts)
        ref = JD.greedy_decode(params, jcfg, W.encode(params, jcfg, jnp.asarray(mel[i : i + 1])),
                               JD.DecodeOptions(**kw))
        assert got["shards_equal"]
        assert got["whole"]["tokens"] == want["tokens"] == got["loaded"]
        assert got["whole"]["tokens"] == ref.tokens[0][: int(ref.lengths[0])].tolist()
        assert abs(got["whole"]["nsp"] - want["nsp"]) < 1e-4
        np.testing.assert_allclose(got["whole"]["xattn"], want["xattn"], atol=1e-3)
    assert sorted(r["data_rank"] for r in ranks) == [0, 0, 1, 1]

    orbax = tmp_path / "orbax"
    (orbax / "params").mkdir(parents=True)
    (orbax / "rtwa_config.json").write_text((tmp_path / "ckpt" / "rtwa_config.json").read_text())
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint_sharded(str(orbax), None)


def test_sequence_parallel_matches_plain_tp_on_every_tier(tmp_path):
    """tp = 2: ``encode`` and ``decode_full`` inside ``activation_sharding``
    equal the plain tensor-parallel ones, bit for bit on the int8 tiers (the
    int8 linears all-gather their input and reduce-scatter their int32
    partials over the sequence; every cross-rank sum is an integer sum) and
    within 1e-5 at f32; ``int8-all`` also equals the single process bit for
    bit."""
    cfg = tiny_cfg(2)
    _, _, state_np = jax_state(2, 6)
    mel = _mel(cfg, 2, 5)
    tokens = np.random.default_rng(6).integers(0, 1000, (2, 8))

    ranks = run_ranks(_rank_sp, 2, tmp_path, state_np, mel, tokens)

    single = single_model(cfg, state_np, "int8-all")
    with torch.inference_mode():
        xa = single.encode(torch.from_numpy(mel))
        want = (xa.numpy(), single.decode_full(torch.from_numpy(tokens), xa).numpy())
    for got in ranks:
        assert got["scope_restored"]
        for tier in (None, "int8", "int8-all"):
            (xa_tp, logits_tp), (xa_sp, logits_sp) = got[tier]
            assert np.isfinite(logits_sp).all()
            if tier is None:
                np.testing.assert_allclose(xa_sp, xa_tp, atol=1e-5)
                np.testing.assert_allclose(logits_sp, logits_tp, atol=1e-5)
            else:
                np.testing.assert_array_equal(xa_sp, xa_tp, err_msg=tier)
                np.testing.assert_array_equal(logits_sp, logits_tp, err_msg=tier)
        for a, b in zip(got["int8-all"][1], want):
            np.testing.assert_array_equal(a, b)
