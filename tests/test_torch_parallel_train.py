"""The port's dp × tp training on the CPU, in gloo ranks (test-tiny widths).

Four ranks on a 2 × 2 (data, model) mesh run ``make_sharded_train_step``
from the JAX package's seed-0 weights of ``_tiny_cfg(4)`` on
``tests/test_parallel.py``'s batch, with ``optim.adamw(1e-3)``; the parent
runs the port's single-process step and the JAX package's
``make_sharded_train_step`` on a 2 × 2 ``Mesh`` of its virtual CPU devices
from the same weights. With the JAX tests' tolerances:

- the step's gradients (``sharded_loss_and_grads``: the whole batch's
  count, the data group's sum), plain and sequence-parallel, gathered: every
  leaf within 1e-5 of its largest magnitude of the single process's
  ``loss_and_grads`` and of ``jax.grad`` of the JAX package's ``loss_fn``,
  the loss within 1e-5 relative (Adam's first update is about lr·sign(g),
  so the parameters below cannot show a whole factor in a gradient);
- the sharded loss within 1e-3 of the single process's and of JAX's
  sharded step's; the parameters after the step within 1e-4 of both;
- ``sequence_parallel=True`` equal to the plain step (and JAX's) within
  1e-4 in the loss and every parameter, and the scope restored after it;
- 5 steps of a seeded ``make_train_state(mesh=)`` lower the loss;
- the global norm of the ranks' shards (``optim.ShardedLeaves``) equals
  the norm of the gathered gradients, within 1 ulp of their norm in
  float64 (optax sums in float32, in XLA's order);
- the train state saved on the mesh, loaded into a fresh template and
  stepped once equals the uninterrupted run bit for bit; a mesh of another
  shape refuses it;
- ``prepare_batch(shard_fn=data_sharding(mesh))`` gives each data rank the
  whole batch's log-mel rows of its own;
- ``tools/finetune.py --mesh 2x2 --cpu`` under ``torch.distributed.run``
  with 4 processes trains, saves, writes a checkpoint ``TorchWhisperASR``
  loads, and resumes with ``--sequence-parallel``.
"""

import json
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu_torch.io import write_wav
from realtime_whisper_asr_tpu_torch.models.whisper import model as M
from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import (
    load_train_state,
    save_train_state,
)
from realtime_whisper_asr_tpu_torch.parallel import mesh as PM
from realtime_whisper_asr_tpu_torch.parallel import sharding as S
from realtime_whisper_asr_tpu_torch.train import optim as O
from realtime_whisper_asr_tpu_torch.train import train_step as TS
from tests.test_torch_parallel_tp import jax_state, run_ranks, tiny_cfg, torch_state

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


def train_batch(cfg, b: int, s: int = 8, seed: int = 0) -> dict:
    """``tests/test_parallel.py``'s ``_batch`` as numpy."""
    rng = np.random.default_rng(seed)
    return {"mel": rng.standard_normal((b, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32),
            "tokens_in": rng.integers(0, 1000, (b, s)).astype(np.int32),
            "tokens_out": rng.integers(0, 1000, (b, s)).astype(np.int32),
            "mask": np.ones((b, s), np.float32)}


def _state_from(state_np: dict, mesh, optimizer):
    params = {k: v.requires_grad_(True) for k, v in
              S.shard_params(torch_state(state_np), mesh).items()}
    return TS.TrainState(params, optimizer.init(params), 0)


def _gathered(params: dict, mesh) -> dict:
    return {k: v.numpy() for k, v in S.gather_params(params, mesh).items()}


def _rank_train(rank, world, state_np, batch, path):
    mesh = PM.make_mesh(model_parallel=2)
    cfg = tiny_cfg(4)
    out = {}
    for sp in (False, True):
        step, shard_batch = TS.make_sharded_train_step(cfg, mesh, O.adamw(1e-3),
                                                       sequence_parallel=sp)
        # the step's gradients: the whole batch's count, summed over the data group
        state = _state_from(state_np, mesh, O.adamw(1e-3))
        loss, grads = TS.sharded_loss_and_grads(state.params, cfg, shard_batch(batch), mesh, sp)
        out[sp] = {"grad_loss": float(loss), "grads": _gathered(grads, mesh)}
        if not sp:  # the norm of the shards, and of the gathered gradients
            whole = S.gather_params(grads, mesh)
            out["norms"] = (float(O.global_norm(O.ShardedLeaves(grads, S.split_names(grads),
                                                                mesh.model_group))),
                            float(O.global_norm(whole)))
        state = _state_from(state_np, mesh, O.adamw(1e-3))
        state, loss = step(state, shard_batch(batch))
        out[sp].update(loss=float(loss), params=_gathered(state.params, mesh))
    out["scope_restored"] = M._ACT_SHARDING is None

    # 5 seeded steps, and a resume after 2 of them
    opt = O.adamw(1e-3)
    step, shard_batch = TS.make_sharded_train_step(cfg, mesh, opt)

    def fresh():
        return TS.make_train_state(cfg, torch.Generator().manual_seed(0), opt, mesh=mesh)[0]

    state, losses = fresh(), []
    for i in range(5):
        state, loss = step(state, shard_batch(batch))
        losses.append(float(loss))
        if i == 1:
            save_train_state(path, state, mesh)
        if i == 2:
            straight = {k: v.detach().clone() for k, v in state.params.items()}
    resumed, _ = step(load_train_state(path, fresh(), mesh), shard_batch(batch))
    out["losses"] = losses
    out["resumed_equal"] = resumed.step == 3 and all(
        torch.equal(resumed.params[k], straight[k]) for k in straight)
    other = PM.make_mesh(model_parallel=4)
    try:
        load_train_state(path, fresh(), other)
        out["other_shape"] = "loaded"
    except ValueError as e:
        out["other_shape"] = str(e)
    return out if rank == 0 else {k: out[k] for k in ("losses", "resumed_equal", "scope_restored")}


def test_sharded_step_matches_single_and_jax(tmp_path):
    import jax
    import optax
    from jax.sharding import Mesh

    from realtime_whisper_asr_tpu import train as JT
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import params_from_jax

    jcfg, jparams0, state_np = jax_state(4, 0)
    batch = train_batch(tiny_cfg(4), 4)
    batch["mask"][2:, 5:] = 0.0  # data rank 1 counts fewer tokens: a per-rank mean differs

    ranks = run_ranks(_rank_train, 4, tmp_path, state_np, batch, str(tmp_path / "ts"))
    got = ranks[0]

    cfg = tiny_cfg(4)
    single = _state_single(state_np)
    step, shard = TS.make_train_step(cfg, O.adamw(1e-3), device="cpu")
    single, loss1 = step(single, shard(batch))
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    with jmesh:
        jstate, _ = JT.make_train_state(jcfg, jax.random.PRNGKey(0), mesh=jmesh,
                                        optimizer=optax.adamw(1e-3))
        jstep, jshard = JT.make_sharded_train_step(jcfg, jmesh, optax.adamw(1e-3))
        jstate, jloss = jstep(jstate, jshard({k: np.asarray(v) for k, v in batch.items()}))
    jparams = params_from_jax(jax.tree.map(np.asarray, jstate.params))

    # every leaf's gradient, plain and sequence-parallel, against the single
    # process's and JAX's: a whole factor in any leaf (data-group gradients
    # averaged, a partial leaf reduced twice) is far outside 1e-5 of its scale
    tl, tg = TS.loss_and_grads(_state_single(state_np).params, cfg,
                               TS._to_device(batch, torch.device("cpu")))
    jl, jg = jax.jit(jax.value_and_grad(JT.loss_fn), static_argnums=1)(
        jparams0, jcfg, *(np.asarray(batch[k]) for k in ("mel", "tokens_in", "tokens_out",
                                                          "mask")))
    jg = params_from_jax(jax.tree.map(np.asarray, jg))
    for sp in (False, True):
        assert abs(got[sp]["grad_loss"] - float(tl)) <= 1e-5 * abs(float(tl))
        assert abs(got[sp]["grad_loss"] - float(jl)) <= 1e-5 * abs(float(jl))
        assert got[sp]["grads"].keys() == tg.keys() == jg.keys()
        for k, g in got[sp]["grads"].items():
            for ref in (tg[k].numpy(), jg[k].numpy()):
                scale = float(np.abs(ref).max())
                assert float(np.abs(g - ref).max()) <= 1e-5 * scale, (sp, k, scale)

    plain, sp = got[False], got[True]
    assert abs(plain["loss"] - float(loss1)) < 1e-3
    assert abs(plain["loss"] - float(jloss)) < 1e-3
    assert abs(plain["loss"] - sp["loss"]) < 1e-4
    for k, v in plain["params"].items():
        assert np.abs(v - single.params[k].detach().numpy()).max() < 1e-4, k
        assert np.abs(v - jparams[k].numpy()).max() < 1e-4, k
        assert np.abs(v - sp["params"][k]).max() < 1e-4, k
        assert np.abs(sp["params"][k] - jparams[k].numpy()).max() < 1e-4, k
    assert all(r["scope_restored"] for r in ranks)

    sharded_norm, gathered_norm = got["norms"]
    assert sharded_norm == gathered_norm
    exact = np.float32(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                   for g in plain["grads"].values())))
    ulps = abs(int(np.float32(sharded_norm).view(np.int32)) - int(exact.view(np.int32)))
    assert ulps <= 1

    losses = got["losses"]
    assert all(r["losses"] == losses for r in ranks)
    assert losses[-1] < losses[0] and np.isfinite(losses).all(), losses
    assert all(r["resumed_equal"] for r in ranks)
    assert "cannot resume on mesh" in got["other_shape"], got["other_shape"]


def _state_single(state_np: dict):
    params = TS.trainable(torch_state(state_np), "cpu")
    return TS.TrainState(params, O.adamw(1e-3).init(params), 0)


def test_prepare_batch_takes_each_data_ranks_rows():
    from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
    from realtime_whisper_asr_tpu_torch.train.data import prepare_batch

    cfg = get_config("test-tiny")
    rng = np.random.default_rng(0)
    batch = {"audio": (rng.standard_normal((4, SR)) * 0.1).astype(np.float32),
             "tokens_in": rng.integers(0, 100, (4, 6)).astype(np.int32),
             "tokens_out": rng.integers(0, 100, (4, 6)).astype(np.int32),
             "mask": np.ones((4, 6), np.float32)}
    whole = prepare_batch(batch, cfg, "cpu")
    for i in range(2):
        mesh = types.SimpleNamespace(data=2, data_rank=i)
        part = prepare_batch(batch, cfg, "cpu", shard_fn=S.data_sharding(mesh))
        for k, v in part.items():
            assert torch.equal(v, whole[k][2 * i : 2 * i + 2]), k
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        S.data_sharding(types.SimpleNamespace(data=3, data_rank=0))(batch)


# ------------------------------------------------------------------ the tool


def manifest(tmp_path, n: int) -> str:
    rng = np.random.default_rng(0)
    path = tmp_path / "train.jsonl"
    with open(path, "w") as f:
        for i in range(n):
            wav = tmp_path / f"c{i}.wav"
            write_wav(str(wav), rng.standard_normal(SR).astype(np.float32) * 0.1)
            f.write(json.dumps({"wav": str(wav), "text": f"w{i} w{i + 1}"}) + "\n")
    return str(path)


def torchrun(nproc: int, args: list, timeout: float = 120) -> str:
    """``tools/finetune.py`` in ``nproc`` processes under
    ``torch.distributed.run --standalone`` on the CPU; its output. The
    whole process group is killed at the time limit."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "-m", "realtime_whisper_asr_tpu_torch.tools.finetune",
           *args, "--cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"torchrun {args} passed {timeout} s:\n{out[-3000:]}")
    assert proc.returncode == 0, out[-3000:]
    return out


def test_finetune_mesh_2x2_under_torchrun(tmp_path):
    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR

    man = manifest(tmp_path, 8)
    out = tmp_path / "run"
    common = ["--manifest", man, "--model", "test-tiny", "--out", str(out), "--epochs", "1",
              "--batch-size", "4", "--mesh", "2x2", "--log-every", "1"]
    log = torchrun(4, common + ["--val-manifest", man, "--lr", "1e-4", "--save-every", "1"])
    line = json.loads([ln for ln in log.splitlines() if ln.startswith("{")][-1])
    assert line["steps"] == 2 and np.isfinite(line["final_train_loss"])
    assert np.isfinite(line["val_loss"])
    assert sorted(os.listdir(out / "train_state")) == sorted(
        ["mesh.json"] + [f"train_state.rank{r}.{x}" for r in range(4)
                         for x in ("json", "safetensors")])

    asr = TorchWhisperASR(checkpoint_dir=str(out / "checkpoint"), dtype=torch.float32,
                          device="cpu")
    asr.transcribe_kargs["max_total_tokens"] = 8
    segs = asr.transcribe(np.random.default_rng(0).standard_normal(SR).astype(np.float32) * 0.1)
    assert isinstance(segs.tokens, list)

    torchrun(4, common + ["--resume", "--sequence-parallel", "--max-steps", "1",
                          "--save-every", "0"])
    with open(out / "train_state" / "train_state.rank3.json") as f:
        assert json.load(f)["/step"] == 3
