"""The port's GPipe pipeline on the CPU, in gloo ranks.

``tests/test_parallel.py``'s pipeline config (``_tiny_cfg(2)`` at width 32
with 4 encoder and 4 decoder layers), the JAX package's seed-0 weights, its
batch of 4 rows. Four ranks are four stages:

- ``pp_encode`` and ``pp_decode_full`` at 2 microbatches bit-equal to the
  port's plain stacks run on the same microbatches, on every stage; within
  1e-5 of the plain whole-batch ``encode`` / ``decode_full`` and of the JAX
  package's ``pp_encode`` / ``pp_decode_full`` on its 4 virtual devices;
- the pipeline's gradients (``pp_loss_and_grads``, gathered from the
  stages) against the single process's ``loss_and_grads`` and ``jax.grad``
  of the JAX package's ``loss_fn``: every leaf within 1e-5 of its largest
  magnitude, the loss within 1e-5 relative (the parameters below, after one
  Adam step of about lr·sign(g), cannot show a whole factor in a gradient);
- one ``make_pp_train_step`` step against the port's plain single-process
  step and the JAX package's pipeline step: the loss within 1e-5, every
  parameter within 1e-4 (the JAX test's tolerances), the stages' gathered
  parameters whole;
- the "divisible" errors: 3 layers over 4 stages, 4 rows over 3
  microbatches;
- ``tools/finetune.py --pipeline-stages 2 --microbatches 2 --cpu`` under
  ``torch.distributed.run`` with 2 processes trains, writes a checkpoint
  ``TorchWhisperASR`` loads, and resumes.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu_torch.models.whisper.model import Whisper, _decoder_block_full
from realtime_whisper_asr_tpu_torch.parallel import pipeline as P
from realtime_whisper_asr_tpu_torch.train import optim as O
from realtime_whisper_asr_tpu_torch.train import train_step as TS
from tests.test_torch_parallel_tp import run_ranks, tiny_cfg, torch_state
from tests.test_torch_parallel_train import manifest, torchrun, train_batch

torch.set_num_threads(2)

SR = 16000


def pp_cfg(cfg=None):
    return dataclasses.replace(tiny_cfg(2, cfg), name="pp-test", n_audio_state=32,
                               n_text_state=32, n_audio_layer=4, n_text_layer=4)


def _rank_pp(rank, world, state_np, batch):
    mesh = P.make_pp_mesh(world)
    cfg = pp_cfg()
    model = Whisper.empty(cfg, torch.float32, "cpu")
    model.load_state_dict(torch_state(state_np))
    b = TS._to_device(batch, mesh.device)
    with torch.no_grad():
        xa = P.pp_encode(model, b["mel"], mesh, n_micro=2)
        logits = P.pp_decode_full(model, b["tokens_in"], xa, mesh, n_micro=2)
    out = {"xa": xa.numpy(), "logits": logits.numpy()}

    def fresh():
        return {k: v.detach().clone().requires_grad_(True) for k, v in
                P.pp_shard_params(torch_state(state_np), cfg, mesh).items()}

    step, shard_batch = P.make_pp_train_step(cfg, mesh, n_micro=2, optimizer=O.adamw(1e-3))
    loss, grads = P.pp_loss_and_grads(fresh(), cfg, shard_batch(batch), mesh, n_micro=2)
    whole = P.pp_gather_params(grads, cfg, mesh)
    out["grad_loss"] = float(loss)
    out["grads"] = {k: v.numpy() for k, v in whole.items()} if rank == 0 else None
    params = fresh()
    state = TS.TrainState(params, O.adamw(1e-3).init(params), 0)
    state, loss = step(state, shard_batch(batch))
    out["loss"] = float(loss)
    out["held"] = sorted(k for k in state.params if ".blocks." in k)
    whole = P.pp_gather_params(state.params, cfg, mesh)
    out["params"] = {k: v.numpy() for k, v in whole.items()} if rank == 0 else None

    errors = []
    for call in (lambda: P.pipeline_blocks(mesh, lambda h, blk: h, [torch.zeros(1, 4)],
                                           [None] * 3),
                 lambda: P.pp_encode(model, b["mel"], mesh, n_micro=3)):
        with pytest.raises(ValueError, match="divisible") as e:
            call()
        errors.append(str(e.value))
    out["errors"] = errors
    return out


def test_pipeline_matches_plain_stacks_and_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    from realtime_whisper_asr_tpu import train as JT
    from realtime_whisper_asr_tpu.models import whisper as W
    from realtime_whisper_asr_tpu.parallel import (
        make_pp_mesh,
        make_pp_train_state,
        make_pp_train_step,
        pp_decode_full,
        pp_encode,
    )
    from realtime_whisper_asr_tpu_torch.models.whisper.convert import params_from_jax

    jcfg = pp_cfg(W.get_config("test-tiny"))
    jparams = W.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    state_np = {k: v.numpy() for k, v in
                params_from_jax(jax.tree.map(np.asarray, jparams)).items()}
    batch = train_batch(pp_cfg(), 4)
    batch["mask"][2:, 5:] = 0.0  # microbatch 1 counts fewer tokens: a per-microbatch mean differs

    ranks = run_ranks(_rank_pp, 4, tmp_path, state_np, batch)

    cfg = pp_cfg()
    model = Whisper.empty(cfg, torch.float32, "cpu")
    model.load_state_dict(torch_state(state_np))
    b = TS._to_device(batch, torch.device("cpu"))
    with torch.no_grad():  # the plain stacks on the same microbatches, and whole
        x = model.encoder.stem(b["mel"])
        ys = []
        for h in x.split(2):
            for blk in model.encoder.blocks:
                h = blk.mlp_block(blk.mha_block(h))
            ys.append(h)
        xa_micro = model.encoder.ln_post(torch.cat(ys)).numpy()
        xa_full = model.encode(b["mel"])
        logits_full = model.decode_full(b["tokens_in"], xa_full).numpy()
        tok = b["tokens_in"]
        x = (model._emb_rows(tok) + model.decoder.pos_emb[: tok.shape[1]]).to(xa_full.dtype)
        causal = torch.triu(torch.full((tok.shape[1],) * 2, -1e9), diagonal=1)
        hs = []
        for h, xam in zip(x.split(2), torch.from_numpy(ranks[0]["xa"]).split(2)):
            for blk in model.decoder.blocks:
                h = _decoder_block_full(blk, h, xam, causal)
            hs.append(h)
        logits_micro = model.logits(model.decoder.ln(torch.cat(hs))).numpy()
    jmesh = make_pp_mesh(4)
    jxa = pp_encode(jparams, jcfg, jnp.asarray(batch["mel"]), jmesh, n_micro=2)
    jlogits = np.asarray(pp_decode_full(jparams, jcfg, jnp.asarray(batch["tokens_in"]), jxa,
                                        jmesh, n_micro=2))
    for got in ranks:
        np.testing.assert_array_equal(got["xa"], xa_micro)
        np.testing.assert_array_equal(got["logits"], logits_micro)
        np.testing.assert_allclose(got["xa"], xa_full.numpy(), atol=1e-5)
        np.testing.assert_allclose(got["xa"], np.asarray(jxa), atol=1e-5)
        np.testing.assert_allclose(got["logits"], logits_full, atol=1e-5)
        np.testing.assert_allclose(got["logits"], jlogits, atol=1e-5)

    # the pipeline's gradients, gathered from the stages, against the single
    # process's and jax.grad of the JAX package's loss_fn: each leaf within 1e-5
    # of its largest magnitude (a stem, tied embedding or head counted once
    # per stage would be a whole factor off)
    tl, tg = TS.loss_and_grads(TS.trainable(torch_state(state_np), "cpu"), cfg, b)
    jl, jg = jax.jit(jax.value_and_grad(JT.loss_fn), static_argnums=1)(
        jparams, jcfg, *(np.asarray(batch[k]) for k in ("mel", "tokens_in", "tokens_out",
                                                         "mask")))
    jg = params_from_jax(jax.tree.map(np.asarray, jg))
    assert all(abs(r["grad_loss"] - float(tl)) <= 1e-5 * abs(float(tl)) for r in ranks)
    assert abs(ranks[0]["grad_loss"] - float(jl)) <= 1e-5 * abs(float(jl))
    assert ranks[0]["grads"].keys() == tg.keys() == jg.keys()
    for k, g in ranks[0]["grads"].items():
        for ref in (tg[k].numpy(), jg[k].numpy()):
            scale = float(np.abs(ref).max())
            assert float(np.abs(g - ref).max()) <= 1e-5 * scale, (k, scale)

    # one pipeline step == one plain step, and the JAX package's pipeline step
    params = TS.trainable(torch_state(state_np), "cpu")
    single = TS.TrainState(params, O.adamw(1e-3).init(params), 0)
    step, shard = TS.make_train_step(cfg, O.adamw(1e-3), device="cpu")
    single, loss1 = step(single, shard(batch))
    jstate, _ = make_pp_train_state(jcfg, jax.random.PRNGKey(0), jmesh, optax.adamw(1e-3))
    jstep, jshard = make_pp_train_step(jcfg, jmesh, n_micro=2, optimizer=optax.adamw(1e-3))
    jstate, jloss = jstep(jstate, jshard({k: np.asarray(v) for k, v in batch.items()}))
    jnew = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    assert all(abs(r["loss"] - float(loss1)) < 1e-5 for r in ranks)
    assert abs(ranks[0]["loss"] - float(jloss)) < 1e-5
    whole = ranks[0]["params"]
    assert whole.keys() == single.params.keys()
    for k, v in whole.items():
        assert np.abs(v - single.params[k].detach().numpy()).max() < 1e-4, k
        assert np.abs(v - jnew[k].numpy()).max() < 1e-4, k
    for s, got in enumerate(ranks):  # stage s holds blocks s of each stack
        assert {k.split(".")[2] for k in got["held"]} == {str(s)}

    assert all("3 layers not divisible by 4 stages" in r["errors"][0] for r in ranks)
    assert all("batch 4 not divisible by 3 microbatches" in r["errors"][1] for r in ranks)


def test_finetune_pipeline_under_torchrun(tmp_path):
    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR

    man = manifest(tmp_path, 4)
    out = tmp_path / "pprun"
    common = ["--manifest", man, "--model", "test-tiny", "--out", str(out), "--epochs", "1",
              "--batch-size", "4", "--pipeline-stages", "2", "--microbatches", "2",
              "--log-every", "1"]
    log = torchrun(2, common + ["--lr", "1e-4", "--max-steps", "2", "--save-every", "1"])
    line = json.loads([ln for ln in log.splitlines() if ln.startswith("{")][-1])
    assert line["steps"] == 1 and np.isfinite(line["final_train_loss"])
    with open(out / "train_state" / "mesh.json") as f:
        assert json.load(f)["shape"] == {"stage": 2}

    asr = TorchWhisperASR(checkpoint_dir=str(out / "checkpoint"), dtype=torch.float32,
                          device="cpu")
    asr.transcribe_kargs["max_total_tokens"] = 8
    segs = asr.transcribe(np.random.default_rng(0).standard_normal(SR).astype(np.float32) * 0.1)
    assert isinstance(segs.tokens, list)

    torchrun(2, common + ["--resume", "--save-every", "0"])
    with open(out / "train_state" / "train_state.rank1.json") as f:
        assert json.load(f)["/step"] == 2
    assert os.path.isdir(out / "checkpoint")
