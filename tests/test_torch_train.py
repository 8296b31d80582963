"""The port's single-card training against the JAX package's (test-tiny, f32, CPU).

- ``loss_fn`` equals the JAX package's within 1e-5 relative on the same
  weights and batch; every leaf's gradient is within 1e-4 of that leaf's
  largest magnitude (``encoder.pos_emb``'s included: it trains, as the JAX
  tree's leaf does), and the fused k bias slice's gradient is exactly 0.
- ``train/optim.py`` against optax, run op by op (eager): ``scale_by_adam``
  / ``adam`` / ``adamw`` bit for bit over many steps of identical numpy
  gradients; ``clip_by_global_norm``'s arithmetic bit for bit given
  optax's norm, its norm within 1 ulp of optax's (the port sums in f64,
  XLA in f32 in its own order), so the clipped leaves within 2 ulps; the
  finetune recipe's schedule bit for bit at counts 0…60. (XLA's jit
  contracts ``a·b + c`` into an FMA, so a jitted optax step differs from
  the eager one in the last bits; the port follows optax's written
  arithmetic.)
- Three steps of the finetune recipe (data pipeline, ``prepare_batch``,
  train step, ``clip_by_global_norm(1.0)`` + ``adamw`` with the warm-up
  cosine schedule) against the JAX package's jitted step on a 1 x 1 mesh:
  losses within 1e-4 relative (measured: equal); parameters within 1e-6
  absolute except for at most 4 elements (measured 0 at lr 1e-4 and 1 at
  lr 1e-3, largest 1.9e-6), each within Adam's bound 2·Σ lr for a flipped
  near-zero gradient.
- The train state's save / load round trip is bit-equal, and continuing
  from it equals the uninterrupted run bit for bit.
- ``tools/finetune.py`` end to end as the JAX test has it (without a mesh):
  its checkpoint drives ``TorchWhisperASR`` and ``--resume`` continues; a
  mesh or a stage count the world cannot run exits with the JAX tool's
  message (the meshes themselves: tests/test_torch_parallel_*.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from realtime_whisper_asr_tpu import train as JT
from realtime_whisper_asr_tpu.models import whisper as JW
from realtime_whisper_asr_tpu.models.whisper.tokenizer import MockTokenizer as JaxMockTokenizer
from realtime_whisper_asr_tpu_torch.io import write_wav
from realtime_whisper_asr_tpu_torch.models.whisper import convert
from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import (
    load_train_state,
    save_train_state,
)
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.tokenizer import MockTokenizer
from realtime_whisper_asr_tpu_torch.train import data as D
from realtime_whisper_asr_tpu_torch.train import optim as O
from realtime_whisper_asr_tpu_torch.train import train_step as TS

torch.set_num_threads(2)

SR = 16000


def _ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


@pytest.fixture(scope="module")
def jax_params():
    return JW.init_params(JW.get_config("test-tiny"), jax.random.PRNGKey(0), jnp.float32)


def _port_params(jax_tree) -> dict:
    return TS.trainable(convert.params_from_jax(jax.tree.map(np.asarray, jax_tree)), "cpu")


def _batch(seed=0, b=2, t=800, s=32):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    return {"mel": rng.standard_normal((b, t, 80)).astype(np.float32),
            "tokens_in": rng.integers(0, 51865, (b, s)).astype(np.int32),
            "tokens_out": rng.integers(0, 51865, (b, s)).astype(np.int32), "mask": mask}


def test_loss_and_grads_match_jax(jax_params):
    cfg = get_config("test-tiny")
    batch = _batch()
    jl, jg = jax.jit(jax.value_and_grad(JT.loss_fn), static_argnums=1)(
        jax_params, JW.get_config("test-tiny"), *(jnp.asarray(batch[k]) for k in
                                                  ("mel", "tokens_in", "tokens_out", "mask")))
    _, shard = TS.make_train_step(cfg, device="cpu")
    params = _port_params(jax_params)
    tl, tg = TS.loss_and_grads(params, cfg, shard(batch))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    ref = convert.params_from_jax(jax.tree.map(np.asarray, jg))
    assert tg.keys() == ref.keys() == params.keys()
    for k, g in tg.items():
        scale = float(np.abs(ref[k].numpy()).max())
        err = float(np.abs(g.numpy() - ref[k].numpy()).max())
        assert err <= 1e-4 * scale, (k, err, scale)
    assert float(tg["encoder.pos_emb"].abs().max()) > 0
    d = cfg.n_audio_state
    for k in tg:
        if k.endswith("attn.qkv.bias"):
            assert torch.count_nonzero(tg[k][d: 2 * d]) == 0, k


def _eager_vs_optax(jopt, topt, steps: int, scale: float = 1.0, seed: int = 0):
    """Worst ulps between optax's and the port's updates over ``steps``
    steps of identical gradients, the params kept equal (optax's)."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (64, 33), "b": (7,), "c": (3, 5, 9)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    worst = []
    for _ in range(steps):
        g = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = topt.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        worst.append(max(_ulps(ju[k], tu[k].numpy()) for k in shapes))
        jp = optax.apply_updates(jp, ju)
        for k in shapes:
            tp[k].copy_(torch.from_numpy(np.array(jp[k])))
    return worst


@pytest.mark.parametrize("name,make_jax,make_port,steps", [
    ("scale_by_adam", lambda: optax.scale_by_adam(), lambda: O.scale_by_adam(), 40),
    ("adam", lambda: optax.adam(2e-3), lambda: O.adam(2e-3), 40),
    ("adamw", lambda: optax.adamw(1e-3, weight_decay=0.01),
     lambda: O.adamw(1e-3, weight_decay=0.01), 20),
    ("adamw default decay", lambda: optax.adamw(1e-5), lambda: O.adamw(1e-5), 5),
    ("finetune recipe, norm under 1",
     lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
         optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 100), weight_decay=0.01)),
     lambda: O.chain(O.clip_by_global_norm(1.0), O.adamw(
         O.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 100), weight_decay=0.01)), 8),
])
def test_optimizer_steps_equal_optax(name, make_jax, make_port, steps):
    scale = 1e-3 if "norm under 1" in name else 1.0
    assert _eager_vs_optax(make_jax(), make_port(), steps, scale) == [0] * steps


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(1)
    sizes = dict(zip("abcd", (2900, 1, 613, 1500)))
    norm_ulps, clip_ulps = [], []
    for _ in range(60):
        g = {k: (rng.standard_normal(n) * rng.uniform(0.001, 0.1)).astype(np.float32)
             for k, n in sizes.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {k: torch.tensor(v) for k, v in g.items()}
        jnorm = optax.global_norm(jg)
        norm_ulps.append(_ulps(jnorm, O.global_norm(tg).numpy()))
        ju, _ = optax.clip_by_global_norm(1.0).update(jg, optax.EmptyState())
        tu, _ = O.clip_by_global_norm(1.0).update({k: v.clone() for k, v in tg.items()},
                                                  O.EmptyState())
        clip_ulps.append(max(_ulps(ju[k], tu[k].numpy()) for k in g))
        # given optax's norm, the clip's arithmetic is optax's bit for bit
        if float(jnorm) >= 1.0:
            n = torch.tensor(np.asarray(jnorm))
            for k in g:
                assert _ulps(ju[k], (tg[k] / n * 1.0).numpy()) == 0
    assert max(norm_ulps) <= 1 and max(clip_ulps) <= 2
    assert clip_ulps.count(0) >= norm_ulps.count(0)


@pytest.mark.parametrize("init,peak,warmup,decay,off_by_one", [
    (0.0, 1e-5, 50, 10000, 0), (0.0, 1e-4, 50, 10000, 0), (0.0, 1e-3, 1, 60, 2),
    (0.0, 3e-4, 7, 40, 0), (1e-6, 1e-4, 0, 30, 0)])
def test_schedule_equals_optax(init, peak, warmup, decay, off_by_one):
    """Counts 0…60: within 1 ulp of optax's; bit for bit for the finetune
    recipe's schedules. The 1-ulp counts (2 of 61 in one schedule) are
    XLA's float32 cosine, which is not correctly rounded; the port's is."""
    ours = O.warmup_cosine_decay_schedule(init, peak, warmup, decay)
    theirs = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay)
    ulps = [_ulps(theirs(jnp.asarray(c, jnp.int32)), np.float32(ours(c))) for c in range(61)]
    assert max(ulps) <= 1 and sum(ulps) == off_by_one, ulps
    # read at the count before the update: a warm-up starts at init_value
    assert ours(0) == np.float32(init if warmup else peak)


def _manifest(tmp_path, n: int, texts=None) -> str:
    rng = np.random.default_rng(0)
    path = tmp_path / "train.jsonl"
    with open(path, "w") as f:
        for i in range(n):
            wav = tmp_path / f"c{i}.wav"
            write_wav(str(wav), rng.standard_normal(SR).astype(np.float32) * 0.1)
            text = texts[i] if texts else f"w{i} w{i + 1} w{i + 3}"
            f.write(json.dumps({"wav": str(wav), "text": text}) + "\n")
    return str(path)


def _recipe(lr, warmup, lib):
    sched = lib.warmup_cosine_decay_schedule(0.0, lr, warmup, 10000)
    return lib.chain(lib.clip_by_global_norm(1.0), lib.adamw(sched, weight_decay=0.01))


@pytest.mark.parametrize("lr,warmup,max_off", [(1e-4, 50, 0), (1e-3, 1, 4)])
def test_three_finetune_steps_track_jax(tmp_path, jax_params, lr, warmup, max_off):
    cfg, jcfg = get_config("test-tiny"), JW.get_config("test-tiny")
    man = _manifest(tmp_path, 6)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jopt = _recipe(lr, warmup, optax)
    init = jax.tree.map(jnp.copy, jax_params)  # the jitted step donates its state
    jstate = JT.TrainState(init, jopt.init(init), jnp.zeros((), jnp.int32))
    jstep, jshard = JT.make_sharded_train_step(jcfg, mesh, jopt)
    topt = _recipe(lr, warmup, O)
    params = _port_params(jax_params)
    state = TS.TrainState(params, topt.init(params), 0)
    step, _ = TS.make_train_step(cfg, topt, device="cpu")
    jlosses, losses = [], []
    ours = D.DataPipeline(man, cfg, MockTokenizer(cfg), batch_size=2, seed=0)
    theirs = JT.DataPipeline(man, jcfg, JaxMockTokenizer(jcfg), batch_size=2, seed=0)
    for b, jb in zip(ours.epochs(1), theirs.epochs(1)):
        jstate, jl = jstep(jstate, JT.prepare_batch(jb, jcfg, shard_fn=jshard))
        state, tl = step(state, D.prepare_batch(b, cfg, device="cpu"))
        jlosses.append(float(jl))
        losses.append(float(tl))
    assert len(losses) == 3 and state.step == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=0)
    ref = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    lr_sum = sum(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, 10000)(c) for c in range(3))
    off = 0
    for k, v in state.params.items():
        diff = np.abs(v.detach().numpy() - ref[k].numpy())
        off += int((diff > 1e-6).sum())
        assert diff.max() <= 2 * float(lr_sum) + 1e-6, k
    assert off <= max_off, off


def test_pos_emb_trains_and_k_bias_stays_zero(tmp_path):
    cfg = get_config("test-tiny")
    state, opt = TS.make_train_state(cfg, torch.Generator().manual_seed(0),
                                     optimizer=O.adamw(1e-3), device="cpu")
    before = {k: v.detach().clone() for k, v in state.params.items()}
    step, shard = TS.make_train_step(cfg, opt, device="cpu")
    for seed in range(2):
        state, loss = step(state, shard(_batch(seed, s=16)))
        assert np.isfinite(float(loss))
    d = cfg.n_audio_state
    for k, v in state.params.items():
        if k.endswith("attn.qkv.bias"):
            assert torch.count_nonzero(v[d: 2 * d]) == 0, k
            assert not torch.equal(v[:d], before[k][:d]), k
        else:
            assert not torch.equal(v, before[k]), k  # every leaf trains
    assert state.step == 2 and state.opt_state[0].count == 2


def test_train_state_round_trip_and_resume_bit_equal(tmp_path):
    cfg = get_config("test-tiny")
    opt = _recipe(1e-3, 1, O)

    def fresh():
        return TS.make_train_state(cfg, torch.Generator().manual_seed(3), optimizer=opt,
                                   device="cpu")[0]

    step, shard = TS.make_train_step(cfg, opt, device="cpu")
    batches = [shard(_batch(seed, s=16)) for seed in range(3)]
    straight = fresh()
    for b in batches:
        straight, _ = step(straight, b)

    state = fresh()
    for b in batches[:2]:
        state, _ = step(state, b)
    save_train_state(str(tmp_path / "ts"), state)
    loaded = load_train_state(str(tmp_path / "ts"), fresh())
    assert loaded.step == 2
    assert [s.count for s in (loaded.opt_state[1][0], loaded.opt_state[1][2])] == [2, 2]
    for k, v in state.params.items():
        assert torch.equal(loaded.params[k], v) and loaded.params[k].requires_grad
        for moment in ("mu", "nu"):
            assert torch.equal(getattr(loaded.opt_state[1][0], moment)[k],
                               getattr(state.opt_state[1][0], moment)[k])
    resumed, _ = step(loaded, batches[2])
    assert resumed.step == 3
    for k, v in straight.params.items():
        assert torch.equal(resumed.params[k], v), k


def test_eval_loss_equals_the_train_loss(tmp_path):
    cfg = get_config("test-tiny")
    state, _ = TS.make_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, shard = TS.make_train_step(cfg, device="cpu")
    batch = shard(_batch(1, s=16))
    loss, _ = TS.loss_and_grads(state.params, cfg, batch)
    assert torch.equal(TS.eval_loss(state.params, cfg, batch), loss)


def test_finetune_recipe_end_to_end(tmp_path):
    """tools/finetune.py: manifest -> steps -> resumable train state ->
    native inference checkpoint loadable by TorchWhisperASR; --resume
    continues from the saved step."""
    from realtime_whisper_asr_tpu_torch.asr import TorchWhisperASR
    from realtime_whisper_asr_tpu_torch.tools.finetune import main as finetune_main

    man = _manifest(tmp_path, 8, [f"w{i} w{i + 1}" for i in range(8)])
    out = tmp_path / "run"
    rc = finetune_main([
        "--manifest", man, "--val-manifest", man, "--model", "test-tiny", "--out", str(out),
        "--epochs", "1", "--batch-size", "4", "--lr", "1e-4", "--save-every", "1",
        "--log-every", "1", "--cpu",
    ])
    assert rc == 0
    assert (out / "train_state").is_dir() and (out / "checkpoint").is_dir()

    asr = TorchWhisperASR(checkpoint_dir=str(out / "checkpoint"), dtype=torch.float32,
                          device="cpu")
    asr.transcribe_kargs["max_total_tokens"] = 8
    rng = np.random.default_rng(0)
    segs = asr.transcribe(rng.standard_normal(SR).astype(np.float32) * 0.1)
    assert isinstance(segs.tokens, list)

    rc = finetune_main([
        "--manifest", man, "--model", "test-tiny", "--out", str(out), "--epochs", "1",
        "--batch-size", "4", "--resume", "--max-steps", "1", "--save-every", "0",
        "--log-every", "1", "--cpu",
    ])
    assert rc == 0
    with open(out / "train_state" / "train_state.json") as f:
        assert json.load(f)["/step"] == 3


def test_finetune_from_a_checkpoint_matches_its_weights(tmp_path):
    """--init-checkpoint DIR (the port's native format) starts from those
    weights: with a zero learning rate the written checkpoint equals them."""
    from realtime_whisper_asr_tpu_torch.models.whisper.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from realtime_whisper_asr_tpu_torch.tools.finetune import finetune, parse_args

    cfg = get_config("test-tiny")
    golden = os.path.join(os.path.dirname(__file__), "fixtures", "golden", "params.npz")
    save_checkpoint(str(tmp_path / "init"), convert.load_flat_npz(golden), cfg)
    man = _manifest(tmp_path, 2)
    out = finetune(parse_args([
        "--manifest", man, "--init-checkpoint", str(tmp_path / "init"), "--out",
        str(tmp_path / "run"), "--batch-size", "2", "--lr", "0", "--cpu"]))
    assert out["steps"] == 1 and np.isfinite(out["losses"][0])
    _, a = load_checkpoint(str(tmp_path / "init"))
    _, b = load_checkpoint(str(tmp_path / "run" / "checkpoint"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("flags, message", [
    (["--mesh", "2x2"], "mesh 2x2 needs 4 devices, have 1"),
    (["--pipeline-stages", "2", "--mesh", "2x2"], "mutually exclusive"),
    (["--pipeline-stages", "2", "--batch-size", "3", "--microbatches", "2"],
     "--batch-size 3 must divide by --microbatches 2"),
    (["--pipeline-stages", "2"], "--pipeline-stages 2 needs 2 devices, have 1"),
], ids=["mesh-world", "pp-and-mesh", "microbatches", "pp-world"])
def test_finetune_refuses_what_the_world_cannot_run(tmp_path, flags, message):
    """A mesh or a stage count the world (here: this process alone) cannot
    run exits with the JAX tool's message before anything is built."""
    from realtime_whisper_asr_tpu_torch.tools.finetune import main as finetune_main

    with pytest.raises(SystemExit, match=message):
        finetune_main(["--manifest", "m.jsonl", "--out", str(tmp_path), "--cpu"] + flags)


def test_finetune_mesh_1x1_in_a_world_of_one(tmp_path):
    """Without torchrun the process is a world of one: ``--mesh 1x1`` runs
    the dp × tp step over a 1-rank gloo group, equal to the single-card
    recipe's losses bit for bit, saves its rank's train state and leaves no
    process group behind."""
    import torch.distributed as dist

    from realtime_whisper_asr_tpu_torch.tools.finetune import finetune, parse_args

    man = _manifest(tmp_path, 4)
    common = ["--manifest", man, "--model", "test-tiny", "--batch-size", "2", "--lr", "1e-3",
              "--warmup-steps", "1", "--save-every", "0", "--cpu"]
    mesh = finetune(parse_args(common + ["--out", str(tmp_path / "mesh"), "--mesh", "1x1"]))
    assert not dist.is_initialized()
    single = finetune(parse_args(common + ["--out", str(tmp_path / "single")]))
    assert mesh["steps"] == single["steps"] == 2
    assert mesh["losses"] == single["losses"]
    assert sorted(os.listdir(tmp_path / "mesh" / "train_state")) == [
        "mesh.json", "train_state.rank0.json", "train_state.rank0.safetensors"]
