"""The port's VAD training against the JAX package's (CPU, f32).

- ``SileroLikeNet.sequence_logits`` (B, T, 512) -> (B, T) equals the JAX
  package's ``vad_sequence_logits`` under ``jax.vmap`` within 1e-5
  (measured 6.7e-7 on logits of magnitude ~0.6), and its gradients, under
  optax's ``sigmoid_binary_cross_entropy``, are within 1e-5 of each
  leaf's largest magnitude (measured ≤ 1.1e-6).
- ``lstm.bias_hh_l0`` stays 0 through training; ``params_to_jax`` sums the
  two biases into the JAX tree's one.
- 5 steps of ``tools/train_vad.py``'s loop track the JAX tool's (its jitted
  ``optax.adam`` step on the same numpy batches): losses within 1e-5
  relative; every leaf within 1e-5 but ``proj_w``, where Adam divides
  near-zero gradients of quiet frequency bins by their own small history
  (measured: 115 of 78,417 elements above 1e-5, all in ``proj_w``, the
  largest 2.0e-4 = 0.1·lr; eager and jitted JAX alike), each element within
  Adam's bound 2·steps·lr.
- The tool writes the npz in the JAX layout to ``--out``, which both
  packages' VADs load; the packaged weights are not touched.
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from realtime_whisper_asr_tpu.models.vad import silero_like as JS
from realtime_whisper_asr_tpu_torch.models.vad import silero_like as S
from realtime_whisper_asr_tpu_torch.tools import train_vad as PT

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_params():
    return JS.init_vad_params(jax.random.PRNGKey(0))


def _net(jax_tree) -> S.SileroLikeNet:
    net = S.SileroLikeNet("cpu")
    net.load_state_dict(S.params_from_jax(jax.tree.map(np.asarray, jax_tree)))
    return net


def _jax_loss(p, audio, labels):
    logits = jax.vmap(lambda a: JS.vad_sequence_logits(p, a))(audio)
    return optax.sigmoid_binary_cross_entropy(logits, labels).mean()


def test_make_batch_equals_jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_vad as jax_tool

    a = PT.make_batch(np.random.default_rng(3), 3, 1.5)
    b = jax_tool.make_batch(np.random.default_rng(3), 3, 1.5)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


def test_sequence_logits_and_grads_match_jax(jax_params):
    audio, labels = PT.make_batch(np.random.default_rng(0), 4, 2.0)
    net = _net(jax_params)
    jl = np.asarray(jax.vmap(lambda a: JS.vad_sequence_logits(jax_params, a))(jnp.asarray(audio)))
    tl = net.sequence_logits(torch.from_numpy(audio))
    assert tl.shape == (4, audio.shape[1])
    assert float(np.abs(tl.detach().numpy() - jl).max()) <= 1e-5

    loss, grads = jax.value_and_grad(_jax_loss)(jax_params, jnp.asarray(audio),
                                                jnp.asarray(labels))
    params = PT.trainable_params(net)
    assert "lstm.bias_hh_l0" not in params
    ours = PT.sigmoid_binary_cross_entropy(tl, torch.from_numpy(labels)).mean()
    assert abs(float(ours) - float(loss)) <= 1e-6 * abs(float(loss))
    tg = dict(zip(params, torch.autograd.grad(ours, list(params.values()))))
    ref = S.params_from_jax(jax.tree.map(np.asarray, grads))
    for k, g in tg.items():
        scale = float(np.abs(ref[k].numpy()).max())
        assert float(np.abs(g.numpy() - ref[k].numpy()).max()) <= 1e-5 * scale, k


def test_sequence_logits_is_the_streaming_network(jax_params):
    """From a zero state, ``forward``'s probabilities are the sigmoid of
    ``sequence_logits`` row by row."""
    audio, _ = PT.make_batch(np.random.default_rng(1), 2, 1.0)
    net = _net(jax_params)
    logits = net.sequence_logits(torch.from_numpy(audio)).detach()
    for row in range(2):
        probs, _ = net(torch.from_numpy(audio[row]), net.init_state())
        np.testing.assert_allclose(probs.detach().numpy(), torch.sigmoid(logits[row]).numpy(),
                                   rtol=0, atol=1e-6)


def test_five_steps_track_the_jax_tool(jax_params):
    lr, steps, batch, seconds = 2e-3, 5, 4, 2.0
    net = _net(jax_params)
    losses = PT.train(net, steps, batch, seconds, lr, seed=0)

    opt = optax.adam(lr)

    @jax.jit
    def train_step(p, s, audio, labels):  # tools/train_vad.py's step
        loss, grads = jax.value_and_grad(_jax_loss)(p, audio, labels)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    p, s = jax_params, opt.init(jax_params)
    rng, jlosses = np.random.default_rng(0), []
    for _ in range(steps):
        audio, labels = PT.make_batch(rng, batch, seconds)
        p, s, loss = train_step(p, s, jnp.asarray(audio), jnp.asarray(labels))
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=0)
    assert float(net.lstm.bias_hh_l0.abs().max()) == 0.0
    ours = S.params_to_jax(net.state_dict())
    off, total = 0, 0
    for k, v in ours.items():
        diff = np.abs(v - np.asarray(p[k]))
        off += int((diff > 1e-5).sum())
        total += diff.size
        assert diff.max() <= 2 * steps * lr, k
        if k != "proj_w":
            assert diff.max() <= 1e-5, k
    # measured: 115 of 78,417 elements, all in proj_w, the largest 2.0e-4
    assert off <= 0.01 * total, off


def test_tool_writes_the_jax_layout_to_out(tmp_path):
    packaged = S._PACKAGED_WEIGHTS
    with open(packaged, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    out = tmp_path / "vad.npz"
    assert PT.main(["--steps", "2", "--batch", "2", "--seconds", "1", "--out", str(out),
                    "--cpu"]) == 0
    with open(packaged, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == digest
    written = dict(np.load(out))
    ref = JS.init_vad_params(jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in written.items()} == {k: v.shape for k, v in ref.items()}
    frames = PT.make_batch(np.random.default_rng(5), 1, 1.0)[0][0]
    theirs = JS.SileroLikeVAD.load_npz(str(out))(frames)
    ours = S.SileroLikeVAD(params=written, device="cpu")(frames)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
