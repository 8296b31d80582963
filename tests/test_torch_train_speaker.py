"""The port's speaker trainer against the JAX package's tool (CPU, f32).

- ``batch_features`` draws the same corpus as the JAX tool, bit for bit.
- The NT-Xent loss and its gradients from ``init_speaker_params(0)`` on one
  seeded batch are within 1e-5 of ``jax.value_and_grad`` of the JAX tool's
  loss (rebuilt here from ``tools/train_speaker.py``'s ``fwd`` / ``ntxent``,
  run op by op: no jit, so no fusion keeps excess precision).
- Both tools' ``main`` with the same small arguments write npz files with
  the same keys: ``f_mu`` / ``f_sd`` bit-equal, every weight within 1e-5 of
  its scale, the threshold within 1e-4.
- The default ``--out`` is the port's packaged file, not the JAX package's.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from realtime_whisper_asr_tpu.models.speaker import init_speaker_params
from realtime_whisper_asr_tpu_torch.tools import train_speaker as PT

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_speaker

    return train_speaker


def _jax_ntxent(p, x, labels, temp):
    """``tools/train_speaker.py``'s ``fwd`` and ``ntxent``."""
    h = jax.nn.relu(x @ p["w1"] + p["b1"])
    h = jax.nn.relu(h @ p["w2"] + p["b2"])
    e = h @ p["w3"] + p["b3"]
    e = e / jnp.maximum(jnp.linalg.norm(e, axis=-1, keepdims=True), 1e-9)
    sims = e @ e.T / temp
    n = x.shape[0]
    mask_self = jnp.eye(n, dtype=bool)
    same = labels[:, None] == labels[None, :]
    pos = same & ~mask_self
    logits = jnp.where(mask_self, -1e9, sims)
    logz = jax.nn.logsumexp(logits, axis=1)
    pos_lp = jnp.where(pos, logits, -1e9)
    pos_logz = jax.nn.logsumexp(pos_lp, axis=1)
    return jnp.mean(logz - pos_logz)


def test_batch_features_equal_jax_tool():
    a = PT.batch_features(np.random.default_rng(5), 4, 2)
    b = _jax_tool().batch_features(np.random.default_rng(5), 4, 2)
    assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()


def test_ntxent_and_grads_match_jax():
    corpus = PT.make_corpus(np.random.default_rng(1), 6, 3)
    x, y = PT.minibatch(np.random.default_rng(2), corpus, 4, 2)
    params = {k: v for k, v in init_speaker_params(0).items() if k.startswith(("w", "b"))}
    jl, jg = jax.value_and_grad(_jax_ntxent)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jnp.asarray(y), 0.1)
    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    loss = PT.ntxent(leaves, torch.from_numpy(x), torch.from_numpy(y).long(),
                     torch.tensor(0.1))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    for k, g in zip(leaves, grads):
        want = np.asarray(jg[k])
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(g.numpy() - want).max()) <= 1e-5 * scale, k


def test_main_matches_jax_tool(tmp_path):
    args = ["--steps", "5", "--corpus-speakers", "8", "--corpus-utts", "3",
            "--speakers-per-batch", "4"]
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert PT.main(args + ["--out", ours, "--cpu"]) == 0
    assert _jax_tool().main(args + ["--out", theirs]) == 0
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in ("f_mu", "f_sd"):
        assert a[k].tobytes() == b[k].tobytes(), k
    for k in a.files:
        if k.startswith(("w", "b")):
            scale = float(np.abs(b[k]).max())
            assert float(np.abs(a[k] - b[k]).max()) <= 1e-5 * scale, k
    assert abs(float(a["threshold"]) - float(b["threshold"])) <= 1e-4


def test_default_out_is_the_ports_packaged_file(monkeypatch):
    import argparse

    from realtime_whisper_asr_tpu_torch.models.speaker import _PACKAGED_WEIGHTS

    seen = {}

    def grab(self, argv=None, namespace=None):
        seen["out"] = self.get_default("out")
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        PT.main([])
    out = os.path.realpath(seen["out"])
    assert out == os.path.realpath(_PACKAGED_WEIGHTS)
    assert os.sep + "realtime_whisper_asr_tpu" + os.sep not in out
