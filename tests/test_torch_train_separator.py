"""The port's separator trainer against the JAX package's tool (CPU, f32).

- The corpora (``make_batch``, ``make_batch_4stem`` with every mixture
  degraded, ``evaluate``'s held-out examples) are bit-equal to the JAX
  tool's for the same generator.
- ``params_to_jax`` inverts ``params_from_jax`` bit for bit.
- The loss for ``v2s`` and ``v2x4`` at batch 2, from the JAX package's
  init, is within 1e-5 relative of the JAX tool's; both tools' gradients
  are within 1e-4 of each leaf's scale of the same loss in float64 (the f32
  sums' own error, measured in the test).
- A checkpoint in the JAX tool's layout (the JAX init of ``v2s``, optax's
  ``adam(cosine_decay_schedule)`` state, step 0, a seeded rng) resumes in
  both tools' mains for 3 steps: the written weights agree within 1e-5 of
  scale, and so do the checkpoints each writes on the way (the step, the
  rng's state, the weights; the optimizer's moments within 1e-4 of scale,
  as the gradients they sum); each tool resumes the other's checkpoint.
- The port's ``evaluate`` of its packaged separators equals the JAX tool's
  on the JAX separator per condition within 0.01 dB, and meets the floors
  ``tests/test_separation.py`` locks for the JAX package.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from realtime_whisper_asr_tpu.models import separation_nn as JS
from realtime_whisper_asr_tpu_torch.models import separation_nn as S
from realtime_whisper_asr_tpu_torch.tools import train_separator as PT

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_separator

    return train_separator


def _jax_init(arch: str, seed: int = 0) -> dict:
    key = jax.random.PRNGKey(seed)
    if arch == "v2s":
        return JS.init_separator_params_v2(key, channels=JS.V2_SMALL_CHANNELS)
    return JS.init_separator_params_v2(key, n_stems=4 if arch == "v2x4" else 1)


def _jax_loss(p, mix, clean, dil, n_stems):
    """``tools/train_separator.py``'s ``loss_fn``."""
    if n_stems > 1:
        est = jax.vmap(lambda a: JS.separate_stems_device(p, a, dil=dil))(mix)
        spec = jax.vmap(jax.vmap(lambda a: JS._stft(a)[0]))
    else:
        est = jax.vmap(lambda a: JS.separate_vocals(p, a, dil=dil))(mix)
        spec = jax.vmap(lambda a: JS._stft(a)[0])
    l_time = jnp.mean(jnp.abs(est - clean))
    spec_e, spec_c = spec(est), spec(clean)
    l_spec = jnp.mean(jnp.abs(jnp.log1p(jnp.abs(spec_e)) - jnp.log1p(jnp.abs(spec_c))))
    return l_time + 0.5 * l_spec


def _close(a: np.ndarray, b: np.ndarray, what: str, tol: float = 1e-5) -> None:
    scale = max(float(np.abs(b).max()), 1e-12)
    assert float(np.abs(np.asarray(a) - np.asarray(b)).max()) <= tol * scale, what


def test_corpora_equal_jax_tool():
    jt = _jax_tool()
    for ours, theirs in ((PT.make_batch(np.random.default_rng(4), 3),
                          jt.make_batch(np.random.default_rng(4), 3)),
                         (PT.make_batch_4stem(np.random.default_rng(5), 4, degrade_prob=1.0),
                          jt.make_batch_4stem(np.random.default_rng(5), 4, degrade_prob=1.0))):
        assert all(x.tobytes() == y.tobytes() for x, y in zip(ours, theirs))
    for cond in PT.CONDITIONS:
        a = PT.make_example(np.random.default_rng((777, 1)), cond=cond)
        b = jt.make_example(np.random.default_rng((777, 1)), cond=cond)
        assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes(), cond


@pytest.mark.parametrize("arch", ["v1", "v2", "v2s", "v2x4"])
def test_params_to_jax_inverts_params_from_jax(arch):
    params = PT.init_params(arch, 3, "cpu")
    back = S.params_from_jax(S.params_to_jax(params), "cpu")
    assert set(back) == set(params)
    assert all(torch.equal(back[k], params[k]) for k in params)
    ref = _jax_init(arch) if arch != "v1" else JS.init_separator_params(jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in S.params_to_jax(params).items()} == {
        k: tuple(v.shape) for k, v in ref.items()}


def _loss_f64(params: dict, mix, clean, dil):
    """The JAX tool's loss in float64 (the port's STFT and iSTFT, which keep
    their input's dtype, around the conv stack written out): the reference
    both f32 gradients are measured against."""
    import torch.nn.functional as F

    def separate(audio):
        spec = S._stft(audio)
        mag = torch.log1p(spec.abs())
        x = torch.stack([mag, torch.linspace(0.0, 1.0, mag.shape[-1],
                                             dtype=torch.float64).expand_as(mag)], 1)
        n_layers = len(dil) - 1
        for i in range(n_layers):
            x = torch.relu(F.conv2d(x, params[f"enc{i}_w"], params[f"enc{i}_b"],
                                    padding=dil[i], dilation=dil[i]))
        x = F.conv2d(x, params["out_w"], params["out_b"], padding=dil[-1], dilation=dil[-1])
        if x.shape[1] == 1:
            return S._istft(spec * torch.sigmoid(x)[:, 0], audio.shape[-1])
        return S._istft(spec[:, None] * torch.softmax(x, dim=1), audio.shape[-1])

    est = separate(mix)
    l_spec = torch.mean(torch.abs(torch.log1p(S._stft(est).abs())
                                  - torch.log1p(S._stft(clean).abs())))
    return torch.mean(torch.abs(est - clean)) + 0.5 * l_spec


@pytest.mark.parametrize("arch", ["v2s", "v2x4"])
def test_loss_and_grads_match_jax(arch):
    """The loss within 1e-5 relative of the JAX tool's; every gradient
    leaf of both tools within 1e-4 of its scale of the same loss evaluated
    in float64, and the two within 1e-4 of each other. A weight's or bias's
    gradient sums its conv's ~66,000 positions (2 rows x 65 frames x 513
    bins) with much cancellation, and each f32 backward sums them in its own
    order: measured against f64, the JAX CPU backward's leaves are off by up
    to 5.6e-5 of their scale (v2s, the deep biases and weights) and the
    port's CPU backward's by up to 1.7e-5 (v2x4, a dilated kernel), so 1e-5
    of scale between the two is below what either f32 sum holds."""
    jp = _jax_init(arch)
    n_stems = JS.n_stems_of(jp)
    dil, _ = JS.arch_of(jp)
    mix, clean = PT.next_batch(np.random.default_rng(6), n_stems, 2, 0.0)
    jl, jg = jax.value_and_grad(_jax_loss)(jp, jnp.asarray(mix), jnp.asarray(clean), dil,
                                          n_stems)
    params = S.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for v in params.values():
        v.requires_grad_(True)
    loss = PT.loss_fn(params, torch.from_numpy(mix), torch.from_numpy(clean), dil)
    ours = S.params_to_jax(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
    p64 = {k: v.detach().double().requires_grad_(True) for k, v in params.items()}
    l64 = _loss_f64(p64, torch.from_numpy(mix).double(), torch.from_numpy(clean).double(), dil)
    exact = S.params_to_jax(dict(zip(p64, torch.autograd.grad(l64, list(p64.values())))))
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(loss.item() - l64.item()) <= 1e-5 * abs(l64.item())
    for k, g in jg.items():
        theirs = np.asarray(g)
        _close(theirs, exact[k], k, tol=1e-4)
        _close(ours[k], exact[k], k, tol=1e-4)
        _close(ours[k], theirs, k, tol=1e-4)


def _jax_checkpoint(path: str, steps: int) -> None:
    """The JAX tool's checkpoint layout at step 0: its init of ``v2s``,
    optax's state of ``adam(cosine_decay_schedule)``, a seeded rng."""
    params = _jax_init("v2s", seed=2)
    opt = optax.adam(optax.cosine_decay_schedule(1e-3, steps, alpha=0.05))
    blob = {f"p/{k}": np.asarray(v) for k, v in params.items()}
    for i, leaf in enumerate(jax.tree_util.tree_leaves(opt.init(params))):
        blob[f"o/{i}"] = np.asarray(leaf)
    blob["step"] = np.asarray(0)
    blob["rng"] = np.asarray(json.dumps(np.random.default_rng(9).bit_generator.state))
    np.savez(path, **blob)


def test_resume_from_jax_checkpoint_matches_jax_tool(tmp_path):
    ckpt = str(tmp_path / "start.npz")
    _jax_checkpoint(ckpt, steps=4)
    args = ["--resume", ckpt, "--steps", "3", "--batch", "2", "--ckpt-every", "2"]
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert PT.main(args + ["--out", ours, "--cpu"]) == 0
    assert _jax_tool().main(args + ["--out", theirs]) == 0
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        _close(a[k], b[k], k)
    ca, cb = np.load(ours + ".ckpt.npz"), np.load(theirs + ".ckpt.npz")
    assert sorted(ca.files) == sorted(cb.files)
    assert int(ca["step"]) == int(cb["step"]) == 3 and str(ca["rng"]) == str(cb["rng"])
    for k in cb.files:
        if k.startswith(("p/", "o/")):
            assert ca[k].shape == cb[k].shape, k
            # the moments are running sums of the gradients: held as those are
            _close(ca[k], cb[k], k, tol=1e-4 if k.startswith("o/") else 1e-5)
    # the port's checkpoint resumes in the JAX tool, and the JAX tool's in the port
    assert _jax_tool().main(["--resume", ours + ".ckpt.npz", "--steps", "3", "--batch", "2",
                             "--out", str(tmp_path / "again_jax.npz")]) == 0
    assert PT.main(["--resume", theirs + ".ckpt.npz", "--steps", "3", "--batch", "2",
                    "--out", str(tmp_path / "again_port.npz"), "--cpu"]) == 0
    again_a, again_b = np.load(tmp_path / "again_port.npz"), np.load(tmp_path / "again_jax.npz")
    for k in b.files:
        _close(again_a[k], b[k], k)
        _close(again_b[k], b[k], k)


@pytest.mark.parametrize("variant", ["default", "small", "4stem"])
def test_evaluate_equals_jax_tool(variant):
    ours = PT.evaluate(S.NeuralSeparator(variant=variant, use_device=False, device="cpu"),
                       seed=777, per_cond=1)
    theirs = _jax_tool().evaluate(JS.NeuralSeparator(variant=variant, use_device=False),
                                  seed=777, per_cond=1)
    assert set(ours) == set(theirs)
    assert all(abs(ours[k] - theirs[k]) <= 0.01 for k in theirs), (ours, theirs)


def test_packaged_weights_equal_jax_packages():
    for variant, path in S.VARIANT_WEIGHTS.items():
        with open(path, "rb") as f, open(JS.VARIANT_WEIGHTS[variant], "rb") as g:
            assert f.read() == g.read(), variant


@pytest.mark.parametrize("variant,floor", [("default", 12.0), ("small", 8.0)])
def test_packaged_separator_floor(variant, floor):
    report = PT.evaluate(S.NeuralSeparator(variant=variant, use_device=False, device="cpu"),
                         seed=777, per_cond=4)
    assert report["overall"] >= floor, report


def test_packaged_4stem_floor():
    sep = S.NeuralSeparator(variant="4stem", use_device=False, device="cpu")
    per_stem = PT.evaluate_4stem(sep, seed=777)
    assert set(per_stem) == set(S.STEM_NAMES)
    assert all(gain >= 8.0 for gain in per_stem.values()), per_stem
    assert PT.evaluate(sep, seed=777, per_cond=4)["overall"] >= 10.0


def test_default_out_and_4stem_redirect(tmp_path, monkeypatch):
    """``--out`` defaults to the port's packaged file; a 4-stem net with the
    default is redirected to the port's 4-stem file (the write itself is
    stubbed so the packaged weights are not touched)."""
    written = []
    monkeypatch.setattr(PT, "train", lambda *a, **k: None)
    monkeypatch.setattr(PT.np, "savez", lambda path, **kw: written.append(path))
    monkeypatch.setattr(S.NeuralSeparator, "load_npz",
                        classmethod(lambda cls, path, **kw: cls(variant="4stem",
                                                                use_device=False)))
    monkeypatch.setattr(PT, "evaluate", lambda *a, **k: {})
    monkeypatch.setattr(PT, "evaluate_4stem", lambda *a, **k: {})
    monkeypatch.setattr(PT, "evaluate_4stem_conditions", lambda *a, **k: {})
    assert PT.main(["--arch", "v2x4", "--steps", "1", "--cpu"]) == 0
    assert PT.main(["--arch", "v2s", "--steps", "1", "--cpu"]) == 0
    assert written == [os.path.abspath(S.VARIANT_WEIGHTS["4stem"]),
                       os.path.abspath(S._PACKAGED_WEIGHTS)]
    assert all(os.sep + "realtime_whisper_asr_tpu" + os.sep not in p for p in written)
