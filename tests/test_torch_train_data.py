"""The port's training data pipeline against the JAX package's.

The host half is the JAX package's numpy code over the port's io and
tokenizer: for the same manifest and seed the batches are equal bit for bit
(audio, tokens, masks), over several epochs. ``prepare_batch`` puts them on
the device with each row's log-mel (on the CPU the plain version; on the
card K1, which chip_smoke.py holds against it), within K1's tolerance of the
JAX package's ``prepare_batch`` (its Pallas kernel in interpret mode). The
cases of tests/test_train_data.py run on the port too.
"""

import json

import numpy as np
import pytest
import torch

from realtime_whisper_asr_tpu.io import write_wav
from realtime_whisper_asr_tpu.models import whisper as JW
from realtime_whisper_asr_tpu.models.whisper.tokenizer import MockTokenizer as JaxMockTokenizer
from realtime_whisper_asr_tpu.train import DataPipeline as JaxPipeline
from realtime_whisper_asr_tpu.train import prepare_batch as jax_prepare_batch
from realtime_whisper_asr_tpu_torch.models.whisper.config import get_config
from realtime_whisper_asr_tpu_torch.models.whisper.tokenizer import MockTokenizer
from realtime_whisper_asr_tpu_torch.train.data import (
    DataPipeline,
    ManifestEntry,
    _audio_bucket,
    _token_bucket,
    prepare_batch,
    read_manifest,
    tokenize_example,
)

torch.set_num_threads(2)

SR = 16000


@pytest.fixture(scope="module")
def cfg():
    return get_config("tiny")


@pytest.fixture(scope="module")
def tok(cfg):
    return MockTokenizer(cfg)


def _write_manifest(tmp_path, specs, name="manifest.jsonl"):
    """specs: list of (seconds, text). Returns manifest path."""
    rng = np.random.default_rng(0)
    path = tmp_path / name
    with open(path, "w") as f:
        for i, (sec, text) in enumerate(specs):
            wav = tmp_path / f"{name}.clip{i}.wav"
            write_wav(str(wav), rng.standard_normal(int(sec * SR)).astype(np.float32) * 0.1)
            f.write(json.dumps({"wav": str(wav), "text": text, "language": "en"}) + "\n")
    return str(path)


def test_read_manifest_errors(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"wav": "x"}\n')
    with pytest.raises(ValueError):
        read_manifest(str(p))
    (tmp_path / "empty.jsonl").write_text("")
    with pytest.raises(ValueError):
        read_manifest(str(tmp_path / "empty.jsonl"))


def test_tokenize_example_teacher_forcing(cfg, tok):
    ti, to, m = tokenize_example(cfg, tok, "hello world", "en")
    assert len(ti) == len(to) == len(m)
    np.testing.assert_array_equal(ti[1:], to[:-1])
    assert to[-1] == cfg.eot
    sot_len = len(cfg.sot_sequence("en", "transcribe", timestamps=False))
    assert m.sum() == len(to) - (sot_len - 1)
    assert (m[: sot_len - 1] == 0).all()


def test_truncated_example_keeps_eot_target(tmp_path, cfg, tok):
    long_text = " ".join(f"w{i}" for i in range(200))
    man = _write_manifest(tmp_path, [(1.0, long_text)])
    pipe = DataPipeline(man, cfg, tok, batch_size=1, max_text_tokens=32)
    _, ti, to, m = pipe._load_example(pipe.entries[0])
    assert len(ti) == len(to) == len(m) == 32
    assert to[-1] == cfg.eot
    assert m[-1] == 1.0


def test_bucketing_static_shapes(tmp_path, cfg, tok):
    man = _write_manifest(
        tmp_path, [(2.0, "a b"), (3.0, "c d e"), (12.0, "f g"), (2.5, "h i j k"), (2.2, "l")])
    pipe = DataPipeline(man, cfg, tok, batch_size=2, seed=1)
    shapes, total = set(), 0
    for batch in pipe.epochs(1):
        b, nb = batch["audio"].shape
        assert nb in (8 * SR, 16 * SR, 30 * SR)
        assert batch["tokens_in"].shape == batch["tokens_out"].shape == batch["mask"].shape
        assert _token_bucket(batch["tokens_in"].shape[1]) == batch["tokens_in"].shape[1]
        shapes.add((nb, batch["tokens_in"].shape[1]))
        total += b
    assert total == 5
    assert any(nb == 8 * SR for nb, _ in shapes)
    assert any(nb == 16 * SR for nb, _ in shapes)


def test_epoch_shuffling_deterministic(tmp_path, cfg, tok):
    man = _write_manifest(tmp_path, [(1.0, f"t {i}") for i in range(6)])
    b1 = [b["tokens_in"].tobytes() for b in DataPipeline(man, cfg, tok, 3, seed=7).epochs(2)]
    b2 = [b["tokens_in"].tobytes() for b in DataPipeline(man, cfg, tok, 3, seed=7).epochs(2)]
    assert b1 == b2
    b3 = [b["tokens_in"].tobytes() for b in DataPipeline(man, cfg, tok, 3, seed=8).epochs(2)]
    assert b1 != b3


def test_prefetch_surfaces_worker_errors(cfg, tok, tmp_path):
    pipe = DataPipeline([ManifestEntry(wav=str(tmp_path / "missing.wav"), text="x")],
                        cfg, tok, batch_size=1)
    with pytest.raises(Exception):
        list(pipe.epochs(1))


def test_audio_bucket_edges():
    assert _audio_bucket(1) == 8 * SR
    assert _audio_bucket(8 * SR) == 8 * SR
    assert _audio_bucket(8 * SR + 1) == 16 * SR
    assert _audio_bucket(40 * SR) == 30 * SR


_SPECS = [(2.0, "a b"), (3.0, "c d e"), (12.0, "f g"), (2.5, "h i j k"), (2.2, "l"),
          (1.0, "w1 w2 w3"), (7.9, "m n"), (9.0, " ".join(f"w{i}" for i in range(40)))]


@pytest.mark.parametrize("batch_size,seed,drop_last", [(2, 0, False), (3, 5, True), (1, 2, False)])
def test_batches_equal_jax_pipeline(tmp_path, cfg, tok, batch_size, seed, drop_last):
    """Same manifest and seed: the same batches, bit for bit, two epochs."""
    man = _write_manifest(tmp_path, _SPECS)
    ours = list(DataPipeline(man, cfg, tok, batch_size=batch_size, seed=seed,
                             drop_last=drop_last).epochs(2))
    jcfg = JW.get_config("tiny")
    theirs = list(JaxPipeline(man, jcfg, JaxMockTokenizer(jcfg), batch_size=batch_size,
                              seed=seed, drop_last=drop_last).epochs(2))
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k


def _assert_logmel_close(ours: np.ndarray, golden: np.ndarray):
    """K1's tolerance (tests/test_torch_logmel.py, tests/test_logmel.py)."""
    diff = np.abs(ours - golden)
    hot = golden > 0.3
    assert hot.any()
    assert diff[hot].max() < 2e-2, f"hot-bin max diff {diff[hot].max()}"
    assert diff.mean() < 3e-3, f"mean diff {diff.mean()}"
    assert diff.max() < 0.5, f"overall max diff {diff.max()}"


def test_prepare_batch_matches_jax(tmp_path, cfg, tok):
    """(B, T/160, n_mels) mel within K1's tolerance of the JAX package's
    prepare_batch; tokens int64 and the mask f32, equal to the host batch."""
    man = _write_manifest(tmp_path, [(1.0, "x y"), (1.2, "z w")])
    batch = next(iter(DataPipeline(man, cfg, tok, batch_size=2, seed=0).epochs(1)))
    dev = prepare_batch(batch, cfg, device="cpu")
    assert dev["mel"].shape == (2, 8 * SR // 160, cfg.n_mels) and dev["mel"].dtype == torch.float32
    assert dev["tokens_in"].dtype == dev["tokens_out"].dtype == torch.int64
    for k in ("tokens_in", "tokens_out", "mask"):
        np.testing.assert_array_equal(dev[k].numpy(), batch[k])
    jdev = jax_prepare_batch(batch, JW.get_config("tiny"))
    for row in range(2):
        _assert_logmel_close(dev["mel"][row].numpy(), np.asarray(jdev["mel"][row]))


def test_prepare_batch_rows_are_the_single_window_logmel(tmp_path, cfg, tok):
    """Each row is ``log_mel_spectrogram`` of that row alone (its own clamp
    to its max − 8 decades), as the JAX package's per-row stack."""
    from realtime_whisper_asr_tpu_torch.ops.logmel import log_mel_spectrogram

    man = _write_manifest(tmp_path, [(1.0, "x y"), (3.0, "z w")])
    batch = next(iter(DataPipeline(man, cfg, tok, batch_size=2, seed=0).epochs(1)))
    dev = prepare_batch(batch, cfg, device="cpu")
    for row in range(2):
        ref = log_mel_spectrogram(torch.from_numpy(batch["audio"][row].copy()), cfg.n_mels)
        assert torch.equal(dev["mel"][row], ref)
