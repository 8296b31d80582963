"""Training data pipeline: wav+text manifest → bucketed mel/token batches.

Port of ``realtime_whisper_asr_tpu/train/data.py``: the host half (manifest,
buckets, tokenization, prefetching, seeded shuffle) is the JAX package's
numpy code over the port's ``io`` and tokenizer, so both packages give the
same batches bit for bit; ``prepare_batch`` is the device half in torch.

The reference has no training path; this feeds train_step.py from a
standard ASR manifest — a JSONL file where each line is ``{"wav": path,
"text": str, "language"?: str}`` — with the static-shape discipline the rest
of the system uses:

- **duration buckets**: audio is padded to one of a few fixed lengths
  (default 8/16/30 s), the encoder's window buckets;
- **token buckets**: target sequences pad to fixed lengths the same way;
- batches are grouped by (duration bucket, token bucket) so every batch is a
  single static shape;
- a background thread prefetches + tokenizes ahead of the card (bounded
  queue), the host/device overlap the reference gets from CTranslate2's
  internal loader threads (`asr_components.py:250-261`);
- deterministic shuffling from a seed, stable across resume (epoch index is
  folded into the shuffle key).

Mel is computed ON THE CARD by ``prepare_batch``: the log-mel kernel (K1,
``ops.logmel``) once per row, keeping the host loop at file-read + tokenize
only.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)

SR = 16000

#: audio bucket lengths (seconds) — mirror asr.TorchWhisperASR.WINDOW_BUCKETS_S
AUDIO_BUCKETS_S = (8.0, 16.0, 30.0)
#: token sequence buckets (tokens_in length)
TOKEN_BUCKETS = (32, 64, 128, 256, 448)


@dataclass
class ManifestEntry:
    wav: str
    text: str
    language: Optional[str] = None
    duration_s: Optional[float] = None


def read_manifest(path: str) -> list[ManifestEntry]:
    """JSONL manifest: one ``{"wav": ..., "text": ...}`` object per line."""
    out = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                out.append(ManifestEntry(
                    wav=obj["wav"], text=obj["text"],
                    language=obj.get("language"), duration_s=obj.get("duration_s"),
                ))
            except (json.JSONDecodeError, KeyError) as e:
                raise ValueError(f"{path}:{i + 1}: bad manifest line: {e}") from e
    if not out:
        raise ValueError(f"{path}: empty manifest")
    return out


def _audio_bucket(n_samples: int) -> int:
    for s in AUDIO_BUCKETS_S:
        nb = int(s * SR)
        if n_samples <= nb:
            return nb
    return int(AUDIO_BUCKETS_S[-1] * SR)


def _token_bucket(n: int) -> int:
    for b in TOKEN_BUCKETS:
        if n <= b:
            return b
    return TOKEN_BUCKETS[-1]


def tokenize_example(cfg, tokenizer, text: str, language: Optional[str],
                     task: str = "transcribe"):
    """Build (tokens_in, tokens_out, mask) numpy arrays (unpadded).

    Whisper teacher forcing: sequence = sot_seq + text_ids + [eot];
    tokens_in = seq[:-1], tokens_out = seq[1:]. The mask counts only
    transcript + EOT predictions (the model is not trained to predict its own
    conditioning prefix).
    """
    sot_seq = list(cfg.sot_sequence(language or "en", task, timestamps=False))
    ids = tokenizer.encode(text)
    seq = sot_seq + list(ids) + [cfg.eot]
    tokens_in = np.asarray(seq[:-1], np.int32)
    tokens_out = np.asarray(seq[1:], np.int32)
    mask = np.zeros(len(tokens_out), np.float32)
    mask[len(sot_seq) - 1 :] = 1.0  # position predicting the first text token onward
    return tokens_in, tokens_out, mask


@dataclass
class DataPipeline:
    """Bucketed, prefetching batch iterator over a manifest.

    Usage::

        pipe = DataPipeline(manifest_path, cfg, tokenizer, batch_size=8)
        for batch in pipe.epochs(2):          # host-side numpy batches
            batch = prepare_batch(batch, cfg) # card: audio -> mel, tokens
            state, loss = train_step(state, batch)
    """

    manifest: str | list[ManifestEntry]
    cfg: object  # WhisperConfig
    tokenizer: object
    batch_size: int = 8
    task: str = "transcribe"
    seed: int = 0
    drop_last: bool = False
    max_text_tokens: int = TOKEN_BUCKETS[-1]
    prefetch: int = 4
    entries: list[ManifestEntry] = field(init=False)

    def __post_init__(self):
        self.entries = (
            read_manifest(self.manifest) if isinstance(self.manifest, str)
            else list(self.manifest)
        )

    # ------------------------------------------------------------- example IO

    def _load_example(self, e: ManifestEntry):
        from realtime_whisper_asr_tpu_torch.io import read_wav

        audio = read_wav(e.wav)
        nb = _audio_bucket(len(audio))
        padded = np.zeros(nb, np.float32)
        padded[: min(len(audio), nb)] = audio[:nb]
        ti, to, m = tokenize_example(self.cfg, self.tokenizer, e.text, e.language, self.task)
        if len(ti) > self.max_text_tokens:
            # Truncate over-budget examples but keep an EOT target at the cut:
            # chopping mid-sequence would drop the stop-token supervision and
            # bias fine-tuning toward non-termination on long utterances.
            ti, to, m = ti[: self.max_text_tokens], to[: self.max_text_tokens], m[: self.max_text_tokens]
            to = np.asarray(to).copy()
            m = np.asarray(m).copy()
            to[-1] = self.cfg.eot
            m[-1] = 1.0
        return padded, ti, to, m

    # --------------------------------------------------------------- batching

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(len(self.entries))

    def _iter_batches(self, epoch: int) -> Iterator[dict]:
        """Group examples by (audio bucket, token bucket); emit full groups as
        they fill so memory stays bounded; flush remainders at epoch end."""
        groups: dict[tuple[int, int], list] = {}
        for idx in self._epoch_order(epoch):
            ex = self._load_example(self.entries[idx])
            key = (len(ex[0]), _token_bucket(len(ex[1])))
            groups.setdefault(key, []).append(ex)
            if len(groups[key]) == self.batch_size:
                yield self._pack(groups.pop(key), key)
        if not self.drop_last:
            for key, g in groups.items():
                yield self._pack(g, key)

    def _pack(self, examples: list, key: tuple[int, int]) -> dict:
        nb, tb = key
        b = len(examples)
        audio = np.zeros((b, nb), np.float32)
        tokens_in = np.full((b, tb), self.cfg.eot, np.int32)
        tokens_out = np.full((b, tb), self.cfg.eot, np.int32)
        mask = np.zeros((b, tb), np.float32)
        for i, (a, ti, to, m) in enumerate(examples):
            audio[i] = a
            tokens_in[i, : len(ti)] = ti
            tokens_out[i, : len(to)] = to
            mask[i, : len(m)] = m
        return {"audio": audio, "tokens_in": tokens_in, "tokens_out": tokens_out,
                "mask": mask}

    # ------------------------------------------------------------ public APIs

    def epochs(self, n_epochs: int = 1) -> Iterator[dict]:
        """Prefetching iterator: a daemon thread loads/tokenizes ahead while
        the consumer (usually the accelerator step) runs."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()
        errors: list[BaseException] = []

        def worker():
            try:
                for ep in range(n_epochs):
                    for batch in self._iter_batches(ep):
                        q.put(batch)
            except BaseException as e:  # surfaced on the consumer side
                errors.append(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=worker, daemon=True, name="data-prefetch")
        t.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        t.join(timeout=5)
        if errors:
            raise errors[0]


def prepare_batch(batch: dict, cfg, device="cuda", shard_fn=None) -> dict:
    """Device half: each row's audio → its log-mel on ``device`` (the card
    unless asked otherwise; raises without CUDA), stacked to (B, T/160,
    n_mels) f32; tokens as int64 and the mask as f32 on ``device``.

    ``ops.logmel.log_mel_spectrogram`` on a CUDA row launches the kernel
    (K1): one launch per row. On a CPU row it runs the plain version.

    ``shard_fn`` (``parallel.sharding.data_sharding(mesh)``) first takes
    this data rank's rows of the host batch: a rank computes the log-mel of
    its own rows only, which equal the whole batch's (log-mel is per row)."""
    import torch

    from realtime_whisper_asr_tpu_torch.device import resolve_device
    from realtime_whisper_asr_tpu_torch.ops.logmel import log_mel_spectrogram

    dev = resolve_device(device)
    if shard_fn is not None:
        batch = shard_fn(batch)
    audio = torch.from_numpy(np.ascontiguousarray(batch["audio"], np.float32)).to(dev)
    out = {k: torch.from_numpy(np.asarray(batch[k])).to(dev, torch.int64)
           for k in ("tokens_in", "tokens_out")}
    out["mask"] = torch.from_numpy(np.asarray(batch["mask"], np.float32)).to(dev)
    out["mel"] = torch.stack([log_mel_spectrogram(row, n_mels=cfg.n_mels) for row in audio])
    return out
