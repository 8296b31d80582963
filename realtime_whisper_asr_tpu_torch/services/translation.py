"""Background batch translation of recognized text via an HTTP LLM API.

Semantics-parity with the reference TranslationManager
(`translation_manager.py:18-284`):

- ``add_text`` dedups on entry against recent pending/translated texts (:61-85)
- a daemon worker wakes every ``translate_interval`` (default 10 s), merges ALL
  pending texts into one newline-joined request (:204), translates, and emits
  per-line via the output callback (:209-231)
- failed texts piggyback on the next batch exactly once: retry_count 0→1→drop
  (:158-191, :233-246)
- default endpoint: SiliconFlow chat-completions, model Hunyuan-MT-7B, key
  from ``SILICONFLOW_API_KEY`` (:22-27) — but the transport is injectable so
  tests (and offline use) never touch the network.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

MODEL_CONFIG = {
    "url": "https://api.siliconflow.cn/v1/chat/completions",
    "model": "tencent/Hunyuan-MT-7B",
    "api_key_env": "SILICONFLOW_API_KEY",
    "timeout_s": 90,
}

PROMPT_ZH = (
    "你是一个专业的翻译助手。请将以下文本翻译成中文。只输出译文，"
    "不要解释。逐行对应翻译，保持行数一致。"
)

_LANGUAGE_NAMES = {"zh": "Chinese", "en": "English", "ja": "Japanese", "ko": "Korean",
                   "es": "Spanish", "fr": "French", "de": "German", "ru": "Russian"}


def translation_prompt(target_language: str) -> str:
    if target_language == "zh":
        return PROMPT_ZH
    name = _LANGUAGE_NAMES.get(target_language, target_language)
    return (f"You are a professional translator. Translate the following text into {name}. "
            "Output ONLY the translation, one line per input line, no explanations.")


def default_transport(text: str, target_language: str = "zh") -> str:
    """POST to the SiliconFlow chat-completions API. Raises on any failure."""
    import requests  # host-side edge; optional dependency

    api_key = os.environ.get(MODEL_CONFIG["api_key_env"], "")
    if not api_key:
        raise RuntimeError(f"{MODEL_CONFIG['api_key_env']} not set")
    resp = requests.post(
        MODEL_CONFIG["url"],
        headers={"Authorization": f"Bearer {api_key}"},
        json={
            "model": MODEL_CONFIG["model"],
            "messages": [
                {"role": "system", "content": translation_prompt(target_language)},
                {"role": "user", "content": text},
            ],
            "temperature": 0.1,
            "max_tokens": 2000,
        },
        timeout=MODEL_CONFIG["timeout_s"],
    )
    resp.raise_for_status()
    return resp.json()["choices"][0]["message"]["content"]


class TranslationManager:
    def __init__(
        self,
        output_callback: Optional[Callable[[str, str], None]] = None,
        translate_interval: float = 10.0,
        target_language: str = "zh",
        transport: Callable[[str, str], str] = default_transport,
        dedup_window: int = 20,
        clock: Callable[[], float] = time.time,
    ):
        self.output_callback = output_callback
        self.translate_interval = translate_interval
        self.target_language = target_language
        self.transport = transport
        self.clock = clock
        self._pending: list[dict] = []  # {text, retry_count}
        self._recent: list[str] = []
        self._dedup_window = dedup_window
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"added": 0, "deduped": 0, "translated": 0, "failed": 0, "dropped": 0,
                      "requests": 0}

    # ------------------------------------------------------------------ input

    def add_text(self, text: str) -> bool:
        t = text.strip()
        if not t:
            return False
        with self._lock:
            if t in self._recent or any(p["text"] == t for p in self._pending):
                self.stats["deduped"] += 1
                return False
            self._pending.append({"text": t, "retry_count": 0})
            self._recent.append(t)
            if len(self._recent) > self._dedup_window:
                self._recent.pop(0)
            self.stats["added"] += 1
            return True

    # ----------------------------------------------------------------- worker

    def _process_pending(self) -> None:
        with self._lock:
            if not self._pending:
                return
            # items only ever carry retry_count 0 (fresh) or 1 (one piggyback
            # retry); the failure path below drops them before reaching 2
            if self._pending[0].get("solo"):
                # alignment recovery: a misaligned merged request re-queued
                # its items at the FRONT flagged solo — drain them one
                # request each (a single-text request can't misalign). A
                # per-item flag, not a counter: a counter left a stale
                # single-item throttle behind whenever a solo item was
                # DROPPED at the retry cap instead of drained (fresh texts
                # then paid one-interval-each latency for no reason)
                batch = [self._pending.pop(0)]
            else:
                batch, self._pending = self._pending, []
        if not batch:
            return
        merged = "\n".join(item["text"] for item in batch)
        try:
            self.stats["requests"] += 1
            result = self.transport(merged, self.target_language)
        except Exception as e:
            logger.warning("translation request failed: %s", e)
            self.stats["failed"] += 1
            with self._lock:
                for item in batch:
                    item["retry_count"] += 1
                    if item["retry_count"] < 2:
                        self._pending.append(item)  # piggyback once
                    else:
                        self.stats["dropped"] += 1
            return
        lines = [l for l in result.splitlines() if l.strip()]
        if len(lines) != len(batch) and len(batch) > 1:
            # the LLM merged/split lines: positional pairing would deliver the
            # wrong translation for every line after the shift, and the
            # unmatched tail would be silently lost (counted as translated,
            # blocked from re-adding by _recent). Re-queue each item for its
            # OWN single-line request instead — alignment is then trivial.
            logger.warning(
                "batch translation returned %d lines for %d texts; retrying "
                "per-line", len(lines), len(batch)
            )
            self.stats["misaligned"] = self.stats.get("misaligned", 0) + 1
            with self._lock:
                requeued = []
                for item in batch:
                    item["retry_count"] += 1
                    if item["retry_count"] < 2:
                        item["solo"] = True
                        requeued.append(item)
                    else:
                        self.stats["dropped"] += 1
                # FRONT of the queue: fresh texts queued meanwhile must not
                # delay the solo drain, or the leftover retry items get
                # merged into a multi-text request again and a second
                # misalignment silently drops them (the loss this path
                # exists to prevent). Solo items are always a queue prefix.
                self._pending[:0] = requeued
            return
        if len(batch) == 1:
            # a single-text request can't misalign; a multi-line answer is
            # one translation that happens to wrap — deliver it joined
            if not lines:
                with self._lock:
                    batch[0]["retry_count"] += 1
                    if batch[0]["retry_count"] < 2:
                        self._pending.append(batch[0])
                    else:
                        self.stats["dropped"] += 1
                return
            lines = [" ".join(l.strip() for l in lines)]
        self.stats["translated"] += len(lines)
        if self.output_callback:
            originals = [item["text"] for item in batch]
            for i, line in enumerate(lines):
                src = originals[i] if i < len(originals) else ""
                try:
                    self.output_callback(src, line.strip())
                except Exception:
                    logger.exception("translation output callback failed")

    def _worker(self):
        while not self._stop.wait(self.translate_interval):
            self._process_pending()
        self._process_pending()  # final drain

    # ---------------------------------------------------------------- control

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="rtwa-translation")
            self._thread.start()

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def get_stats(self) -> dict:
        with self._lock:
            out = dict(self.stats)
            out["pending"] = len(self._pending)
        return out

    # deterministic single step for tests / non-threaded use
    def process_once(self):
        self._process_pending()
