"""What a run records, from the benchmark's own files.

The program is not edited: the recorder replaces methods of the program's
objects by instance attributes that time and note each call and then call
the original. It notes

- each packet a stream is fed (its due time, its samples, the end of its
  last speech sample) and the samples each stream has handed to its
  processor;
- each request a stream's online processor prepares (the samples handed over
  by then, the time, the window's audio, the prompt, prefix and draft
  tokens), the dispatch that carried it, and the apply of its result (the
  tokens served);
- each dispatch (batched or one window): its host time, its rows, the window
  bucket it encoded, and, when tracing, a profiler range around it and
  around its encode, so the trace's kernels can be charged to it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Optional

import numpy as np

SR = 16000


@dataclasses.dataclass
class Packet:
    stream: int
    due: float
    a: int  # first sample
    b: int  # one past the last sample
    speech_end: int  # one past the packet's last speech sample, -1 if none
    fed: float = 0.0
    counted: bool = False  # due inside the measured window


@dataclasses.dataclass
class Req:
    rid: int
    stream: int
    t_prepare: float
    drained: int
    audio: Optional[np.ndarray]
    dispatch: Optional[int] = None
    prompt: list = dataclasses.field(default_factory=list)
    prefix: list = dataclasses.field(default_factory=list)
    draft: list = dataclasses.field(default_factory=list)
    device_draft: Optional[dict] = None
    t_dispatch: Optional[float] = None
    t_apply: Optional[float] = None
    tokens: Optional[list] = None
    abandoned: bool = False
    multi_window: bool = False
    counted: bool = False  # prepared inside the measured window or its drain


@dataclasses.dataclass
class Dispatch:
    did: int
    kind: str  # "batch" or "window"
    t0: float
    t1: float = 0.0
    rids: list = dataclasses.field(default_factory=list)
    rows_real: int = 0
    rows_encoded: int = 0


@dataclasses.dataclass
class StreamState:
    drained: int = 0
    fifo: collections.deque = dataclasses.field(default_factory=collections.deque)
    undispatched: list = dataclasses.field(default_factory=list)
    last_dispatched: Optional[int] = None


def _next_pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


class Recorder:
    """Notes of one run, each request's window among them (the correctness
    check reads a sample of them). ``trace``: put profiler ranges around
    dispatches and encodes."""

    def __init__(self, clock=time.perf_counter, trace: bool = False):
        self.clock = clock
        self.trace = trace
        self.lock = threading.Lock()
        self.packets: list[Packet] = []
        self.reqs: list[Req] = []
        self.dispatches: list[Dispatch] = []
        self.streams: dict[int, StreamState] = collections.defaultdict(StreamState)
        self.key_to_stream: dict = {}
        self.host_ms: list = []  # one-stream: (fed, host ms a tick outside the ASR)
        self.asr_inside_s = 0.0  # seconds inside the ASR's dispatch / finalize calls
        self._cur: Optional[Dispatch] = None
        self._wrapped: list = []

    # ------------------------------------------------------------ wrapping

    def _wrap(self, obj, name: str, make):
        orig = getattr(obj, name)
        setattr(obj, name, make(orig))
        self._wrapped.append((obj, name))

    def unwrap(self) -> None:
        for obj, name in reversed(self._wrapped):
            try:
                delattr(obj, name)
            except AttributeError:
                pass
        self._wrapped.clear()

    def _range(self, name: str):
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def attach_stream(self, index: int, processor, key) -> None:
        """Record stream ``index``: ``processor`` is what the stream's audio
        is inserted into (a VAC processor or an online one), ``key`` the
        ASR's ring key of the stream (None: the ASR's active stream)."""
        self.key_to_stream[key] = index
        online = getattr(processor, "online", processor)
        st = self.streams[index]

        def insert(orig):
            def call(chunk, *a, **kw):
                out = orig(chunk, *a, **kw)
                st.drained += len(chunk)
                return out
            return call

        def prepare(orig):
            def call(*a, **kw):
                req = orig(*a, **kw)
                with self.lock:
                    r = Req(len(self.reqs), index, self.clock(), st.drained,
                            np.array(req["audio"], np.float32))
                    self.reqs.append(r)
                    st.fifo.append(r.rid)
                    st.undispatched.append(r.rid)
                return req
            return call

        def apply(orig):
            def call(res, *a, **kw):
                with self.lock:
                    while st.fifo:
                        r = self.reqs[st.fifo.popleft()]
                        if r.dispatch is not None:
                            r.t_apply = self.clock()
                            r.tokens = [int(t) for t in getattr(res, "tokens", [])]
                            break
                        r.abandoned = True
                return orig(res, *a, **kw)
            return call

        def init(orig):
            def call(*a, **kw):
                with self.lock:
                    while st.fifo:
                        self.reqs[st.fifo.popleft()].abandoned = True
                    st.undispatched.clear()
                return orig(*a, **kw)
            return call

        self._wrap(processor, "insert_audio_chunk", insert)
        self._wrap(online, "prepare_request", prepare)
        self._wrap(online, "apply_result", apply)
        self._wrap(online, "init", init)

    def _claim(self, key, did: int) -> Optional[Req]:
        """The oldest prepared, not yet dispatched request of ``key``'s
        stream, now carried by dispatch ``did``; a second window of one
        request (input past 30 s) marks that request instead."""
        index = self.key_to_stream.get(key)
        if index is None:
            return None
        st = self.streams[index]
        if not st.undispatched:
            if st.last_dispatched is not None:
                self.reqs[st.last_dispatched].multi_window = True
            return None
        r = self.reqs[st.undispatched.pop(0)]
        r.dispatch, r.t_dispatch = did, self.clock()
        st.last_dispatched = r.rid
        return r

    def attach_asr(self, asr) -> None:
        def batch_dispatch(orig):
            def call(items, *a, **kw):
                with self.lock:
                    d = Dispatch(len(self.dispatches), "batch", self.clock())
                    self.dispatches.append(d)
                    reqs = [self._claim(it["key"], d.did) for it in items]
                d.rows_real = len(items)
                d.rows_encoded = _next_pow2(len(items))
                self._cur = d
                with self._range(f"portbench.dispatch.{d.did}"):
                    st = orig(items, *a, **kw)
                d.t1 = self.clock()
                self.asr_inside_s += d.t1 - d.t0
                for r, q in zip(reqs, st["requests"]):
                    if r is not None:
                        d.rids.append(r.rid)
                        r.prompt = list(q.get("prompt_tokens") or [])
                        r.prefix = list(q.get("prefix_tokens") or [])
                        r.draft = list(q.get("draft_tokens") or [])
                return st
            return call

        def window_dispatch(orig):
            def call(audio, init_prompt, time_offset, prefix_ids=None, draft_ids=None,
                     prompt_ids=None, device_draft=None):
                with self.lock:
                    d = Dispatch(len(self.dispatches), "window", self.clock())
                    self.dispatches.append(d)
                    key = asr._active_stream
                    st_prev = self.streams[self.key_to_stream[key]].last_dispatched \
                        if key in self.key_to_stream else None
                    r = self._claim(key, d.did)
                d.rows_real = d.rows_encoded = 1
                self._cur = d
                with self._range(f"portbench.dispatch.{d.did}"):
                    st = orig(audio, init_prompt, time_offset, prefix_ids, draft_ids,
                              prompt_ids, device_draft)
                d.t1 = self.clock()
                self.asr_inside_s += d.t1 - d.t0
                if r is not None:
                    d.rids.append(r.rid)
                    r.prompt = list(st.get("prompt_ids") or [])
                    r.prefix = list(prefix_ids or [])
                    r.draft = list(draft_ids or [])
                    if device_draft is not None:
                        r.device_draft = {k: device_draft[k] for k in
                                          ("offset", "max_new", "force", "safety")}
                        r.device_draft["prev"] = st_prev
                return st
            return call

        def encode_many(orig):
            def call(keys, n_samples_list):
                d = self._cur
                if d is not None:
                    d.rows_encoded = len(keys)
                name = f"portbench.encode.{d.did if d is not None else -1}"
                with self._range(name):
                    return orig(keys, n_samples_list)
            return call

        def timed(orig):
            def call(*a, **kw):
                t0 = self.clock()
                try:
                    return orig(*a, **kw)
                finally:
                    self.asr_inside_s += self.clock() - t0
            return call

        self._wrap(asr, "transcribe_batch_dispatch", batch_dispatch)
        self._wrap(asr, "_transcribe_window_dispatch", window_dispatch)
        self._wrap(asr, "_encode_many", encode_many)
        self._wrap(asr, "transcribe_batch_finalize", timed)
        self._wrap(asr, "_transcribe_window_finalize", timed)
