"""Word-level timestamps from cross-attention DTW.

Replaces faster-whisper's ``word_timestamps=True`` machinery (the reference
relies on it for the online protocol's word stream, `asr_components.py:275,
291-297`): during decoding the model captures alignment-head-averaged
cross-attention over audio frames (model.decode_step ``alignment_mask``);
here we run dynamic time warping on the host (cheap O(T·F) numpy) to map each
sampled token to an audio frame, then group tokens into words.

Frame rate: one encoder frame = 0.02 s (2 mel hops).
"""

from __future__ import annotations

import numpy as np

SECONDS_PER_FRAME = 0.02


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis (odd width), edge-padded."""
    if width <= 1:
        return x
    if x.ndim == 2:
        import ctypes

        from realtime_whisper_asr_tpu_torch.native import get_lib

        lib = get_lib()
        if lib is not None:
            c = np.ascontiguousarray(x, np.float64)
            out = np.empty_like(c)
            lib.rtwa_median_filter(
                c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                c.shape[0], c.shape[1], width,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
            return out
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through cost (N_tokens, N_frames); returns (token_idx, frame_idx).

    Uses the C kernel (native/dtw.c, ~500× faster than the Python DP — this
    runs on every transcription window) with a pure-Python fallback."""
    import ctypes

    from realtime_whisper_asr_tpu_torch.native import get_lib

    lib = get_lib()
    n, m = cost.shape
    if lib is not None and n > 0 and m > 0:
        c = np.ascontiguousarray(cost, np.float64)
        ti = np.empty(n + m, np.int32)
        fj = np.empty(n + m, np.int32)
        k = lib.rtwa_dtw(
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, m,
            ti.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            fj.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if k >= 0:
            return ti[:k].copy(), fj[:k].copy()
    return _dtw_path_py(cost)


def _dtw_path_py(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pure-Python DP (fallback + parity oracle for the C kernel)."""
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf, dtype=np.float64)
    acc[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), dtype=np.int8)
    for i in range(1, n + 1):
        row_cost = cost[i - 1]
        for j in range(1, m + 1):
            c0 = acc[i - 1, j - 1]  # diagonal
            c1 = acc[i - 1, j]  # token advance
            c2 = acc[i, j - 1]  # frame advance
            if c0 <= c1 and c0 <= c2:
                acc[i, j] = c0 + row_cost[j - 1]
                trace[i, j] = 0
            elif c1 <= c2:
                acc[i, j] = c1 + row_cost[j - 1]
                trace[i, j] = 1
            else:
                acc[i, j] = c2 + row_cost[j - 1]
                trace[i, j] = 2
    i, j = n, m
    ti, fj = [], []
    while i > 0 and j > 0:
        ti.append(i - 1)
        fj.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(ti[::-1]), np.array(fj[::-1])


def token_times(
    xattn: np.ndarray,  # (n_tokens, n_audio_ctx) alignment-averaged weights
    n_frames: int,  # valid encoder frames (audio_seconds / 0.02)
    time_offset: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-token (start, end) seconds via DTW over -log attention."""
    n_tokens = xattn.shape[0]
    if n_tokens == 0:
        return np.zeros(0), np.zeros(0)
    w = xattn[:, : max(n_frames, 2)].astype(np.float64)
    # normalize per token, smooth across time
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-9)
    w = median_filter(w, 7)
    # standardize per token so DTW cost is scale-free
    mu = w.mean(-1, keepdims=True)
    sd = w.std(-1, keepdims=True) + 1e-9
    cost = -(w - mu) / sd
    ti, fj = dtw_path(cost)
    starts = np.zeros(n_tokens)
    ends = np.zeros(n_tokens)
    for t in range(n_tokens):
        frames = fj[ti == t]
        if frames.size == 0:
            frames = np.array([0])
        starts[t] = frames[0] * SECONDS_PER_FRAME
        ends[t] = (frames[-1] + 1) * SECONDS_PER_FRAME
    return starts + time_offset, ends + time_offset


def word_timestamps(
    token_ids: list[int],
    xattn: np.ndarray,  # (n_sampled, n_audio_ctx), rows aligned with token_ids
    tokenizer,
    n_frames: int,
    time_offset: float = 0.0,
    return_token_counts: bool = False,
    language: str | None = None,
):
    """[(begin_s, end_s, word_text)] — the L3→L5 word stream of the online
    protocol. With ``return_token_counts``, also returns tokens-per-word so
    callers slicing by segment token counts stay aligned for multi-token words.
    ``language`` selects space vs unicode word grouping (tokenizer.split_words)."""
    words, word_tokens = tokenizer.split_to_word_tokens(token_ids, language=language)
    if not words:
        return ([], []) if return_token_counts else []
    # xattn rows correspond to token_ids positions; build text-token row index
    text_rows = [i for i, t in enumerate(token_ids) if t < tokenizer.cfg.eot]
    starts, ends = token_times(xattn[text_rows], n_frames, time_offset)
    out = []
    row = 0
    for word, toks in zip(words, word_tokens):
        n = len(toks)
        if n == 0 or row + n > len(starts):
            break
        out.append((float(starts[row]), float(ends[row + n - 1]), word))
        row += n
    # enforce monotonic non-overlapping times
    for i in range(1, len(out)):
        b, e, wtext = out[i]
        pb, pe, _ = out[i - 1]
        if b < pe:
            out[i] = (pe, max(e, pe), wtext)
    if return_token_counts:
        return out, [len(t) for t in word_tokens[: len(out)]]
    return out
