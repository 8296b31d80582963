"""Known-noise log suppression (reference FilteredLogFile, 一键…py:1970-1981).

Port of ``realtime_whisper_asr_tpu/utils/log_filter.py``. The reference
wraps stderr to hide whisper_streaming's noisy internals; here the
equivalent is a logging filter dropping known-benign records from console
output while file logs keep everything. The port's noise is PyTorch's
warnings (routed into logging by ``install``): the notice that a read-only
numpy array became a tensor, and the deprecation of ``TypedStorage``.
"""

from __future__ import annotations

import logging

_NOISE_SUBSTRINGS = (
    "The given NumPy array is not writable",
    "TypedStorage is deprecated",
)


class KnownNoiseFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        msg = record.getMessage()
        return not any(s in msg for s in _NOISE_SUBSTRINGS)


def install(logger_names: tuple[str, ...] = ("py.warnings",)) -> None:
    """Filter the named loggers; Python warnings go to ``py.warnings``."""
    logging.captureWarnings(True)
    for name in logger_names:
        logging.getLogger(name).addFilter(KnownNoiseFilter())
