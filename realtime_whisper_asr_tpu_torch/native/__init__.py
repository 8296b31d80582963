"""Native (C) host-side kernels, built on demand and loaded via ctypes.

The card does the model math; these cover host hot loops where pure Python is
too slow on the streaming path (DTW alignment, median filtering). The build is
lazy and lands in the package's gitignored build directory; every consumer has
a pure-Python fallback, so a missing C compiler degrades gracefully.
"""

from realtime_whisper_asr_tpu_torch.native.build import get_lib
