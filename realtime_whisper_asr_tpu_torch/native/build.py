"""Build-on-first-use for the port's shared libraries, and the DTW loader.

Both native libraries of the port — the host DTW/median kernels (``dtw.c``,
built with ``cc``) and the CUDA kernels under ``csrc/`` (built with ``nvcc``)
— are compiled at first use into ``BUILD_DIR``, which ``.gitignore`` lists,
and loaded with ``ctypes``. A file lock serialises concurrent builders (test
workers, several processes on one machine); the library is written to a
temporary name and renamed into place, so a reader never sees half a file.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dtw.c")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


class BuildError(RuntimeError):
    """A compiler run failed; the message carries its output."""


def build_library(name: str, sources: list[str], compile_cmd) -> str:
    """Path of ``BUILD_DIR/name``, compiling it first when it is missing or
    older than any of ``sources``. ``compile_cmd(out_path)`` returns the
    compiler's argv writing to ``out_path``; the compiler's output is kept in
    ``BUILD_DIR/name.log``. Raises ``BuildError`` when the build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, name)
    newest = max(os.path.getmtime(s) for s in sources)
    with open(os.path.join(BUILD_DIR, name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out) and os.path.getmtime(out) >= newest:
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = compile_cmd(tmp)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise BuildError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                                 f"{proc.stdout}{proc.stderr}")
            with open(out + ".log", "w") as log:
                log.write(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def _build() -> str | None:
    cc = os.environ.get("CC", "cc")
    try:
        return build_library(
            "librtwa_native.so", [_SRC],
            lambda out: [cc, "-O3", "-shared", "-fPIC", _SRC, "-o", out],
        )
    except (OSError, subprocess.SubprocessError, BuildError) as e:
        logger.warning("native build failed (%s); using Python fallbacks", e)
        return None


def get_lib() -> ctypes.CDLL | None:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.rtwa_dtw.restype = ctypes.c_int64
            lib.rtwa_dtw.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ]
            lib.rtwa_median_filter.restype = None
            lib.rtwa_median_filter.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ]
            _lib = lib
        except OSError as e:
            logger.warning("failed to load native lib: %s", e)
        return _lib
