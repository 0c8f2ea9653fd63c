"""ctypes bindings for the native (C++) dataset parsers.

Counterpart of ``n_body_problem_tpu.io.native``, built from this package's
own copy of the source (``native/nbody_io.cpp`` and its ``Makefile``). The
shared library is built there with ``make`` (``g++``) on first use and
cached; every entry point degrades to ``None`` (callers fall back to the
numpy parsers) if the toolchain or library is unavailable, so the package
never hard-requires the native path. Set ``NBODY_NO_NATIVE=1`` to force the
pure-Python parsers (used by tests to compare both implementations). The
build holds an exclusive ``flock`` on the source, so processes that start
together do not write the library over each other.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import subprocess
import threading

import numpy as np

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
SOURCE = NATIVE_DIR / "nbody_io.cpp"
LIB_PATH = NATIVE_DIR / "libnbody_io.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _stale() -> bool:
    return not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime


def _build() -> None:
    with open(SOURCE, "rb") as f:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        if _stale():  # another process may have built it while we waited
            subprocess.run(["make", "-s", "-C", str(NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    if os.environ.get("NBODY_NO_NATIVE"):
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if _stale():
                _build()
            lib = ctypes.CDLL(str(LIB_PATH))
            lib.nb_parse_table.restype = ctypes.c_long
            lib.nb_parse_table.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_long,
            ]
            lib.nb_parse_tokens.restype = ctypes.c_long
            lib.nb_parse_tokens.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ]
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def parse_table(
    path: str | pathlib.Path, n_cols: int, *, skip_blank: bool = True
) -> np.ndarray | None:
    """(rows, n_cols) f32 array, or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    p = str(path).encode()
    rows = lib.nb_parse_table(p, n_cols, int(skip_blank), None, 0)
    if rows < 0:
        raise OSError(f"native parser failed on {path} (code {rows})")
    out = np.empty((rows, n_cols), dtype=np.float32)
    got = lib.nb_parse_table(
        p, n_cols, int(skip_blank), out.ctypes.data_as(ctypes.c_void_p), rows
    )
    if got != rows:
        raise OSError(f"native parser inconsistent row count on {path}: {got} != {rows}")
    return out


def parse_tokens(
    path: str | pathlib.Path, skip_lines: int
) -> np.ndarray | None:
    """All whitespace-separated floats after ``skip_lines``, or None."""
    lib = _load()
    if lib is None:
        return None
    p = str(path).encode()
    count = lib.nb_parse_tokens(p, skip_lines, None, 0)
    if count < 0:
        raise OSError(f"native token parser failed on {path} (code {count})")
    out = np.empty(count, dtype=np.float64)
    got = lib.nb_parse_tokens(p, skip_lines, out.ctypes.data_as(ctypes.c_void_p), count)
    if got != count:
        raise OSError(f"native token parser inconsistent count on {path}")
    return out
