"""ctypes bindings for the native host ops (native/godsp_native.cpp).

The C++ source is the port's own copy of godsp_tpu's (same C ABI),
kept beside this module and outside csrc/ (which holds the CUDA
sources that ops/_build.py hashes and compiles).  It compiles with g++
at first use into the port's git-ignored _build/ directory, keyed by a
hash of the source — never beside the source.  Every entry point keeps the same
pure-numpy fallback as godsp_tpu/native/__init__.py, so the package
works without a toolchain; `available()` says which is active.  These
ops feed the host side only (WAV decode, stream buffering).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import threading

import numpy as np

__all__ = [
    "available",
    "decode_u8",
    "decode_i16",
    "StreamBuffer",
]

log = logging.getLogger("godsp_tpu_torch.native")

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = pathlib.Path(__file__).resolve().parent / "godsp_native.cpp"
_BUILD = _PKG / "_build"

_lock = threading.Lock()
_lib = None
_tried = False


def _build(so: pathlib.Path) -> bool:
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        _BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", str(tmp), str(_SRC)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so)  # atomic: safe when two processes build at once
        return True
    except (OSError, subprocess.SubprocessError) as e:  # no toolchain / read-only tree
        log.info("native build unavailable, using numpy fallbacks: %s", e)
        tmp.unlink(missing_ok=True)
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            log.info("native source %s missing, using numpy fallbacks", _SRC)
            return None
        key = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        so = _BUILD / f"libgodsp_native_{key}.so"
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            log.info("native load failed, using numpy fallbacks: %s", e)
            return None
        c_i64, c_p = ctypes.c_int64, ctypes.c_void_p
        lib.gdsp_decode_u8.argtypes = [c_p, c_p, c_i64]
        lib.gdsp_decode_u8.restype = None
        lib.gdsp_decode_i16.argtypes = [c_p, c_p, c_i64]
        lib.gdsp_decode_i16.restype = None
        lib.gdsp_sbuf_new.argtypes = [c_i64]
        lib.gdsp_sbuf_new.restype = c_p
        lib.gdsp_sbuf_free.argtypes = [c_p]
        lib.gdsp_sbuf_free.restype = None
        lib.gdsp_sbuf_size.argtypes = [c_p]
        lib.gdsp_sbuf_size.restype = c_i64
        lib.gdsp_sbuf_push.argtypes = [c_p, c_p, c_i64]
        lib.gdsp_sbuf_push.restype = ctypes.c_int
        lib.gdsp_sbuf_peek.argtypes = [c_p, c_p, c_i64]
        lib.gdsp_sbuf_peek.restype = c_i64
        lib.gdsp_sbuf_consume.argtypes = [c_p, c_i64]
        lib.gdsp_sbuf_consume.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the compiled native library is in use."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def decode_u8(data: np.ndarray) -> np.ndarray:
    """uint8 -> float32 v/255 in [0, 1] (wav.go:147-150 quirk parity)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return data.astype(np.float32) / 255.0
    out = np.empty(data.shape, dtype=np.float32)
    lib.gdsp_decode_u8(_ptr(data), _ptr(out), data.size)
    return out


def decode_i16(data: np.ndarray) -> np.ndarray:
    """int16 -> float32 (v+32768)/65535 in [0, 1] (wav.go:151-155)."""
    data = np.ascontiguousarray(data, dtype=np.int16)
    lib = _load()
    if lib is None:
        return (data.astype(np.float32) + 32768.0) / 65535.0
    out = np.empty(data.shape, dtype=np.float32)
    lib.gdsp_decode_i16(_ptr(data), _ptr(out), data.size)
    return out


class StreamBuffer:
    """Growable FIFO of samples (native byte ring with compaction; numpy
    fallback).  Backs StreamingPwelch's chunk assembly: push blocks, peek
    chunk+halo, consume chunk.  Lengths are in samples of the dtype."""

    def __init__(self, capacity: int = 1 << 20, dtype=np.float64):
        self._dt = np.dtype(dtype)
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.gdsp_sbuf_new(int(capacity) * self._dt.itemsize)
            if not self._h:
                raise MemoryError("gdsp_sbuf_new failed")
        else:
            self._buf = np.zeros(0, dtype=self._dt)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.gdsp_sbuf_free(self._h)
            self._h = None

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.gdsp_sbuf_size(self._h)) // self._dt.itemsize
        return self._buf.shape[0]

    def push(self, samples: np.ndarray) -> None:
        samples = np.ascontiguousarray(samples, dtype=self._dt).reshape(-1)
        if self._lib is not None:
            if self._lib.gdsp_sbuf_push(self._h, _ptr(samples), samples.nbytes):
                raise MemoryError("gdsp_sbuf_push failed")
        else:
            self._buf = np.concatenate([self._buf, samples])

    def peek(self, n: int) -> np.ndarray:
        """First min(n, len) buffered samples, without consuming."""
        if self._lib is not None:
            out = np.empty(n, dtype=self._dt)
            m = int(self._lib.gdsp_sbuf_peek(self._h, _ptr(out), out.nbytes))
            return out[: m // self._dt.itemsize]
        return self._buf[:n].copy()

    def consume(self, n: int) -> None:
        if self._lib is not None:
            self._lib.gdsp_sbuf_consume(self._h, int(n) * self._dt.itemsize)
        else:
            self._buf = self._buf[n:]
