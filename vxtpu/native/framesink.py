"""ctypes binding for the native async frame sink (native/framesink.cpp):
a C++ worker pool that PNG-encodes and writes frames off the Python render
loop — the runtime-native rebuild of the reference's per-frame present/blit
tail (SURVEY.md §4.2), where disk IO replaces the window on a headless
host. Built on first use with g++ (same pattern as vxtpu/native/oracle.py;
pybind11 is not in this image).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "framesink.cpp")
_LIB = None
_LIB_ERR: str | None = None


def _build_lib() -> str:
    out = os.path.join(_REPO, "native", "_build", "libvxframesink.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(_SRC):
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler on PATH")
    tmp = out + ".tmp.so"
    subprocess.run(
        [cxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
         "-o", tmp, _SRC],
        check=True, capture_output=True, text=True,
    )
    os.replace(tmp, out)
    return out


def _get_lib():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(_build_lib())
        lib.fs_create.restype = ctypes.c_void_p
        lib.fs_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.fs_submit.restype = None
        lib.fs_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_uint8)]
        lib.fs_flush.restype = ctypes.c_long
        lib.fs_flush.argtypes = [ctypes.c_void_p]
        lib.fs_destroy.restype = None
        lib.fs_destroy.argtypes = [ctypes.c_void_p]
        lib.fs_write_png.restype = ctypes.c_int
        lib.fs_write_png.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_uint8)]
        _LIB = lib
    except Exception as e:
        _LIB_ERR = str(e)
    return _LIB


def framesink_available() -> bool:
    return _get_lib() is not None


def _to_rgb8(img) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    assert a.ndim == 3 and a.shape[2] == 3, a.shape
    return np.ascontiguousarray(a)


class FrameSink:
    """Async PNG writer. submit() copies the frame into the native queue and
    returns immediately (bounded backpressure); flush() blocks until every
    frame is on disk and returns the failed-write count (0 = clean)."""

    def __init__(self, workers: int = 2, max_queue: int = 8):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native framesink unavailable: {_LIB_ERR}")
        self._lib = lib
        self._h = lib.fs_create(workers, max_queue)

    def submit(self, path: str, img) -> None:
        a = _to_rgb8(img)
        h, w = a.shape[:2]
        self._lib.fs_submit(self._h, path.encode(), w, h,
                            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))

    def flush(self) -> int:
        return int(self._lib.fs_flush(self._h))

    def close(self) -> None:
        if self._h is not None:
            self._lib.fs_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
        self.close()


def write_png(path: str, img) -> None:
    """Synchronous native PNG write (single frame, no pool)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native framesink unavailable: {_LIB_ERR}")
    a = _to_rgb8(img)
    h, w = a.shape[:2]
    ok = lib.fs_write_png(path.encode(), w, h,
                          a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if not ok:
        raise IOError(f"native png write failed: {path}")
