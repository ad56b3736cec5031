"""ctypes binding for the native C++ DDA oracle (native/dda_oracle.cpp) —
the algorithm-faithful CPU reimplementation of the reference's OpenCL march
(SURVEY.md §5 "optional deeper oracle"). pybind11 is not in this image, so
the library is a plain ``extern "C"`` shared object compiled on first use
with g++ and cached next to the source (keyed by source mtime).

Use: tests cross-check kernel_ref (the JAX oracle) against this independent
implementation, closing the loop "fast paths == JAX oracle == reference
algorithm". It is NOT a runtime render path — device compute stays in
XLA/Pallas; native code here plays the same role the reference's
Software_Caster played for its OpenCL kernel (SURVEY.md §3 C6).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "dda_oracle.cpp")
_LIB = None
_LIB_ERR: str | None = None


def _build_lib() -> str:
    out = os.path.join(_REPO, "native", "_build", "libvxoracle.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(_SRC):
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler on PATH")
    tmp = out + ".tmp.so"
    subprocess.run(
        [cxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC],
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
        lib.vx_march.restype = None
        lib.vx_march.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),                      # occ
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,      # X,Y,Z
            ctypes.POINTER(ctypes.c_float),                      # o
            ctypes.POINTER(ctypes.c_float),                      # d
            ctypes.POINTER(ctypes.c_float),                      # t_max
            ctypes.c_int64,                                      # n
            ctypes.c_int32,                                      # max_steps
            ctypes.POINTER(ctypes.c_uint8),                      # hit
            ctypes.POINTER(ctypes.c_float),                      # t
            ctypes.POINTER(ctypes.c_int32),                      # voxel
            ctypes.POINTER(ctypes.c_float),                      # normal
            ctypes.POINTER(ctypes.c_int32),                      # steps
        ]
        _LIB = lib
    except Exception as e:  # compiler missing, build failure, ...
        _LIB_ERR = str(e)
    return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def march_native(o, d, occ, dims: tuple[int, int, int], max_steps: int,
                 t_max=None):
    """March rays with the native oracle. Inputs are host arrays (or jax
    arrays — converted); returns a dict of numpy arrays mirroring
    HitRecord's fields (hit, t, voxel, normal, steps)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native oracle unavailable: {_LIB_ERR}")
    X, Y, Z = dims
    o = np.ascontiguousarray(np.asarray(o, np.float32))
    d = np.ascontiguousarray(np.asarray(d, np.float32))
    occ = np.ascontiguousarray(np.asarray(occ, np.uint8).reshape(-1))
    assert occ.size == X * Y * Z, (occ.size, dims)
    n = o.shape[0]
    assert o.shape == (n, 3) and d.shape == (n, 3)
    if t_max is None:
        t_max = np.full((n,), 1.0e30, np.float32)
    t_max = np.ascontiguousarray(np.asarray(t_max, np.float32))

    hit = np.empty((n,), np.uint8)
    t = np.empty((n,), np.float32)
    voxel = np.empty((n, 3), np.int32)
    normal = np.empty((n, 3), np.float32)
    steps = np.empty((n,), np.int32)

    cptr = lambda a, ty: a.ctypes.data_as(ctypes.POINTER(ty))
    lib.vx_march(
        cptr(occ, ctypes.c_uint8), X, Y, Z,
        cptr(o, ctypes.c_float), cptr(d, ctypes.c_float),
        cptr(t_max, ctypes.c_float), n, max_steps,
        cptr(hit, ctypes.c_uint8), cptr(t, ctypes.c_float),
        cptr(voxel, ctypes.c_int32), cptr(normal, ctypes.c_float),
        cptr(steps, ctypes.c_int32),
    )
    return dict(hit=hit.astype(bool), t=t, voxel=voxel, normal=normal,
                steps=steps)
