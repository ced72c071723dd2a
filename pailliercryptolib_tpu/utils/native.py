"""ctypes bindings for the native host codec (csrc/host_codec.cpp).

Compiled from the committed source on first use with g++ into the package
directory (the library itself is never committed); every consumer
falls back to the pure-numpy codec in ops/limbs.py when the toolchain or
the shared object is unavailable, mirroring the reference's always-available
CPU fallback policy (#ifdef IPCL_USE_QAT, ipcl/mod_exp.cpp:13-16).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "..", "csrc", "host_codec.cpp")
_SO = os.path.join(os.path.dirname(__file__), "..", "csrc", "libhost_codec.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(
                _SRC
            ):
                # build beside the target, then rename: concurrent
                # processes never load a half-written library
                tmp = f"{_SO}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            i64 = ctypes.c_int64
            lib.pack_limbs.argtypes = [u8p, i64, i64, u32p, i64]
            lib.unpack_limbs.argtypes = [u32p, i64, i64, u8p, i64]
            lib.pack_windows.argtypes = [u8p, i64, i64, u32p, i64]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def available() -> bool:
    return _load() is not None


def _bytes_matrix(xs: Sequence[int], nbytes: int) -> np.ndarray:
    buf = bytearray(len(xs) * nbytes)
    for i, x in enumerate(xs):
        buf[i * nbytes : (i + 1) * nbytes] = int(x).to_bytes(nbytes, "little")
    return np.frombuffer(bytes(buf), np.uint8).reshape(len(xs), nbytes)


def ints_to_limbs(xs: Sequence[int], num_limbs: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    nbytes = -(-(num_limbs * 15) // 8)
    mat = np.ascontiguousarray(_bytes_matrix(xs, nbytes))
    out = np.empty((len(xs), num_limbs), np.uint32)
    lib.pack_limbs(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(xs),
        nbytes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        num_limbs,
    )
    return out


def limbs_to_ints(limbs: np.ndarray) -> Optional[List[int]]:
    lib = _load()
    if lib is None:
        return None
    limbs = np.ascontiguousarray(limbs, np.uint32)
    if limbs.ndim == 1:
        limbs = limbs[None]
    batch, L = limbs.shape
    nbytes = -(-(L * 15) // 8)
    out = np.empty((batch, nbytes), np.uint8)
    lib.unpack_limbs(
        limbs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        batch,
        L,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nbytes,
    )
    return [int.from_bytes(row.tobytes(), "little") for row in out]


def ints_to_windows(xs: Sequence[int], nw: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    nbytes = -(-(nw * 4) // 8)
    mat = np.ascontiguousarray(_bytes_matrix(xs, nbytes))
    out = np.empty((len(xs), nw), np.uint32)
    lib.pack_windows(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(xs),
        nbytes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        nw,
    )
    return out.astype(np.uint8)  # values < 16; quarters the device upload
