"""ctypes bindings for the native host library (``hhe_native.cpp``) —
counterpart of ``hhe_tpu.native``.

SHAKE128, the PASTA-3 block randomness and batched plain PASTA keystreams
in C++.  The source is compiled with ``g++ -O3 -shared -fPIC`` at first use
into ``build/hhe_tpu_torch/`` (keyed by a hash of the source and the flags,
as the NTT kernels are) and loaded with ctypes.

``available()`` reports whether the library builds and loads here; it never
raises.  Every other function raises ``RuntimeError`` with the compiler's or
the loader's message when the library cannot be had, so a failed build is
never mistaken for a missing toolchain by a caller that did not ask.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "hhe_native.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "hhe_tpu_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the library could not be had, once tried


def build() -> pathlib.Path:
    """Compile ``hhe_native.cpp`` unless a library for this source exists;
    raises ``RuntimeError`` with g++'s output if it fails."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libhhe_native_{tag}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native PASTA library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def _library() -> ctypes.CDLL:
    """The loaded library; builds it at first use.  Raises with the reason
    it cannot be had (the same reason on every later call)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
                _error = str(e)
            else:
                u64 = ctypes.c_uint64
                p8 = ctypes.POINTER(ctypes.c_uint8)
                p64 = ctypes.POINTER(ctypes.c_uint64)
                lib.hhe_shake128.argtypes = [p8, u64, p8, u64]
                lib.hhe_pasta_block_randomness.argtypes = [u64, u64, u64, p64, p64, p64, p64]
                lib.hhe_pasta_keystreams.argtypes = [u64, u64, u64, p64, u64, p64]
                for fn in (lib.hhe_shake128, lib.hhe_pasta_block_randomness,
                           lib.hhe_pasta_keystreams):
                    fn.restype = None
                _lib = lib
        if _lib is None:
            raise RuntimeError(f"native PASTA library unavailable: {_error}")
        return _lib


def available() -> bool:
    """Whether the library builds and loads (tried once per process)."""
    try:
        _library()
    except RuntimeError:
        return False
    return True


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def shake128(seed: bytes, outlen: int) -> bytes:
    """The first ``outlen`` bytes of SHAKE128(seed)."""
    lib = _library()
    out = np.zeros(outlen, np.uint8)
    seed_arr = np.frombuffer(seed, np.uint8).copy()
    lib.hhe_shake128(
        seed_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        outlen,
    )
    return out.tobytes()


def pasta_block_randomness(
    p: int, nonce: int, counter: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(mats1 [4,128,128], mats2, rcs1 [4,128], rcs2) u64."""
    lib = _library()
    m1 = np.zeros((4, 128, 128), np.uint64)
    m2 = np.zeros((4, 128, 128), np.uint64)
    r1 = np.zeros((4, 128), np.uint64)
    r2 = np.zeros((4, 128), np.uint64)
    lib.hhe_pasta_block_randomness(p, nonce, counter, _p64(m1), _p64(m2), _p64(r1), _p64(r2))
    return m1, m2, r1, r2


def pasta_keystreams(p: int, nonce: int, counter: int, keys: np.ndarray) -> np.ndarray:
    """Batched keystream blocks: keys [nkeys, 256] -> [nkeys, 128]."""
    lib = _library()
    keys = np.ascontiguousarray(keys, np.uint64)
    nkeys = keys.shape[0]
    out = np.zeros((nkeys, 128), np.uint64)
    lib.hhe_pasta_keystreams(p, nonce, counter, _p64(keys), nkeys, _p64(out))
    return out
