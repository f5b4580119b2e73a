"""Hand-written CUDA NTT kernels (``csrc/ntt.cu``) and their wrappers.

The two kernels replace the JAX package's Pallas kernels
``hhe_tpu.ops.ntt_pallas._fwd_kernel`` and ``_inv_kernel``.  The source is
compiled with ``nvcc`` at first use into a shared library with a plain C
interface under ``build/hhe_tpu_torch/`` (keyed by a hash of the source) and
loaded with ctypes.  Their plain PyTorch versions are ``ntt.ntt_fwd_plain`` /
``ntt.ntt_inv_plain``; ``ntt.ntt_fwd`` / ``ntt.ntt_inv`` send CPU tensors
there and CUDA tensors here.

The wrappers take only what the kernels take — a contiguous int32 CUDA tensor
``[..., k, N]`` with 256 <= N <= 16384 a power of two and the matching
tables on the same device — and raise on anything else.  ``LAUNCHES`` counts
the kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

MIN_N = 256
MAX_N = 16384  # one row in shared memory: 4N bytes <= 64 KB

LAUNCHES = {"ntt_fwd": 0, "ntt_inv": 0}

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "ntt.cu"
BUILD_DIR = _PKG.parent / "build" / "hhe_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lib = None
_lock = threading.Lock()
BUILD_LOG = {}  # filled by build(): library path and, if it compiled, seconds and output


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def build() -> pathlib.Path:
    """Compile ``csrc/ntt.cu`` unless a library for this source exists."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libhhe_ntt_{tag}.so"
    if out.exists():
        BUILD_LOG.setdefault("library", str(out))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG.update(
        library=str(out),
        seconds=time.perf_counter() - t0,
        compiler_output=proc.stdout + proc.stderr,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.hhe_ntt_fwd.argtypes = [p, p, p, p, p, ll, i, i, i, p]
            lib.hhe_ntt_fwd.restype = i
            lib.hhe_ntt_inv.argtypes = [p, p, p, p, p, p, ll, i, i, i, p]
            lib.hhe_ntt_inv.restype = i
            lib.hhe_cuda_error_string.argtypes = [i]
            lib.hhe_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(x: torch.Tensor, tb) -> int:
    """Validate the operands; returns the number of rows (batch * k)."""
    if x.device.type != "cuda":
        raise ValueError(f"NTT kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"NTT kernel needs int32 residues, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("NTT kernel needs a contiguous tensor")
    if x.dim() < 2:
        raise ValueError(f"NTT kernel needs [..., k, N], got {tuple(x.shape)}")
    k, n = x.shape[-2], x.shape[-1]
    if n < MIN_N or n > MAX_N or n & (n - 1):
        raise ValueError(f"NTT kernel supports N = 2^j in [{MIN_N}, {MAX_N}], got {n}")
    if tuple(tb.psi_br.shape) != (k, n) or len(tb.moduli) != k:
        raise ValueError(
            f"tables for {len(tb.moduli)} moduli x {tb.psi_br.shape[-1]} do not "
            f"match a tensor of {k} limbs x {n}"
        )
    if tb.psi_br.device != x.device:
        raise ValueError(f"tables on {tb.psi_br.device}, tensor on {x.device}")
    return x.numel() // n


def _raise_on(rc: int, what: str):
    if rc != 0:
        msg = _library().hhe_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def ntt_fwd(x: torch.Tensor, tb) -> torch.Tensor:
    """Forward negacyclic NTT kernel (natural -> bit-reversed order)."""
    rows = _check(x, tb)
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hhe_ntt_fwd(
            x.data_ptr(), y.data_ptr(), tb.psi_br.data_ptr(), tb.q32.data_ptr(),
            tb.qinv32.data_ptr(), rows, x.shape[-2], x.shape[-1].bit_length() - 1,
            int(tb.lazy), stream,
        )
    _raise_on(rc, "ntt_fwd")
    LAUNCHES["ntt_fwd"] += 1
    return y


def ntt_inv(x: torch.Tensor, tb) -> torch.Tensor:
    """Inverse negacyclic NTT kernel (bit-reversed -> natural order)."""
    rows = _check(x, tb)
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hhe_ntt_inv(
            x.data_ptr(), y.data_ptr(), tb.ipsi_br.data_ptr(), tb.q32.data_ptr(),
            tb.qinv32.data_ptr(), tb.ninv32.data_ptr(), rows, x.shape[-2],
            x.shape[-1].bit_length() - 1, int(tb.lazy), stream,
        )
    _raise_on(rc, "ntt_inv")
    LAUNCHES["ntt_inv"] += 1
    return y


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0
