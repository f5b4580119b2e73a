"""Hand-written CUDA NTT kernels (``csrc/ntt.cu``) and their wrappers.

The two kernels replace the JAX package's Pallas kernels
``hhe_tpu.ops.ntt_pallas._fwd_kernel`` and ``_inv_kernel``.  The source is
compiled with ``nvcc`` at first use into a shared library with a plain C
interface under ``build/hhe_tpu_torch/`` (keyed by a hash of the source) and
loaded with ctypes.  Their plain PyTorch versions are ``ntt.ntt_fwd_plain`` /
``ntt.ntt_inv_plain``; ``ntt.ntt_fwd`` / ``ntt.ntt_inv`` send CPU tensors
there and CUDA tensors here.

Design (``ntt.cu``'s header has the details): a persistent grid of one
1024-thread block per SM walks over 64 KB tiles of the tensor (one row at
N = 16384, several below), bringing each in and out of shared memory with one
bulk copy while the block transforms the previous one.  Each thread runs up
to four butterfly stages on 16 coefficients in registers between exchanges
through bank-conflict-free shared memory, with Shoup twiddle pairs
(``NttTables.psi_parts`` / ``ipsi_parts`` / ``ninv_shoup``) and lazy
reduction when every q < 2^30.  The bytes of the row tensor and the integer
issue rate bound it about equally; tensor cores would need many int8
products per exact 31-bit modular product and are not used.

Rows longer than a tile (N = 32768, 65536) take two launches each way: a
top pass (``ntt_fwd_top`` / ``ntt_inv_top``, elementwise over the row's
P = N / 16384 parts, twiddles from ``psi_shoup`` / ``ipsi_shoup``) runs the
stages that mix the parts, before (forward) or after (inverse) the tile
kernel transforms each part with the part's own table.

The wrappers take only what the kernels take — a contiguous, 16-byte aligned
int32 CUDA tensor ``[..., k, N]`` with 32 <= N <= 65536 a power of two and
the matching tables on the same device — and raise on anything else, a CPU
tensor included.  The kernel instance is chosen from N and the moduli alone.
``LAUNCHES`` counts the launches of each kernel, the top passes under their
own names.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

import torch

from .ntt import TILE  # words of one shared-memory tile: a row, or a part of a longer one

MIN_N = 32  # the four-step NTT's smallest local transform (N = 1024 = 32 x 32)
MAX_N = 65536  # four parts
ALIGN = 16  # bytes; the bulk copies need it

# the tile kernels (K1, K2) and, for N > TILE, the top passes
LAUNCHES = {"ntt_fwd": 0, "ntt_inv": 0, "ntt_fwd_top": 0, "ntt_inv_top": 0}

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


def nvcc_command(source, out) -> list:
    """nvcc's command line for a library built from ``source``, with ptxas'
    register and spill report (``ptxas_report`` reads it)."""
    return [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(source)]


_KERNEL_NAME = re.compile(r"(ntt_(?:fwd|inv)(?:_top)?_kernel)ILi(\d+)ELb([01])E")


def ptxas_report(output: str) -> dict:
    """ptxas' lines per kernel instance from nvcc's output:
    ``{"ntt_fwd_kernel<log2 N, lazy|eager>": {"registers": ..., "spill_bytes": ...}}``,
    the top passes as ``ntt_fwd_top_kernel<...>`` / ``ntt_inv_top_kernel<...>``."""
    report, name = {}, None
    for line in output.splitlines():
        if "entry function" in line:
            mangled = line.split("'")[1]
            m = _KERNEL_NAME.search(mangled)
            name = f"{m[1]}<{m[2]}, {'lazy' if m[3] == '1' else 'eager'}>" if m else mangled
            report[name] = {"registers": "", "spill_bytes": 0}
        elif name is None:
            continue
        elif "spill" in line:
            report[name]["spill_bytes"] += sum(int(w) for w in re.findall(r"(\d+) bytes spill", line))
        elif "registers" in line:
            report[name]["registers"] = line.split(":", 1)[1].strip()
    return report


def build(source: pathlib.Path = SOURCE, log: dict = BUILD_LOG) -> pathlib.Path:
    """Compile ``source`` (``csrc/ntt.cu`` by default) into
    ``libhhe_<stem>_<hash>.so`` unless a library for this source exists;
    fills ``log`` as ``BUILD_LOG``."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libhhe_{source.stem}_{tag}.so"
    if out.exists():
        log.setdefault("library", str(out))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(source, tmp), capture_output=True, text=True)
    log.update(
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
            _lib = bind(ctypes.CDLL(str(build())))
        return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``ntt.cu``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hhe_ntt_fwd.argtypes = [p, p, p, p, ll, i, i, i, i, i, p]
    lib.hhe_ntt_fwd.restype = i
    lib.hhe_ntt_inv.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, p]
    lib.hhe_ntt_inv.restype = i
    lib.hhe_ntt_fwd_top.argtypes = [p, p, p, p, ll, i, i, i, i, p]
    lib.hhe_ntt_fwd_top.restype = i
    lib.hhe_ntt_inv_top.argtypes = [p, p, p, p, p, ll, i, i, i, i, p]
    lib.hhe_ntt_inv_top.restype = i
    lib.hhe_cuda_error_string.argtypes = [i]
    lib.hhe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, tb) -> int:
    """Validate the operands; returns the number of rows (batch * k).  The
    device is checked last, so every refusal shows on a CPU tensor too."""
    if x.dtype != torch.int32:
        raise TypeError(f"NTT kernel needs int32 residues, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("NTT kernel needs a contiguous tensor")
    if x.dim() < 2:
        raise ValueError(f"NTT kernel needs [..., k, N], got {tuple(x.shape)}")
    k, n = x.shape[-2], x.shape[-1]
    if n < MIN_N or n > MAX_N or n & (n - 1):
        raise ValueError(f"NTT kernel supports N = 2^j in [{MIN_N}, {MAX_N}], got {n}")
    # the tile kernels read the parts' tables, the top passes (N > TILE) the
    # whole ones; checked in few comparisons, as this runs on every call
    parts = n // TILE or 1
    shape = tb.psi_parts.shape
    if (len(tb.moduli) != k or shape != (k, parts, n // parts, 2)
            or tb.ipsi_parts.shape != shape
            or parts > 1 and not tb.psi_shoup.shape == tb.ipsi_shoup.shape == (k, n, 2)):
        raise ValueError(
            f"tables for {len(tb.moduli)} moduli x {tb.psi_br.shape[-1]} "
            f"({tuple(tb.psi_parts.shape)} per part) do not match a tensor of "
            f"{k} limbs x {n}"
        )
    if x.data_ptr() % ALIGN:
        raise ValueError(f"NTT kernel needs a {ALIGN}-byte aligned tensor")
    if tb.psi_shoup.device != x.device:
        raise ValueError(f"tables on {tb.psi_shoup.device}, tensor on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"NTT kernel needs a CUDA tensor, got {x.device}")
    return x.numel() // n


@functools.lru_cache(maxsize=None)
def _max_blocks(index: int) -> int:
    """The persistent grid's size: one block per SM."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _raise_on(rc: int, what: str):
    if rc != 0:
        msg = _library().hhe_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def launch(lib: ctypes.CDLL, name: str, x: torch.Tensor, y: torch.Tensor, tb) -> int:
    """Launch kernel ``name`` (a key of ``LAUNCHES``) of ``lib`` from x into
    y on the current stream, operands already checked (x may be y for the
    top passes); returns the CUDA error code.  Counts nothing."""
    n, dev = x.shape[-1], x.device.index
    shape = (x.numel() // n, x.shape[-2], n.bit_length() - 1, int(tb.lazy))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if name == "ntt_fwd":
        return lib.hhe_ntt_fwd(x.data_ptr(), y.data_ptr(), tb.psi_parts.data_ptr(),
                               tb.q32.data_ptr(), *shape, _max_blocks(dev), dev, stream)
    if name == "ntt_inv":
        return lib.hhe_ntt_inv(x.data_ptr(), y.data_ptr(), tb.ipsi_parts.data_ptr(),
                               tb.q32.data_ptr(), tb.ninv_shoup.data_ptr(), *shape,
                               _max_blocks(dev), dev, stream)
    if name == "ntt_fwd_top":
        return lib.hhe_ntt_fwd_top(x.data_ptr(), y.data_ptr(), tb.psi_shoup.data_ptr(),
                                   tb.q32.data_ptr(), *shape, dev, stream)
    if name == "ntt_inv_top":
        return lib.hhe_ntt_inv_top(x.data_ptr(), y.data_ptr(), tb.ipsi_shoup.data_ptr(),
                                   tb.q32.data_ptr(), tb.ninv_shoup.data_ptr(), *shape, dev,
                                   stream)
    raise ValueError(f"no kernel {name!r}")


def _launch(lib: ctypes.CDLL, name: str, x: torch.Tensor, y: torch.Tensor, tb):
    _raise_on(launch(lib, name, x, y, tb), name)
    LAUNCHES[name] += 1


def ntt_fwd(x: torch.Tensor, tb) -> torch.Tensor:
    """Forward negacyclic NTT kernel (natural -> bit-reversed order); a row
    longer than a tile first goes through the top pass."""
    rows = _check(x, tb)
    y = torch.empty_like(x)
    if rows:
        lib = _library()
        if x.shape[-1] > TILE:
            _launch(lib, "ntt_fwd_top", x, y, tb)
            x = y
        _launch(lib, "ntt_fwd", x, y, tb)
    return y


def ntt_inv(x: torch.Tensor, tb) -> torch.Tensor:
    """Inverse negacyclic NTT kernel (bit-reversed -> natural order); a row
    longer than a tile ends with the top pass."""
    rows = _check(x, tb)
    y = torch.empty_like(x)
    if rows:
        lib = _library()
        _launch(lib, "ntt_inv", x, y, tb)
        if x.shape[-1] > TILE:
            _launch(lib, "ntt_inv_top", y, y, tb)
    return y


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0
