"""Hand-written CUDA kernels for the Montgomery product (K3) and the
Montgomery multiply-accumulate (K4), ``csrc/modarith.cu``, and their wrappers.

The JAX package has no Pallas kernel for either: XLA fuses each chain of
``hhe_tpu.ops.modular.mont_mul`` (and of ``tree_add_mod`` over its products)
into one loop over the data.  Here each is one launch that keeps the 64-bit
products in registers, where the plain PyTorch versions
(``modular.mont_mul_plain``, ``mont_mul_lazy_plain``, ``mont_mac_plain``)
take about fifteen int64 passes.  ``modular.mont_mul`` / ``mont_mul_lazy`` /
``mont_mac`` send a CUDA tensor here and a CPU tensor to the plain versions.
The source is built like ``csrc/ntt.cu`` (``ntt_kernels.build``): with
``nvcc`` at first use into ``build/hhe_tpu_torch/``, keyed by a hash of the
source, and loaded with ctypes.

The wrappers take what the plain versions take: a tensor ``a`` (int32 or
int64; the output has its dtype), and ``b`` / ``q`` / ``qinv_neg`` as int32
or int64 tensors that broadcast against it, or as Python ints below 2^32.
Values are read as u32 bit patterns (an int64 by its low 32 bits).  A
broadcast operand reaches the kernel as strides of 0, never materialised;
the output's shape is collapsed to at most ``MAX_DIMS`` dimensions.  A
tensor on the CPU, another dtype, shapes that do not broadcast, moduli that
vary along the reduction axis, or a shape that does not collapse to
``MAX_DIMS`` dimensions raise; nothing falls back to the plain version.
``LAUNCHES`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import ntt_kernels

MAX_DIMS = 6  # the kernel's dimensions (csrc/modarith.cu MAXD)
HEAD_WORDS = 5  # out, out64, lazy, terms, vec
DESC_WORDS = HEAD_WORDS + 4 * (4 + MAX_DIMS) + MAX_DIMS  # hhe_mont's descriptor
ALIGN = 16  # bytes; the kernel's vector path loads and stores 16 bytes at once
NAMES = ("a", "b", "q", "qinv_neg")

# K3 (eager and lazy) and K4
LAUNCHES = {"mont_mul": 0, "mont_mac": 0}

SOURCE = ntt_kernels._PKG / "csrc" / "modarith.cu"
BUILD_LOG = {}  # as ntt_kernels.BUILD_LOG, for this source

_lib = None
_lock = threading.Lock()


def build():
    """Compile ``csrc/modarith.cu`` unless a library for this source exists."""
    return ntt_kernels.build(SOURCE, BUILD_LOG)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.hhe_mont.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                                     ctypes.c_void_p]
            lib.hhe_mont.restype = ctypes.c_int
            lib.hhe_mont_desc_words.restype = ctypes.c_int
            lib.hhe_mont_error_string.argtypes = [ctypes.c_int]
            lib.hhe_mont_error_string.restype = ctypes.c_char_p
            if lib.hhe_mont_desc_words() != DESC_WORDS:
                raise RuntimeError("csrc/modarith.cu and mod_kernels disagree on the descriptor")
            _lib = lib
        return _lib


class Plan(NamedTuple):
    """What one launch computes: the output's shape, its ``MAX_DIMS``
    collapsed sizes, and per operand (a, b, q, qinv_neg) the tensor (None
    for a scalar), the scalar, its strides over the collapsed sizes and its
    stride along the reduction axis; ``terms`` the reduction's length (1
    for K3)."""

    shape: Tuple[int, ...]
    sizes: Tuple[int, ...]
    operands: Tuple[Tuple[Optional[torch.Tensor], int, Tuple[int, ...], int], ...]
    terms: int


def plan(a, b, q, qinv_neg, dim: Optional[int] = None) -> Plan:
    """Check the operands and lay them out for the kernel; reduce over
    ``dim`` of their broadcast shape (K4) or over nothing (K3).  Raises on
    anything the kernel does not take except the device (``_run`` checks
    that on every call)."""
    ops = (a, b, q, qinv_neg)
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"a must be a tensor, got {type(a).__name__}")
    for name, x in zip(NAMES, ops):
        if isinstance(x, torch.Tensor):
            if x.dtype not in (torch.int32, torch.int64):
                raise TypeError(f"{name}: Montgomery kernels take int32 or int64, got {x.dtype}")
        elif isinstance(x, (int, np.integer)) and not isinstance(x, bool):
            if not 0 <= int(x) < 1 << 32:
                raise ValueError(f"{name} = {int(x)} is not a u32 value")
        else:
            raise TypeError(f"{name} must be a tensor or an int, got {type(x).__name__}")
    tensors = [x for x in ops if isinstance(x, torch.Tensor)]
    try:
        full = tuple(torch.broadcast_shapes(*(x.shape for x in tensors)))
    except RuntimeError as e:
        raise ValueError(f"operands do not broadcast: {[tuple(x.shape) for x in tensors]}") from e
    nd = len(full)
    strides = [x.expand(full).stride() if isinstance(x, torch.Tensor) else (0,) * nd
               for x in ops]
    red, terms = None, 1
    if dim is not None:
        if not -nd <= dim < nd:
            raise ValueError(f"reduction axis {dim} out of range for {nd} dimensions")
        red = dim % nd
        terms = full[red]
        if terms < 1:
            raise ValueError("empty reduction axis")
        if terms > 1 and (strides[2][red] or strides[3][red]):
            raise ValueError("the moduli must not vary along the reduction axis")
    shape = tuple(s for i, s in enumerate(full) if i != red)
    # merge each dimension into the next inner one where every operand's
    # strides let it (the output is contiguous); size-1 dimensions go
    dims = []
    for i, size in enumerate(full):
        if i == red or size == 1:
            continue
        st = [s[i] for s in strides]
        if dims and all(ps == s * size for ps, s in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * size, st)
        else:
            dims.append((size, st))
    if len(dims) > MAX_DIMS:
        raise ValueError(f"{len(dims)} dimensions do not collapse to {MAX_DIMS}: {full}")
    dims = [(1, [0] * 4)] * (MAX_DIMS - len(dims)) + dims
    operands = tuple(
        (x if isinstance(x, torch.Tensor) else None,
         0 if isinstance(x, torch.Tensor) else int(x),
         tuple(st[o] for _, st in dims),
         strides[o][red] if red is not None else 0)
        for o, x in enumerate(ops)
    )
    return Plan(shape, tuple(size for size, _ in dims), operands, terms)


_Desc = ctypes.c_longlong * DESC_WORDS
_OPERAND_WORDS = 4 + MAX_DIMS  # ptr, is64, scalar, rstride, strides
# checked layouts: key -> (output shape, descriptor without pointers, the
# operands the vector path needs aligned, or None where it does not apply)
_PLANS = {}
_MAX_PLANS = 4096


def _layout_key(x):
    if isinstance(x, torch.Tensor):
        return x.shape, x.stride(), x.dtype
    return type(x), x


def _descriptor(p: Plan, lazy: bool, dtype) -> "ctypes.Array":
    """``hhe_mont``'s descriptor for plan `p`, pointers and vec left 0."""
    words = [0, int(dtype == torch.int64), int(lazy), p.terms, 0]
    for x, scalar, st, rst in p.operands:
        words += [0, int(x is not None and x.dtype == torch.int64), scalar, rst, *st]
    return _Desc(*words, *p.sizes)


def _vector_operands(p: Plan):
    """The operands whose pointers must be ALIGN-byte aligned for the
    kernel's vector path (groups of 4 consecutive words), or None where the
    layout does not allow it: the row a multiple of 4 words, every operand
    broadcast over the innermost axis or contiguous along it with outer and
    reduction strides that are multiples of 4."""
    if p.sizes[-1] % 4:
        return None
    need = []
    for o, (x, _, st, rst) in enumerate(p.operands):
        if x is None or st[-1] == 0:
            continue
        if st[-1] != 1 or rst % 4 or any(s % 4 for s in st[:-1]):
            return None
        need.append(o)
    return tuple(need)


def _run(name: str, a, b, q, qinv_neg, dim, lazy: bool) -> torch.Tensor:
    """Check (or find checked) the layout, then launch on a's device and
    current stream.  The wrapper runs on every call, so a layout is planned
    once and kept."""
    ops = (a, b, q, qinv_neg)
    key = (dim, lazy, *map(_layout_key, ops))
    hit = _PLANS.get(key)
    if hit is None:
        p = plan(a, b, q, qinv_neg, dim)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        hit = _PLANS[key] = (p.shape, _descriptor(p, lazy, a.dtype), _vector_operands(p))
    shape, static, vec = hit
    if a.device.type != "cuda":
        raise ValueError(f"Montgomery kernel needs CUDA tensors, got {a.device}")
    for x in ops[1:]:
        if isinstance(x, torch.Tensor) and x.device != a.device:
            raise ValueError(f"operands on several devices: {a.device} and {x.device}")
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    desc = _Desc.from_buffer_copy(static)
    desc[0] = out.data_ptr()
    for o, x in enumerate(ops):
        if isinstance(x, torch.Tensor):
            desc[HEAD_WORDS + o * _OPERAND_WORDS] = x.data_ptr()
    desc[4] = int(vec is not None and all(ops[o].data_ptr() % ALIGN == 0 for o in vec))
    dev = a.device.index
    lib = _library()
    rc = lib.hhe_mont(desc, dev, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.hhe_mont_error_string(rc).decode()})")
    LAUNCHES[name] += 1
    return out


def mont_mul(a, b_mont, q, qinv_neg) -> torch.Tensor:
    """K3: a * b_mont * 2^-32 mod q in [0, q), over the broadcast shape."""
    return _run("mont_mul", a, b_mont, q, qinv_neg, None, False)


def mont_mul_lazy(a, b_mont, q, qinv_neg) -> torch.Tensor:
    """K3 without the final subtract: [0, 2q)."""
    return _run("mont_mul", a, b_mont, q, qinv_neg, None, True)


def mont_mac(a, b_mont, q, qinv_neg, dim: int) -> torch.Tensor:
    """K4: sum over axis ``dim`` of the broadcast shape of
    mont_mul(a, b_mont) mod q, in [0, q), the axis removed; q and qinv_neg
    must not vary along it."""
    return _run("mont_mac", a, b_mont, q, qinv_neg, dim, False)


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0
