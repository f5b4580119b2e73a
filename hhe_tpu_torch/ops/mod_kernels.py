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
``LAUNCHES`` counts the launches of each kernel, ``FORM_LAUNCHES`` K4's by
form.

K4 takes one of four forms by layout (``plan``): where one multiplicand is
broadcast over an output axis along which the other varies (a key-switch's
k0/k1 pair, the BSGS babysteps and giantsteps, a base conversion's output
moduli), the kernel reads the shared one once for every output of that
axis and streams the other ("fanout", staged in shared memory;
"fanout_regs", up to four outputs summed in registers where the staged
tile would be too large; "table" where the streamed one is a constant per
word row, as a base conversion's, held as Shoup pairs); other layouts take
the one-pass loop ("general").
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import ntt_kernels

MAX_DIMS = 6  # the kernel's dimensions (csrc/modarith.cu MAXD)
HEAD_WORDS = 7  # out, out64, lazy, terms, vec, form, threads
DESC_WORDS = HEAD_WORDS + 4 * (4 + MAX_DIMS) + 2 * MAX_DIMS  # hhe_mont's descriptor
ALIGN = 16  # bytes; the kernel's vector path loads and stores 16 bytes at once
NAMES = ("a", "b", "q", "qinv_neg")
# K4's forms (csrc/modarith.cu Form): the one-pass loop; a shared operand staged
# once for every output of its fan-out; the same with Shoup constants; a
# fan-out of at most FAN_REG outputs with its sums in registers, nothing staged
FORMS = ("general", "fanout", "table", "fanout_regs")
MIN_BLOCKS = 264  # two blocks on each of the H100's 132 SMs
SMEM_BUDGET = 48 * 1024  # a fan-out block's shared memory where the threads allow it
SMEM_MAX = 227 * 1024  # the most a block may have (csrc/modarith.cu SMEM_MAX)
MAX_FAN_TERMS = 1 << 20  # the fan-out forms' exact u64 sums (csrc/modarith.cu hhe_mont)
# a table-form block walks its outputs one after another: below this many
# blocks (at 64 threads) the general form, which spreads them over blocks,
# is faster (the accuracy report's N=1024 conversions, 8-24 blocks; H100)
TABLE_MIN_BLOCKS = 64
FAN_REG = 4  # the most outputs "fanout_regs" keeps sums of (csrc/modarith.cu FAN_REG)

# K3 (eager and lazy) and K4; K4's launches by form
LAUNCHES = {"mont_mul": 0, "mont_mac": 0}
FORM_LAUNCHES = dict.fromkeys(FORMS, 0)

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
    """What one launch computes: the output's shape; the ``MAX_DIMS``
    collapsed sizes and the output's strides over them, in the kernel's
    order; per kernel operand the tensor (None for a scalar), the scalar,
    its strides over the collapsed sizes and its stride along the reduction
    axis; ``order``, the index in (a, b, q, qinv_neg) of each kernel
    operand; ``terms`` the reduction's length (1 for K3); ``form`` one of
    ``FORMS``; ``threads`` a block's.  Fan-out forms: kernel operand 0 (S)
    is broadcast over dimension 0, the fan-out, along which operand 1 (W)
    varies; the other rows run with the dimensions W is broadcast over
    fastest."""

    shape: Tuple[int, ...]
    sizes: Tuple[int, ...]
    ostrides: Tuple[int, ...]
    operands: Tuple[Tuple[Optional[torch.Tensor], int, Tuple[int, ...], int], ...]
    order: Tuple[int, ...]
    terms: int
    form: str
    threads: int


def _footprint(x) -> int:
    """Bytes of a tensor's distinct elements (0 for a scalar)."""
    if not isinstance(x, torch.Tensor):
        return 0
    return x.element_size() * int(np.prod([n for n, st in zip(x.shape, x.stride()) if st]))


def fan_smem(form: str, terms: int, fan: int, threads: int, v: int = 4) -> int:
    """Shared memory of a fan-out block (csrc/modarith.cu fan_smem)."""
    if form == "fanout_regs":
        return 0
    return 4 * terms * threads * v + (8 * fan * terms + 8 * fan if form == "table" else 0)


def _fan_out(dims, ops, terms):
    """(dimension, shared operand, form) of the best fan-out of collapsed
    `dims` [(size, strides of a, b, q, qinv)], or None.  A fan-out is a
    dimension along which one of a / b is broadcast while the other varies,
    the shared one running along the innermost axis and the moduli constant
    along it.  The one whose launch requests the fewest bytes wins, then the
    longest: each of a / b counts its bytes once for every output row it is
    broadcast over, the shared one's fan-out aside (the rows run with those
    of the streamed one fastest, so that its re-reads find it in L2)."""
    inner = dims[-1][1]
    if len(dims) < 2 or inner[2] or inner[3] or terms >= MAX_FAN_TERMS:
        return None
    found = []
    for i, (size, st) in enumerate(dims[:-1]):
        for s in (0, 1):
            w = 1 - s
            if size < 2 or st[s] or not st[w] or not inner[s] or not isinstance(ops[s], torch.Tensor):
                continue
            form = "fanout" if inner[w] else "table"
            # a small fan-out whose tile would not fit 128-thread blocks in
            # the budget keeps its sums in registers instead
            if form == "fanout" and size <= FAN_REG and fan_smem(form, terms, size, 128) > SMEM_BUDGET:
                form = "fanout_regs"
            if fan_smem(form, terms, size, 64) > SMEM_MAX:
                continue
            rows = int(np.prod([n for d, (n, _) in enumerate(dims[:-1]) if d != i]))
            if form == "table" and rows * -(-dims[-1][0] // (64 * 4)) < TABLE_MIN_BLOCKS:
                continue
            requested = sum(
                _footprint(ops[o]) * int(np.prod([n for d, (n, sd) in enumerate(dims[:-1])
                                                  if d != i and not sd[o]]))
                for o in (0, 1))
            found.append(((requested, -size), (i, s, form)))
    return min(found)[1] if found else None


def _threads(form: str, sizes, terms: int) -> int:
    """A block's threads: the most (up to 256) that leave a launch at least
    MIN_BLOCKS blocks (for 16-byte words), within SMEM_BUDGET for a fan-out
    block where any count allows, else the fewest."""
    inner = sizes[-1]
    if form == "general":
        rows, words = int(np.prod(sizes[:-1])), 8
        choices = (256, 128, 64)
    else:
        rows, words = int(np.prod(sizes[1:-1])), 4
        choices = [t for t in (256, 128, 64) if fan_smem(form, terms, sizes[0], t) <= SMEM_BUDGET] or [64]
    for t in choices:
        if rows * -(-inner // (t * words)) >= MIN_BLOCKS:
            return t
    return choices[-1]


def plan(a, b, q, qinv_neg, dim: Optional[int] = None, fan_out: bool = True) -> Plan:
    """Check the operands and lay them out for the kernel; reduce over
    ``dim`` of their broadcast shape (K4) or over nothing (K3).  K4 takes a
    fan-out form where the layout has one (``_fan_out``) unless ``fan_out``
    is False.  Raises on anything the kernel does not take except the
    device (``_run`` checks that on every call)."""
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
    ostrides, outer = [], 1  # the output's, contiguous over the collapsed sizes
    for size, _ in reversed(dims):
        ostrides.append(outer)
        outer *= size
    dims = [(size, st, os) for (size, st), os in zip(dims, reversed(ostrides))]
    order, form = (0, 1, 2, 3), "general"
    fan = _fan_out([(n, st) for n, st, _ in dims], ops, terms) if red is not None and fan_out else None
    one = (1, [0] * 4, 0)
    if fan is None:
        dims = [one] * (MAX_DIMS - len(dims)) + dims
    else:
        i, s, form = fan
        order = (s, 1 - s, 2, 3)
        rest = [d for n, d in enumerate(dims[:-1]) if n != i]
        rest.sort(key=lambda d: d[1][1 - s] == 0)  # rows W is broadcast over run fastest
        dims = [dims[i]] + [one] * (MAX_DIMS - len(dims)) + rest + [dims[-1]]
    sizes = tuple(n for n, _, _ in dims)
    operands = tuple(
        (ops[o] if isinstance(ops[o], torch.Tensor) else None,
         0 if isinstance(ops[o], torch.Tensor) else int(ops[o]),
         tuple(st[o] for _, st, _ in dims),
         strides[o][red] if red is not None else 0)
        for o in order
    )
    threads = 256 if red is None else _threads(form, sizes, terms)
    return Plan(shape, sizes, tuple(os for _, _, os in dims), operands, order, terms, form, threads)


_Desc = ctypes.c_longlong * DESC_WORDS
_OPERAND_WORDS = 4 + MAX_DIMS  # ptr, is64, scalar, rstride, strides
# checked layouts: key -> (output shape, descriptor without pointers, the
# kernel operands' indices in (a, b, q, qinv_neg), the kernel operands the
# vector path needs aligned or None where it does not apply, the form)
_PLANS = {}
_MAX_PLANS = 4096


def _layout_key(x):
    if isinstance(x, torch.Tensor):
        return x.shape, x.stride(), x.dtype
    return type(x), x


def _descriptor(p: Plan, lazy: bool, dtype) -> "ctypes.Array":
    """``hhe_mont``'s descriptor for plan `p`, pointers and vec left 0."""
    words = [0, int(dtype == torch.int64), int(lazy), p.terms, 0, FORMS.index(p.form), p.threads]
    for x, scalar, st, rst in p.operands:
        words += [0, int(x is not None and x.dtype == torch.int64), scalar, rst, *st]
    return _Desc(*words, *p.sizes, *p.ostrides)


def _vector_operands(p: Plan):
    """The kernel operands whose pointers must be ALIGN-byte aligned for the
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


def _run(name: str, a, b, q, qinv_neg, dim, lazy: bool, fan_out: bool = True) -> torch.Tensor:
    """Check (or find checked) the layout, then launch on a's device and
    current stream.  The wrapper runs on every call, so a layout is planned
    once and kept."""
    ops = (a, b, q, qinv_neg)
    key = (dim, lazy, fan_out, *map(_layout_key, ops))
    hit = _PLANS.get(key)
    if hit is None:
        p = plan(a, b, q, qinv_neg, dim, fan_out)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        hit = _PLANS[key] = (p.shape, _descriptor(p, lazy, a.dtype), p.order, _vector_operands(p),
                             p.form)
    shape, static, order, vec, form = hit
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
    kops = [ops[o] for o in order]
    for o, x in enumerate(kops):
        if isinstance(x, torch.Tensor):
            desc[HEAD_WORDS + o * _OPERAND_WORDS] = x.data_ptr()
    desc[4] = int(vec is not None and all(kops[o].data_ptr() % ALIGN == 0 for o in vec))
    dev = a.device.index
    lib = _library()
    rc = lib.hhe_mont(desc, dev, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.hhe_mont_error_string(rc).decode()})")
    LAUNCHES[name] += 1
    if name == "mont_mac":
        FORM_LAUNCHES[form] += 1
    return out


def mont_mul(a, b_mont, q, qinv_neg) -> torch.Tensor:
    """K3: a * b_mont * 2^-32 mod q in [0, q), over the broadcast shape."""
    return _run("mont_mul", a, b_mont, q, qinv_neg, None, False)


def mont_mul_lazy(a, b_mont, q, qinv_neg) -> torch.Tensor:
    """K3 without the final subtract: [0, 2q)."""
    return _run("mont_mul", a, b_mont, q, qinv_neg, None, True)


def mont_mac(a, b_mont, q, qinv_neg, dim: int, fan_out: bool = True) -> torch.Tensor:
    """K4: sum over axis ``dim`` of the broadcast shape of
    mont_mul(a, b_mont) mod q, in [0, q), the axis removed; q and qinv_neg
    must not vary along it.  ``fan_out=False`` keeps the general form (for
    timing one form against another)."""
    return _run("mont_mac", a, b_mont, q, qinv_neg, dim, False, fan_out)


def reset_launches():
    for counts in (LAUNCHES, FORM_LAUNCHES):
        for key in counts:
            counts[key] = 0
