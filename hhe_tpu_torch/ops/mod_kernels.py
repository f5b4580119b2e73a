"""Hand-written CUDA kernels for modular arithmetic on RNS residues,
``csrc/modarith.cu``, and their wrappers: the Montgomery product (K3), the
Montgomery multiply-accumulate (K4), the modular add / sub / neg and the
three-subtract reduction (K5 ``mod_elem``) and the divide-and-round by the
special prime (K6 ``mod_down``).

The JAX package has no Pallas kernel for any of them: XLA fuses each chain
of ``hhe_tpu.ops.modular.mont_mul`` (and of ``tree_add_mod`` over its
products), of ``add_mod`` / ``sub_mod`` / ``neg_mod``, of
``hhe_tpu.ops.rns.reduce_u32`` and of ``hhe_tpu.ops.bfv_eval.mod_down``
into one loop over the data.  Here each is one launch that keeps its
intermediates in registers, where the plain PyTorch versions
(``modular.*_plain``, ``rns.reduce_u32_plain``,
``bfv_eval.mod_down_plain``) take 5-29 int64 passes.  ``modular.mont_mul``
/ ``mont_mul_lazy`` / ``mont_mac`` / ``add_mod`` / ``sub_mod`` /
``neg_mod``, ``rns.reduce_u32`` and ``bfv_eval.mod_down`` send a CUDA tensor
here and a CPU tensor to the plain versions.  The source is built like
``csrc/ntt.cu`` (``ntt_kernels.build``): with ``nvcc`` at first use into
``build/hhe_tpu_torch/``, keyed by a hash of the source, and loaded with
ctypes.

The K3-K5 wrappers take what the plain versions take: a tensor ``a`` (int32
or int64; the output has its dtype), and the other operands as int32 or
int64 tensors that broadcast against it, or as Python ints below 2^32.
Values are read as u32 bit patterns (an int64 by its low 32 bits), which the
plain versions' int64 arithmetic equals for operands in [0, 2^31) (K5's sub
and neg: below their row's q as well).  A broadcast operand reaches the
kernel as strides of 0, never materialised; the output's shape is collapsed
to at most ``MAX_DIMS`` dimensions.  A tensor on the CPU, another dtype,
shapes that do not broadcast, moduli that vary along the reduction axis, or
a shape that does not collapse to ``MAX_DIMS`` dimensions raise; nothing
falls back to the plain version.  K6 takes c [..., k + 1, N] (int32 or
int64, leading dimensions collapsing to ``MAX_LEAD``) and four [k, 1]
constant columns.  ``LAUNCHES`` counts the launches of each kernel,
``FORM_LAUNCHES`` K4's by form, ``OP_LAUNCHES`` K5's by op.

K4 takes one of four forms by layout (``plan``): where one multiplicand is
broadcast over an output axis along which the other varies (a key-switch's
k0/k1 pair, the BSGS babysteps and giantsteps, a base conversion's output
moduli), the kernel reads the shared one once for every output of that
axis and streams the other ("fanout", staged in shared memory;
"fanout_regs", up to four outputs summed in registers where the staged
tile would be too large; "table" where the streamed one is a constant per
word row, as a base conversion's, held as Shoup pairs); other layouts take
the one-pass loop ("general").  K5 (``elem_plan``) walks, in each thread,
the largest output axis that a and b are both broadcast over (a digit
decomposition's moduli), so its input is read once for all of its outputs.
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

# K5's ops (csrc/modarith.cu ElemOp) and its operands' names in messages
ELEM_OPS = ("add", "sub", "neg", "reduce")
ELEM_NAMES = ("a", "b", "q", "unused")
# K6: c's leading dimensions after the collapse (csrc/modarith.cu MAXL), its
# constant columns, and its descriptor (HEAD 9, c 3, the leading dimensions'
# sizes and strides, 3 words a column)
MAX_LEAD = MAX_DIMS - 2
DOWN_NAMES = ("q", "qinv_neg", "p_mod_q", "p_inv_mont")
_DOWN_C = 9  # the descriptor's first word of c
DOWN_DESC_WORDS = _DOWN_C + 3 + 2 * MAX_LEAD + 3 * len(DOWN_NAMES)

# K3 (eager and lazy), K4, K5 and K6; K4's launches by form, K5's by op
LAUNCHES = {"mont_mul": 0, "mont_mac": 0, "mod_elem": 0, "mod_down": 0}
FORM_LAUNCHES = dict.fromkeys(FORMS, 0)
OP_LAUNCHES = dict.fromkeys(ELEM_OPS, 0)

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
            lib.hhe_mod_elem.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
            lib.hhe_mod_elem.restype = ctypes.c_int
            lib.hhe_mod_down.argtypes = lib.hhe_mont.argtypes
            lib.hhe_mod_down.restype = ctypes.c_int
            lib.hhe_mont_desc_words.restype = ctypes.c_int
            lib.hhe_mod_down_desc_words.restype = ctypes.c_int
            lib.hhe_mont_error_string.argtypes = [ctypes.c_int]
            lib.hhe_mont_error_string.restype = ctypes.c_char_p
            if (lib.hhe_mont_desc_words(), lib.hhe_mod_down_desc_words()) != (DESC_WORDS, DOWN_DESC_WORDS):
                raise RuntimeError("csrc/modarith.cu and mod_kernels disagree on the descriptors")
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


def _check(ops, names=NAMES, what="Montgomery kernels"):
    """Raise unless ops[0] is a tensor and every operand an int32 / int64
    tensor or a Python int below 2^32."""
    if not isinstance(ops[0], torch.Tensor):
        raise TypeError(f"{names[0]} must be a tensor, got {type(ops[0]).__name__}")
    for name, x in zip(names, ops):
        if isinstance(x, torch.Tensor):
            if x.dtype not in (torch.int32, torch.int64):
                raise TypeError(f"{name}: {what} take int32 or int64, got {x.dtype}")
        elif isinstance(x, (int, np.integer)) and not isinstance(x, bool):
            if not 0 <= int(x) < 1 << 32:
                raise ValueError(f"{name} = {int(x)} is not a u32 value")
        else:
            raise TypeError(f"{name} must be a tensor or an int, got {type(x).__name__}")


def _collapse(dims):
    """[(size, [each operand's stride])], outermost first, with size-1
    dimensions dropped and each dimension merged into the next inner one
    where every operand's strides let it."""
    out = []
    for size, st in dims:
        if size == 1:
            continue
        if out and all(ps == s * size for ps, s in zip(out[-1][1], st)):
            out[-1] = (out[-1][0] * size, st)
        else:
            out.append((size, st))
    return out


def _layout(ops, dim: Optional[int]):
    """(broadcast shape, each operand's strides over it, the output's shape,
    collapsed dimensions [(size, strides of each operand, output stride)],
    the reduced axis) of `ops` with axis `dim` (or None) reduced: every
    dimension merged into the next inner one where each operand's strides
    let it (the output is contiguous), size-1 dimensions dropped."""
    tensors = [x for x in ops if isinstance(x, torch.Tensor)]
    try:
        full = tuple(torch.broadcast_shapes(*(x.shape for x in tensors)))
    except RuntimeError as e:
        raise ValueError(f"operands do not broadcast: {[tuple(x.shape) for x in tensors]}") from e
    nd = len(full)
    red = None
    if dim is not None:
        if not -nd <= dim < nd:
            raise ValueError(f"reduction axis {dim} out of range for {nd} dimensions")
        red = dim % nd
    strides = [x.expand(full).stride() if isinstance(x, torch.Tensor) else (0,) * nd
               for x in ops]
    shape = tuple(s for i, s in enumerate(full) if i != red)
    dims = _collapse([(size, [s[i] for s in strides]) for i, size in enumerate(full) if i != red])
    if len(dims) > MAX_DIMS:
        raise ValueError(f"{len(dims)} dimensions do not collapse to {MAX_DIMS}: {full}")
    ostrides, outer = [], 1  # the output's, contiguous over the collapsed sizes
    for size, _ in reversed(dims):
        ostrides.append(outer)
        outer *= size
    dims = [(size, st, os) for (size, st), os in zip(dims, reversed(ostrides))]
    return full, strides, shape, dims, red


_ONE = (1, [0] * 4, 0)  # a dimension of size 1


def _operands(ops, order, dims, strides, red):
    return tuple(
        (ops[o] if isinstance(ops[o], torch.Tensor) else None,
         0 if isinstance(ops[o], torch.Tensor) else int(ops[o]),
         tuple(st[o] for _, st, _ in dims),
         strides[o][red] if red is not None else 0)
        for o in order
    )


def plan(a, b, q, qinv_neg, dim: Optional[int] = None, fan_out: bool = True) -> Plan:
    """Check the operands and lay them out for the kernel; reduce over
    ``dim`` of their broadcast shape (K4) or over nothing (K3).  K4 takes a
    fan-out form where the layout has one (``_fan_out``) unless ``fan_out``
    is False.  Raises on anything the kernel does not take except the
    device (``_run`` checks that on every call)."""
    ops = (a, b, q, qinv_neg)
    _check(ops)
    full, strides, shape, dims, red = _layout(ops, dim)
    terms = 1
    if red is not None:
        terms = full[red]
        if terms < 1:
            raise ValueError("empty reduction axis")
        if terms > 1 and (strides[2][red] or strides[3][red]):
            raise ValueError("the moduli must not vary along the reduction axis")
    order, form = (0, 1, 2, 3), "general"
    fan = _fan_out([(n, st) for n, st, _ in dims], ops, terms) if red is not None and fan_out else None
    if fan is None:
        dims = [_ONE] * (MAX_DIMS - len(dims)) + dims
    else:
        i, s, form = fan
        order = (s, 1 - s, 2, 3)
        rest = [d for n, d in enumerate(dims[:-1]) if n != i]
        rest.sort(key=lambda d: d[1][1 - s] == 0)  # rows W is broadcast over run fastest
        dims = [dims[i]] + [_ONE] * (MAX_DIMS - len(dims)) + rest + [dims[-1]]
    sizes = tuple(n for n, _, _ in dims)
    threads = 256 if red is None else _threads(form, sizes, terms)
    return Plan(shape, sizes, tuple(os for _, _, os in dims), _operands(ops, order, dims, strides, red),
                order, terms, form, threads)


def _row_threads(rows: int, inner: int) -> int:
    """The most threads a block (256, 128, 64) that leave a launch of `rows`
    rows of `inner` words, 4 words a thread, at least MIN_BLOCKS blocks;
    else 64."""
    for t in (256, 128, 64):
        if rows * -(-inner // (4 * t)) >= MIN_BLOCKS:
            return t
    return 64


def elem_plan(a, b, q) -> Plan:
    """K5's layout of ``a op b mod q`` (b 0 for neg and reduce): the
    collapsed dimensions with the fan-out first -- the largest dimension
    that a and b are both broadcast over (the moduli of a digit
    decomposition), which a thread walks after one read of a and b -- or a
    fan-out of 1; ``form`` "general", one term.  Raises as ``plan``."""
    ops = (a, b, q, 0)
    _check(ops, ELEM_NAMES, "modular kernels")
    _, strides, shape, dims, _ = _layout(ops, None)
    fans = [i for i, (n, st, _) in enumerate(dims[:-1]) if not st[0] and not st[1]]
    if fans:
        i = max(fans, key=lambda i: dims[i][0])
        dims = [dims[i]] + [_ONE] * (MAX_DIMS - len(dims)) + [d for n, d in enumerate(dims) if n != i]
    else:
        dims = [_ONE] * (MAX_DIMS - len(dims)) + dims
    sizes = tuple(n for n, _, _ in dims)
    return Plan(shape, sizes, tuple(os for _, _, os in dims),
                _operands(ops, (0, 1, 2, 3), dims, strides, None), (0, 1, 2, 3), 1, "general",
                _row_threads(int(np.prod(sizes[1:-1])), sizes[-1]))


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


def _check_device(a, ops, what):
    if a.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {a.device}")
    for x in ops:
        if isinstance(x, torch.Tensor) and x.device != a.device:
            raise ValueError(f"operands on several devices: {a.device} and {x.device}")


def _launched(name: str, rc: int, lib):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.hhe_mont_error_string(rc).decode()})")
    LAUNCHES[name] += 1


def _run(name: str, a, b, q, qinv_neg, dim, lazy: bool, fan_out: bool = True,
         op: Optional[str] = None) -> torch.Tensor:
    """Check (or find checked) the layout, then launch on a's device and
    current stream: K3 / K4 (``hhe_mont``), or K5 (``hhe_mod_elem``) where
    `op` names one of ``ELEM_OPS``.  The wrapper runs on every call, so a
    layout is planned once and kept."""
    ops = (a, b, q, qinv_neg)
    key = (name, dim, lazy, fan_out, *map(_layout_key, ops))
    hit = _PLANS.get(key)
    if hit is None:
        p = elem_plan(a, b, q) if op is not None else plan(a, b, q, qinv_neg, dim, fan_out)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        hit = _PLANS[key] = (p.shape, _descriptor(p, lazy, a.dtype), p.order, _vector_operands(p),
                             p.form)
    shape, static, order, vec, form = hit
    _check_device(a, ops[1:], f"{name} kernel")
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    if op is not None:
        _launched(name, lib.hhe_mod_elem(desc, ELEM_OPS.index(op), dev, stream), lib)
        OP_LAUNCHES[op] += 1
    else:
        _launched(name, lib.hhe_mont(desc, dev, stream), lib)
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


def mod_elem(op: str, a, b, q) -> torch.Tensor:
    """K5, one launch: ``op`` ("add", "sub", "neg" or "reduce") of a (and b)
    modulo q over the broadcast shape, in u32 arithmetic, a's dtype: a + b
    less q if >= q; a - b, plus q if a < b; q - a unless a = 0; a less q
    three times where >= q."""
    return _run("mod_elem", a, b, q, 0, None, False, op=op)


class DownPlan(NamedTuple):
    """K6's launch for c [..., k + 1, N]: the output's shape; k, N; c's
    limb and innermost strides; c's leading sizes and strides, collapsed
    to ``MAX_LEAD`` (the output's rows, in order); the four [k, 1]
    constant columns (q, qinv, P mod q, Mont(P^-1 mod q)) and their limb
    strides; p_half; a block's threads; the limb groups over the grid's
    third axis; whether the layout allows the 16-byte path."""

    shape: Tuple[int, ...]
    k: int
    inner: int
    limb_stride: int
    inner_stride: int
    lead_sizes: Tuple[int, ...]
    lead_strides: Tuple[int, ...]
    cols: Tuple[torch.Tensor, ...]
    col_strides: Tuple[int, ...]
    p_half: int
    threads: int
    zsplit: int
    vec: bool


def down_plan(c, q, qinv_neg, p_mod_q, p_inv_mont, p_half) -> DownPlan:
    """Check K6's operands and lay them out; raises on anything the kernel
    does not take except the device."""
    if not isinstance(c, torch.Tensor) or c.dtype not in (torch.int32, torch.int64) or c.dim() < 2:
        raise TypeError("c must be an int32 or int64 tensor [..., k + 1, N]")
    k, inner = c.shape[-2] - 1, c.shape[-1]
    if k < 1 or inner < 1:
        raise ValueError(f"c {tuple(c.shape)} has no data limb or no word")
    cols = (q, qinv_neg, p_mod_q, p_inv_mont)
    for name, x in zip(DOWN_NAMES, cols):
        if not isinstance(x, torch.Tensor) or x.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be an int32 or int64 tensor")
        if tuple(x.shape) != (k, 1):
            raise ValueError(f"{name} {tuple(x.shape)} is not a [{k}, 1] column")
    if isinstance(p_half, bool) or not isinstance(p_half, (int, np.integer)) or not 0 <= p_half < 1 << 32:
        raise ValueError(f"p_half = {p_half!r} is not a u32 value")
    lead = _collapse([(n, [st]) for n, st in zip(c.shape[:-2], c.stride()[:-2])])
    lead = [(n, st) for n, (st,) in lead]
    if len(lead) > MAX_LEAD:
        raise ValueError(f"c's leading dimensions do not collapse to {MAX_LEAD}: {tuple(c.shape)}")
    lead = [(1, 0)] * (MAX_LEAD - len(lead)) + lead
    rows = int(np.prod([n for n, _ in lead]))
    threads = _row_threads(rows, inner)
    blocks = rows * -(-inner // (4 * threads))
    limb_stride, inner_stride = c.stride(-2), c.stride(-1)
    vec = (inner % 4 == 0 and inner_stride == 1 and limb_stride % 4 == 0
           and all(st % 4 == 0 for _, st in lead))
    return DownPlan((*c.shape[:-2], k, inner), k, inner, limb_stride, inner_stride,
                    tuple(n for n, _ in lead), tuple(st for _, st in lead), cols,
                    tuple(x.stride(0) for x in cols), int(p_half), threads,
                    min(k, max(1, -(-MIN_BLOCKS // blocks))), vec)


_DownDesc = ctypes.c_longlong * DOWN_DESC_WORDS
_DOWN_PLANS = {}


def _down_descriptor(p: DownPlan, dtype) -> "ctypes.Array":
    """``hhe_mod_down``'s descriptor for plan `p`, pointers and vec left 0."""
    words = [0, int(dtype == torch.int64), 0, p.threads, p.zsplit, p.k, p.inner, p.limb_stride,
             p.p_half, 0, int(dtype == torch.int64), p.inner_stride, *p.lead_sizes, *p.lead_strides]
    for x, st in zip(p.cols, p.col_strides):
        words += [0, int(x.dtype == torch.int64), st]
    return _DownDesc(*words)


def mod_down(c, q, qinv_neg, p_mod_q, p_inv_mont, p_half) -> torch.Tensor:
    """K6, one launch: divide-and-round by the special prime P of c [..., k
    + 1, N] (row k: the residues mod P) -> [..., k, N] over q, c's dtype
    (``bfv_eval.mod_down_plain``'s bits).  q, qinv_neg, p_mod_q (P mod q)
    and p_inv_mont (Mont(P^-1 mod q)) are [k, 1] columns, p_half = P // 2."""
    cols = (q, qinv_neg, p_mod_q, p_inv_mont)
    key = (_layout_key(c), *map(_layout_key, cols), p_half)
    hit = _DOWN_PLANS.get(key)
    if hit is None:
        p = down_plan(c, *cols, p_half)
        if len(_DOWN_PLANS) >= _MAX_PLANS:
            _DOWN_PLANS.clear()
        hit = _DOWN_PLANS[key] = (p.shape, _down_descriptor(p, c.dtype), p.vec)
    shape, static, vec = hit
    _check_device(c, cols, "mod_down kernel")
    out = torch.empty(shape, dtype=c.dtype, device=c.device)
    if out.numel() == 0:
        return out
    desc = _DownDesc.from_buffer_copy(static)
    desc[0] = out.data_ptr()
    desc[2] = int(vec and c.data_ptr() % ALIGN == 0)
    desc[_DOWN_C] = c.data_ptr()
    for o, x in enumerate(cols):
        desc[_DOWN_C + 3 + 2 * MAX_LEAD + 3 * o] = x.data_ptr()
    dev = c.device.index
    lib = _library()
    _launched("mod_down", lib.hhe_mod_down(desc, dev, torch.cuda.current_stream(dev).cuda_stream), lib)
    return out


def reset_launches():
    for counts in (LAUNCHES, FORM_LAUNCHES, OP_LAUNCHES):
        for key in counts:
            counts[key] = 0
