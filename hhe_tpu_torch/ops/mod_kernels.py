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
``FORM_LAUNCHES`` K4's by form, ``OP_LAUNCHES`` K5's by mode and
``DOWN_LAUNCHES`` K6's by the addends it took.

K5's modes beyond the elementwise ops: ``mod_gather`` reads a through an
int32 index along the last axis (one row of indices, or one a leading
index), negating mod q where a bool mask is set -- a galois permutation;
``mod_sum`` sums an axis mod q, each term through its own index row where
given -- the BSGS giantstep sums; ``mod_center`` lifts a centred residue
mod m to q -- BEHZ's two ``where``s.  K6 takes up to two ``Addend``s, each
added to the output rows its first axis covers (one read through a galois
permutation), and an ``out`` slice.  An index's values are checked once a
tensor (``_index_in_range``).  K3-K6 write into a caller's contiguous
``out`` where given (the stacks of the BSGS and the tensor product).

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
import weakref
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

# K5's modes, as OP_LAUNCHES counts them: the elementwise ops, the centred
# lift, a read through an index (signed where a mask is given) and a sum
# over an axis; the csrc/modarith.cu ElemOp each launches; its operands'
# names in messages (a, b, q, CENTER's threshold, the index, the mask)
ELEM_OPS = ("add", "sub", "neg", "reduce", "center", "gather", "sum")
_ELEM_KOP = {"add": 0, "sub": 1, "neg": 2, "reduce": 3, "center": 4, "gather": 5, "sum": 0}
ELEM_NAMES = ("a", "b", "q", "half", "idx", "sign")
ELEM_DESC_WORDS = HEAD_WORDS + len(ELEM_NAMES) * (4 + MAX_DIMS) + 2 * MAX_DIMS
# a launch with fewer blocks than MIN_BLOCKS (one ciphertext) splits K5's
# fan-out / K6's limbs over the grid's third axis up to about this many
# blocks: 16 of 64 threads on each of the 132 SMs
FILL_BLOCKS = 132 * 16
# K6: c's leading dimensions after the collapse (csrc/modarith.cu MAXL), its
# constant columns, its addends, and its descriptor (HEAD 9, c 3, the
# leading dimensions' sizes and strides, 3 words a column, ADD_WORDS an
# addend)
MAX_LEAD = MAX_DIMS - 2
DOWN_NAMES = ("q", "qinv_neg", "p_mod_q", "p_inv_mont")
MAX_ADDENDS = 2
_DOWN_C = 9  # the descriptor's first word of c
_ADD_WORDS = 8 + MAX_LEAD
_DOWN_ADD = _DOWN_C + 3 + 2 * MAX_LEAD + 3 * len(DOWN_NAMES)  # the first addend's word
DOWN_DESC_WORDS = _DOWN_ADD + MAX_ADDENDS * _ADD_WORDS
# K6's launches by the addends they took
DOWN_FORMS = ("bare", "one_addend", "two_addends")

# K3 (eager and lazy), K4, K5 and K6; K4's launches by form, K5's by mode,
# K6's by addends
LAUNCHES = {"mont_mul": 0, "mont_mac": 0, "mod_elem": 0, "mod_down": 0}
FORM_LAUNCHES = dict.fromkeys(FORMS, 0)
OP_LAUNCHES = dict.fromkeys(ELEM_OPS, 0)
DOWN_LAUNCHES = dict.fromkeys(DOWN_FORMS, 0)

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
            for fn in (lib.hhe_mont_desc_words, lib.hhe_mod_elem_desc_words, lib.hhe_mod_down_desc_words):
                fn.restype = ctypes.c_int
            lib.hhe_mont_error_string.argtypes = [ctypes.c_int]
            lib.hhe_mont_error_string.restype = ctypes.c_char_p
            if (lib.hhe_mont_desc_words(), lib.hhe_mod_elem_desc_words(),
                    lib.hhe_mod_down_desc_words()) != (DESC_WORDS, ELEM_DESC_WORDS, DOWN_DESC_WORDS):
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
    zsplit: int = 1  # K5: the fan-out's split over the grid's third axis


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


def _collapse(dims, keep_inner: bool = False):
    """[(size, [each operand's stride])], outermost first, with size-1
    dimensions dropped and each dimension merged into the next inner one
    where every operand's strides let it (the innermost left alone with
    `keep_inner`: a gather's index counts from the start of its row)."""
    out = []
    last = len(dims) - 1
    for d, (size, st) in enumerate(dims):
        if size == 1 and not (keep_inner and d == last):
            continue
        if out and not (keep_inner and d == last) and all(ps == s * size for ps, s in zip(out[-1][1], st)):
            out[-1] = (out[-1][0] * size, st)
        else:
            out.append((size, st))
    return out


def _layout(ops, dim: Optional[int], keep_inner: bool = False):
    """(broadcast shape, each operand's strides over it, the output's shape,
    collapsed dimensions [(size, strides of each operand, output stride)],
    the reduced axis) of `ops` with axis `dim` (or None) reduced: every
    dimension merged into the next inner one where each operand's strides
    let it (the output is contiguous), size-1 dimensions dropped (the
    innermost kept whole with `keep_inner`)."""
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
    dims = _collapse([(size, [s[i] for s in strides]) for i, size in enumerate(full) if i != red],
                     keep_inner)
    if len(dims) > MAX_DIMS:
        raise ValueError(f"{len(dims)} dimensions do not collapse to {MAX_DIMS}: {full}")
    ostrides, outer = [], 1  # the output's, contiguous over the collapsed sizes
    for size, _ in reversed(dims):
        ostrides.append(outer)
        outer *= size
    dims = [(size, st, os) for (size, st), os in zip(dims, reversed(ostrides))]
    return full, strides, shape, dims, red


_ONE = (1, [0] * len(ELEM_NAMES), 0)  # a dimension of size 1


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


def _zsplit(rows: int, inner: int, threads: int, walk: int) -> int:
    """How many blocks share the `walk` rows a thread walks (K5's fan-out,
    K6's limbs): 1 where the launch has MIN_BLOCKS blocks without it, else
    enough to reach FILL_BLOCKS (one ciphertext: a launch too small to fill
    the card otherwise)."""
    blocks = rows * -(-inner // (4 * threads))
    if blocks >= MIN_BLOCKS:
        return 1
    return max(1, min(walk, -(-FILL_BLOCKS // blocks), 65535))


def _check_out(out, shape, dtype, device, what):
    """Raise unless `out` is a contiguous tensor of `shape` and `dtype` on
    `device` (a caller's slice the kernel writes into)."""
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"{what}: out must be a tensor, got {type(out).__name__}")
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype:
        raise ValueError(f"{what}: out {tuple(out.shape)} {out.dtype} is not {tuple(shape)} {dtype}")
    if not out.is_contiguous():
        raise ValueError(f"{what}: out must be contiguous")
    if out.device != device:
        raise ValueError(f"{what}: out on {out.device}, operands on {device}")


def _check_index(idx, sign, rows: int):
    """Raise unless idx is None or an int32 tensor and sign None or a bool
    tensor, idx's values in [0, rows) (a gather's source row length)."""
    if idx is not None:
        if not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32:
            raise TypeError(f"idx must be an int32 tensor, got "
                            f"{idx.dtype if isinstance(idx, torch.Tensor) else type(idx).__name__}")
    if sign is not None:
        if not isinstance(sign, torch.Tensor) or sign.dtype != torch.bool:
            raise TypeError(f"sign must be a bool tensor, got "
                            f"{sign.dtype if isinstance(sign, torch.Tensor) else type(sign).__name__}")
    if sign is not None and idx is None:
        raise ValueError("a sign mask comes with an index")
    if idx is not None:
        _index_in_range(idx, rows)


_INDEX_OK = {}  # id(idx) -> (weakref to idx, its version, the row length it was checked against)


def _index_in_range(idx: torch.Tensor, rows: int):
    """Raise unless every value of `idx` lies in [0, rows).  The check reads
    the values back (a synchronisation), once per index tensor and version:
    index tables are device constants, first met in a unit's eager warm-up,
    never first inside a graph capture."""
    hit = _INDEX_OK.get(id(idx))
    if hit is not None and hit[0]() is idx and hit[1:] == (idx._version, rows):
        return
    if idx.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("an index met first inside a graph capture cannot be range-checked")
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= rows:
            raise ValueError(f"index values [{lo}, {hi}] fall outside [0, {rows})")
    if len(_INDEX_OK) >= _MAX_PLANS:
        _INDEX_OK.clear()
    _INDEX_OK[id(idx)] = (weakref.ref(idx), idx._version, rows)


def elem_plan(a, b, q, half: int = 0, idx=None, sign=None, dim: Optional[int] = None) -> Plan:
    """K5's layout of ``a op b mod q`` (b 0 for neg, reduce, gather and sum),
    a read through ``idx`` along the innermost axis where given (``sign``
    marking the words negated mod q) and summed over axis ``dim`` where
    given: the collapsed dimensions with the fan-out first -- the largest
    dimension that a and b are both broadcast over (the moduli of a digit
    decomposition), which a thread walks after one read of a and b, or for
    a gather the largest that the index and mask are broadcast over (every
    limb of a galois permutation), or a fan-out of 1 -- and the blocks that
    share it; ``form`` "general".  Raises as ``plan``; the index's values
    are checked by ``_index_in_range``, on every call."""
    ops = (a, b, q, half, 0 if idx is None else idx, 0 if sign is None else sign)
    _check(ops[:4], ELEM_NAMES, "modular kernels")
    _check_index(idx, sign, a.shape[-1] if a.dim() else 0)
    if idx is not None and (idx.dim() < 1 or idx.shape[-1] != a.shape[-1]):
        raise ValueError(f"idx {tuple(idx.shape)} does not index rows of {a.shape[-1]} words")
    full, strides, shape, dims, red = _layout(ops, dim, keep_inner=idx is not None)
    terms = 1
    if red is not None:
        terms = full[red]
        if terms < 1 or terms >= MAX_FAN_TERMS:
            raise ValueError(f"a sum over {terms} terms")
        if strides[2][red]:
            raise ValueError("the moduli must not vary along the reduction axis")
    fans = [i for i, (n, st, _) in enumerate(dims[:-1]) if not st[0] and not st[1]]
    if not fans and idx is not None:
        fans = [i for i, (n, st, _) in enumerate(dims[:-1]) if not st[4] and not st[5]]
    if fans:
        i = max(fans, key=lambda i: dims[i][0])
        dims = [dims[i]] + [_ONE] * (MAX_DIMS - len(dims)) + [d for n, d in enumerate(dims) if n != i]
    else:
        dims = [_ONE] * (MAX_DIMS - len(dims)) + dims
    sizes = tuple(n for n, _, _ in dims)
    rows = int(np.prod(sizes[1:-1]))
    threads = _row_threads(rows, sizes[-1])
    return Plan(shape, sizes, tuple(os for _, _, os in dims),
                _operands(ops, tuple(range(len(ELEM_NAMES))), dims, strides, red),
                tuple(range(len(ELEM_NAMES))), terms, "general", threads,
                _zsplit(rows, sizes[-1], threads, sizes[0]))


_Desc = ctypes.c_longlong * DESC_WORDS
_ElemDesc = ctypes.c_longlong * ELEM_DESC_WORDS
_OPERAND_WORDS = 4 + MAX_DIMS  # ptr, is64, scalar, rstride, strides
# checked layouts: key -> (output shape, descriptor without pointers, the
# kernel operands' indices in the caller's operands, the kernel operands
# the vector path needs aligned or None where it does not apply, the form)
_PLANS = {}
_MAX_PLANS = 4096


def _layout_key(x):
    if isinstance(x, torch.Tensor):
        return x.shape, x.stride(), x.dtype
    return type(x), x


def _descriptor(p: Plan, lazy: bool, dtype, elem: bool = False) -> "ctypes.Array":
    """``hhe_mont``'s (``hhe_mod_elem``'s where `elem`) descriptor for plan
    `p`, pointers and vec left 0."""
    words = [0, int(dtype == torch.int64), int(lazy), p.terms, 0,
             p.zsplit if elem else FORMS.index(p.form), p.threads]
    for x, scalar, st, rst in p.operands:
        words += [0, int(x is not None and x.dtype == torch.int64), scalar, rst, *st]
    return (_ElemDesc if elem else _Desc)(*words, *p.sizes, *p.ostrides)


def _vector_operands(p: Plan):
    """The kernel operands whose pointers must be ALIGN-byte aligned for the
    kernel's vector path (groups of 4 consecutive words), or None where the
    layout does not allow it: the row a multiple of 4 words, every operand
    broadcast over the innermost axis or contiguous along it with outer and
    reduction strides that are multiples of 4.  K5's gathered a and its
    mask are read a word at a time (the mask must run along the row)."""
    if p.sizes[-1] % 4:
        return None
    gathered = len(p.operands) > 4 and p.operands[4][0] is not None
    need = []
    for o, (x, _, st, rst) in enumerate(p.operands):
        if x is None or st[-1] == 0 or (o == 0 and gathered):
            continue
        if o == 5:
            if st[-1] != 1:
                return None
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
         op: Optional[str] = None, half: int = 0, idx=None, sign=None, out=None) -> torch.Tensor:
    """Check (or find checked) the layout, then launch on a's device and
    current stream: K3 / K4 (``hhe_mont``), or K5 (``hhe_mod_elem``) where
    `op` names one of ``ELEM_OPS``; into ``out`` (a contiguous tensor of the
    output's shape and a's dtype, the caller's slice) where given.  The
    wrapper runs on every call, so a layout is planned once and kept."""
    ops = (a, b, q, qinv_neg) if op is None else (a, b, q, half, idx, sign)
    key = (name, op, dim, lazy, fan_out, *map(_layout_key, ops))
    hit = _PLANS.get(key)
    if hit is None:
        if op is None:
            p = plan(a, b, q, qinv_neg, dim, fan_out)
        else:
            p = elem_plan(a, b, q, half, idx, sign, dim)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        hit = _PLANS[key] = (p.shape, _descriptor(p, lazy, a.dtype, op is not None), p.order,
                             _vector_operands(p), p.form)
    elif idx is not None:
        _index_in_range(idx, a.shape[-1])
    shape, static, order, vec, form = hit
    if out is not None:
        _check_out(out, shape, a.dtype, a.device, f"{name} kernel")
    _check_device(a, ops[1:], f"{name} kernel")
    if out is None:
        out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    desc = (_ElemDesc if op is not None else _Desc).from_buffer_copy(static)
    desc[0] = out.data_ptr()
    kops = [ops[o] for o in order]
    for o, x in enumerate(kops):
        if isinstance(x, torch.Tensor):
            desc[HEAD_WORDS + o * _OPERAND_WORDS] = x.data_ptr()
    desc[4] = int(vec is not None and out.data_ptr() % ALIGN == 0
                  and all(kops[o].data_ptr() % ALIGN == 0 for o in vec))
    dev = a.device.index
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if op is not None:
        _launched(name, lib.hhe_mod_elem(desc, _ELEM_KOP[op], dev, stream), lib)
        OP_LAUNCHES[op] += 1
    else:
        _launched(name, lib.hhe_mont(desc, dev, stream), lib)
        if name == "mont_mac":
            FORM_LAUNCHES[form] += 1
    return out


def mont_mul(a, b_mont, q, qinv_neg, out=None) -> torch.Tensor:
    """K3: a * b_mont * 2^-32 mod q in [0, q), over the broadcast shape
    (into ``out`` where given, as every wrapper here)."""
    return _run("mont_mul", a, b_mont, q, qinv_neg, None, False, out=out)


def mont_mul_lazy(a, b_mont, q, qinv_neg) -> torch.Tensor:
    """K3 without the final subtract: [0, 2q)."""
    return _run("mont_mul", a, b_mont, q, qinv_neg, None, True)


def mont_mac(a, b_mont, q, qinv_neg, dim: int, fan_out: bool = True, out=None) -> torch.Tensor:
    """K4: sum over axis ``dim`` of the broadcast shape of
    mont_mul(a, b_mont) mod q, in [0, q), the axis removed; q and qinv_neg
    must not vary along it.  ``fan_out=False`` keeps the general form (for
    timing one form against another)."""
    return _run("mont_mac", a, b_mont, q, qinv_neg, dim, False, fan_out, out=out)


def mod_elem(op: str, a, b, q, out=None) -> torch.Tensor:
    """K5, one launch: ``op`` ("add", "sub", "neg" or "reduce") of a (and b)
    modulo q over the broadcast shape, in u32 arithmetic, a's dtype: a + b
    less q if >= q; a - b, plus q if a < b; q - a unless a = 0; a less q
    three times where >= q."""
    if op not in ELEM_OPS[:4]:
        raise ValueError(f"unknown op {op!r}")
    return _run("mod_elem", a, b, q, 0, None, False, op=op, out=out)


def mod_center(a, m_mod_q, q, half: int) -> torch.Tensor:
    """K5 "center": a (below 2^31, a residue mod m taken as centred: a >
    half stands for a - m) lifted to q: reduce(a, q), less m mod q where a >
    half -- the centred lift of BEHZ's conversions."""
    return _run("mod_elem", a, m_mod_q, q, 0, None, False, op="center", half=half)


def mod_gather(a, idx, q=None, sign=None) -> torch.Tensor:
    """K5 "gather": a read through ``idx`` (int32, values in [0, a's row
    length)) along the innermost axis, ``out[..., n] = a[..., idx[..., n]]``
    over the broadcast of a, idx and sign, negated mod q where ``sign``
    (bool) is set; one index row per leading index where idx has them."""
    if sign is not None and q is None:
        raise ValueError("a signed gather needs q")
    return _run("mod_elem", a, 0, 0 if q is None else q, 0, None, False, op="gather", idx=idx,
                sign=sign)


def mod_sum(a, q, dim: int, idx=None, sign=None) -> torch.Tensor:
    """K5 "sum": the sum mod q over axis ``dim`` of the broadcast of a (read
    through ``idx`` and negated where ``sign`` is set, each term through its
    own index row where idx varies along the axis), taken exactly in u64 and
    reduced once; the axis removed, q constant along it."""
    return _run("mod_elem", a, 0, q, 0, dim, False, op="sum", idx=idx, sign=sign)


class Addend(NamedTuple):
    """An addend of K6: ``x`` [C', ..., k, N] added, mod q, to the output
    rows whose first index is below C' (every row where the output has no
    leading axis), read through the [N] int32 ``idx`` and negated where the
    [N] bool ``sign`` is set where given (``mod_gather``'s meaning; a mask
    comes with an index)."""

    x: torch.Tensor
    idx: Optional[torch.Tensor] = None
    sign: Optional[torch.Tensor] = None


def addend(add) -> Addend:
    """An ``Addend`` from an Addend, an (x, idx, sign) tuple or a tensor."""
    if isinstance(add, torch.Tensor):
        return Addend(add)
    return Addend(*add)


class DownPlan(NamedTuple):
    """K6's launch for c [..., k + 1, N]: the output's shape; k, N; c's
    limb and innermost strides; c's leading sizes and strides, collapsed
    to ``MAX_LEAD`` (the output's rows, in order); the four [k, 1]
    constant columns (q, qinv, P mod q, Mont(P^-1 mod q)) and their limb
    strides; p_half; a block's threads; the limb groups over the grid's
    third axis; whether the layout allows the 16-byte path; per addend
    (x, idx, sign, innermost stride, limb stride, the output rows it covers,
    its strides over the leading sizes)."""

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
    adds: Tuple[tuple, ...] = ()


def _addend_strides(add: Addend, shape, k: int, inner: int):
    """(its strides over `shape` [..., k, N], the output rows it covers) of
    an addend of an output of `shape`; raises on what K6 does not take."""
    x, idx, sign = add
    if not isinstance(x, torch.Tensor) or x.dtype not in (torch.int32, torch.int64):
        raise TypeError("an addend must be an int32 or int64 tensor")
    _check_index(idx, sign, x.shape[-1] if x.dim() else 0)
    for name, t in (("idx", idx), ("sign", sign)):
        if t is not None and (tuple(t.shape) != (inner,) or not t.is_contiguous()):
            raise ValueError(f"an addend's {name} {tuple(t.shape)} is not a contiguous [{inner}] row")
    if x.dim() != len(shape) or x.shape[-1] != inner:
        raise ValueError(f"addend {tuple(x.shape)} does not match the output {tuple(shape)}")
    lead = len(shape) - 2
    cx = x.shape[0] if lead else 1
    if lead and not 1 <= cx <= shape[0]:
        raise ValueError(f"addend {tuple(x.shape)} has more rows than the output {tuple(shape)}")
    try:
        st = list(x.expand((cx, *shape[1:]) if lead else shape).stride())
    except RuntimeError as e:
        raise ValueError(f"addend {tuple(x.shape)} does not broadcast to {tuple(shape)}") from e
    if lead and cx == 1:  # never stepped along: the value that lets axis 0 merge
        st[0] = st[1] * shape[1] if lead > 1 else 0
    return st, cx * int(np.prod(shape[1:lead]))


def down_plan(c, q, qinv_neg, p_mod_q, p_inv_mont, p_half, adds=()) -> DownPlan:
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
    adds = tuple(addend(a) for a in adds)
    if len(adds) > MAX_ADDENDS:
        raise ValueError(f"{len(adds)} addends, K6 takes at most {MAX_ADDENDS}")
    shape = (*c.shape[:-2], k, inner)
    placed = [_addend_strides(a, shape, k, inner) for a in adds]
    nlead = c.dim() - 2
    lead = _collapse([(n, [c.stride(d)] + [st[d] for st, _ in placed])
                      for d, n in enumerate(c.shape[:-2])])
    if len(lead) > MAX_LEAD:
        raise ValueError(f"c's leading dimensions do not collapse to {MAX_LEAD}: {tuple(c.shape)}")
    lead = [(1, [0] * (1 + len(adds)))] * (MAX_LEAD - len(lead)) + lead
    rows = int(np.prod([n for n, _ in lead]))
    threads = _row_threads(rows, inner)
    limb_stride, inner_stride = c.stride(-2), c.stride(-1)
    vec = (inner % 4 == 0 and inner_stride == 1 and limb_stride % 4 == 0
           and all(st[0] % 4 == 0 for _, st in lead))
    padd = []
    for e, (a, (st, covered)) in enumerate(zip(adds, placed)):
        lst = tuple(s[1 + e] for _, s in lead)
        if a.idx is None and st[-1] != 0:
            vec = vec and st[-1] == 1 and st[-2] % 4 == 0 and all(x % 4 == 0 for x in lst)
        padd.append((a.x, a.idx, a.sign, st[-1], st[-2], covered if nlead else rows, lst))
    return DownPlan(shape, k, inner, limb_stride, inner_stride,
                    tuple(n for n, _ in lead), tuple(st[0] for _, st in lead), cols,
                    tuple(x.stride(0) for x in cols), int(p_half), threads,
                    min(k, _zsplit(rows, inner, threads, k)), vec, tuple(padd))


_DownDesc = ctypes.c_longlong * DOWN_DESC_WORDS
_DOWN_PLANS = {}


def _down_descriptor(p: DownPlan, dtype) -> "ctypes.Array":
    """``hhe_mod_down``'s descriptor for plan `p`, pointers and vec left 0."""
    words = [0, int(dtype == torch.int64), 0, p.threads, p.zsplit, p.k, p.inner, p.limb_stride,
             p.p_half, 0, int(dtype == torch.int64), p.inner_stride, *p.lead_sizes, *p.lead_strides]
    for x, st in zip(p.cols, p.col_strides):
        words += [0, int(x.dtype == torch.int64), st]
    for e in range(MAX_ADDENDS):
        if e < len(p.adds):
            x, _, _, ist, lst, covered, lead = p.adds[e]
            words += [0, int(x.dtype == torch.int64), ist, lst, covered, 0, 0, 0, *lead]
        else:
            words += [0] * _ADD_WORDS
    return _DownDesc(*words)


def mod_down(c, q, qinv_neg, p_mod_q, p_inv_mont, p_half, adds=(), out=None) -> torch.Tensor:
    """K6, one launch: divide-and-round by the special prime P of c [..., k
    + 1, N] (row k: the residues mod P) -> [..., k, N] over q, c's dtype
    (``bfv_eval.mod_down_plain``'s bits), plus up to two ``Addend``s (or
    tensors) mod q, into ``out`` (a contiguous tensor of the output's shape
    and c's dtype) where given.  q, qinv_neg, p_mod_q (P mod q) and
    p_inv_mont (Mont(P^-1 mod q)) are [k, 1] columns, p_half = P // 2."""
    cols = (q, qinv_neg, p_mod_q, p_inv_mont)
    adds = tuple(addend(a) for a in adds)
    key = (_layout_key(c), *map(_layout_key, cols), p_half,
           *((_layout_key(a.x), _layout_key(a.idx), _layout_key(a.sign)) for a in adds))
    hit = _DOWN_PLANS.get(key)
    if hit is None:
        p = down_plan(c, *cols, p_half, adds)
        if len(_DOWN_PLANS) >= _MAX_PLANS:
            _DOWN_PLANS.clear()
        hit = _DOWN_PLANS[key] = (p.shape, _down_descriptor(p, c.dtype), p.vec)
    else:
        for a in adds:
            if a.idx is not None:
                _index_in_range(a.idx, a.x.shape[-1])
    shape, static, vec = hit
    if out is not None:
        _check_out(out, shape, c.dtype, c.device, "mod_down kernel")
    _check_device(c, cols + tuple(t for a in adds for t in a), "mod_down kernel")
    if out is None:
        out = torch.empty(shape, dtype=c.dtype, device=c.device)
    if out.numel() == 0:
        return out
    desc = _DownDesc.from_buffer_copy(static)
    desc[0] = out.data_ptr()
    aligned = [c, out] + [t for a in adds for t in ((a.idx,) if a.idx is not None else (a.x,))]
    desc[2] = int(vec and all(t.data_ptr() % ALIGN == 0 for t in aligned))
    desc[_DOWN_C] = c.data_ptr()
    for o, x in enumerate(cols):
        desc[_DOWN_C + 3 + 2 * MAX_LEAD + 3 * o] = x.data_ptr()
    for e, a in enumerate(adds):
        base = _DOWN_ADD + e * _ADD_WORDS
        desc[base] = a.x.data_ptr()
        desc[base + 5] = 0 if a.idx is None else a.idx.data_ptr()
        desc[base + 6] = 0 if a.sign is None else a.sign.data_ptr()
    dev = c.device.index
    lib = _library()
    _launched("mod_down", lib.hhe_mod_down(desc, dev, torch.cuda.current_stream(dev).cuda_stream), lib)
    DOWN_LAUNCHES[DOWN_FORMS[len(adds)]] += 1
    return out


def reset_launches():
    for counts in (LAUNCHES, FORM_LAUNCHES, OP_LAUNCHES, DOWN_LAUNCHES):
        for key in counts:
            counts[key] = 0
