"""Frozen copies of ``chip_smoke.py``'s shape recorder and roofline
arithmetic, taken at commit d2108b4 (``chip_smoke.py`` lines 188-190, 870-
1046, 1073-1103, 1332-1344, 1511-1516 and 3034-3049), so that later
changes to ``chip_smoke.py`` do not move the benchmark's yardstick.

Changed from the originals: ``ShapeRecorder``'s patched wrappers also put,
the first time they see a layout, its least time on the card (``BOUNDS``,
ms) and its int32 multiplies (``MULTS``) under the same key as its calls;
the K5 / K6 bytes are those of ``chip_smoke.elem_entry``'s bound, read off
the call's own operands and output.  ``call_bound`` sums a K1 / K2 call's
launches.  Nothing of the phases that remake and time each layout is kept.
"""

from __future__ import annotations

import collections

import numpy as np

# H100 SXM peaks: HBM rate (NVIDIA data sheet), and 32-bit integer multiplies
# at 132 SMs x 64 INT32 lanes x 1.98 GHz (Hopper architecture white paper):
# a quarter of the 67 TFLOP/s float32 rate, which counts an FMA as two flops
# on 128 lanes per SM.  The multiply rate is derived, not published.
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9

# a device kernel's family in a profile, the first that matches its name: the
# port's kernels by their __global__ function (K3 and K4's forms are mont_*),
# then PyTorch's
KERNEL_FAMILIES = (("ntt", ("ntt_",)), ("mont", ("mont_",)), ("mod_elem", ("mod_elem_kernel", "mod_fused_kernel")),
                   ("mod_down", ("mod_down_kernel",)), ("index", ("index", "gather", "scatter")),
                   ("copy/cat", ("CatArray", "copy", "Copy")),
                   ("elementwise", ("elementwise", "reduce_kernel")))


def kernel_family(name: str) -> str:
    for fam, tags in KERNEL_FAMILIES:
        if any(tag in name for tag in tags):
            return fam
    return "other"


def bound(shape, moduli, stages, ninv, table_bytes=None):
    """Least time on the card (ms) for a pass over a [..., k, N] tensor: the
    larger of the bytes over the HBM rate and the multiplies over the int32
    multiply rate, and which of the two it is.  Bytes: the row tensor read
    and written once, plus `table_bytes` (by default one twiddle table and
    the per-limb constants).  Multiplies: 3 per butterfly (a Shoup product)
    of the `stages` stages and, with `ninv`, 3 per coefficient for N^-1."""
    n = shape[-1]
    nrows = int(np.prod(shape[:-1]))
    if table_bytes is None:
        table_bytes = 4 * len(moduli) * (n + 3)
    nbytes = 8 * nrows * n + table_bytes
    muls = 3 * nrows * (n // 2) * stages + (3 * nrows * n if ninv else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, muls / INT32_MUL_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def launch_bound(name, shape, moduli):
    """The bound of one launch of kernel `name`: the whole transform up to
    N = 16384; above it the top pass's log2 P stages (and N^-1 for the
    inverse's) or the tile kernel's other 14.  A top pass reads only the
    Shoup pairs of psi_br[1 .. P-1] and q per limb, and the inverse's also
    its two N^-1 pairs (``ntt.cu`` ``ntt_top``)."""
    logn = shape[-1].bit_length() - 1
    logp = max(0, logn - 14)
    if name.endswith("_top"):
        inv, k = name == "ntt_inv_top", len(moduli)
        table_bytes = 8 * k * ((1 << logp) - 1) + 4 * k + (16 * k if inv else 0)
        return bound(shape, moduli, logp, inv, table_bytes)
    return bound(shape, moduli, logn - logp, name == "ntt_inv" and logp == 0)


def call_bound(name, shape, moduli) -> float:
    """ms: one ``ntt_fwd`` / ``ntt_inv`` call, its top pass included where
    the row is longer than a tile."""
    ms = launch_bound(name, shape, moduli)[0]
    if shape[-1] > 16384:
        ms += launch_bound(name + "_top", shape, moduli)[0]
    return ms


def ntt_mults(name, shape) -> int:
    """int32 multiplies of one call: 3 a butterfly, and 3 a coefficient for
    the inverse's N^-1."""
    n = shape[-1]
    nrows = int(np.prod(shape[:-1]))
    return 3 * nrows * (n // 2) * (n.bit_length() - 1) + (3 * nrows * n if name == "ntt_inv" else 0)


def mont_bound(p, a, b, q, qi):
    """Least time on the card (ms) for one K3 / K4 launch of plan `p`: each
    tensor operand's distinct words read once and the output written once
    at the HBM rate, or three 32-bit multiplies a product at the int32
    multiply rate; and which of the two it is."""
    out = int(np.prod(p.shape))
    nbytes = out * a.element_size()
    for x in (a, b, q, qi):
        if hasattr(x, "stride"):
            nbytes += x.element_size() * int(np.prod([n for n, st in zip(x.shape, x.stride()) if st]))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * out * p.terms / INT32_MUL_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def words_bytes(x) -> int:
    """Bytes of a tensor's distinct elements (0 for a Python int)."""
    if not hasattr(x, "stride"):
        return 0
    return x.element_size() * int(np.prod([n for n, st in zip(x.shape, x.stride()) if st]))


def mont_layout(x):
    """A K3 / K4 operand as a key: a Python int, or the tensor's (shape,
    strides, dtype)."""
    if isinstance(x, (int, np.integer)):
        return int(x)
    return tuple(x.shape), tuple(x.stride()), str(x.dtype).split(".")[-1]


def index_layout(x):
    """An index or mask as a key: None, or its layout."""
    return None if x is None else mont_layout(x)


def elem_args(wrapper, args):
    """(mode, {a, b, q, half, idx, sign, dim}) of a call of a K5 wrapper
    (``mod_kernels.mod_elem`` / ``mod_center`` / ``mod_gather`` /
    ``mod_sum``) on positional `args`."""
    e = dict(b=0, half=0, idx=None, sign=None, dim=None)
    if wrapper == "mod_elem":
        mode, e["a"], e["b"], e["q"] = args
    elif wrapper == "mod_center":
        mode = "center"
        e["a"], e["b"], e["q"], e["half"] = args
    elif wrapper == "mod_gather":
        mode = "gather"
        a, idx, q, sign = (tuple(args) + (None, None))[:4]
        e.update(a=a, idx=idx, q=0 if q is None else q, sign=sign)
    else:
        mode = "sum"
        a, q, dim, idx, sign = (tuple(args) + (None, None))[:5]
        e.update(a=a, q=q, dim=dim, idx=idx, sign=sign)
    return mode, e


def _out_bytes(res) -> int:
    return res.numel() * res.element_size()


class ShapeRecorder:
    """Records the (shape, moduli) of every K1 / K2 call (``calls["ntt_fwd"]``,
    ``calls["ntt_inv"]``), the operand layout of every K3 / K4 call
    (``calls["mont"]``), of every K5 call (``calls["elem"]``) and of every
    K6 call (``calls["down"]``), without touching the wrappers' launch
    counts; ``BOUNDS[(name, key)]`` and ``MULTS[(name, key)]`` hold each
    layout's least time on the card (ms) and int32 multiplies.

    While a recorder is entered, and during every capture of a
    ``utils.graphs`` unit, the wrappers are patched to count each call into
    ``TAPE``, whose counters ``graphs.COUNTERS`` holds: a unit's replay
    credits the calls its capture made, as it credits the launch counts, so
    that the calls per layout of a path are those of an eager run.  A
    recorder's ``calls`` are TAPE's growth while it is entered.  ``install``
    runs once, before any unit is captured."""

    TAPE = None
    BOUNDS = {}
    MULTS = {}
    _orig = None
    _depth = 0

    @classmethod
    def install(cls):
        from hhe_tpu_torch.ops import mod_kernels, ntt_kernels
        from hhe_tpu_torch.utils import graphs

        if cls.TAPE is not None:
            return
        cls.TAPE = {name: collections.Counter()
                    for name in ("ntt_fwd", "ntt_inv", "mont", "elem", "down")}
        graphs.COUNTERS.extend(cls.TAPE.values())
        cls._orig = [(ntt_kernels, name, getattr(ntt_kernels, name)) for name in ("ntt_fwd", "ntt_inv")]
        cls._orig += [(mod_kernels, name, getattr(mod_kernels, name))
                      for name in ("mont_mul", "mont_mul_lazy", "mont_mac", "mod_elem", "mod_center",
                                   "mod_gather", "mod_sum", "mod_down")]
        capture = graphs.Jit._capture

        def recorded_capture(jit, key, args):
            cls._patch()
            try:
                return capture(jit, key, args)
            finally:
                cls._unpatch()

        graphs.Jit._capture = recorded_capture

    @classmethod
    def _patch(cls):
        cls._depth += 1
        if cls._depth > 1:
            return
        tape, bounds, mults = cls.TAPE, cls.BOUNDS, cls.MULTS
        for mod, name, fn in cls._orig:
            if name.startswith("ntt"):
                def rec(x, tb, _fn=fn, _name=name):
                    key = (tuple(x.shape), tb.moduli)
                    if (_name, key) not in bounds:
                        bounds[_name, key] = call_bound(_name, key[0], key[1])
                        mults[_name, key] = ntt_mults(_name, key[0])
                    tape[_name][key] += 1
                    return _fn(x, tb)
            elif name.startswith("mod_") and name != "mod_down":
                def rec(*args, _fn=fn, _name=name, **kw):
                    mode, e = elem_args(_name, args)
                    key = (mode, *map(mont_layout, (e["a"], e["b"], e["q"])), e["half"],
                           *map(index_layout, (e["idx"], e["sign"])), e["dim"])
                    res = _fn(*args, **kw)
                    if ("elem", key) not in bounds:
                        nbytes = sum(words_bytes(e[n]) for n in ("a", "b", "q", "idx", "sign"))
                        bounds["elem", key] = (nbytes + _out_bytes(res)) / HBM_BYTES_PER_S * 1e3
                        mults["elem", key] = 0
                    tape["elem"][key] += 1
                    return res
            elif name == "mod_down":
                def rec(c, *consts, adds=(), out=None, _fn=fn, _mod=mod):
                    adds = tuple(_mod.addend(x) for x in adds)
                    key = (mont_layout(c), mont_layout(consts[0]),
                           tuple((mont_layout(x.x), *map(index_layout, (x.idx, x.sign))) for x in adds))
                    res = _fn(c, *consts, adds=adds, out=out)
                    if ("down", key) not in bounds:
                        nbytes = words_bytes(c) + sum(words_bytes(x) for x in consts[:4]) + sum(
                            words_bytes(a.x) + words_bytes(a.idx) + words_bytes(a.sign) for a in adds)
                        bounds["down", key] = (nbytes + _out_bytes(res)) / HBM_BYTES_PER_S * 1e3
                        mults["down", key] = 3 * res.numel()  # one Montgomery product a word
                    tape["down"][key] += 1
                    return res
            else:
                def rec(a, b, q, qi, *dim, _fn=fn, _name=name, _mod=mod, **kw):
                    key = (_name, dim[0] if dim else None, *map(mont_layout, (a, b, q, qi)))
                    if ("mont", key) not in bounds:
                        p = _mod.plan(a, b, q, qi, dim[0] if dim else None)
                        bounds["mont", key] = mont_bound(p, a, b, q, qi)[0]
                        mults["mont", key] = 3 * int(np.prod(p.shape)) * p.terms
                    tape["mont"][key] += 1
                    return _fn(a, b, q, qi, *dim, **kw)
            setattr(mod, name, rec)

    @classmethod
    def _unpatch(cls):
        cls._depth -= 1
        if cls._depth == 0:
            for mod, name, fn in cls._orig:
                setattr(mod, name, fn)

    def __init__(self):
        self.install()
        self.calls = None

    def __enter__(self):
        self._patch()
        self.start = {name: collections.Counter(c) for name, c in self.TAPE.items()}
        return self

    def __exit__(self, *exc):
        self.calls = {name: c - self.start[name] for name, c in self.TAPE.items()}
        self._unpatch()

    def totals(self, names) -> tuple:
        """(bound ms, int32 multiplies) summed over the recorded calls of the
        tape entries ``names``."""
        ms = mults = 0
        for name in names:
            for key, n in self.calls[name].items():
                ms += n * self.BOUNDS[name, key]
                mults += n * self.MULTS[name, key]
        return ms, mults
