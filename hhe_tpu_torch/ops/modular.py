"""Modular arithmetic on RNS residues in PyTorch — counterpart of
``hhe_tpu.ops.modular``.

Residues are stored as ``torch.int32`` (every modulus is below 2^31, so the
bits equal the JAX package's ``uint32`` arrays).  Arithmetic widens to
``torch.int64``: a product of two values below 2^32 and 2^31 is exact there,
which replaces the JAX package's 16-bit-digit products.  Montgomery reduction
(R = 2^32) is carried out exactly as the JAX version does it, so even the lazy
form (``mont_mul_lazy``, result in [0, 2q)) gives the same bits:

- ``lo * qinv_neg mod 2^32`` is formed from 16-bit halves of ``lo`` so that no
  product reaches 2^63 (signed int64 overflow is never relied on);
- ``m * q`` and ``a * b`` stay below 2^63.

Every function returns the dtype of its first tensor argument; tables and
constants are int64 ``[k, 1]`` columns that broadcast against ``[..., k, N]``.
``host`` is the numpy u64 golden model.

``mont_mul``, ``mont_mul_lazy``, ``mont_mac``, ``add_mod``, ``sub_mod``,
``neg_mod``, ``gather_mod`` and ``sum_mod`` send a CUDA tensor ``a`` to the
hand-written kernels of ``mod_kernels`` (K3, K4, and K5 for the last five),
which raise on what they do not take, and a CPU tensor to their plain
versions (``*_plain``).  ``mont_mul``, ``mont_mac`` and ``add_mod`` write
into a caller's contiguous ``out`` where one is given.
The kernels read every operand as u32 bits (an int64 by its low 32), the
plain versions compute exactly in int64: the two agree for operands in
[0, 2^31), and for ``sub_mod`` / ``neg_mod`` below their row's q (there
a + q - b and q - a stay non-negative; the kernel wraps them mod 2^32),
which every caller passes.  Plain code that must stay plain on the card
(the NTT stage loop, ``mont_mac_plain``) calls the ``*_plain`` versions.
"""

from __future__ import annotations

import numpy as np
import torch

MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF
I64 = torch.int64


# ---------------------------------------------------------------------------
# Host-side constant preparation (numpy, exact)
# ---------------------------------------------------------------------------


def mont_constants(q: int):
    """Montgomery constants for modulus q < 2^31 (R = 2^32).

    Returns (qinv_neg, r1, r2): -q^{-1} mod 2^32, R mod q, R^2 mod q.
    """
    q = int(q)
    if not (q % 2 == 1 and 1 < q < (1 << 31)):
        raise ValueError(f"modulus {q} must be odd and below 2^31")
    qinv = pow(q, -1, 1 << 32)
    qinv_neg = ((1 << 32) - qinv) & MASK32
    r1 = (1 << 32) % q
    r2 = pow(1 << 32, 2, q)
    return np.uint32(qinv_neg), np.uint32(r1), np.uint32(r2)


def to_mont_host(a, q: int) -> np.ndarray:
    """Host: standard -> Montgomery domain (a * 2^32 mod q), exact numpy."""
    a = np.asarray(a, dtype=np.uint64)
    return ((a << np.uint64(32)) % np.uint64(q)).astype(np.uint32)


# ---------------------------------------------------------------------------
# Tensor primitives
# ---------------------------------------------------------------------------


def _w(x):
    """Widen a tensor to int64 (Python ints pass through)."""
    return x.to(I64) if isinstance(x, torch.Tensor) else x


def _like(out, a):
    return out.to(a.dtype) if isinstance(a, torch.Tensor) else out


def _redc(a, b, q, qinv_neg):
    """a * b * 2^-32 mod q in [0, 2q) (Montgomery REDC), in int64.

    Needs a < 2^32, b < 2^31 and a * b < q * 2^32."""
    ab = _w(a) * _w(b)
    hi = ab >> 32
    lo = ab & MASK32
    qi = _w(qinv_neg)
    m = ((lo & MASK16) * qi + ((((lo >> 16) * qi) & MASK16) << 16)) & MASK32
    mhi = (m * _w(q)) >> 32
    return hi + mhi + (lo != 0).to(I64)


def _on_cuda(a) -> bool:
    return isinstance(a, torch.Tensor) and a.is_cuda


def into_out(res, out):
    """A plain version's result, written into ``out`` where one is given
    (the kernels' ``out=``: a contiguous tensor of the result's shape)."""
    if out is None:
        return res
    if tuple(out.shape) != tuple(res.shape) or out.dtype != res.dtype or not out.is_contiguous():
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} is not a contiguous "
                         f"{tuple(res.shape)} {res.dtype}")
    return out.copy_(res)


def mont_mul(a, b_mont, q, qinv_neg, out=None):
    """Montgomery product: a * b_mont * 2^-32 mod q, in [0, q) (into
    ``out`` where given, as for ``mont_mac``, ``add_mod`` and the K5 modes
    below)."""
    if _on_cuda(a):
        from . import mod_kernels

        return mod_kernels.mont_mul(a, b_mont, q, qinv_neg, out=out)
    return into_out(mont_mul_plain(a, b_mont, q, qinv_neg), out)


def mont_mul_lazy(a, b_mont, q, qinv_neg):
    """Montgomery product without the final subtract: [0, 2q) (Harvey lazy
    form).  Admits any a < 2^32 when b_mont < q < 2^30."""
    if _on_cuda(a):
        from . import mod_kernels

        return mod_kernels.mont_mul_lazy(a, b_mont, q, qinv_neg)
    return mont_mul_lazy_plain(a, b_mont, q, qinv_neg)


def mont_mac(a, b_mont, q, qinv_neg, dim: int, out=None):
    """Montgomery multiply-accumulate: the sum over axis ``dim`` of the
    broadcast of a and b_mont of mont_mul(a, b_mont) mod q, in [0, q), with
    that axis removed; q and qinv_neg broadcast against the same shape and
    do not vary along ``dim``."""
    if _on_cuda(a):
        from . import mod_kernels

        return mod_kernels.mont_mac(a, b_mont, q, qinv_neg, dim, out=out)
    return into_out(mont_mac_plain(a, b_mont, q, qinv_neg, dim), out)


def mont_mul_plain(a, b_mont, q, qinv_neg):
    """Plain version of ``mont_mul`` (int64 PyTorch)."""
    t = _redc(a, b_mont, q, qinv_neg)
    q = _w(q)
    return _like(torch.where(t >= q, t - q, t), a)


def mont_mul_lazy_plain(a, b_mont, q, qinv_neg):
    """Plain version of ``mont_mul_lazy``."""
    return _like(_redc(a, b_mont, q, qinv_neg), a)


def mont_mac_plain(a, b_mont, q, qinv_neg, dim: int):
    """Plain version of ``mont_mac``: the products, then ``tree_add_mod_plain``
    (the JAX package's ``tree_add_mod(mont_mul(...))``)."""
    t = mont_mul_plain(a, b_mont, q, qinv_neg)
    return tree_add_mod_plain(t, q, axis=dim).select(dim, 0)


def add_mod(a, b, q, out=None):
    """a + b mod q (a, b < q), in a's dtype."""
    if _on_cuda(a):
        from . import mod_kernels

        return mod_kernels.mod_elem("add", a, b, q, out=out)
    return into_out(add_mod_plain(a, b, q), out)


def sub_mod(a, b, q):
    """a - b mod q (a, b < q), in a's dtype."""
    if _on_cuda(a):
        from . import mod_kernels

        return mod_kernels.mod_elem("sub", a, b, q)
    return sub_mod_plain(a, b, q)


def neg_mod(a, q):
    """-a mod q (a < q), in a's dtype."""
    if _on_cuda(a):
        from . import mod_kernels

        return mod_kernels.mod_elem("neg", a, 0, q)
    return neg_mod_plain(a, q)


def add_mod_plain(a, b, q):
    """Plain version of ``add_mod`` (int64 PyTorch)."""
    s = _w(a) + _w(b)
    q = _w(q)
    return _like(torch.where(s >= q, s - q, s), a)


def sub_mod_plain(a, b, q):
    """Plain version of ``sub_mod``."""
    a64, b64 = _w(a), _w(b)
    return _like(torch.where(a64 >= b64, a64 - b64, a64 + _w(q) - b64), a)


def neg_mod_plain(a, q):
    """Plain version of ``neg_mod``."""
    a64 = _w(a)
    return _like(torch.where(a64 == 0, a64, _w(q) - a64), a)


def gather_mod(a, idx, q=None, sign=None):
    """a read through the int32 index ``idx`` along the last axis, ``out[...,
    n] = a[..., idx[..., n]]`` over the broadcast of a, idx and sign (one
    index row per leading index where idx has them), negated mod q (a < q)
    where the bool ``sign`` is set: a galois permutation (``jnp.take`` +
    ``neg_mod`` + ``jnp.where`` in the JAX package); one K5 launch on the
    card."""
    if _on_cuda(a):
        from . import mod_kernels

        return mod_kernels.mod_gather(a, idx, q, sign)
    return gather_mod_plain(a, idx, q, sign)


def gather_mod_plain(a, idx, q=None, sign=None):
    """Plain version of ``gather_mod`` (int64 PyTorch)."""
    shape = torch.broadcast_shapes(*(x.shape for x in (a, idx, sign, q) if isinstance(x, torch.Tensor)))
    out = torch.gather(a.expand(shape), -1, idx.to(I64).expand(shape))
    if sign is None:
        return out
    return torch.where(sign, neg_mod_plain(out, q), out)


def sum_mod(a, q, dim: int, idx=None, sign=None):
    """The sum mod q over axis ``dim`` of a (terms below q), read through
    ``idx`` and signed by ``sign`` as ``gather_mod`` where given (each term
    through its own index row where idx varies along the axis), the axis
    removed, q constant along it: a chain or tree of ``add_mod`` in the JAX
    package (the BSGS giantstep sums); one K5 launch on the card."""
    if _on_cuda(a):
        from . import mod_kernels

        return mod_kernels.mod_sum(a, q, dim, idx, sign)
    return sum_mod_plain(a, q, dim, idx, sign)


def sum_mod_plain(a, q, dim: int, idx=None, sign=None):
    """Plain version of ``sum_mod``: the exact int64 sum, reduced once."""
    x = a if idx is None else gather_mod_plain(a, idx, q, sign)
    s = x.to(I64).sum(dim)
    if isinstance(q, torch.Tensor):
        q = torch.broadcast_to(q, x.shape).select(dim, 0).to(I64)
    return (s % q).to(a.dtype)


def _tree_add(t, q, axis, add):
    axis = axis % t.ndim
    n = t.shape[axis]
    if n & (n - 1):  # pad once to a power of two (0 is the add_mod identity)
        pad_shape = list(t.shape)
        pad_shape[axis] = (1 << n.bit_length()) - n
        t = torch.cat([t, t.new_zeros(pad_shape)], dim=axis)
    while t.shape[axis] > 1:
        half = t.shape[axis] // 2
        t = add(t.narrow(axis, 0, half), t.narrow(axis, half, half), q)
    return t


def tree_add_mod(t, q, axis=0):
    """Log-depth modular sum along ``axis`` (keeps the axis, size 1), each
    level one ``add_mod`` (K5 on the card)."""
    return _tree_add(t, q, axis, add_mod)


def tree_add_mod_plain(t, q, axis=0):
    """Plain version of ``tree_add_mod``: every level ``add_mod_plain``."""
    return _tree_add(t, q, axis, add_mod_plain)


def to_mont(a, r2_mont, q, qinv_neg):
    """Standard -> Montgomery domain via mont_mul with R^2."""
    return mont_mul(a, r2_mont, q, qinv_neg)


def from_mont(a_mont, q, qinv_neg):
    """Montgomery -> standard domain (a_mont * 2^-32 mod q)."""
    return mont_mul(a_mont, 1, q, qinv_neg)


# ---------------------------------------------------------------------------
# Host golden model (numpy u64, products exact for q < 2^31)
# ---------------------------------------------------------------------------


class host:
    @staticmethod
    def mul_mod(a, b, q):
        return (np.asarray(a, np.uint64) * np.asarray(b, np.uint64)) % np.uint64(q)

    @staticmethod
    def add_mod(a, b, q):
        return (np.asarray(a, np.uint64) + np.asarray(b, np.uint64)) % np.uint64(q)

    @staticmethod
    def sub_mod(a, b, q):
        qq = np.uint64(q)
        return (np.asarray(a, np.uint64) + qq - np.asarray(b, np.uint64) % qq) % qq

    @staticmethod
    def pow_mod(a, e, q):
        return np.uint64(pow(int(a), int(e), int(q)))
