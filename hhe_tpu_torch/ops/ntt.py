"""Negacyclic NTT over RNS limbs — counterpart of ``hhe_tpu.ops.ntt``.

Same conventions as the JAX package: merged-psi iterative NTT (Cooley-Tukey
forward, Gentleman-Sande inverse) with twiddles in bit-reversed order and
Montgomery form; forward maps natural -> bit-reversed order, inverse maps
bit-reversed -> natural.  Tensors are int32 ``[..., k, N]`` residues.

``ntt_fwd`` / ``ntt_inv`` dispatch on the tensor's device: a CUDA tensor goes
to the hand-written kernels of ``ntt_kernels`` (which raise on anything they
do not take), a CPU tensor to the plain PyTorch stage loop below
(``ntt_fwd_plain`` / ``ntt_inv_plain``, the counterparts of
``_ntt_fwd_xla`` / ``_ntt_inv_xla``).  ``ntt_fwd_top_plain`` /
``ntt_inv_top_plain`` are the plain versions of the kernels' top passes for
rows longer than ``TILE``.  The host numpy NTT at the end serves keygen,
encrypt, encode and decrypt.

``u32_to_torch`` is the port's funnel from host residues to the device
(``Context.to_device``); ``upload`` takes any other host array there.
Both count into ``UPLOADS`` and open the span ``hhe.upload``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils import trace
from . import modular, primes

I64 = torch.int64
# Words of the kernels' shared-memory tile.  A longer row is cut into
# P = N / TILE parts, and its tables into one per part (``part_index``).
TILE = 16384


def bit_reverse_indices(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def powers(base: int, n: int, q: int, dtype=np.uint64) -> np.ndarray:
    """base^j mod q for j in [0, n) (n a power of two), by doubling: exact in
    uint64 for q < 2^32, where every product is below 2^64; pass
    ``dtype=object`` for Python integers."""
    cast = np.uint64 if dtype is np.uint64 else int
    out = np.ones(1, dtype)
    while len(out) < n:
        out = np.concatenate([out, out * cast(pow(base, len(out), q)) % cast(q)])
    return out


def part_index(n: int, parts: int) -> np.ndarray:
    """[parts, n // parts] indices into a bit-reversed twiddle table: entry j
    in [m', 2m') of part p is (parts + p) m' + j - m', the twiddle that the
    stage with m' sub-groups of each part takes in the merged-psi order once
    the log2(parts) stages that mix the parts have run (entry 0 is unused and
    takes index 0).  parts = 1 is the identity."""
    j = np.arange(n // parts, dtype=np.int64)
    hi = j.copy()  # the highest power of two <= j (0 for j = 0)
    for s in (1, 2, 4, 8, 16):
        hi |= hi >> s
    hi -= hi >> 1
    p = np.arange(parts, dtype=np.int64)[:, None]
    return (parts + p) * hi + (j - hi)


# host arrays handed to a device: calls, and bytes of the arrays handed over
UPLOADS = {"calls": 0, "bytes": 0}


def u32_to_torch(a: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor with the same bits, on ``device``."""
    with trace.span("hhe.upload"):
        a = np.ascontiguousarray(np.asarray(a).astype(np.uint32))
        return _upload(a.view(np.int32), device)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor of its dtype on ``device``."""
    with trace.span("hhe.upload"):
        return _upload(np.ascontiguousarray(a), device)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    UPLOADS["calls"] += 1
    UPLOADS["bytes"] += a.nbytes
    return torch.from_numpy(a).to(device)


def u32_to_numpy(x) -> np.ndarray:
    """int32 tensor (or any array of residues) -> numpy uint32, same bits."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.int32).cpu().numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


class NttTables(NamedTuple):
    """Per-limb-set NTT tables on one device."""

    moduli: Tuple[int, ...]
    q: torch.Tensor  # [k, 1] int64 moduli
    qinv_neg: torch.Tensor  # [k, 1] int64 (-q^-1 mod 2^32)
    r2: torch.Tensor  # [k, 1] int64 (2^64 mod q, for to_mont)
    psi_br: torch.Tensor  # [k, N] int32 Montgomery-domain psi^bitrev(i)
    ipsi_br: torch.Tensor  # [k, N] int32 Montgomery-domain psi^-bitrev(i)
    ninv: torch.Tensor  # [k, 1] int64 Montgomery-domain N^-1
    # the same constants as flat 32-bit words, the kernels' operands
    q32: torch.Tensor  # [k] int32
    lazy: bool  # every modulus < 2^30: the kernels may reduce lazily
    # Shoup pairs for the kernels: (w, floor(w * 2^32 / q)) with w the
    # standard-domain value of the Montgomery entry above
    psi_shoup: torch.Tensor  # [k, N, 2] int32, from psi_br
    ipsi_shoup: torch.Tensor  # [k, N, 2] int32, from ipsi_br
    ninv_shoup: torch.Tensor  # [k, 2, 2] int32: N^-1 (from ninv), N^-1 * ipsi_br[1]
    # the tile kernels' tables: [k, P, N / P, 2] int32, psi_shoup re-indexed
    # by part_index for N > TILE; up to TILE, P = 1 and a view of psi_shoup
    psi_parts: torch.Tensor
    ipsi_parts: torch.Tensor


@functools.lru_cache(maxsize=32)
def build_tables(moduli: Tuple[int, ...], n: int, device) -> NttTables:
    """Host-precomputed tables for the given RNS moduli and polynomial degree."""
    moduli = tuple(int(q) for q in moduli)
    k = len(moduli)
    rev = bit_reverse_indices(n)
    q_arr = np.zeros((k, 1), np.uint32)
    qi_arr = np.zeros((k, 1), np.uint32)
    r2_arr = np.zeros((k, 1), np.uint32)
    psi_t = np.zeros((k, n), np.uint32)
    ipsi_t = np.zeros((k, n), np.uint32)
    ninv_t = np.zeros((k, 1), np.uint32)
    for i, q in enumerate(moduli):
        qinv_neg, r1, r2 = modular.mont_constants(q)
        psi = primes.root_of_unity(2 * n, q)
        q_arr[i, 0] = q
        qi_arr[i, 0] = qinv_neg
        r2_arr[i, 0] = r2
        psi_t[i] = modular.to_mont_host(powers(psi, n, q)[rev], q)
        ipsi_t[i] = modular.to_mont_host(powers(pow(psi, -1, q), n, q)[rev], q)
        ninv_t[i, 0] = modular.to_mont_host(np.uint64(pow(n, -1, q)), q)

    ninv_std = np.array([pow(n, -1, q) for q in moduli], np.uint64)

    def col(a):
        return torch.from_numpy(a.astype(np.int64)).to(device)

    def shoup(mont):  # [k, ...] Montgomery entries -> [k, ..., 2] Shoup pairs
        q = q_arr.astype(np.uint64).reshape(k, *([1] * (mont.ndim - 1)))
        rinv = np.array([pow(1 << 32, -1, int(m)) for m in moduli], np.uint64)
        w = mont.astype(np.uint64) * rinv.reshape(q.shape) % q
        return u32_to_torch(np.stack([w, (w << np.uint64(32)) // q], -1), device)

    parts = max(1, n // TILE)
    idx = torch.from_numpy(part_index(n, parts)).to(device)

    def by_part(pairs):  # [k, N, 2] -> [k, P, N / P, 2]
        return pairs.view(k, 1, n, 2) if parts == 1 else pairs[:, idx].contiguous()

    psi_shoup, ipsi_shoup = shoup(psi_t), shoup(ipsi_t)
    return NttTables(
        moduli=moduli,
        q=col(q_arr),
        qinv_neg=col(qi_arr),
        r2=col(r2_arr),
        psi_br=u32_to_torch(psi_t, device),
        ipsi_br=u32_to_torch(ipsi_t, device),
        ninv=col(ninv_t),
        q32=u32_to_torch(q_arr[:, 0], device),
        lazy=all(q < (1 << 30) for q in moduli),
        psi_shoup=psi_shoup,
        ipsi_shoup=ipsi_shoup,
        # N^-1, and N^-1 times the inverse's last-stage twiddle ipsi_br[1]
        ninv_shoup=shoup(np.stack([ninv_t[:, 0], ipsi_t[:, 1] * ninv_std % q_arr[:, 0]], 1)),
        psi_parts=by_part(psi_shoup),
        ipsi_parts=by_part(ipsi_shoup),
    )


def ntt_fwd(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Forward negacyclic NTT, natural -> bit-reversed order.

    x: [..., k, N] residues in standard domain; returns int32 of that shape."""
    x = x.to(torch.int32)
    if x.device.type == "cpu":
        return ntt_fwd_plain(x, tb)
    from . import ntt_kernels

    return ntt_kernels.ntt_fwd(x.contiguous(), tb)


def ntt_inv(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Inverse negacyclic NTT, bit-reversed -> natural order."""
    x = x.to(torch.int32)
    if x.device.type == "cpu":
        return ntt_inv_plain(x, tb)
    from . import ntt_kernels

    return ntt_kernels.ntt_inv(x.contiguous(), tb)


def _fwd_stages(x: torch.Tensor, tb: NttTables, stop: int) -> torch.Tensor:
    """The forward stages with m = 1, 2, 4, ... < stop groups, in int64."""
    *lead, k, n = x.shape
    q = tb.q[..., None]  # [k,1,1]
    qi = tb.qinv_neg[..., None]
    y = x.to(I64)
    t, m = n, 1
    while m < stop:
        t //= 2
        yv = y.reshape(*lead, k, m, 2, t)
        s = tb.psi_br[:, m : 2 * m].reshape(k, m, 1)
        u = yv[..., 0, :]
        v = modular.mont_mul_plain(yv[..., 1, :], s, q, qi)
        y = torch.stack(
            [modular.add_mod_plain(u, v, q), modular.sub_mod_plain(u, v, q)], dim=-2
        ).reshape(*lead, k, n)
        m *= 2
    return y.to(x.dtype)


def _inv_stages(x: torch.Tensor, tb: NttTables, h: int) -> torch.Tensor:
    """The inverse stages with h, h/2, ..., 1 groups, then the factor N^-1,
    in int64."""
    *lead, k, n = x.shape
    q = tb.q[..., None]
    qi = tb.qinv_neg[..., None]
    y = x.to(I64)
    while h >= 1:
        t = n // (2 * h)
        yv = y.reshape(*lead, k, h, 2, t)
        s = tb.ipsi_br[:, h : 2 * h].reshape(k, h, 1)
        u = yv[..., 0, :]
        v = yv[..., 1, :]
        y = torch.stack(
            [
                modular.add_mod_plain(u, v, q),
                modular.mont_mul_plain(modular.sub_mod_plain(u, v, q), s, q, qi),
            ],
            dim=-2,
        ).reshape(*lead, k, n)
        h //= 2
    return modular.mont_mul_plain(y, tb.ninv, tb.q, tb.qinv_neg).to(x.dtype)


def ntt_fwd_plain(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Plain PyTorch forward NTT (CT butterflies, merged psi), in int64:
    the stage loop of ``hhe_tpu.ops.ntt._ntt_fwd_xla``."""
    return _fwd_stages(x, tb, x.shape[-1])


def ntt_inv_plain(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Plain PyTorch inverse NTT (GS butterflies), in int64: the stage loop
    of ``hhe_tpu.ops.ntt._ntt_inv_xla``."""
    return _inv_stages(x, tb, x.shape[-1] // 2)


def ntt_fwd_top_plain(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """The forward stages that mix the parts of a row longer than TILE (the
    first log2(N / TILE)), canonical: the plain version of the kernels' top
    pass, whose own output is congruent to this mod q."""
    return _fwd_stages(x, tb, x.shape[-1] // TILE)


def ntt_inv_top_plain(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """The inverse's last log2(N / TILE) stages and N^-1: the plain version
    of the kernels' inverse top pass."""
    return _inv_stages(x, tb, x.shape[-1] // TILE // 2)


def pointwise_mont(a: torch.Tensor, b_mont: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Pointwise a*b where b is already in Montgomery domain."""
    return modular.mont_mul(a, b_mont, tb.q, tb.qinv_neg)


def to_mont(a: torch.Tensor, tb: NttTables) -> torch.Tensor:
    return modular.mont_mul(a, tb.r2, tb.q, tb.qinv_neg)


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Full negacyclic polynomial product (both inputs standard domain, coeff order)."""
    fa = ntt_fwd(a, tb)
    fb = ntt_fwd(to_mont(b, tb), tb)
    return ntt_inv(pointwise_mont(fa, fb, tb), tb)


# ------------------------------------------------------------------
# Host (numpy u64) NTT — used by keygen/encrypt/decrypt, party-side on CPU;
# exact since all products are of values < 2^31.
# ------------------------------------------------------------------


class HostTables(NamedTuple):
    q: int
    psi_br: np.ndarray  # [N] u64, standard domain, bit-reversed powers
    ipsi_br: np.ndarray
    ninv: int


@functools.lru_cache(maxsize=64)
def build_host_tables(q: int, n: int) -> HostTables:
    """q may exceed 2^32: tables then use object dtype and the host NTT runs
    in exact Python integers."""
    rev = bit_reverse_indices(n)
    psi = primes.root_of_unity(2 * n, q)
    dt = np.uint64 if q < (1 << 32) else object
    pw = powers(psi, n, q, dt)
    ipw = powers(pow(psi, -1, q), n, q, dt)
    return HostTables(q, pw[rev].copy(), ipw[rev].copy(), pow(n, -1, q))


def ntt_fwd_host(x: np.ndarray, tb: HostTables) -> np.ndarray:
    """Forward negacyclic NTT on host, natural -> bit-reversed ([..., N] u64;
    object dtype — exact bigint — when q >= 2^32)."""
    if tb.q >= (1 << 32):
        x = np.asarray(x, object) % tb.q
        q = tb.q
    else:
        x = np.asarray(x, np.uint64) % np.uint64(tb.q)
        q = np.uint64(tb.q)
    *lead, n = x.shape
    t, m = n, 1
    while m < n:
        t //= 2
        xv = x.reshape(*lead, m, 2, t)
        s = tb.psi_br[m : 2 * m].reshape(m, 1)
        u = xv[..., 0, :]
        v = (xv[..., 1, :] * s) % q
        x = np.stack([(u + v) % q, (u + q - v) % q], axis=-2).reshape(*lead, n)
        m *= 2
    return x


def ntt_inv_host(x: np.ndarray, tb: HostTables) -> np.ndarray:
    """Inverse negacyclic NTT on host, bit-reversed -> natural."""
    if tb.q >= (1 << 32):
        x = np.asarray(x, object)
        q = tb.q
    else:
        x = np.asarray(x, np.uint64)
        q = np.uint64(tb.q)
    *lead, n = x.shape
    t, m = 1, n
    while m > 1:
        h = m // 2
        xv = x.reshape(*lead, h, 2, t)
        s = tb.ipsi_br[h : 2 * h].reshape(h, 1)
        u = xv[..., 0, :]
        v = xv[..., 1, :]
        x = np.stack(
            [(u + v) % q, ((u + q - v) % q * s) % q], axis=-2
        ).reshape(*lead, n)
        t *= 2
        m = h
    ninv = tb.ninv if tb.q >= (1 << 32) else np.uint64(tb.ninv)
    return (x * ninv) % q


def poly_mul_host(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Negacyclic a*b mod q on host via NTT ([..., N])."""
    tb = build_host_tables(q, a.shape[-1])
    fa = ntt_fwd_host(a, tb)
    fb = ntt_fwd_host(b, tb)
    return ntt_inv_host((fa * fb) % np.uint64(q), tb)


def negacyclic_mul_host(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """O(N^2) schoolbook negacyclic product mod q (exact Python integers),
    the cross-check of the NTT products."""
    n = a.shape[-1]
    ai = [int(v) for v in np.asarray(a, np.uint64)]
    bi = [int(v) for v in np.asarray(b, np.uint64)]
    res = np.zeros(n, dtype=object)
    for i in range(n):
        s = 0
        for j in range(i + 1):
            s += ai[j] * bi[i - j]
        for j in range(i + 1, n):
            s -= ai[j] * bi[n + i - j]
        res[i] = s % q
    return res.astype(np.uint64)
