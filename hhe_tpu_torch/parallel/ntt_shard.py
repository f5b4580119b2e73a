"""Multi-device NTT: one polynomial's coefficients split over the ranks of a
mesh axis — counterpart of ``hhe_tpu.parallel.ntt_shard``.

Four-step decomposition over N = N1 * N2 with the coefficient axis split
over the ``poly`` axis's d ranks (each holds [k, N/d]):

    view v = x * psi_N^i as an [N1, N2] row-major matrix, rows split
    1. all_to_all transpose
    2. local cyclic DFT_N1 along rows
    3. local twiddle by w_N^(i2 * k1)
    4. all_to_all transpose back
    5. local cyclic DFT_N2 along rows

The local cyclic DFTs are the single-device negacyclic NTTs (``ntt.ntt_fwd``
/ ``ntt_inv``, so K1/K2 on the card at M = N1 and N2, 32 ... 256) via
``DFT_M(u)[j] = NTT_M(u * psi_M^-i)[rev(j)]``.  The forward output is the
fixed digit-reversed permutation out[k1' * N2 + k2'] = DFT_N[rev1(k1') +
N1*rev2(k2')], whatever d; the inverse consumes exactly that order, so
fwd/mul/inv compose as the single-device NTT does.  Every twist and twiddle
constant is split like the data, so steps 2, 3 and 5 are local and only the
transposes (``torch.distributed.all_to_all_single`` over the axis's group)
communicate.  As in the JAX package, this backs ``Context.keygen_public(
mesh=...)``, where one N = 65536 product stands alone.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import modular, ntt, primes
from ..ops.modular import mont_mul


class ShardNttPlan(NamedTuple):
    """Host-built constants for one (moduli, N, d) sharded transform, as
    int32 numpy arrays holding the JAX package's uint32 bits (Montgomery
    form).  [k, N] arrays are flattened matrices in the layout of the step
    that consumes them, so they split with the data over the last axis."""

    n1: int
    n2: int
    d: int
    pre: np.ndarray  # [k, N] Mont psi_N^i,   (i1, i2) layout
    mid_f: np.ndarray  # [k, N] Mont psi_N1^-i1, (i2, i1) layout
    tw_f: np.ndarray  # [k, N] Mont w_N^(i2*rev1(k1')), (i2, k1') layout
    tw_i: np.ndarray  # [k, N] Mont w_N^-(i2*rev1(k1'))
    mid_i: np.ndarray  # [k, N] Mont psi_N1^+i1, (i2, i1) layout
    post: np.ndarray  # [k, N] Mont psi_N^-i,  (i1, i2) layout
    psi2_i: np.ndarray  # [k, n2] Mont psi_N2^-i2 (row twist, replicated)
    psi2: np.ndarray  # [k, n2] Mont psi_N2^+i2
    r2: np.ndarray  # [k, 1] R^2 mod q (standard -> Mont lift)


def _mont(vals: np.ndarray, q: int) -> np.ndarray:
    return modular.to_mont_host(vals, q).view(np.int32)


@functools.lru_cache(maxsize=8)
def build_plan(moduli: Tuple[int, ...], n: int, d: int) -> ShardNttPlan:
    """The plan's constants; each power comes from a table of base^e for
    e in [0, M) (``ntt.powers``), the same residues as the JAX package's
    per-exponent ``pow``."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    if n1 % d or n2 % d:
        raise ValueError(f"{d} ranks do not divide N1 = {n1} and N2 = {n2}")
    k = len(moduli)
    rev1 = ntt.bit_reverse_indices(n1)
    i_lin = np.arange(n)  # (i1, i2) layout: i = i1 * n2 + i2
    i1_cols = np.broadcast_to(np.arange(n1), (n2, n1)).ravel()  # (i2, i1) layout
    tw_exp = ((np.arange(n2)[:, None] * rev1[None, :]) % n).ravel()  # (i2, k1')
    names = ("pre", "mid_f", "tw_f", "tw_i", "mid_i", "post", "psi2_i", "psi2")
    out = {name: np.empty((k, n2 if name.startswith("psi2") else n), np.int32) for name in names}
    r2 = np.empty((k, 1), np.int32)
    for t, q in enumerate(moduli):
        q = int(q)
        psi_n = primes.root_of_unity(2 * n, q)
        om = psi_n * psi_n % q  # N-th root
        psi1 = primes.root_of_unity(2 * n1, q)
        psi2 = primes.root_of_unity(2 * n2, q)
        r2[t, 0] = np.uint32(pow(1 << 32, 2, q)).view(np.int32)
        table = {
            "pre": (ntt.powers(psi_n, n, q), i_lin),
            "post": (ntt.powers(pow(psi_n, -1, q), n, q), i_lin),
            "mid_f": (ntt.powers(pow(psi1, -1, q), n1, q), i1_cols),
            "mid_i": (ntt.powers(psi1, n1, q), i1_cols),
            "tw_f": (ntt.powers(om, n, q), tw_exp),
            "tw_i": (ntt.powers(pow(om, -1, q), n, q), tw_exp),
            "psi2_i": (ntt.powers(pow(psi2, -1, q), n2, q), np.arange(n2)),
            "psi2": (ntt.powers(psi2, n2, q), np.arange(n2)),
        }
        for name, (pw, e) in table.items():
            out[name][t] = _mont(pw[e], q)
    return ShardNttPlan(n1=n1, n2=n2, d=d, r2=r2, **out)


def _transpose_a2a(x: torch.Tensor, d: int, group) -> torch.Tensor:
    """Global row-split [rows, cols] -> row-split [cols, rows] transpose.

    x: [..., r, c], this rank's rows of a [d*r, c] global matrix; returns
    [..., c // d, d * r].  Rank p sends its column group j to rank j; the
    received row blocks arrive in rank order, which is the global row
    order."""
    *lead, r, c = x.shape
    pos = len(lead)
    chunks = x.reshape(*lead, r, d, c // d).movedim(pos + 1, 0).contiguous()
    recv = torch.empty_like(chunks)
    dist.all_to_all_single(recv, chunks, group=group)
    y = recv.movedim(0, pos).reshape(*lead, d * r, c // d)
    return y.transpose(-1, -2)


class ShardedNtt:
    """Sharded negacyclic NTT and pointwise algebra over a mesh axis.

    A [k, N] RNS polynomial is split over the mesh's ``axis`` (last dim):
    rank p of d holds columns [p N/d, (p+1) N/d).  ``fwd``/``inv`` are
    inverse bijections sharing one fixed output order, so
    ``inv(pointwise_mul(fwd(a), fwd(b)))`` is the exact negacyclic product,
    the multi-device ``ntt.negacyclic_mul``."""

    def __init__(self, moduli, n: int, mesh, axis: str = "poly"):
        if axis not in mesh.shape:
            raise KeyError(f"mesh axes {tuple(mesh.shape)} have no {axis!r} axis")
        self.moduli = tuple(int(m) for m in moduli)
        self.n = n
        self.mesh = mesh
        self.axis = axis
        self.d = mesh.shape[axis]
        self.rank = mesh.rank(axis)
        self.group = mesh.group(axis)
        self.device = dev = mesh.device
        self.plan = p = build_plan(self.moduli, n, self.d)
        self.tb1 = ntt.build_tables(self.moduli, p.n1, dev)
        self.tb2 = ntt.build_tables(self.moduli, p.n2, dev)
        k, d, n1, n2 = len(self.moduli), self.d, p.n1, p.n2

        def mine(a, rows, cols):
            """This rank's share of a [k, N] constant as the [rows/d, k,
            cols] operand of a local step (a view of its [k, N/d] slice)."""
            s = self._local(torch.from_numpy(a))
            return s.reshape(k, rows // d, cols).transpose(0, 1)

        self.pre = self._local(torch.from_numpy(p.pre))  # [k, N/d]
        self.post = self._local(torch.from_numpy(p.post))
        self.mid_f = mine(p.mid_f, n2, n1)  # [n2/d, k, n1]
        self.tw_f = mine(p.tw_f, n2, n1)
        self.tw_i = mine(p.tw_i, n2, n1)
        self.mid_i = mine(p.mid_i, n2, n1)
        self.psi2_i = torch.from_numpy(p.psi2_i).to(dev)  # [k, n2]
        self.psi2 = torch.from_numpy(p.psi2).to(dev)
        self.r2 = torch.from_numpy(p.r2.astype(np.int64)).to(dev)
        self.q, self.qi = self.tb1.q, self.tb1.qinv_neg  # [k, 1]

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        cols = self.n // self.d
        return x[..., self.rank * cols : (self.rank + 1) * cols].to(self.device)

    def _a2a(self, x: torch.Tensor) -> torch.Tensor:
        return _transpose_a2a(x, self.d, self.group)

    def shard(self, x) -> torch.Tensor:
        """This rank's [k, N/d] int32 share of a whole [k, N] polynomial
        (numpy uint32 or a tensor of residues)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(np.uint32)).view(np.int32))
        return self._local(x.to(torch.int32)).contiguous()

    def gather(self, xl: torch.Tensor) -> torch.Tensor:
        """The whole [k, N] from every rank's [k, N/d] share, on every rank."""
        parts = [torch.empty_like(xl) for _ in range(self.d)]
        dist.all_gather(parts, xl.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)

    def fwd(self, xl: torch.Tensor) -> torch.Tensor:
        """Forward transform of this rank's [k, N/d] share, (i1, i2) rows."""
        k = xl.shape[0]
        n1, n2, d = self.plan.n1, self.plan.n2, self.d
        q, qi = self.q, self.qi
        v = mont_mul(xl, self.pre, q, qi).reshape(k, n1 // d, n2)
        y = self._a2a(v).transpose(0, 1)  # [n2/d, k, n1]: (i2, i1) layout
        y = mont_mul(y, self.mid_f, q, qi)
        c = ntt.ntt_fwd(y, self.tb1)  # local cyclic DFT_N1 (bit-reversed k1')
        c = mont_mul(c, self.tw_f, q, qi).transpose(0, 1)  # [k, n2/d, n1]
        w = self._a2a(c).transpose(0, 1)  # [n1/d, k, n2]: (k1', i2) layout
        out = ntt.ntt_fwd(mont_mul(w, self.psi2_i, q, qi), self.tb2)
        return out.transpose(0, 1).reshape(k, n1 // d * n2)

    def inv(self, xl: torch.Tensor) -> torch.Tensor:
        """Inverse transform of this rank's [k, N/d] share in fwd order."""
        k = xl.shape[0]
        n1, n2, d = self.plan.n1, self.plan.n2, self.d
        q, qi = self.q, self.qi
        w = xl.reshape(k, n1 // d, n2).transpose(0, 1)  # [n1/d, k, n2]
        w = mont_mul(ntt.ntt_inv(w, self.tb2), self.psi2, q, qi)  # undo DFT_N2
        c = self._a2a(w.transpose(0, 1)).transpose(0, 1)  # [n2/d, k, n1]: (i2, k1')
        c = mont_mul(c, self.tw_i, q, qi)
        y = mont_mul(ntt.ntt_inv(c, self.tb1), self.mid_i, q, qi)
        v = self._a2a(y.transpose(0, 1))  # [k, n1/d, n2]: (i1, i2) layout
        return mont_mul(v.reshape(k, -1), self.post, q, qi)

    def pointwise_mul(self, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        """Product of two fwd-domain (standard-domain) shares."""
        fb_m = mont_mul(fb, self.r2, self.q, self.qi)
        return mont_mul(fa, fb_m, self.q, self.qi)

    def negacyclic_mul(self, a, b) -> torch.Tensor:
        """Exact negacyclic product of two whole coefficient-domain [k, N]
        polynomials, computed split and gathered: the whole [k, N] int32
        product on every rank."""
        return self.gather(
            self.inv(self.pointwise_mul(self.fwd(self.shard(a)), self.fwd(self.shard(b))))
        )
