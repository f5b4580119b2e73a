"""One rank's RNS limbs of a BFV context: the evaluator's side of limb
parallelism — the counterpart of what XLA's SPMD partitioner inserts when
the JAX package shards a ciphertext's limbs over the mesh's ``limb`` axis.

``LimbView(ctx, mesh)`` stands where the evaluator takes a ``Context``
(``ops.bfv_eval``, ``ops.helin``, ``ops.transcipher``): rank r of the d
``limb`` ranks holds the limbs L_r = ``mesh.limb_range(k, mesh)``, the r-th
contiguous block of k/d, and the view holds

- tables: the NTT tables of L_r and of L_r ∪ {P}; the Bsk tables whole;
- constants: the rank's rows of every ``EvalConsts`` column over q (and the
  rank's q rows and m_sk of the Bsk -> q ∪ {m_sk} conversion), the whole
  rest;
- operands: ``take`` / ``take_qp`` / ``take_key`` take a whole-context
  [.., k, N] plaintext, a [.., k+1, N] tensor over q ∪ P and a key-switch key
  [2, kd, k+1, N] to the rank's rows ([2, kd, |L_r|+1, N]: every digit, only
  the rank's target moduli and P), and let a tensor that is already the
  rank's pass;
- gather: ``gather`` all-gathers a [.., |L_r|, N] tensor into [.., k, N]
  over the limb group (``mesh.gather_limbs``), counted in ``all_gathers``.

Everything else of the evaluator is limb-local.  Where the axis does not
divide k the view holds every limb and each of the above is the identity
(``split`` is False), as the JAX package keeps such limbs whole.  Decryption,
encryption and keygen stay on the whole ``Context``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops import bfv, bfv_eval, ntt, rns
from . import mesh as hmesh

# EvalConsts columns over the q moduli that the limb-local steps read
# (BEHZ's Bsk -> q output, the fast floor's t, the key-switch mod-down); the
# q -> Bsk constants stay whole, since the view gathers those operands
_Q_ROWS = ("q", "qi", "t_mont_q", "msk_mod_q", "b_mod_q_mont", "p_mod_q", "p_inv_mont")


class LimbView:
    """Rank ``mesh.rank("limb")``'s limbs of ``ctx`` (see the module)."""

    def __init__(self, ctx: bfv.Context, mesh: hmesh.Mesh):
        if mesh.device.type != ctx.device.type:
            raise ValueError(f"mesh on {mesh.device}, context on {ctx.device}")
        self.whole_ctx = ctx
        self.mesh = mesh
        self.split = ctx.k % mesh.shape["limb"] == 0
        self.limbs = hmesh.limb_range(ctx.k, mesh)
        lo, hi = self.limbs.start, self.limbs.stop
        self.k = hi - lo
        self.n, self.t, self.device = ctx.n, ctx.t, ctx.device
        self.q_moduli = ctx.q_moduli[lo:hi]
        self.tb_q = ntt.build_tables(self.q_moduli, ctx.n, ctx.device)
        self.tb_qp = ntt.build_tables(self.q_moduli + (ctx.p_special,), ctx.n, ctx.device)
        self.tb_bsk = ctx.tb_bsk
        self.delta_mod_q = ctx.delta_mod_q[lo:hi]
        self.q_mod_t = ctx.q_mod_t
        self.encoder_map = ctx.encoder_map
        self._ntt_perm_cache = ctx._ntt_perm_cache
        ec = bfv_eval.eval_consts(ctx)
        f = ec.fbc_b_to_q_msk
        rows = list(range(lo, hi)) + [ctx.k]  # the rank's q rows and m_sk
        self._eval_consts = ec._replace(
            **{name: getattr(ec, name)[lo:hi] for name in _Q_ROWS},
            fbc_b_to_q_msk=rns.FBC(f.a_q, f.a_qinv, f.inv_mont, f.c_q[rows], f.c_qinv[rows],
                                   f.m_mont[:, rows]),
        )
        self._keys: Dict[int, tuple] = {}  # id(whole pair) -> (whole key, rank's key)
        self.all_gathers = 0
        self.gathered_bytes = 0  # of the gathered [.., k, N] tensors

    def __repr__(self):
        return (f"LimbView(limbs {self.limbs.start}..{self.limbs.stop - 1} of {self.whole_ctx.k}, "
                f"split={self.split}, {self.mesh})")

    @property
    def whole(self) -> bfv.Context:
        """The context of every limb (the Bsk half of BEHZ runs on it)."""
        return self.whole_ctx

    # ------------------------------------------------------------------
    # Operands: whole-context -> the rank's rows, and back
    # ------------------------------------------------------------------

    def _rows(self, x: torch.Tensor, extra: int) -> int:
        rows = x.shape[-2]
        if rows not in (self.k + extra, self.whole_ctx.k + extra):
            raise ValueError(f"{rows} rows fit neither the view's {self.k} limbs nor the "
                             f"context's {self.whole_ctx.k} (+{extra})")
        return rows

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """A [.., k, N] tensor over q -> the rank's [.., |L_r|, N]."""
        if self._rows(x, 0) == self.k:
            return x
        return x[..., self.limbs.start : self.limbs.stop, :]

    def take_qp(self, x: torch.Tensor) -> torch.Tensor:
        """A [.., k+1, N] tensor over q ∪ P -> [.., |L_r|+1, N] (P last)."""
        if self._rows(x, 1) == self.k + 1:
            return x
        return torch.cat([x[..., self.limbs.start : self.limbs.stop, :], x[..., -1:, :]], -2)

    def take_key(self, ksk: bfv.KSwitchKey) -> bfv.KSwitchKey:
        """A key-switch key [2, kd, k+1, N] -> its rank's rows [2, kd,
        |L_r|+1, N], taken once a key and kept (the whole key is pinned, so
        that its id is not reused while the entry lives)."""
        if self._rows(ksk.pair, 1) == self.k + 1:
            return ksk
        hit = self._keys.get(id(ksk.pair))
        if hit is None:
            local = bfv.KSwitchKey(self.take_qp(ksk.pair).contiguous())
            hit = self._keys[id(ksk.pair)] = (ksk, local)
        return hit[1]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's [.., |L_r|, N] -> every limb [.., k, N] on every rank
        (one all-gather over the limb group); a whole tensor passes."""
        if not self.split or self._rows(x, 0) != self.k:
            return x
        out = hmesh.gather_limbs(x, self.mesh)
        self.all_gathers += 1
        self.gathered_bytes += out.numel() * out.element_size()
        return out

    def key_bytes(self, keys) -> int:
        """Bytes of the rank's rows of the key-switch keys ``keys``."""
        return sum(2 * k.k0.shape[0] * (self.k + 1) * k.k0.shape[-1] * k.k0.element_size()
                   for k in keys)

    # ------------------------------------------------------------------
    # The limb-free rest of the Context the evaluator reads
    # ------------------------------------------------------------------

    def galois_perm(self, g: int):
        return self.whole_ctx.galois_perm(g)

    def galois_perm_device(self, g: int):
        return self.whole_ctx.galois_perm_device(g)

    def galois_elt_from_step(self, step: int) -> int:
        return self.whole_ctx.galois_elt_from_step(step)

    def encode(self, values):
        return self.whole_ctx.encode(values)

    def encode_batch(self, values):
        return self.whole_ctx.encode_batch(values)

    def to_device(self, a):
        return self.whole_ctx.to_device(a)

    def plain_for_mul(self, pt) -> torch.Tensor:
        return self.take(self.whole_ctx.plain_for_mul(pt))

    def plain_for_add_batch(self, polys) -> torch.Tensor:
        return self.take(self.whole_ctx.plain_for_add_batch(polys))
