"""BFV evaluator — counterpart of ``hhe_tpu.ops.bfv_eval``.

Plain functions on int32 ``[size, (B,) k, N]`` ciphertext tensors:

- add/sub/negate/add_plain/multiply_plain;
- apply_galois / rotate_rows / rotate_columns: coefficient permutation by
  index selection on the last axis, then hybrid key-switch (on the card:
  one K5 gather of c1; K6 adds the permuted c0, and a ciphertext ``plus``,
  in the mod-down's launch);
- key-switch: RNS-digit decomposition over the data primes, inner product
  with NTT-domain keys over q ∪ {P}, mod-down by the special prime;
- multiply/square/relinearize: BEHZ RNS multiplication (m_tilde-corrected
  base extension to Bsk, NTT-domain tensor product, t/Q fast floor,
  Shenoy-Kumaresan conversion back).

Every polynomial product goes through ``ntt.ntt_fwd`` / ``ntt.ntt_inv``,
which launch the CUDA kernels for tensors on the card.  ``multiply``,
``square``, ``relinearize`` and ``apply_galois`` are the spans
``hhe.eval.multiply`` / ``square`` / ``relinearize`` / ``galois``
(``utils.trace``): eager calls show in a trace, and inside a graph unit its
replay's span stands for them.

``ctx`` is a ``Context`` or a ``parallel.limb_shard.LimbView`` (one rank's
limbs of a context).  Plaintexts and keys are whole-context; ``ctx.take*``
takes them to the limbs held.  Each step that crosses limbs first gathers
its operand (``ctx.gather``; the identity for a Context): the key-switch
digits, and the q -> Bsk conversions of BEHZ, whose Bsk half every rank of
a view computes whole.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import trace
from . import ntt, rns
from .bfv import Ciphertext, Context, KSwitchKey
from .mod_kernels import Addend, addend
from .modular import (add_mod, add_mod_plain, gather_mod, gather_mod_plain, mont_mac, mont_mul,
                      into_out, mont_mul_plain, neg_mod, sub_mod, sub_mod_plain, to_mont_host)
from .rns import center_lift, reduce_u32, reduce_u32_plain

I64 = torch.int64


# ---------------------------------------------------------------------------
# Evaluator constants (tensors derived from a Context)
# ---------------------------------------------------------------------------


class EvalConsts(NamedTuple):
    q: torch.Tensor  # [k,1]
    qi: torch.Tensor
    bq: torch.Tensor  # [kb+1,1] Bsk moduli
    bqi: torch.Tensor
    # base extension q -> Bsk with m_tilde correction
    mtilde_inv_mont: torch.Tensor  # [k,1] Mont(inv_j * m_tilde mod q_j)
    fbc_q_to_bsk: rns.FBC
    tilde_mod_mtilde: torch.Tensor  # [k,1] (Q/q_j) mod 2^16
    neg_qinv_mtilde: int  # (-Q^-1) mod 2^16
    mtinv_bsk_mont: torch.Tensor  # [kb+1,1] Mont(m_tilde^-1 mod b)
    q_mtinv_bsk_mont: torch.Tensor  # [kb+1,1] Mont(Q * m_tilde^-1 mod b)
    # fast floor
    t_mont_q: torch.Tensor  # [k,1]
    t_mont_bsk: torch.Tensor  # [kb+1,1]
    qinv_bsk_mont: torch.Tensor  # [kb+1,1] Mont(Q^-1 mod b)
    # Shenoy-Kumaresan Bsk -> q: one conversion to q ∪ {m_sk} (m_sk last)
    fbc_b_to_q_msk: rns.FBC
    binv_msk_mont: torch.Tensor  # [1,1] Mont(B^-1 mod m_sk)
    msk: int
    msk_half: int
    msk_mod_q: torch.Tensor  # [k,1]
    b_mod_q_mont: torch.Tensor  # [k,1] Mont(B mod q)
    # key-switch mod-down
    p_mod_q: torch.Tensor  # [k,1]
    p_half: int
    p_inv_mont: torch.Tensor  # [k,1]


def _col(vals, device) -> torch.Tensor:
    return torch.tensor([int(v) for v in vals], dtype=I64, device=device).reshape(-1, 1)


def _mont_col(vals, moduli, device) -> torch.Tensor:
    return _col(
        [to_mont_host(np.uint64(v % m), m) for v, m in zip(vals, moduli)], device
    )


def eval_consts(ctx: Context) -> EvalConsts:
    if ctx._eval_consts is None:
        ctx._eval_consts = _build_eval_consts(ctx)
    return ctx._eval_consts


def _build_eval_consts(ctx: Context) -> EvalConsts:
    dev = ctx.device
    q_mods = ctx.q_moduli
    bsk_mods = ctx.base_bsk.moduli
    Q = ctx.Q
    mt = ctx.m_tilde
    B = ctx.base_b.Q
    msk = ctx.m_sk
    return EvalConsts(
        q=ctx.tb_q.q,
        qi=ctx.tb_q.qinv_neg,
        bq=ctx.tb_bsk.q,
        bqi=ctx.tb_bsk.qinv_neg,
        mtilde_inv_mont=_mont_col([inv * mt for inv in ctx.base_q.inv], q_mods, dev),
        fbc_q_to_bsk=rns.build_fbc(ctx.base_q, bsk_mods, dev),
        tilde_mod_mtilde=_col([t % mt for t in ctx.base_q.tilde], dev),
        neg_qinv_mtilde=(-pow(Q, -1, mt)) % mt,
        mtinv_bsk_mont=_mont_col([pow(mt, -1, b) for b in bsk_mods], bsk_mods, dev),
        q_mtinv_bsk_mont=_mont_col([Q * pow(mt, -1, b) for b in bsk_mods], bsk_mods, dev),
        t_mont_q=_mont_col([ctx.t] * len(q_mods), q_mods, dev),
        t_mont_bsk=_mont_col([ctx.t] * len(bsk_mods), bsk_mods, dev),
        qinv_bsk_mont=_mont_col([pow(Q, -1, b) for b in bsk_mods], bsk_mods, dev),
        fbc_b_to_q_msk=rns.build_fbc(ctx.base_b, tuple(q_mods) + (msk,), dev),
        binv_msk_mont=_mont_col([pow(B, -1, msk)], (msk,), dev),
        msk=msk,
        msk_half=msk // 2,
        msk_mod_q=_col([msk % q for q in q_mods], dev),
        b_mod_q_mont=_mont_col([B] * len(q_mods), q_mods, dev),
        p_mod_q=_col([ctx.p_special % q for q in q_mods], dev),
        p_half=ctx.p_special // 2,
        p_inv_mont=ctx.p_inv_mont,
    )


# ---------------------------------------------------------------------------
# Linear ops
# ---------------------------------------------------------------------------


def add(ctx: Context, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    q = ctx.tb_q.q
    sa, sb = a.size, b.size
    if sa == sb:
        return Ciphertext(add_mod(a.data, b.data, q))
    big, small = (a, b) if sa > sb else (b, a)
    head = add_mod(big.data[: small.size], small.data, q)
    return Ciphertext(torch.cat([head, big.data[small.size :]], 0))


def sub(ctx: Context, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    if a.size != b.size:
        raise ValueError(f"sub needs equal sizes, got {a.size} and {b.size}")
    return Ciphertext(sub_mod(a.data, b.data, ctx.tb_q.q))


def negate(ctx: Context, a: Ciphertext) -> Ciphertext:
    return Ciphertext(neg_mod(a.data, ctx.tb_q.q))


def add_plain(ctx: Context, a: Ciphertext, pt_dev: torch.Tensor) -> Ciphertext:
    """pt_dev = Context.plain_for_add(pt): [k, N] scaled round(Q m / t).
    Row 0's sum is written into its place of the result, the other rows
    copied beside it (no concatenation)."""
    out = torch.empty(a.data.shape, dtype=a.data.dtype, device=a.data.device)
    add_mod(a.data[0], ctx.take(pt_dev), ctx.tb_q.q, out=out[0])
    out[1:].copy_(a.data[1:])
    return Ciphertext(out)


def multiply_plain(ctx: Context, a: Ciphertext, pt_ntt_mont: torch.Tensor) -> Ciphertext:
    """pt_ntt_mont = Context.plain_for_mul(pt): [k, N] NTT+Mont."""
    f = ntt.ntt_fwd(a.data, ctx.tb_q)
    g = mont_mul(f, ctx.take(pt_ntt_mont), ctx.tb_q.q, ctx.tb_q.qinv_neg)
    return Ciphertext(ntt.ntt_inv(g, ctx.tb_q))


# ---------------------------------------------------------------------------
# NTT-domain galois permutations (for hoisted rotations)
# ---------------------------------------------------------------------------


def ntt_galois_src(ctx: Context, g: int) -> np.ndarray:
    """Permutation of NTT-domain (bit-reversed evaluation order) indices
    realizing x(X) -> x(X^g): out[s] = in[src[s]], no sign flips."""
    cache = ctx._ntt_perm_cache
    if g in cache:
        return cache[g]
    n, m = ctx.n, 2 * ctx.n
    rev = ntt.bit_reverse_indices(n)
    j = np.arange(n, dtype=np.int64)
    h_in = ((2 * j + 1) * g) % m  # out slot rev[j] evaluates at psi^(2j+1)
    src = np.empty(n, np.int64)
    src[rev[j]] = rev[(h_in - 1) // 2]
    cache[g] = src
    return src


# ---------------------------------------------------------------------------
# Key switching (hybrid, one special prime)
# ---------------------------------------------------------------------------


def _digits(ctx: Context, poly_q: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Limbs start..stop-1 of the whole poly_q, each reduced mod every
    modulus of ctx's q ∪ P: [..., k, N] -> [..., stop-start, k'+1, N], one
    ``reduce_u32`` over the broadcast (one K5 launch on the card)."""
    return reduce_u32(poly_q[..., start:stop, None, :], ctx.tb_qp.q)


def hoist_digits(ctx: Context, poly_q: torch.Tensor) -> torch.Tensor:
    """RNS digit decomposition + NTT, done once per ciphertext so many
    rotations can share it: [..., k', N] -> [..., k, k'+1, N] (one limb
    gather on a view: every digit reaches every modulus it holds)."""
    whole = ctx.gather(poly_q)
    return ntt.ntt_fwd(_digits(ctx, whole, 0, whole.shape[-2]), ctx.tb_qp)


def hoisted_ks_products(ctx: Context, fd_perm: torch.Tensor, ksk: KSwitchKey,
                        digits: slice = slice(None)) -> torch.Tensor:
    """Inner products of (permuted) hoisted digits with one rotation's keys
    (the key's rows ``digits``): [..., kd, k'+1, N] NTT digits -> [2, ...,
    k'+1, N] NTT over q ∪ P, k0's product first; one K4 launch reads the
    digits once for both."""
    pair = ctx.take_key(ksk).pair[:, digits]
    pair = pair.reshape(2, *([1] * (fd_perm.dim() - 3)), *pair.shape[1:])
    return mont_mac(fd_perm, pair, ctx.tb_qp.q, ctx.tb_qp.qinv_neg, -3)


def mod_down(ctx: Context, c: torch.Tensor, adds=(), out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Divide-and-round by the special prime: [..., k+1, N] coeff over q ∪ P
    -> [..., k, N] over q (the rows of ctx's q; P's the last row of c), plus
    up to two ``Addend``s (or tensors) mod q, each added to the output rows
    its first axis covers (``mod_kernels.Addend``), into ``out`` where
    given.  A CUDA c goes to the K6 kernel (``mod_kernels.mod_down``, one
    launch), a CPU c to ``mod_down_plain``."""
    ec = eval_consts(ctx)
    consts = (ec.q, ec.qi, ec.p_mod_q, ec.p_inv_mont, ec.p_half)
    if c.is_cuda:
        from . import mod_kernels

        return mod_kernels.mod_down(c, *consts, adds=adds, out=out)
    return mod_down_plain(c, *consts, adds=adds, out=out)


def mod_down_plain(c, q, qinv_neg, p_mod_q, p_inv_mont, p_half, adds=(), out=None) -> torch.Tensor:
    """Plain version of ``mod_down`` (int64 PyTorch), on the K6 wrapper's
    arguments: [k, 1] columns q, qinv_neg, P mod q, Mont(P^-1 mod q) and
    p_half = P // 2; the addends each ``add_mod_plain``-ed (read through
    ``gather_mod_plain`` where gathered) into the rows they cover."""
    xp = c[..., -1:, :]
    a1 = reduce_u32_plain(xp, q)
    fix = torch.where(xp > p_half, sub_mod_plain(a1, p_mod_q, q), a1)
    res = mont_mul_plain(sub_mod_plain(c[..., :-1, :], fix, q), p_inv_mont, q, qinv_neg)
    for x, idx, sign in map(addend, adds):
        if idx is not None:
            x = gather_mod_plain(x, idx, q, sign)
        rows = x.shape[0] if res.dim() > 2 else None
        res[:rows] = add_mod_plain(res[:rows], x, q)
    return into_out(res, out)


def keyswitch(
    ctx: Context,
    poly_q: torch.Tensor,
    ksk: KSwitchKey,
    digit_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """poly_q [..., k, N] coeff mod q -> (d0, d1) [..., k, N] coeff mod q such
    that d0 + d1*s ~= poly * target (+ small noise).

    ``digit_chunk`` processes the decomposition digits in groups of that
    size, bounding the hoisted-digit temporary; modular adds are exact so
    the regrouped accumulation is bit-identical."""
    d = mod_down(ctx, keyswitch_products(ctx, poly_q, ksk, digit_chunk))  # [2, ..., k', N]
    return d[0], d[1]


def keyswitch_products(
    ctx: Context,
    poly_q: torch.Tensor,
    ksk: KSwitchKey,
    digit_chunk: Optional[int] = None,
) -> torch.Tensor:
    """``keyswitch`` up to its mod-down: [2, ..., k'+1, N] coefficients over
    q ∪ P, k0's first, for a ``mod_down`` that adds what the caller adds to
    d0 and d1 in the same launch."""
    kd = ctx.whole.k
    if digit_chunk is None or digit_chunk >= kd:
        acc = hoisted_ks_products(ctx, hoist_digits(ctx, poly_q), ksk)
    else:
        poly_q = ctx.gather(poly_q)
        acc = None
        for s in range(0, kd, digit_chunk):
            e = min(s + digit_chunk, kd)
            fd = ntt.ntt_fwd(_digits(ctx, poly_q, s, e), ctx.tb_qp)
            part = hoisted_ks_products(ctx, fd, ksk, slice(s, e))
            acc = part if acc is None else add_mod(acc, part, ctx.tb_qp.q)
    return ntt.ntt_inv(acc, ctx.tb_qp)


def _plus(plus: Optional[Ciphertext]):
    """The addend of a ciphertext added to a key-switch's result."""
    if plus is None:
        return ()
    if plus.size != 2:
        raise ValueError(f"only a size-2 ciphertext is added in the mod-down, got {plus.size}")
    return (plus.data,)


def apply_galois(ctx: Context, ct: Ciphertext, g: int, gk: KSwitchKey,
                 plus: Optional[Ciphertext] = None) -> Ciphertext:
    """x(X) -> x(X^g) on a size-2 ciphertext + key-switch back to s, plus
    the size-2 ciphertext ``plus`` where given (``add(plus, rotation)``).

    The permuted c1 is one signed gather (``gather_mod``); the permuted c0
    is never formed: the mod-down reads it through the permutation as an
    addend of d0, writes d0 and d1 stacked, and adds ``plus`` in the same
    launch (K6)."""
    if ct.size != 2:
        raise ValueError("relinearize before rotating")
    with trace.span("hhe.eval.galois"):
        src, sign = ctx.galois_perm_device(g)
        acc = keyswitch_products(ctx, gather_mod(ct.data[1], src, ctx.tb_q.q, sign), gk)
        return Ciphertext(mod_down(ctx, acc, (Addend(ct.data[:1], src, sign),) + _plus(plus)))


def rotate_rows(ctx: Context, ct: Ciphertext, step: int, gks: Dict[int, KSwitchKey],
                plus: Optional[Ciphertext] = None) -> Ciphertext:
    """Rotate both rows left by `step` slots (SEAL rotate_rows semantics),
    plus ``plus`` where given."""
    g = ctx.galois_elt_from_step(step)
    return apply_galois(ctx, ct, g, gks[g], plus)


def rotate_columns(ctx: Context, ct: Ciphertext, gks: Dict[int, KSwitchKey]) -> Ciphertext:
    g = 2 * ctx.n - 1
    return apply_galois(ctx, ct, g, gks[g])


def relinearize(
    ctx: Context,
    ct: Ciphertext,
    rk: KSwitchKey,
    digit_chunk: Optional[int] = None,
    plus: Optional[Ciphertext] = None,
) -> Ciphertext:
    """Size-3 -> size-2 using the relin key (target s^2), plus the size-2
    ciphertext ``plus`` where given; c0 and c1 (and ``plus``) are added to
    d0 and d1 in the mod-down's launch."""
    if ct.size != 3:
        raise ValueError(f"relinearize needs a size-3 ciphertext, got {ct.size}")
    with trace.span("hhe.eval.relinearize"):
        acc = keyswitch_products(ctx, ct.data[2], rk, digit_chunk=digit_chunk)
        return Ciphertext(mod_down(ctx, acc, (ct.data[:2],) + _plus(plus)))


# ---------------------------------------------------------------------------
# BEHZ ct x ct multiplication
# ---------------------------------------------------------------------------


def _to_bsk(ctx: Context, x: torch.Tensor) -> torch.Tensor:
    """[..., k, N] mod q -> [..., kb+1, N] mod Bsk, m_tilde-corrected so the
    result represents the centered value of x (+/- a single q overflow)."""
    ec = eval_consts(ctx)
    tmp = mont_mul(x, ec.mtilde_inv_mont, ec.q, ec.qi)  # digits of x * m_tilde
    cb = rns.fbc_from_digits(tmp, ec.fbc_q_to_bsk)
    cm = rns.fbc_digits_to_pow2(tmp, ec.tilde_mod_mtilde, ctx.m_tilde_bits)
    r = ((cm.to(I64) * ec.neg_qinv_mtilde) & (ctx.m_tilde - 1)).to(x.dtype)  # < 2^16
    # centered r as residue mod each Bsk modulus (b > 2^16 always): r, or
    # r - m_tilde + b where r >= m_tilde / 2
    r_mod_b = center_lift(r[..., None, :], ctx.m_tilde, ec.bq, ctx.m_tilde // 2 - 1)
    return add_mod(
        mont_mul(cb, ec.mtinv_bsk_mont, ec.bq, ec.bqi),
        mont_mul(r_mod_b, ec.q_mtinv_bsk_mont, ec.bq, ec.bqi),
        ec.bq,
    )


def _bsk_to_q(ctx: Context, x_bsk: torch.Tensor) -> torch.Tensor:
    """Exact Shenoy-Kumaresan conversion [..., kb+1, N] Bsk -> [..., k, N] q."""
    ec = eval_consts(ctx)
    f = ec.fbc_b_to_q_msk
    x_b = x_bsk[..., :-1, :]
    x_msk = x_bsk[..., -1:, :]
    y = rns.fbc_apply(x_b, f)  # [..., k'+1, N]: every q row and m_sk, from one set of digits
    y_q, y_msk = y[..., :-1, :], y[..., -1:, :]
    msk_q = f.c_q[-1:]
    msk_qi = f.c_qinv[-1:]
    alpha = mont_mul(
        sub_mod(y_msk, x_msk, msk_q), ec.binv_msk_mont, msk_q, msk_qi
    )  # [...,1,N] in [0, m_sk)
    alpha_c = center_lift(alpha, ec.msk_mod_q, ec.q, ec.msk_half)
    corr = mont_mul(alpha_c, ec.b_mod_q_mont, ec.q, ec.qi)
    return sub_mod(y_q, corr, ec.q)


def _tensor(fa: torch.Tensor, fb_mont: torch.Tensor, q, qi) -> torch.Tensor:
    """NTT-domain tensor product of ciphertexts sized s1, s2 -> s1+s2-1,
    each component's last product or sum written into its place of the
    result (no stack)."""
    s1, s2 = fa.shape[0], fb_mont.shape[0]
    shape = torch.broadcast_shapes(fa.shape[1:], fb_mont.shape[1:])
    out = torch.empty((s1 + s2 - 1, *shape), dtype=fa.dtype, device=fa.device)
    for d in range(s1 + s2 - 1):
        terms = range(max(0, d - s2 + 1), min(s1, d + 1))
        acc = None
        for n, i in enumerate(terms):
            last = out[d] if n == len(terms) - 1 else None
            if acc is None:
                acc = mont_mul(fa[i], fb_mont[d - i], q, qi, out=last)
            else:
                acc = add_mod(acc, mont_mul(fa[i], fb_mont[d - i], q, qi), q, out=last)
    return out


def multiply(ctx: Context, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """BFV multiply: round(t/Q * (a ⊗ b)), result size a.size+b.size-1.

    On a view the q half runs on the rank's limbs; the two q -> Bsk
    conversions sum over every q limb, so their operands are gathered and
    the Bsk half is computed whole on every rank."""
    with trace.span("hhe.eval.multiply"):
        return _multiply(ctx, a, b)


def square(ctx: Context, a: Ciphertext) -> Ciphertext:
    with trace.span("hhe.eval.square"):
        return _multiply(ctx, a, a)


def _multiply(ctx: Context, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    ec = eval_consts(ctx)
    wa = ctx.gather(a.data)
    wb = wa if b.data is a.data else ctx.gather(b.data)
    a_bsk = _to_bsk(ctx.whole, wa)
    b_bsk = _to_bsk(ctx.whole, wb)
    fa_q = ntt.ntt_fwd(ctx.take(a.data), ctx.tb_q)
    fb_q = ntt.to_mont(ntt.ntt_fwd(ctx.take(b.data), ctx.tb_q), ctx.tb_q)
    fa_b = ntt.ntt_fwd(a_bsk, ctx.tb_bsk)
    fb_b = ntt.to_mont(ntt.ntt_fwd(b_bsk, ctx.tb_bsk), ctx.tb_bsk)
    x_q = ntt.ntt_inv(_tensor(fa_q, fb_q, ec.q, ec.qi), ctx.tb_q)
    x_b = ntt.ntt_inv(_tensor(fa_b, fb_b, ec.bq, ec.bqi), ctx.tb_bsk)
    # fast floor of t*x / Q in Bsk
    tx_q = mont_mul(x_q, ec.t_mont_q, ec.q, ec.qi)
    tx_b = mont_mul(x_b, ec.t_mont_bsk, ec.bq, ec.bqi)
    f = rns.fbc_apply(ctx.gather(tx_q), ec.fbc_q_to_bsk)
    y_b = mont_mul(sub_mod(tx_b, f, ec.bq), ec.qinv_bsk_mont, ec.bq, ec.bqi)
    return Ciphertext(_bsk_to_q(ctx, y_b))


def exponentiate(ctx: Context, a: Ciphertext, e: int, rk: KSwitchKey) -> Ciphertext:
    """Repeated multiply + relinearize (reference Evaluator::exponentiate)."""
    if e < 1:
        raise ValueError(f"exponent {e} must be >= 1")
    out = a
    for _ in range(e - 1):
        out = relinearize(ctx, multiply(ctx, out, a), rk)
    return out
