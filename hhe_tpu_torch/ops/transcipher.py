"""Homomorphic PASTA-3 transcipher — counterpart of ``hhe_tpu.ops.transcipher``.

Evaluates PASTA-3 decryption under BFV on the HE-encrypted symmetric key,
turning PASTA ciphertexts into BFV ciphertexts ("decomposition").

- Only SHAKE words cross from the host: each block's first rows of the
  round matrices and its round-constant words, 2 x 4 x 2 x 128 words, all
  of a request's blocks in one upload (``block_words``).  The row
  recurrence, diagonal extraction, BSGS pre-rotation, slot encoding and NTT
  lifting to q ∪ P (``_expand_round_mats``) and the round constants' slot
  encoding and round(Q m / t) scaling (``_round_constants``) run on the
  context's device.
- The keystream ciphertext depends only on (key, nonce, block), so it is
  computed once and cached; decomposing a batch of B samples is then one
  batched negate + encode + add (``_finish_impl``).
- Every galois permutation in the NTT domain is index selection on the last
  axis (the JAX package's MXU one-hot lowering is a TPU workaround for slow
  gathers and has no counterpart here).

Packing: PASTA key/state halves live at slots ``[0..T)`` (row 0) and
``[N/2..N/2+T)`` (row 1); `mix` is a column swap.

A Transcipher on a ``parallel.limb_shard.LimbView`` (``on_limbs``) holds
the rank's rows of the BSGS keys and expands the round material only over
the rank's moduli; its keystream takes a whole or a limb-split encrypted
key and returns the rank's limbs.

The four units the JAX package jits -- ``_jit_expand``, ``_jit_keystream``,
``_jit_keystream_seeded`` and ``_jit_finish`` -- are, on a whole Context,
``utils.graphs`` callables: on the card each is captured once per layout as
a CUDA graph and replayed as one launch; on the CPU each runs its body.  On
a limb view they are the bodies themselves (graphs that hold the view's
collectives are not made).
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List

import numpy as np
import torch

from ..utils import graphs, trace
from . import bfv_eval, ntt, pasta, rns
from .bfv import Ciphertext, Context, KSwitchKey, PublicKey
from .modular import add_mod, gather_mod, mont_mac, mont_mul, neg_mod, sum_mod, to_mont_host

T = pasta.PASTA_T
# each block's round constants by where they were made
RC_BLOCKS = {"device": 0, "host": 0}
# BSGS split of the 128 diagonals: n1 babysteps x n2 giantsteps.  Any split
# with n1 * n2 = 128 is bit-equivalent; this is the JAX package's default.
BSGS_N1 = 32
BSGS_N2 = 4
I64 = torch.int64


def galois_elts(
    ctx: Context, use_bsgs: bool = True, n1: int = BSGS_N1, n2: int = BSGS_N2
) -> List[int]:
    """Galois elements the transcipher needs: rotate -1, column swap, +T when
    the packing is not full, and for the BSGS matmul the babystep elements
    -1..-(n1-1) and giantstep elements -n1*k."""
    elts = {ctx.galois_elt_from_step(-1), 2 * ctx.n - 1}
    if ctx.n // 2 != T:
        elts.add(ctx.galois_elt_from_step(T))
    if use_bsgs:
        for j in range(1, n1):
            elts.add(ctx.galois_elt_from_step(-j))
        for k in range(1, n2):
            elts.add(ctx.galois_elt_from_step(-k * n1))
    return sorted(elts)


class Transcipher:
    """Evaluates PASTA-3 decryption under BFV (one instance per context+keys)."""

    def __init__(
        self,
        ctx: Context,
        rk: KSwitchKey,
        gks: Dict[int, KSwitchKey],
        use_bsgs: bool = True,
        n1: int = BSGS_N1,
        n2: int = BSGS_N2,
    ):
        if n1 * n2 != T:
            raise ValueError(f"BSGS split {n1} x {n2} must cover the {T} diagonals")
        self.ctx = ctx
        self.rk = rk
        self.gks_all = gks
        self.n1, self.n2 = n1, n2
        self.g_neg1 = ctx.galois_elt_from_step(-1)
        self.g_cols = 2 * ctx.n - 1
        self.g_t = ctx.galois_elt_from_step(T) if ctx.n // 2 != T else None
        self.gk_neg1 = gks[self.g_neg1]
        self.gk_cols = gks[self.g_cols]
        self.gk_t = gks[self.g_t] if self.g_t is not None else gks[self.g_neg1]
        self.use_bsgs = use_bsgs and set(galois_elts(ctx, True, n1, n2)) <= set(gks)
        if self.use_bsgs:
            self._build_bsgs_keys(gks)
        half = ctx.n // 2
        mask = np.zeros(half + T, np.int64)
        mask[1:T] = 1
        mask[half + 1 : half + T] = 1
        self.feistel_mask = ctx.plain_for_mul(ctx.encode(mask))
        # bounded LRU caches: round material is ~0.5 GB per block at N=16384
        self._pt_cache: collections.OrderedDict = collections.OrderedDict()
        self._pt_cache_max = 4
        # keystream cts; each value pins its enc_key tensor so that the id()
        # in the key cannot be reused while the entry lives
        self._ks_cache: collections.OrderedDict = collections.OrderedDict()
        self._ks_cache_max = 64
        self._limb_tcs: Dict[int, tuple] = {}  # id(mesh) -> (mesh, Transcipher)
        self._build_expand_consts()
        base = (self.rk, self.gk_neg1, self.gk_t, self.gk_cols)
        if self.use_bsgs:
            base += ((self.baby_k, *self._baby_idx), (self.giant_k, *self._giant_idx))
        self._key_bundle = base  # one object: the graphs read the keys by its identity
        if isinstance(ctx, Context):
            def unit(fn, name):
                return graphs.jit(fn, name, ctx)
        else:
            def unit(fn, name):
                return fn
        self._jit_keystream = unit(self._keystream_impl, "keystream")
        self._jit_keystream_seeded = unit(self._keystream_seeded_impl, "keystream_seeded")
        self._jit_expand = unit(self._expand_impl, "expand")
        self._jit_finish = unit(self._finish_impl, "finish")

    def _cache_put(self, cache, maxsize, key, value):
        cache[key] = value
        cache.move_to_end(key)
        while len(cache) > maxsize:
            cache.popitem(last=False)

    def clear_caches(self):
        """Free the device round-material / keystream caches (the round
        material is ~0.5 GB per block at production N), those of the limb
        views too."""
        self._pt_cache.clear()
        self._ks_cache.clear()
        for _, tc in self._limb_tcs.values():
            tc.clear_caches()

    def on_limbs(self, mesh) -> "Transcipher":
        """This transcipher on the rank's limbs of ``mesh`` (a
        ``parallel.mesh.Mesh`` with a "limb" axis): a Transcipher on a
        ``LimbView``, built once a mesh, with its own caches (a whole and a
        split keystream never share an entry).  Where the axis does not
        divide k every rank keeps all limbs, and this is ``self``."""
        hit = self._limb_tcs.get(id(mesh))
        if hit is None:
            from ..parallel import limb_shard

            view = limb_shard.LimbView(self.ctx, mesh)
            tc = self if not view.split else Transcipher(
                view, self.rk, self.gks_all, self.use_bsgs, self.n1, self.n2)
            hit = self._limb_tcs[id(mesh)] = (mesh, tc)  # pins mesh: its id stays unique
        return hit[1]

    def _build_bsgs_keys(self, gks: Dict[int, KSwitchKey]):
        """Precompute the batched BSGS material.

        Babysteps permute after the key contraction: with
        K'_{j,d} = sigma_j^{-1}(K_{j,d}) precomputed here,
        sum_d sigma_j(fd_d) * K_{j,d} == sigma_j(sum_d fd_d * K'_{j,d}), so
        the hot path permutes the [k+1, N] contraction results instead of the
        [kd, k+1, N] digit tensors.  On a limb view only the rank's target
        moduli and P of each key are kept: [k'+1, kd, N].  Each step's k0
        and k1 are held as one [2, steps, k'+1, kd, N] tensor (``baby_k``,
        ``giant_k``; ``baby_k0`` and the like are views of it), so that one
        K4 launch contracts the digits with both.  The index tables are
        int32, and the views the gathers and sums read them through
        (``_baby_idx``, ``_giant_idx``) are made here once: K5 checks an
        index's range once per tensor."""
        ctx = self.ctx
        dev = ctx.device

        def inv_permuted(elt: int):
            src = bfv_eval.ntt_galois_src(ctx, elt)
            inv = torch.as_tensor(np.argsort(src), device=dev)
            # moduli-major [2, k+1, kd, N] layout
            return ctx.take_qp(gks[elt].pair)[..., inv].transpose(1, 2), src

        baby = [inv_permuted(ctx.galois_elt_from_step(-j)) for j in range(1, self.n1)]
        self.baby_k = torch.stack([b[0] for b in baby], dim=1)  # [2, n1-1, k+1, kd, N]
        self.baby_k0, self.baby_k1 = self.baby_k
        ident = np.arange(ctx.n)
        # row 0 = identity: used for the rot_f0 fan-out (j = 0 term included)
        self.baby_srcs = torch.as_tensor(
            np.stack([ident] + [b[1] for b in baby]).astype(np.int32), device=dev
        )  # [n1, N]
        # rot_f0's [n1, 1, N] (over the limbs of f0) and the babystep
        # results' [1, n1-1, 1, N] (over k0/k1 and q ∪ P)
        self._baby_idx = (self.baby_srcs[:, None, :], self.baby_srcs[None, 1:, None, :])
        giant = [
            inv_permuted(ctx.galois_elt_from_step(-k * self.n1))
            for k in range(1, self.n2)
        ]
        if not giant:  # n2 = 1: no giantsteps
            self.giant_k = self.giant_k0 = self.giant_k1 = None
            self.giant_nsrc = self.giant_csrc = self.giant_csign = None
            self._giant_idx = ()
            return
        self.giant_k = torch.stack([g[0] for g in giant], dim=1)  # [2, n2-1, k+1, kd, N]
        self.giant_k0, self.giant_k1 = self.giant_k
        self.giant_nsrc = torch.as_tensor(np.stack([g[1] for g in giant]).astype(np.int32), device=dev)
        csrc, csign = zip(
            *(ctx.galois_perm(ctx.galois_elt_from_step(-k * self.n1)) for k in range(1, self.n2))
        )
        self.giant_csrc = torch.as_tensor(np.stack(csrc).astype(np.int32), device=dev)
        self.giant_csign = torch.as_tensor(np.stack(csign), device=dev)
        # the contraction results' [1, n2-1, 1, N]; inner_g's [n2-1, 1, N] and its signs
        self._giant_idx = (self.giant_nsrc[None, :, None, :], self.giant_csrc[:, None, :],
                           self.giant_csign[:, None, :])

    # ------------------------------------------------------------------
    # Key encryption
    # ------------------------------------------------------------------

    def encrypt_key(self, pk: PublicKey, key: np.ndarray) -> Ciphertext:
        key = np.asarray(key, np.uint64)
        if key.shape != (pasta.KEY_SIZE,):
            raise ValueError(f"PASTA key must have {pasta.KEY_SIZE} words")
        half = self.ctx.n // 2
        vec = np.zeros(half + T, np.int64)
        vec[:T] = key[:T]
        vec[half : half + T] = key[T:]
        return self.ctx.encrypt(pk, self.ctx.encode(vec))

    # ------------------------------------------------------------------
    # Device round-material expansion (seeded)
    # ------------------------------------------------------------------

    def _build_expand_consts(self):
        ctx = self.ctx
        dev = ctx.device
        half, n = ctx.n // 2, ctx.n
        i_idx = np.arange(T)[:, None]
        j_idx = np.arange(T)[None, :]
        self._diag_sel = torch.as_tensor((j_idx + T - i_idx) % T, device=dev)  # [T(i), T(j)]
        roll = (i_idx // self.n1) * self.n1 if self.use_bsgs else np.zeros_like(i_idx)
        tgt0 = (j_idx - roll) % half  # slot within row 0
        self._scatter_rows = torch.as_tensor(np.broadcast_to(i_idx, (T, T)).copy(), device=dev)
        self._scatter_cols0 = torch.as_tensor(tgt0, device=dev)
        self._scatter_cols1 = torch.as_tensor(tgt0 + half, device=dev)
        # encoder inverse permutation: poly_br = slots[inv_map]
        inv_map = np.empty(n, np.int64)
        inv_map[ctx.encoder_map] = np.arange(n)
        self._enc_inv_map = torch.as_tensor(inv_map, device=dev)
        self._tb_t = ntt.build_tables((ctx.t,), n, dev)  # t below 2^31
        # plain-add scaling constants: round(Q m / t) mod q_i = delta_i * m +
        # fix with fix = floor((r m + h) / t), r = Q mod t, h = (t+1)/2; one
        # conditional subtract reduces fix < t mod q_i while t <= 2 q_i
        t = int(ctx.t)
        if t > 2 * min(int(q) for q in ctx.q_moduli):
            raise ValueError(f"t = {t} exceeds twice the smallest q_i")
        self._fin_r = int(ctx.q_mod_t) % t
        self._fin_h = (t + 1) // 2
        self._fin_delta_mont = torch.tensor(
            [
                int(to_mont_host(np.uint64(int(d) % int(q)), int(q)))
                for d, q in zip(ctx.delta_mod_q, ctx.q_moduli)
            ],
            dtype=I64,
            device=dev,
        ).reshape(ctx.k, 1)

    def _expand_round_mats(self, first_rows: torch.Tensor) -> torch.Tensor:
        """first_rows int32 [8, T] (4 rounds x (mat1, mat2)) -> NTT+Mont
        plaintext diagonals over q ∪ P: [4, T, k+1, N]."""
        ctx = self.ctx
        t_q, t_qi, t_r2 = self._tb_t.q[0], self._tb_t.qinv_neg[0], self._tb_t.r2[0]

        first_m = mont_mul(first_rows, t_r2, t_q, t_qi)  # Mont domain
        # row recurrence row[j] = first[j]*prev[T-1] + prev[j-1]  (mod t)
        rows = [first_rows]
        prev = first_rows
        zero = torch.zeros_like(first_rows[:, :1])
        for _ in range(T - 1):
            prod = mont_mul(first_m, prev[:, T - 1 : T], t_q, t_qi)
            prev = add_mod(prod, torch.cat([zero, prev[:, :-1]], dim=1), t_q)
            rows.append(prev)
        mats = torch.stack(rows, 1)  # [8, T(row), T(col)]

        # diagonals: d[s, i, j] = mats[s, j, (j+T-i)%T]
        dev = first_rows.device
        d = mats[
            torch.arange(8, device=dev)[:, None, None],
            torch.arange(T, device=dev)[None, None, :],
            self._diag_sel[None, :, :],
        ]  # [8, T(i), T(j)]
        # scatter into slot rows with BSGS pre-rotation; mat1 and mat2 have
        # disjoint supports, so their sum is their union
        slot_vecs = torch.zeros((4, T, ctx.n), dtype=first_rows.dtype, device=dev)
        slot_vecs[:, self._scatter_rows, self._scatter_cols0] = d[0::2]
        slot_vecs[:, self._scatter_rows, self._scatter_cols1] = d[1::2]

        # encode: slots -> bit-reversed order -> inverse NTT mod t
        poly_br = slot_vecs[..., self._enc_inv_map]
        poly = ntt.ntt_inv(poly_br[..., None, :], self._tb_t)[..., 0, :]  # [4,T,N] mod t
        # lift to q ∪ P: reduce, forward NTT, to Montgomery (the residues of
        # ``Context.plain_for_mul_qp_batch``)
        tb = ctx.tb_qp
        return ntt.to_mont(ntt.ntt_fwd(rns.reduce_u32(poly[..., None, :], tb.q), tb), tb)

    def _encode_scaled(self, slots: torch.Tensor) -> torch.Tensor:
        """Slot vectors int32 [B, N] (values mod t) -> their plaintexts m
        scaled for a plain add, round(Q m / t) mod q_i: [B, k, N].

        Encodes on the device (the encoder's inverse map, then K2 at t) and
        computes delta_i m + fix; fix = floor((r m + h) / t) < t is exact
        int64 division (the JAX package reaches the same quotient with
        wrapping u32 arithmetic and t^-1 mod 2^32).  Bit for bit
        ``Context.plain_for_add_batch(Context.encode_batch(...))``."""
        ctx = self.ctx
        q, qi = ctx.tb_q.q, ctx.tb_q.qinv_neg
        poly_br = slots[:, self._enc_inv_map]
        m = ntt.ntt_inv(poly_br[:, None, :], self._tb_t)[:, 0, :]  # [B, N] mod t
        fix = torch.div(
            m.to(I64) * self._fin_r + self._fin_h, int(ctx.t), rounding_mode="floor"
        )
        dm = mont_mul(m[:, None, :], self._fin_delta_mont, q, qi)  # [B, k, N]
        fixb = fix[:, None, :]
        fixr = torch.where(fixb >= q, fixb - q, fixb)
        return add_mod(dm, fixr, q)

    def _round_constants(self, rc_words: torch.Tensor) -> torch.Tensor:
        """Round-constant words int32 [8, T] (rows 2r, 2r+1: rcs1[r],
        rcs2[r]) -> the scaled plaintexts [4, k, N] (``block_rcs``'s)."""
        half = self.ctx.n // 2
        slots = torch.zeros((4, self.ctx.n), dtype=rc_words.dtype, device=rc_words.device)
        slots[:, :T] = rc_words[0::2]
        slots[:, half : half + T] = rc_words[1::2]
        return self._encode_scaled(slots)

    def _expand_impl(self, words: torch.Tensor):
        """A block's SHAKE words int32 [16, T] (``block_words``) -> its
        round material: ([4, T, k+1, N] diagonals, [4, k, N] constants)."""
        return self._expand_round_mats(words[:8]), self._round_constants(words[8:])

    def block_words(self, nonce: int, blocks: List[int]) -> torch.Tensor:
        """Host: each block's SHAKE words, [len(blocks), 16, T] int32 in one
        upload: rows 0-7 the first rows of the round matrices (4 rounds x
        (mat1, mat2); the span ``hhe.transcipher.first_rows``, which runs
        the SHAKE expansion), rows 8-15 the round-constant words (4 rounds x
        (rcs1, rcs2); the span ``hhe.transcipher.round_constants``, which
        holds the upload)."""
        t = self.ctx.t
        out = np.empty((len(blocks), 16, T), np.uint32)
        with trace.span("hhe.transcipher.first_rows"):
            for i, b in enumerate(blocks):
                mats1, mats2, _, _ = pasta.block_randomness(t, nonce, b)
                for r in range(4):
                    out[i, 2 * r] = mats1[r][0]
                    out[i, 2 * r + 1] = mats2[r][0]
        with trace.span("hhe.transcipher.round_constants"):
            for i, b in enumerate(blocks):
                _, _, rcs1, rcs2 = pasta.block_randomness(t, nonce, b)
                out[i, 8::2] = rcs1
                out[i, 9::2] = rcs2
            return self.ctx.to_device(out)

    def block_rcs(self, nonce: int, b: int) -> torch.Tensor:
        """Host: scaled round-constant plaintexts [4, k, N], the reference
        for ``_round_constants`` (the span ``hhe.transcipher.round_constants``)."""
        with trace.span("hhe.transcipher.round_constants"):
            RC_BLOCKS["host"] += 1
            ctx = self.ctx
            half = ctx.n // 2
            _, _, rcs1, rcs2 = pasta.block_randomness(ctx.t, nonce, b)
            rc_vecs = np.zeros((4, half + T), np.uint64)
            for r in range(4):
                rc_vecs[r, :T] = rcs1[r]
                rc_vecs[r, half : half + T] = rcs2[r]
            return ctx.plain_for_add_batch(ctx.encode_batch(rc_vecs))

    def _keystream_seeded_impl(self, key_data, words, keys):
        """Keystream with the block's round material made on the device
        from its SHAKE words [16, T]."""
        return self._keystream_impl(key_data, *self._expand_impl(words), keys)

    # ------------------------------------------------------------------
    # Homomorphic building blocks
    # ------------------------------------------------------------------

    def _keys(self):
        """(rk, gk_neg1, gk_t, gk_cols[, (baby_k, *_baby_idx), (giant_k,
        *_giant_idx)]): the same tuple on every call."""
        return self._key_bundle

    def round_mats(self, mats: torch.Tensor, r: int):
        """Round r of a block's [4, T, k+1, N] diagonals (``_expand_impl``'s):
        (q part, q ∪ P) for BSGS, the q part alone for the diagonal matmul."""
        m = mats[r]
        q_part = m[..., : self.ctx.k, :]
        return (q_part, m) if self.use_bsgs else q_part

    def _matmul(self, st: Ciphertext, mats, keys) -> Ciphertext:
        if self.use_bsgs:
            return self._matmul_bsgs(st, mats, keys)
        return self._matmul_diag(st, mats, keys)

    def _matmul_diag(self, st: Ciphertext, mats: torch.Tensor, keys) -> Ciphertext:
        """Packed two-matrix diagonal product: T-1 sequential rotations."""
        ctx = self.ctx
        gk_neg1, gk_t = keys[1], keys[2]
        if self.g_t is not None:
            st = bfv_eval.apply_galois(ctx, st, self.g_t, gk_t, plus=st)
        acc = bfv_eval.multiply_plain(ctx, st, mats[0])
        for diag in mats[1:]:
            st = bfv_eval.apply_galois(ctx, st, self.g_neg1, gk_neg1)
            acc = bfv_eval.add(ctx, acc, bfv_eval.multiply_plain(ctx, st, diag))
        return acc

    def _matmul_bsgs(self, st: Ciphertext, mats, keys) -> Ciphertext:
        """Babystep-giantstep matmul with one hoisted digit decomposition per
        matmul, permute-after-contraction babysteps, all babysteps and
        giantstep groups batched, and lazy mod-down over q ∪ P.

        Each NTT-domain permutation is one K5 gather, each giantstep sum one
        K5 sum over the gathered (and signed) terms, and each mod-down adds
        what the JAX package adds after it, writing its result in place of
        the stack (K6): no PyTorch gather, where, stack or add loop."""
        ctx = self.ctx
        n1, n2 = self.n1, self.n2
        mats_q, mats_qp = mats  # [T, k, N], [T, k+1, N]
        gk_t = keys[2]
        baby_k, rot_idx, h_idx = keys[4]
        q, qi = ctx.tb_q.q, ctx.tb_q.qinv_neg
        qp, qpi = ctx.tb_qp.q, ctx.tb_qp.qinv_neg

        if self.g_t is not None:
            st = bfv_eval.apply_galois(ctx, st, self.g_t, gk_t, plus=st)

        f01 = ntt.ntt_fwd(st.data, ctx.tb_q)  # one call for both components
        f0, f1 = f01[0], f01[1]
        fd = bfv_eval.hoist_digits(ctx, st.data[1])  # [kd, k+1, N] NTT(qP), one gather
        fd_t = fd.transpose(-3, -2)  # moduli-major [k+1, kd, N]

        # all n1 NTT-domain rotations of f0 at once (row 0 = identity)
        rot_f0 = gather_mod(f0[None], rot_idx)  # [n1, k, N]

        qpc, qpic = qp[:, None], qpi[:, None]  # the moduli on axis -3

        def contract(fdig_t, ks):  # over all kd digits (axis -2), k0 and k1 in one launch
            return mont_mac(fdig_t, ks, qpc, qpic, -2)

        b = contract(fd_t, baby_k)  # [2, n1-1, k+1, N]
        h = gather_mod(b, h_idx)  # H0, H1

        dq = mats_q.reshape(n2, n1, ctx.k, ctx.n)
        dqp = mats_qp.reshape(n2, n1, ctx.k + 1, ctx.n)

        # q-part: acc0q[g] = sum_j rot_f0[j] * Dq[g, j]; raw c1 only at j = 0;
        # both written into one [2, n2, k, N] tensor
        accq = f01.new_empty((2, n2, ctx.k, ctx.n))
        mont_mac(rot_f0[None], dq, q, qi, 1, out=accq[0])
        mont_mul(f1[None], dq[:, 0], q, qi, out=accq[1])

        # P-part: acc*p[g] = sum_{j>=1} H*[j] * Dqp[g, j], lazily over q ∪ P
        accp = mont_mac(h[:, None], dqp[:, 1:], qp, qpi, 2)  # [2, n2, k+1, N]

        # inner[c, g] = iq[c, g] + mod_down(ip)[c, g], one launch
        inner = bfv_eval.mod_down(ctx, ntt.ntt_inv(accp, ctx.tb_qp), (ntt.ntt_inv(accq, ctx.tb_q),))
        if n2 == 1:
            return Ciphertext(inner[:, 0])

        # giantsteps: out = inner_0 + sum_g sigma_{-g*n1}(inner_g)
        nsrc_idx, csrc_idx, csign_idx = keys[5][1:]
        p0 = sum_mod(inner[0, 1:], q, 0, csrc_idx, csign_idx)  # [k, N]

        fdg = bfv_eval.hoist_digits(ctx, inner[1, 1:])  # [n2-1, kd, k+1, N]
        g01 = contract(fdg.transpose(-3, -2), keys[5][0])  # [2, n2-1, k+1, N]
        accg = sum_mod(g01, qp, 1, nsrc_idx)  # [2, k+1, N]
        # row 0: inner_0[0] + p0 + mod_down(accg0); row 1: inner_1[0] + mod_down(accg1)
        return Ciphertext(bfv_eval.mod_down(ctx, ntt.ntt_inv(accg, ctx.tb_qp),
                                            (p0[None], inner[:, 0])))

    def _mix(self, st: Ciphertext, keys) -> Ciphertext:
        """(2 1; 1 2) over the two rows (rotate_columns + adds)."""
        ctx = self.ctx
        tmp = bfv_eval.apply_galois(ctx, st, self.g_cols, keys[3], plus=st)
        return bfv_eval.add(ctx, st, tmp)

    def _sbox_feistel(self, st: Ciphertext, keys) -> Ciphertext:
        """state[i] += state[i-1]^2 (rotate, mask, square, relinearize, add)."""
        ctx = self.ctx
        rot = bfv_eval.apply_galois(ctx, st, self.g_neg1, keys[1])
        rot = bfv_eval.multiply_plain(ctx, rot, self.feistel_mask)
        return bfv_eval.relinearize(ctx, bfv_eval.square(ctx, rot), keys[0], plus=st)

    def _finish_impl(self, ks_data: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
        """Negate the keystream and add the symmetric-ciphertext chunk.

        Encodes the chunk on the device and scales it for the plain add
        (``_encode_scaled``).

        ks_data [2, k, N]; chunk int32 [B, L<=T]; returns [2, B, k, N]."""
        ctx = self.ctx
        q = ctx.tb_q.q
        slots = torch.zeros((chunk.shape[0], ctx.n), dtype=torch.int32, device=chunk.device)
        slots[:, : chunk.shape[1]] = chunk
        scaled = self._encode_scaled(slots)
        c0 = add_mod(neg_mod(ks_data[0], q)[None], scaled, q)
        c1 = neg_mod(ks_data[1], q)[None].expand(c0.shape)
        return torch.stack([c0, c1])

    def _keystream_impl(self, key_data, mats_qp, rcs_pt, keys) -> torch.Tensor:
        """Full 3-round PASTA keystream evaluation on the encrypted key
        (whole or the view's limbs)."""
        ctx = self.ctx
        st = Ciphertext(ctx.take(key_data))
        for r in range(4):
            st = self._matmul(st, self.round_mats(mats_qp, r), keys)
            st = bfv_eval.add_plain(ctx, st, rcs_pt[r])
            st = self._mix(st, keys)
            if r < 2:
                st = self._sbox_feistel(st, keys)
            elif r == 2:
                st = bfv_eval.exponentiate(ctx, st, 3, keys[0])
        return st.data

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def keystream_ct(self, enc_key: Ciphertext, nonce: int, b: int) -> Ciphertext:
        """BFV ciphertext of the PASTA keystream for block b (cached by key,
        nonce and block), from the block's round material made on the
        device (``device_block_plaintexts``)."""
        ck = (id(enc_key.data), nonce, b)
        if ck not in self._ks_cache:
            mats, rcs_pt = self.device_block_plaintexts(nonce, b)
            out = self._jit_keystream(enc_key.data, mats, rcs_pt, self._keys())
            self._cache_put(
                self._ks_cache, self._ks_cache_max, ck, (enc_key.data, Ciphertext(out))
            )
        return self._ks_cache[ck][1]

    def device_block_plaintexts(self, nonce: int, b: int):
        """Per-block round material, made on the device from the block's
        SHAKE words (cached by nonce and block): ([4, T, k+1, N] NTT+Mont
        diagonals, [4, k, N] round constants)."""
        ck = (nonce, b)
        if ck not in self._pt_cache:
            words = self.block_words(nonce, [b])[0]
            RC_BLOCKS["device"] += 1
            self._cache_put(self._pt_cache, self._pt_cache_max, ck, self._jit_expand(words))
        return self._pt_cache[ck]

    def keystream_blocks(
        self, enc_key: Ciphertext, nonce: int, blocks: List[int]
    ) -> List[Ciphertext]:
        """Keystream ciphertexts for several blocks (cached).  With two or
        more blocks missing, their SHAKE words cross in one upload and each
        block's round material is made inside its own keystream evaluation
        and not kept."""
        missing = [b for b in blocks if (id(enc_key.data), nonce, b) not in self._ks_cache]
        if len(missing) >= 2:
            keys = self._keys()
            words = self.block_words(nonce, missing)
            RC_BLOCKS["device"] += len(missing)
            for b, w in zip(missing, words):
                out = self._jit_keystream_seeded(enc_key.data, w, keys)
                self._cache_put(
                    self._ks_cache, self._ks_cache_max,
                    (id(enc_key.data), nonce, b), (enc_key.data, Ciphertext(out)),
                )
        return [self.keystream_ct(enc_key, nonce, b) for b in blocks]

    def keystream_round_budgets(
        self, enc_key: Ciphertext, sk, nonce: int = pasta.NONCE, b: int = 0
    ) -> List[int]:
        """Noise budget (bits) after each of the 4 keystream rounds."""
        ctx = self.ctx
        mats_qp, rcs_pt = self.device_block_plaintexts(nonce, b)
        keys = self._keys()
        st = Ciphertext(enc_key.data)
        budgets = []
        for r in range(4):
            st = self._matmul(st, self.round_mats(mats_qp, r), keys)
            st = bfv_eval.add_plain(ctx, st, rcs_pt[r])
            st = self._mix(st, keys)
            if r < 2:
                st = self._sbox_feistel(st, keys)
            elif r == 2:
                st = bfv_eval.exponentiate(ctx, st, 3, keys[0])
            budgets.append(ctx.noise_budget(sk, st))
        return budgets

    def decompose(
        self, enc_key: Ciphertext, sym_ct, nonce: int = pasta.NONCE, mesh=None
    ) -> List[Ciphertext]:
        """PASTA ciphertexts -> BFV ciphertexts.

        sym_ct: [L] or [B, L].  Returns one ciphertext per 128-block; for
        batched input each has data shape [2, B, k, N].

        With ``mesh`` (a ``parallel.mesh.Mesh`` with "batch" and "limb"
        axes) the keystream is evaluated on the rank's limbs where the limb
        axis divides k (``on_limbs``), each batch rank finishes its share of
        the sample batch (padded to a multiple of the axis with
        ``pad_batch``) on those limbs, and the limbs and then the shares are
        gathered, so every rank returns the whole result."""
        sym = np.asarray(sym_ct, np.uint64)
        batched = sym.ndim == 2
        sym2 = np.atleast_2d(sym)
        B, L = sym2.shape
        nblocks = math.ceil(L / T)
        tc = self
        if mesh is not None:
            from ..parallel import mesh as hmesh

            tc = self.on_limbs(mesh)
            sym2 = hmesh.local_batch(hmesh.pad_batch(sym2, mesh.shape["batch"])[0], mesh)
        kss = tc.keystream_blocks(enc_key, nonce, list(range(nblocks)))
        out = []
        for b in range(nblocks):
            chunk = self.ctx.to_device(sym2[:, b * T : min((b + 1) * T, L)])
            res = tc._jit_finish(kss[b].data, chunk)  # [2, B, k, N]
            if mesh is not None:
                res = hmesh.gather_batch(tc.ctx.gather(res), mesh)[:, :B]
            out.append(Ciphertext(res if batched else res[:, 0]))
        return out
