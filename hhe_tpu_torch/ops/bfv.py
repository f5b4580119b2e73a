"""BFV (RNS) context, keys, encoder, encryption and decryption — counterpart
of ``hhe_tpu.ops.bfv``.

- Ciphertexts are int32 RNS tensors ``[size, k, N]`` (or ``[size, B, k, N]``)
  in coefficient domain on the context's device; key-switch keys are stored
  in NTT + Montgomery domain.
- Prime selection, the encoder map, the galois maps and the host keygen /
  encrypt / decrypt are the JAX package's, draw for draw from
  ``np.random.default_rng(params.seed)``, so the same ``BFVParams`` give the
  same keys and ciphertexts in both packages (key-switch keys take their
  algebra on the context's device, with the same residues).
- ``Context(params, device=None)`` runs on CUDA; without a card it raises
  unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..utils import trace
from . import modular, ntt, primes, rns

I64 = torch.int64


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; CUDA without a card raises instead of falling
    back to the CPU (pass ``device="cpu"`` to run there)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BFVParams:
    """HE parameters: t=65537, N=16384, 13x30-bit data primes plus one
    special prime (the JAX package's defaults)."""

    n: int = 16384
    t: int = 65537
    data_limb_bits: int = 30
    data_limbs: int = 13
    seed: int = 0

    def __post_init__(self):
        if self.n & (self.n - 1):
            raise ValueError(f"n={self.n} must be a power of two")
        if (self.t - 1) % (2 * self.n):
            raise ValueError("t must be NTT-friendly for batching")


class Ciphertext(NamedTuple):
    """BFV ciphertext: int32 ``[size, k, N]`` coefficient-domain tensor."""

    data: torch.Tensor

    @property
    def size(self) -> int:
        return self.data.shape[0]


class Plaintext(NamedTuple):
    """Plaintext polynomial mod t: u64 ``[N]`` coefficient domain (host)."""

    data: np.ndarray


class SecretKey(NamedTuple):
    s_small: np.ndarray  # [N] int8 ternary coefficients
    s_q: np.ndarray  # [k, N] u32 coeff domain (mod each data prime)


class PublicKey(NamedTuple):
    data: np.ndarray  # [2, k, N] u32 coeff domain


class KSwitchKey(NamedTuple):
    """Key-switch key: digits over data primes, each encrypting
    P * u_j * target over base q ∪ {P}; NTT + Montgomery domain.  Its two
    halves are held as one tensor, so that one K4 launch reads the digits
    once for both (``bfv_eval.hoisted_ks_products``)."""

    pair: torch.Tensor  # [2, kd, k+1, N] int32: k0, k1

    @classmethod
    def of(cls, k0: torch.Tensor, k1: torch.Tensor) -> "KSwitchKey":
        return cls(torch.stack([k0, k1]))

    @property
    def k0(self) -> torch.Tensor:  # [kd, k+1, N]
        return self.pair[0]

    @property
    def k1(self) -> torch.Tensor:
        return self.pair[1]


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------


class Context:
    """All precomputed material for one parameter set on one device."""

    def __init__(self, params: BFVParams = BFVParams(), device=None):
        p = params
        self.params = p
        self.device = resolve_device(device)
        self.n, self.t = p.n, p.t
        # prime selection, as hhe_tpu.ops.bfv.Context: the special prime is
        # the largest prime at the data-limb width, t is never reused
        tskip = (p.t,)
        sp = primes.ntt_primes(p.n, p.data_limb_bits, 1, skip=tskip)
        self.p_special = sp[0]
        self.q_moduli = primes.ntt_primes(
            p.n, p.data_limb_bits, p.data_limbs, skip=tskip + sp
        )
        aux_count = p.data_limbs + 1
        b_moduli = primes.ntt_primes(p.n, 31, aux_count + 2, skip=sp + tskip)
        self.b_moduli = b_moduli[:aux_count]
        self.m_sk = b_moduli[aux_count]
        self.gamma = b_moduli[aux_count + 1]
        self.m_tilde_bits = 16
        self.m_tilde = 1 << self.m_tilde_bits

        self.base_q = rns.RnsBase(self.q_moduli)
        self.base_qp = rns.RnsBase(self.q_moduli + (self.p_special,))
        self.base_bsk = rns.RnsBase(self.b_moduli + (self.m_sk,))
        self.base_b = rns.RnsBase(self.b_moduli)
        self.k = self.base_q.k
        self.Q = self.base_q.Q

        # BEHZ capacity — |tensor product| * t < prod(Bsk)/2
        bound = self.n * self.Q * self.Q * self.t
        if self.base_bsk.Q * self.Q <= 2 * bound:
            raise ValueError("aux base too small")

        dev = self.device
        self.tb_q = ntt.build_tables(self.q_moduli, p.n, dev)
        self.tb_qp = ntt.build_tables(self.base_qp.moduli, p.n, dev)
        self.tb_bsk = ntt.build_tables(self.base_bsk.moduli, p.n, dev)
        self.tb_t_host = ntt.build_host_tables(self.t, p.n)

        # encryption scaling: round(Q*m/t) = delta_i*m + fix(m)
        self.delta_mod_q = np.array(
            [(self.Q // self.t) % q for q in self.q_moduli], np.uint64
        )
        self.q_mod_t = self.Q % self.t

        # key-switch constants
        pq = self.base_qp.moduli
        self.p_mod_q = np.array([self.p_special % q for q in self.q_moduli], np.uint64)
        self.p_inv_mont = torch.tensor(
            [
                int(modular.to_mont_host(np.uint64(pow(self.p_special, -1, q)), q))
                for q in self.q_moduli
            ],
            dtype=I64,
            device=dev,
        ).reshape(self.k, 1)
        self.p_half = self.p_special // 2
        self.unit_mod_qp = np.array(
            [[u % m for m in pq] for u in self.base_q.unit], dtype=np.uint64
        )  # [kd, k+1]

        self._galois_perm_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._galois_dev_cache: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._ntt_perm_cache: Dict[int, np.ndarray] = {}
        self._build_encoder_map()
        self._eval_consts = None
        self._dec_consts = None
        self._ks_factor = None
        self._dec_sk_cache: Dict[int, tuple] = {}
        self._level_bases: Dict[int, rns.RnsBase] = {}

        self.rng = np.random.default_rng(p.seed)

    # The limb view protocol of the evaluator: ``parallel.limb_shard.LimbView``
    # holds one rank's limbs and takes whole-context operands to them, or
    # gathers a rank's limbs back; a Context holds every limb, so all four are
    # the identity.

    @property
    def whole(self) -> "Context":
        return self

    def take(self, x):
        return x

    def take_qp(self, x):
        return x

    def take_key(self, ksk):
        return ksk

    def gather(self, x):
        return x

    def synchronize(self):
        """Wait for the context's device, so that a timed phase holds its work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        """uint32 residues (numpy) -> int32 tensor on this context's device."""
        return ntt.u32_to_torch(a, self.device)

    # ------------------------------------------------------------------
    # Batch encoder (SEAL seal/batchencoder.h semantics)
    # ------------------------------------------------------------------

    def _build_encoder_map(self):
        n, m = self.n, 2 * self.n
        rev = ntt.bit_reverse_indices(n)
        idx_map = np.empty(n, np.int64)
        pos = 1
        for i in range(n // 2):
            idx_map[i] = rev[(pos - 1) >> 1]
            idx_map[i + n // 2] = rev[(m - pos - 1) >> 1]
            pos = pos * 3 % m
        self.encoder_map = idx_map

    def encode(self, values) -> Plaintext:
        """Slot values (len <= N, ints mod t; negatives allowed) -> plaintext."""
        v = np.asarray(values, np.int64) % self.t
        if v.ndim != 1 or len(v) > self.n:
            raise ValueError(f"cannot encode {v.shape} values into {self.n} slots")
        slots = np.zeros(self.n, np.uint64)
        slots[self.encoder_map[: len(v)]] = v.astype(np.uint64)
        poly = ntt.ntt_inv_host(slots, self.tb_t_host)
        return Plaintext(poly.astype(np.uint64))

    def encode_batch(self, values: np.ndarray) -> np.ndarray:
        """[B, L<=N] slot values -> [B, N] plaintext polys (the span
        ``hhe.bfv.encode``)."""
        with trace.span("hhe.bfv.encode"):
            v = np.asarray(values, np.int64) % self.t
            b, l = v.shape
            slots = np.zeros((b, self.n), np.uint64)
            slots[:, self.encoder_map[:l]] = v.astype(np.uint64)
            return ntt.ntt_inv_host(slots, self.tb_t_host).astype(np.uint64)

    def decode(self, pt: Plaintext) -> np.ndarray:
        slots = ntt.ntt_fwd_host(np.asarray(pt.data, np.uint64), self.tb_t_host)
        return slots[self.encoder_map].astype(np.uint64)

    def decode_signed(self, pt: Plaintext) -> np.ndarray:
        v = self.decode(pt).astype(np.int64)
        return np.where(v > self.t // 2, v - self.t, v)

    # ------------------------------------------------------------------
    # Sampling (host)
    # ------------------------------------------------------------------

    def _sample_ternary(self) -> np.ndarray:
        return self.rng.integers(-1, 2, self.n, dtype=np.int64)

    def _sample_cbd(self) -> np.ndarray:
        """Centered binomial, sigma = sqrt(20/2) ~ 3.16 (SEAL sigma 3.2)."""
        b = self.rng.integers(0, 2, (2, 20, self.n), dtype=np.int64)
        return b[0].sum(0) - b[1].sum(0)

    def _sample_uniform(self, moduli: Sequence[int]) -> np.ndarray:
        return np.stack(
            [self.rng.integers(0, q, self.n, dtype=np.int64) for q in moduli]
        ).astype(np.uint64)

    @staticmethod
    def _small_to_rns(x: np.ndarray, moduli: Sequence[int]) -> np.ndarray:
        """Signed small coefficients -> u64 [k, N] RNS."""
        x = np.asarray(x, np.int64)
        return np.stack([np.asarray(x % q, np.uint64) for q in moduli])

    # ------------------------------------------------------------------
    # Keygen (host)
    # ------------------------------------------------------------------

    def keygen_secret(self) -> SecretKey:
        s = self._sample_ternary()
        return SecretKey(s.astype(np.int8), self._small_to_rns(s, self.q_moduli).astype(np.uint32))

    def keygen_public(self, sk: SecretKey, mesh=None) -> PublicKey:
        """pk = (-(a s + e), a) over base q, coefficient domain.

        With ``mesh`` (a ``parallel.mesh.Mesh`` with a "poly" axis, on this
        context's device) the products a*s run through the four-step NTT
        split over that axis (``parallel.ntt_shard``), the backend the JAX
        package gives the N = 65536 large preset.  a and e are the same host
        draws, so every rank gets the host path's key, bit for bit."""
        a = self._sample_uniform(self.q_moduli)
        e = self._sample_cbd()
        s_rns = self._small_to_rns(sk.s_small, self.q_moduli)
        e_rns = self._small_to_rns(e, self.q_moduli)
        if mesh is not None:
            from ..parallel import ntt_shard

            if mesh.device.type != self.device.type:
                raise ValueError(f"mesh on {mesh.device}, context on {self.device}")
            sn = ntt_shard.ShardedNtt(self.q_moduli, self.n, mesh)
            as_all = ntt.u32_to_numpy(sn.negacyclic_mul(a, s_rns)).astype(np.uint64)
        else:
            as_all = np.stack(
                [ntt.poly_mul_host(a[i], s_rns[i], q) for i, q in enumerate(self.q_moduli)]
            )
        q = np.array(self.q_moduli, np.uint64)[:, None]
        pk0 = (q - (as_all + e_rns) % q) % q
        return PublicKey(np.stack([pk0, a]).astype(np.uint32))

    def _ks_factor_mont(self) -> torch.Tensor:
        """P * unit_j mod m in Montgomery form, int64 [kd, k+1, 1]; zero on
        the special prime itself (P * unit_j mod P == 0)."""
        if self._ks_factor is None:
            pq = self.base_qp.moduli
            factor = np.zeros((self.k, len(pq), 1), np.uint32)
            for j in range(self.k):
                for i, m in enumerate(pq):
                    v = (self.p_special % m) * int(self.unit_mod_qp[j, i]) % m
                    factor[j, i, 0] = modular.to_mont_host(np.uint64(v), m)
            self._ks_factor = torch.from_numpy(factor.astype(np.int64)).to(self.device)
        return self._ks_factor

    def _keyswitch_gen(self, sk: SecretKey, target_rns_qp: np.ndarray) -> KSwitchKey:
        """KSK for target poly (u64 [k+1, N], coeff, mod q ∪ P):
        key_j = (-(a_j s + e_j) + P * unit_j * target, a_j) over q ∪ P.

        a and e are drawn on the host as the JAX package draws them; the
        algebra runs in the NTT domain on the context's device (the key's
        own domain): NTT(key_j) = NTT(target) P unit_j - (NTT(a_j) NTT(s) +
        NTT(e_j)), the same residues as the JAX package's coefficient-domain
        numpy products, with half its NTTs."""
        pq = self.base_qp.moduli
        kd = self.k
        a = np.stack([self._sample_uniform(pq) for _ in range(kd)])  # [kd, k+1, N]
        e = np.stack(
            [self._small_to_rns(self._sample_cbd(), pq) for _ in range(kd)]
        )
        tb = self.tb_qp
        q, qi = tb.q, tb.qinv_neg
        fs = ntt.ntt_fwd(self.to_device(self._small_to_rns(sk.s_small, pq)), tb)
        ft = ntt.ntt_fwd(self.to_device(target_rns_qp), tb)
        fa = ntt.ntt_fwd(self.to_device(a), tb)
        fe = ntt.ntt_fwd(self.to_device(e), tb)
        as_ = modular.mont_mul(fa, ntt.to_mont(fs, tb), q, qi)
        payload = modular.mont_mul(ft[None], self._ks_factor_mont(), q, qi)
        k0 = modular.sub_mod(payload, modular.add_mod(as_, fe, q), q)
        return KSwitchKey(ntt.to_mont(torch.stack([k0, fa]), tb))

    def keygen_relin(self, sk: SecretKey) -> KSwitchKey:
        """Relinearization key: target = s^2."""
        pq = self.base_qp.moduli
        s_rns = self._small_to_rns(sk.s_small, pq)
        s2 = np.stack(
            [ntt.poly_mul_host(s_rns[i], s_rns[i], m) for i, m in enumerate(pq)]
        )
        return self._keyswitch_gen(sk, s2)

    def keygen_galois(self, sk: SecretKey, elts: Sequence[int]) -> Dict[int, KSwitchKey]:
        """Galois keys: target = s(X^g)."""
        pq = self.base_qp.moduli
        out = {}
        s_rns = self._small_to_rns(sk.s_small, pq)
        for g in elts:
            src, sign = self.galois_perm(int(g))
            sg = np.empty((len(pq), self.n), np.uint64)
            for i, m in enumerate(pq):
                v = s_rns[i][src]
                sg[i] = np.where(sign, (m - v) % m, v)
            out[int(g)] = self._keyswitch_gen(sk, sg)
        return out

    # ------------------------------------------------------------------
    # Device evaluation-key generation
    # ------------------------------------------------------------------

    def keygen_eval_keys_device(
        self,
        sk: SecretKey,
        galois_elts: Sequence[int] = (),
        include_relin: bool = True,
        seed: int = 0,
    ):
        """Returns (relin_key | None, {elt: galois_key}) generated on the
        context's device: uniform and CBD(20) randomness from a
        ``torch.Generator`` seeded with ``seed ^ 0x5EED``, polynomial algebra
        as device NTTs.  The bits differ from the JAX PRNG's; the keys are
        checked by decryption."""
        from .bfv_eval import ntt_galois_src

        dev = self.device
        pq_mods = self.base_qp.moduli
        kd = self.k
        n = self.n
        tb = self.tb_qp
        q, qi = tb.q, tb.qinv_neg
        s_rns = self.to_device(self._small_to_rns(sk.s_small, pq_mods))
        fs = ntt.ntt_fwd(s_rns, tb)  # [k+1, N] std domain
        fs_mont = ntt.to_mont(fs, tb)

        targets = []
        labels = []
        if include_relin:
            targets.append(modular.mont_mul(fs, fs_mont, q, qi))
            labels.append("relin")
        for g in galois_elts:
            src = torch.as_tensor(ntt_galois_src(self, int(g)), device=dev)
            targets.append(fs[..., src])
            labels.append(int(g))

        factor = self._ks_factor_mont()
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed ^ 0x5EED)
        out_rk = None
        gks = {}
        for lab, tf in zip(labels, targets):
            # uniform a per modulus: [kd, k+1, N]
            a = torch.stack(
                [
                    torch.randint(0, int(m), (kd, n), generator=gen, device=dev)
                    for m in pq_mods
                ],
                dim=1,
            ).to(torch.int32)
            # CBD(20) error as the difference of two 20-bit popcounts
            bits = torch.randint(0, 1 << 20, (2, kd, n), generator=gen, device=dev)
            e = _popcount20(bits[0]) - _popcount20(bits[1])  # [kd, N] in [-20, 20]
            e_rns = (e[:, None, :] + q) % q  # [kd, k+1, N]
            fa = ntt.ntt_fwd(a, tb)
            fe = ntt.ntt_fwd(e_rns, tb)
            as_f = modular.mont_mul(fa, fs_mont, q, qi)
            payload = modular.mont_mul(tf[None], factor, q, qi)
            k0 = modular.sub_mod(payload, modular.add_mod(as_f, fe, q), q)
            ksk = KSwitchKey(ntt.to_mont(torch.stack([k0, fa]), tb))
            if lab == "relin":
                out_rk = ksk
            else:
                gks[lab] = ksk
        return out_rk, gks

    # ------------------------------------------------------------------
    # Galois utilities
    # ------------------------------------------------------------------

    def galois_perm(self, g: int) -> Tuple[np.ndarray, np.ndarray]:
        """Coefficient permutation of x(X) -> x(X^g): returns (src, negate)
        with out[j] = ± x[src[j]]."""
        if g in self._galois_perm_cache:
            return self._galois_perm_cache[g]
        n, m = self.n, 2 * self.n
        if g % 2 != 1:
            raise ValueError(f"galois element {g} must be odd")
        i = np.arange(n, dtype=np.int64)
        j = i * g % m
        src = np.empty(n, np.int64)
        sign = np.empty(n, bool)
        lo = j < n
        src[j[lo]] = i[lo]
        sign[j[lo]] = False
        src[j[~lo] - n] = i[~lo]
        sign[j[~lo] - n] = True
        self._galois_perm_cache[g] = (src, sign)
        return src, sign

    def galois_perm_device(self, g: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``galois_perm(g)`` on the context's device (int32 source index,
        bool negate mask: what K5's gather and K6's addend read), uploaded
        once per element and kept: a rotation reads them on every call, and
        a captured graph cannot upload."""
        hit = self._galois_dev_cache.get(g)
        if hit is None:
            src, sign = self.galois_perm(g)
            hit = self._galois_dev_cache[g] = (torch.as_tensor(src.astype(np.int32), device=self.device),
                                               torch.as_tensor(sign, device=self.device))
        return hit

    def galois_elt_from_step(self, step: int) -> int:
        """SEAL convention: step 0 -> column swap (elt 2N-1); else row
        rotation by `step` slots (left for positive)."""
        n, m = self.n, 2 * self.n
        if step == 0:
            return m - 1
        return pow(3, step % (n // 2), m)

    # ------------------------------------------------------------------
    # Encryption / decryption (host)
    # ------------------------------------------------------------------

    def scale_plain(self, pt: Plaintext) -> np.ndarray:
        """round(Q * m / t) in RNS: u64 [k, N]."""
        return self._scale(pt.data)

    def _scale(self, polys) -> np.ndarray:
        """round(Q * m / t) in RNS for plaintext polys [..., N] mod t:
        u64 [..., k, N]; exact Python integers when t >= 2^32, where
        (Q mod t) * m outgrows uint64.  The span ``hhe.bfv.scale``."""
        with trace.span("hhe.bfv.scale"):
            if self.t >= (1 << 32):
                m = np.asarray(polys, object)
                prod = int(self.q_mod_t) * m
                fix = (prod + (self.t + 1) // 2) // self.t
            else:
                m = np.asarray(polys, np.uint64)
                prod = (self.q_mod_t * m).astype(np.uint64)
                fix = (prod + np.uint64((self.t + 1) // 2)) // np.uint64(self.t)
            out = np.empty(m.shape[:-1] + (self.k, self.n), np.uint64)
            for i, q in enumerate(self.q_moduli):
                out[..., i, :] = ((self.delta_mod_q[i] * (m % q) + fix) % q).astype(np.uint64)
            return out

    def encrypt(self, pk: PublicKey, pt: Plaintext) -> Ciphertext:
        """c = (pk0*u + e0 + round(Q m / t), pk1*u + e1)."""
        u = self._small_to_rns(self._sample_ternary(), self.q_moduli)
        e0 = self._small_to_rns(self._sample_cbd(), self.q_moduli)
        e1 = self._small_to_rns(self._sample_cbd(), self.q_moduli)
        pkd = np.asarray(pk.data, np.uint64)
        dm = self.scale_plain(pt)
        c = np.empty((2, self.k, self.n), np.uint64)
        for i, q in enumerate(self.q_moduli):
            c[0, i] = (ntt.poly_mul_host(pkd[0, i], u[i], q) + e0[i] + dm[i]) % q
            c[1, i] = (ntt.poly_mul_host(pkd[1, i], u[i], q) + e1[i]) % q
        return Ciphertext(self.to_device(c))

    def _base_for(self, kc: int) -> rns.RnsBase:
        """RNS base of the first kc data limbs (full base when kc == k)."""
        if kc == self.k:
            return self.base_q
        if kc not in self._level_bases:
            self._level_bases[kc] = rns.RnsBase(self.q_moduli[:kc])
        return self._level_bases[kc]

    def _dot_with_sk(self, sk: SecretKey, ct: Ciphertext) -> np.ndarray:
        """[c0 + c1 s + c2 s^2 + ...]_q, u64 [kc, N] coeff domain (host)."""
        c = ntt.u32_to_numpy(ct.data).astype(np.uint64)
        size = c.shape[0]
        s_rns = np.asarray(sk.s_q, np.uint64)
        acc = c[0].copy()
        for i in range(c.shape[1]):
            q = self.q_moduli[i]
            spow = s_rns[i]
            for d in range(1, size):
                acc[i] = (acc[i] + ntt.poly_mul_host(c[d, i], spow, q)) % q
                if d + 1 < size:
                    spow = ntt.poly_mul_host(spow, s_rns[i], q)
        return acc

    def decrypt(self, sk: SecretKey, ct: Ciphertext) -> Plaintext:
        """m = [round(t/Q * [c(s)]_Q)]_t — exact host CRT scale-and-round."""
        x = self._dot_with_sk(sk, ct)
        base = self._base_for(x.shape[0])
        xc = base.compose_centered(x)
        num = xc * self.t
        m = (num + (base.Q // 2)) // base.Q  # floor((tx + Q/2)/Q), exact round
        return Plaintext((m % self.t).astype(np.uint64))

    def decrypt_batch(self, sk: SecretKey, ct: Ciphertext) -> np.ndarray:
        """Batched decrypt of a [size, B, k, N] ciphertext -> [B, N] mod t.

        [c0 + c1 s (+ c2 s^2)]_q for the whole batch as device NTT products,
        then the t/Q scale-and-round on the device: with
        u_i = [x_i (Q/q_i)^{-1}]_{q_i},
        m = [sum_i floor(t u_i / q_i) + round(sum_i (t u_i mod q_i)/q_i)]_t.
        Quotient and remainder of t u_i by q_i are exact in int64 for any t
        below 2^55: t is split as t_hi 2^24 + t_lo, so that every product
        stays below 2^63 (t u_i itself outgrows int64 from t = 2^32 on).
        The quotients are summed in int64 (no u32 wrap for any k * t) and the
        fractions in float64 (error k * 2^-52 against the >= 1/4 rounding
        margin of a ciphertext with noise budget left).  Equal to
        ``decrypt`` + ``decode`` per sample."""
        cd = ct.data
        if cd.ndim != 4 or cd.shape[0] not in (2, 3):
            raise ValueError(f"decrypt_batch needs [2|3, B, k, N], got {tuple(cd.shape)}")
        if cd.shape[2] != self.k:
            raise ValueError("decrypt_batch supports full-level ciphertexts only")
        if self.t >= 1 << 55:
            raise ValueError(f"decrypt_batch needs t < 2^55, got a {self.t.bit_length()}-bit t")
        if self._dec_consts is None:
            dev = self.device
            wm = [(int(w) << 32) % int(qm) for w, qm in zip(self.base_q.inv, self.q_moduli)]
            self._dec_consts = (
                torch.tensor(wm, dtype=I64, device=dev)[:, None],
                torch.tensor(self.q_moduli, dtype=torch.float64, device=dev)[:, None],
            )
        wm, qf = self._dec_consts
        skk = id(sk)
        if skk not in self._dec_sk_cache:
            s = np.asarray(sk.s_q, np.uint64)
            s_nm, s2_nm = [], []
            for i, qm in enumerate(self.q_moduli):
                qm = int(qm)
                f = ntt.ntt_fwd_host(s[i], ntt.build_host_tables(qm, self.n))
                s_nm.append(modular.to_mont_host(f, qm))
                s2_nm.append(modular.to_mont_host((f * f) % np.uint64(qm), qm))
            # keep one cached key transform, pinning sk so its id stays unique
            self._dec_sk_cache = {
                skk: (sk, self.to_device(np.stack(s_nm)), self.to_device(np.stack(s2_nm)))
            }
        _, s_nm, s2_nm = self._dec_sk_cache[skk]
        q, qi = self.tb_q.q, self.tb_q.qinv_neg
        g = modular.mont_mul(ntt.ntt_fwd(cd[1], self.tb_q), s_nm, q, qi)
        if cd.shape[0] == 3:
            f2 = ntt.ntt_fwd(cd[2], self.tb_q)
            g = modular.add_mod(g, modular.mont_mul(f2, s2_nm, q, qi), q)
        x = modular.add_mod(cd[0], ntt.ntt_inv(g, self.tb_q), q)  # [B, k, N]
        u = modular.mont_mul(x, wm, q, qi).to(I64)
        # t u = 2^24 (t_hi u) + t_lo u = 2^24 (qa q + ra) + t_lo u, and
        # 2^24 ra + t_lo u = qb q + r: so floor(t u / q) = 2^24 qa + qb
        t_hi, t_lo = self.t >> 24, self.t & 0xFFFFFF
        a = u * t_hi
        qa = torch.div(a, q, rounding_mode="floor")
        b = ((a - qa * q) << 24) + u * t_lo
        qb = torch.div(b, q, rounding_mode="floor")
        r = b - qb * q
        int_sum = ((qa << 24) + qb).sum(dim=-2)
        frac_sum = (r.to(torch.float64) / qf).sum(dim=-2)
        m = (int_sum + torch.floor(frac_sum + 0.5).to(I64)) % self.t
        return m.cpu().numpy().astype(np.uint64)  # [B, N] mod t

    def decode_batch(self, m: np.ndarray) -> np.ndarray:
        """[B, N] plaintext polys mod t -> [B, N] slot values."""
        slots = ntt.ntt_fwd_host(np.asarray(m, np.uint64), self.tb_t_host)
        return slots[:, self.encoder_map].astype(np.uint64)

    def decode_signed_batch(self, m: np.ndarray) -> np.ndarray:
        v = self.decode_batch(m).astype(np.int64)
        return np.where(v > self.t // 2, v - self.t, v)

    def noise_budget(self, sk: SecretKey, ct: Ciphertext) -> int:
        """Invariant noise budget in bits: log2(Q / (2*||[t*c(s)]_Q||_inf))."""
        x = self._dot_with_sk(sk, ct)
        base = self._base_for(x.shape[0])
        xi = base.compose(x)
        r = (xi * self.t) % base.Q
        half = base.Q // 2
        r = np.where(r > half, base.Q - r, r)
        mx = int(max(r.max(), 1))
        return max(0, base.Q.bit_length() - 1 - mx.bit_length() - 1)

    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        """Drop the last data limb with divide-and-round (SEAL
        Evaluator::mod_switch_to_next / RNSTool::divide_and_round_q_last:
        c'_i = [(c_i - [c + q_last/2]_{q_last} + q_last/2) / q_last]_{q_i}).

        [size, (B, ...) kc, N] -> [size, (B, ...) kc-1, N] on the context's
        device, in int64 (every product is below 2^62), bit-identical to the
        JAX package's numpy u64 version."""
        c = ct.data.to(self.device)
        kc = c.shape[-2]
        if kc < 2:
            raise ValueError("the ciphertext is already at the lowest level")
        q_last = self.q_moduli[kc - 1]
        half = q_last >> 1
        qs = self.q_moduli[: kc - 1]
        q, half_q, inv = (
            torch.tensor(v, dtype=I64, device=self.device)[:, None]
            for v in (qs, [half % qi for qi in qs], [pow(q_last, -1, qi) for qi in qs])
        )
        x_last = (c[..., kc - 1 :, :].to(I64) + half) % q_last  # [..., 1, N]
        tmp = (x_last % q + q - half_q) % q
        out = (c[..., : kc - 1, :].to(I64) + q - tmp) % q * inv % q
        return Ciphertext(out.to(torch.int32))

    def mod_switch_to(self, ct: Ciphertext, levels: int) -> Ciphertext:
        """Apply mod_switch_to_next `levels` times."""
        for _ in range(levels):
            ct = self.mod_switch_to_next(ct)
        return ct

    # ------------------------------------------------------------------
    # Plaintext device preparation (for the evaluator)
    # ------------------------------------------------------------------

    def _ntt_mont_host(self, polys: np.ndarray, moduli: Sequence[int]) -> np.ndarray:
        m = np.asarray(polys, np.uint64)
        out = np.empty(m.shape[:-1] + (len(moduli), self.n), np.uint64)
        for i, q in enumerate(moduli):
            f = ntt.ntt_fwd_host(m % q, ntt.build_host_tables(q, self.n))
            out[..., i, :] = (f << np.uint64(32)) % np.uint64(q)
        return out

    def plain_for_mul(self, pt: Plaintext) -> torch.Tensor:
        """Plaintext -> [k, N] NTT+Mont over base q for pointwise ct*pt."""
        return self.to_device(self._ntt_mont_host(pt.data, self.q_moduli))

    def plain_for_add(self, pt: Plaintext) -> torch.Tensor:
        """Plaintext -> [k, N] coeff-domain round(Q m / t) for ct + pt."""
        return self.to_device(self.scale_plain(pt))

    def plain_for_mul_batch(self, polys: np.ndarray) -> torch.Tensor:
        """[..., N] plaintext polys mod t -> [..., k, N] NTT+Mont."""
        return self.to_device(self._ntt_mont_host(polys, self.q_moduli))

    def plain_for_mul_qp_batch(self, polys: np.ndarray) -> torch.Tensor:
        """[..., N] plaintext polys mod t -> [..., k+1, N] NTT+Mont over q ∪ P."""
        return self.to_device(self._ntt_mont_host(polys, self.base_qp.moduli))

    def plain_for_add_batch(self, polys: np.ndarray) -> torch.Tensor:
        """[..., N] plaintext polys mod t -> [..., k, N] scaled round(Q m / t)
        (exact for t >= 2^32, where the JAX package's uint64 product wraps)."""
        return self.to_device(self._scale(polys))


def _popcount20(v: torch.Tensor) -> torch.Tensor:
    """Number of set bits of int64 values below 2^20 (SWAR popcount)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def large_params(data_limbs: int = 58, seed: int = 0) -> BFVParams:
    """The reference's large preset, as the JAX package cuts it: N = 65536
    with 58 x 30-bit data limbs (the 1740 usable bits of the reference's
    29 x 60-bit chain) and a 29-bit NTT-friendly plaintext modulus
    (t = 65537 cannot batch at this degree: t - 1 must divide 2N)."""
    t = primes.ntt_primes(65536, 29, 1)[0]
    return BFVParams(n=65536, t=t, data_limbs=data_limbs, seed=seed)


@functools.lru_cache(maxsize=4)
def default_context(n: int = 16384, seed: int = 0, device=None) -> Context:
    """A context at degree n with the JAX package's limb count for it."""
    limbs = {4096: 4, 8192: 7, 16384: 13, 32768: 26}[n] if n >= 4096 else 3
    return Context(BFVParams(n=n, data_limbs=limbs, seed=seed), device=device)
