"""Plain BFV over RNS in PyTorch: the benchmark's own keys, encryption and
decryption, written from the scheme's definition and independent of the
program under test (it imports nothing of it).

Conventions it shares with the program by definition, not by code:

- the data moduli are the largest primes of ``bits`` bits that are 1 mod 2N,
  other than t; the largest is the special prime, the next ``limbs`` are q;
- slots (SEAL's batch encoder): slot i < N/2 holds m(psi^(3^i)) and slot
  N/2 + i holds m(psi^(-3^i)), psi = g^((t-1)/2N) with g the smallest
  generator of Z_t^*;
- a ciphertext is int32 [2, ..., k, N] in the coefficient domain, values in
  [0, q_i); decryption is round(t [c0 + c1 s]_Q / Q) mod t.

Every tensor is int64 inside and every result exact for any t below 2^50.
A product of two residues below 2^31 fits int64, and is taken as it is;
residues mod a wider prime (t alone: the data moduli are 30-bit) are
multiplied by ``mulmod`` in chunks.  Runs on whichever device its inputs
are on (the CPU in the tests, the card in a benchmark run, after the
program's state is freed).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

I64 = torch.int64
WORD = 31  # bits of a fraction word: a residue below 2^31 shifted by it fits int64
MASK = (1 << WORD) - 1
FRAC_WORDS = 3
NARROW = 31  # primes below 2^NARROW multiply their residues in one int64 product
T_BITS = 50  # t below 2^T_BITS
T_SPLIT = 20  # decryption takes t y as (t >> T_SPLIT) y 2^T_SPLIT + (t mod 2^T_SPLIT) y


def mulmod(a: torch.Tensor, b: torch.Tensor, p, bits: int) -> torch.Tensor:
    """a b mod p, broadcasting, for residues b in [0, p) of primes p below
    2^bits.  Below 2^NARROW the product fits int64.  Above, a is reduced and
    b taken in chunks of s = 62 - bits bits from the top (Horner), so that
    the running remainder shifted by s bits and a times a chunk each stay
    below 2^62 and their sum below 2^63."""
    if bits <= NARROW:
        return a * b % p
    s = 62 - bits
    top = -(-bits // s) - 1
    a = a % p
    r = a * (b >> (top * s)) % p
    for c in range(top - 1, -1, -1):
        r = ((r << s) + a * ((b >> (c * s)) & ((1 << s) - 1))) % p
    return r


# ---------------------------------------------------------------------------
# Primes and roots
# ---------------------------------------------------------------------------


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    bases = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    for p in bases:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in bases:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def moduli(n: int, t: int, bits: int, limbs: int) -> Tuple[int, Tuple[int, ...]]:
    """(special prime, data moduli q): the limbs + 1 largest primes of
    ``bits`` bits that are 1 mod 2n, t left out, the largest the special."""
    m = 2 * n
    out: List[int] = []
    c = ((1 << bits) - 1) // m * m + 1
    while len(out) < limbs + 1:
        if c < 1 << (bits - 1):
            raise ValueError(f"too few {bits}-bit primes for N={n}")
        if c != t and is_prime(c):
            out.append(c)
        c -= m
    return out[0], tuple(out[1:])


def smallest_generator(p: int) -> int:
    fs, v, d = [], p - 1, 2
    while d * d <= v:
        if v % d == 0:
            fs.append(d)
            while v % d == 0:
                v //= d
        d += 1
    if v > 1:
        fs.append(v)
    g = 2
    while any(pow(g, (p - 1) // f, p) == 1 for f in fs):
        g += 1
    return g


def psi(p: int, n: int) -> int:
    """The primitive 2n-th root of unity mod p: g^((p-1)/2n), g the smallest
    generator."""
    if (p - 1) % (2 * n):
        raise ValueError(f"{p} has no 2*{n}-th root of unity")
    return pow(smallest_generator(p), (p - 1) // (2 * n), p)


# ---------------------------------------------------------------------------
# Negacyclic transform: evaluations at psi^(2j+1), j = 0 .. n-1
# ---------------------------------------------------------------------------


class Negacyclic:
    """a(X) mod (X^n + 1, p_i) <-> its values at psi_i^(2j+1), for a column
    of primes p_i: tensors [..., len(primes), n].  The twist by psi^i turns
    the negacyclic product into a cyclic one, computed by a radix-2
    decimation-in-time transform on bit-reversed input."""

    def __init__(self, primes: Sequence[int], n: int, device):
        self.n, self.primes = n, tuple(int(p) for p in primes)
        self.bits = max(p.bit_length() for p in self.primes)
        self.log_n = n.bit_length() - 1
        self.p = torch.tensor(self.primes, dtype=I64, device=device)[:, None]
        rev = torch.zeros(n, dtype=I64)
        for b in range(self.log_n):
            rev |= ((torch.arange(n) >> b) & 1) << (self.log_n - 1 - b)
        self.rev = rev.to(device)
        tw, itw, om, iom = [], [], [], []
        for p in self.primes:
            s = psi(p, n)
            si = pow(s, -1, p)
            ninv = pow(n, -1, p)
            tw.append(self._powers(s, p, 1))
            itw.append(self._powers(si, p, ninv))
            om.append(self._powers(s * s % p, p, 1)[: n // 2])
            iom.append(self._powers(si * si % p, p, 1)[: n // 2])
        self.tw, self.itw = (torch.tensor(np.stack(x), dtype=I64, device=device) for x in (tw, itw))
        self.om, self.iom = (torch.tensor(np.stack(x), dtype=I64, device=device) for x in (om, iom))

    def _powers(self, base: int, p: int, scale: int) -> np.ndarray:
        """scale * base^i mod p for i < n: the first 128 powers times each
        128th, as an outer product."""
        step = min(128, self.n)
        lo = np.empty(step, np.int64)
        v = scale % p
        for i in range(step):
            lo[i] = v
            v = v * base % p
        big = pow(base, step, p)
        hi = np.empty(self.n // step, np.int64)
        v = 1
        for j in range(self.n // step):
            hi[j] = v
            v = v * big % p
        return mulmod(torch.from_numpy(hi)[:, None], torch.from_numpy(lo)[None, :], p,
                      p.bit_length()).reshape(-1).numpy()

    def _cyclic(self, x: torch.Tensor, om: torch.Tensor) -> torch.Tensor:
        x = x[..., self.rev]
        lead = x.shape[:-2]
        k, n = x.shape[-2:]
        half = 1
        while half < n:
            w = om[:, :: n // (2 * half)][:, :half]  # [k, half]
            xv = x.reshape(*lead, k, n // (2 * half), 2, half)
            u = xv[..., 0, :]
            v = mulmod(xv[..., 1, :], w[:, None, :], self.p[..., None], self.bits)
            x = torch.stack(((u + v) % self.p[..., None], (u - v) % self.p[..., None]), -2)
            x = x.reshape(*lead, k, n)
            half *= 2
        return x

    def fwd(self, a: torch.Tensor) -> torch.Tensor:
        return self._cyclic(mulmod(a.to(I64), self.tw, self.p, self.bits), self.om)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        return mulmod(self._cyclic(a.to(I64), self.iom), self.itw, self.p, self.bits)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a * b mod (X^n + 1, p_i), both [..., k, n] (broadcasting)."""
        return self.inv(mulmod(self.fwd(a), self.fwd(b), self.p, self.bits))


# ---------------------------------------------------------------------------
# Slots
# ---------------------------------------------------------------------------


class Slots:
    """SEAL's batch encoding mod t (see the module)."""

    def __init__(self, t: int, n: int, device):
        self.t, self.n = t, n
        self.tr = Negacyclic((t,), n, device)
        m = 2 * n
        j = np.empty(n, np.int64)
        g = 1
        for i in range(n // 2):
            j[i] = (g - 1) // 2
            j[i + n // 2] = (m - g - 1) // 2
            g = g * 3 % m
        self.eval_index = torch.as_tensor(j, device=device)

    def decode(self, m: torch.Tensor) -> torch.Tensor:
        """Plaintext polys [..., n] mod t -> slot values [..., n] in [0, t)."""
        return self.tr.fwd(m[..., None, :])[..., 0, :][..., self.eval_index]

    def encode(self, v: torch.Tensor) -> torch.Tensor:
        """Slot values [..., L <= n] (any integers) -> plaintext polys [..., n]."""
        v = v.to(I64) % self.t
        ev = torch.zeros((*v.shape[:-1], self.n), dtype=I64, device=v.device)
        ev[..., self.eval_index[: v.shape[-1]]] = v
        return self.tr.inv(ev[..., None, :])[..., 0, :]


def signed(v: torch.Tensor, t: int) -> torch.Tensor:
    return torch.where(v > t // 2, v - t, v)


# ---------------------------------------------------------------------------
# Keys, encryption, decryption
# ---------------------------------------------------------------------------


class Scheme:
    """BFV at (n, t, bits, limbs) on ``device``; randomness from ``gen``."""

    def __init__(self, n: int, t: int, bits: int, limbs: int, device):
        if not 1 < t < 1 << T_BITS:
            raise ValueError(f"t = {t}: the reference is exact for 1 < t < 2^{T_BITS}")
        if bits > NARROW:
            raise ValueError(f"{bits}-bit data moduli: the reference takes them below 2^{NARROW}")
        self.n, self.t, self.device = n, t, torch.device(device)
        self.special, self.q = moduli(n, t, bits, limbs)
        self.k = len(self.q)
        self.Q = math.prod(self.q)
        self.rns = Negacyclic(self.q, n, self.device)
        self.slots = Slots(t, n, self.device)
        self.qcol = torch.tensor(self.q, dtype=I64, device=self.device)[:, None]
        self.delta = torch.tensor([(self.Q // t) % q for q in self.q], dtype=I64,
                                  device=self.device)[:, None]
        # decryption: y_i = x_i (Q/q_i)^-1 mod q_i
        self.punc_inv = torch.tensor([pow(self.Q // q % q, -1, q) for q in self.q], dtype=I64,
                                     device=self.device)[:, None]

    # randomness -----------------------------------------------------------

    def ternary(self, shape, gen) -> torch.Tensor:
        return torch.randint(-1, 2, (*shape, self.n), generator=gen, device=self.device, dtype=I64)

    def cbd(self, shape, gen) -> torch.Tensor:
        """Centred binomial of 20 coin pairs (sigma ~3.16, SEAL's 3.2)."""
        b = torch.randint(0, 2, (2, 20, *shape, self.n), generator=gen, device=self.device,
                          dtype=torch.int8)
        return b[0].sum(0, dtype=I64) - b[1].sum(0, dtype=I64)

    def uniform(self, shape, gen) -> torch.Tensor:
        """[*shape, k, n] uniform residues."""
        x = torch.randint(0, 1 << 62, (*shape, self.k, self.n), generator=gen, device=self.device,
                          dtype=I64)
        return x % self.qcol

    def to_rns(self, small: torch.Tensor) -> torch.Tensor:
        """Signed small coefficients [..., n] -> [..., k, n]."""
        return small[..., None, :] % self.qcol

    # keys -------------------------------------------------------------------

    def secret_key(self, rng: np.random.Generator) -> np.ndarray:
        """Ternary s [n] int8, drawn on the host from ``rng``."""
        return rng.integers(-1, 2, self.n).astype(np.int8)

    def secret_residues(self, s: np.ndarray) -> np.ndarray:
        """s mod q_i as uint32 [k, n]."""
        return np.stack([np.asarray(s, np.int64) % q for q in self.q]).astype(np.uint32)

    def public_key(self, s: torch.Tensor, gen) -> torch.Tensor:
        """pk = (-(a s + e), a) [2, k, n] int64."""
        a = self.uniform((), gen)
        e = self.to_rns(self.cbd((), gen))
        b = (-(self.rns.mul(a, self.to_rns(s)) + e)) % self.qcol
        return torch.stack((b, a))

    def encrypt(self, pk: torch.Tensor, m: torch.Tensor, gen) -> torch.Tensor:
        """Plaintext polys m [..., n] mod t -> int32 ciphertexts [2, ..., k, n]
        under pk: (pk0 u + e1 + delta m, pk1 u + e2), delta = floor(Q/t)."""
        lead = tuple(m.shape[:-1])
        u = self.to_rns(self.ternary(lead, gen))
        fu = self.rns.fwd(u)
        c = [self.rns.inv(self.rns.fwd(pk[i]) * fu % self.qcol) for i in range(2)]
        dm = self.delta * (m[..., None, :].to(I64) % self.qcol)
        c[0] = (c[0] + self.to_rns(self.cbd(lead, gen)) + dm) % self.qcol
        c[1] = (c[1] + self.to_rns(self.cbd(lead, gen))) % self.qcol
        return torch.stack(c).to(torch.int32)

    def decrypt(self, s: torch.Tensor, ct: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ciphertexts [2, ..., k, n] -> (plaintext polys [..., n] mod t,
        noise share [..., n]).  The share is 2 |t x / Q - round(t x / Q)|
        for x = [c0 + c1 s]_Q: below 1 exactly where decryption is right.
        t x / Q is sum_i t y_i / q_i mod t with y_i = x_i (Q/q_i)^-1 mod q_i;
        each fraction is taken to FRAC_WORDS words of 31 bits, so the share
        reads down to about k 2^-92 at any t.  t y_i (up to 2^81) is split as
        (t_hi y_i) 2^T_SPLIT + t_lo y_i, each part below 2^62."""
        c0, c1 = ct[0].to(I64), ct[1].to(I64)
        x = (c0 + self.rns.mul(c1, self.to_rns(s))) % self.qcol
        y = x * self.punc_inv % self.qcol
        hi = (self.t >> T_SPLIT) * y
        lo = ((hi % self.qcol) << T_SPLIT) + (self.t & ((1 << T_SPLIT) - 1)) * y
        # the integer parts of t y_i / q_i, and the remainders
        whole = (((hi // self.qcol) << T_SPLIT) + lo // self.qcol).sum(-2)
        rem = lo % self.qcol
        words = []
        for _ in range(FRAC_WORDS):  # most significant first
            rem = rem << WORD
            words.append((rem // self.qcol).sum(-2))
            rem = rem % self.qcol
        carry = torch.zeros_like(whole)
        for w in reversed(range(FRAC_WORDS)):
            words[w] = words[w] + carry
            carry = words[w] >> WORD
            words[w] = words[w] & MASK
        up = words[0] >= 1 << (WORD - 1)  # the fraction is one half or more
        m = (whole + carry + up.to(I64)) % self.t
        # distance to the nearest integer: the fraction, or its complement
        dist = torch.zeros(m.shape, dtype=torch.float64, device=m.device)
        for w in range(FRAC_WORDS):
            digit = torch.where(up, MASK - words[w], words[w])
            dist += digit.to(torch.float64) * 2.0 ** (-WORD * (w + 1))
        return m, 2 * dist
