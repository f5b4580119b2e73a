"""NTT-friendly RNS prime generation.

Replaces SEAL's precomputed default prime tables
(``seal/util/globals.h``, ``seal/modulus.h`` CoeffModulus::BFVDefault): the
TPU build uses chains of primes q ≡ 1 (mod 2N), each < 2^31 so all limb
arithmetic fits 32-bit lanes (see ``hhe_tpu.ops.modular``), with the total
data-modulus bit budget matching SEAL's 128-bit-security tables.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit)."""
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=64)
def ntt_primes(n_poly: int, bits: int, count: int, skip: Tuple[int, ...] = ()) -> Tuple[int, ...]:
    """`count` primes of exactly `bits` bits with q ≡ 1 mod 2*n_poly, descending.

    `skip` lists moduli that must not be reused (e.g. the plaintext modulus or
    primes already allocated to another base).
    """
    assert bits <= 31, "limbs must fit u32 Montgomery (q < 2^31)"
    m = 2 * n_poly
    out: List[int] = []
    # largest candidate of form k*m + 1 below 2^bits
    q = ((1 << bits) - 1) // m * m + 1
    while len(out) < count:
        if q < (1 << (bits - 1)):
            raise RuntimeError(f"not enough {bits}-bit NTT primes for N={n_poly}")
        if q not in skip and is_prime(q):
            out.append(q)
        q -= m
    return tuple(out)


def _factorize(n: int) -> List[int]:
    fs = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            if not fs or fs[-1] != d:
                fs.append(d)
            n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


@functools.lru_cache(maxsize=256)
def primitive_root(q: int) -> int:
    """Smallest generator of Z_q^*."""
    factors = _factorize(q - 1)
    g = 2
    while True:
        if all(pow(g, (q - 1) // f, q) != 1 for f in factors):
            return g
        g += 1


@functools.lru_cache(maxsize=256)
def root_of_unity(order: int, q: int) -> int:
    """A primitive `order`-th root of unity mod q (order | q-1)."""
    assert (q - 1) % order == 0, (order, q)
    g = primitive_root(q)
    psi = pow(g, (q - 1) // order, q)
    # primitivity check
    assert pow(psi, order // 2, q) == q - 1
    return psi
