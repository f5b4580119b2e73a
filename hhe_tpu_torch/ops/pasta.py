"""PASTA-3 symmetric stream cipher over Z_p, bit-exact with the reference.

The port's own copy of ``hhe_tpu.ops.pasta`` (host-side numpy, no device
code). Re-design of the reference cipher (``src/pasta/pasta_3_plain.{h,cpp}``
and ``libs/keccak``):

- The per-block SHAKE128 expansion runs in C++ (``hhe_tpu_torch.native``)
  when that library builds, as the JAX package's does; otherwise it uses
  CPython's built-in FIPS-202 implementation (``hashlib.shake_128``) wrapped
  as an incremental XOF stream (``block_randomness_python``, the semantic
  reference).  Both are bit-exact with the vendored Keccak library (golden
  vectors from the reference binary, ``tests/test_pasta.py``);
  ``EXPANSIONS`` counts which one expanded each uncached block.
- All per-(nonce, block) randomness (round matrices, round constants) is
  **key-independent** and therefore precomputed once on the host and cached;
  the keystream itself is vectorized numpy (u64 exact: all values < 2^17, so
  128-term dot products fit 64 bits) and broadcast over arbitrarily large
  sample batches (the reference encrypts sample-by-sample,
  ``pasta_3_plain.cpp:9-26``).

Parameters (reference ``pasta_3_plain.h:15,31-32``): key 256 words, block 128
words, 3 rounds, fixed nonce 123456789.
"""

from __future__ import annotations

import functools
import hashlib
import struct
from typing import List, Tuple

import numpy as np

from ..utils import trace

PASTA_T = 128  # words per block
PASTA_R = 3  # rounds
KEY_SIZE = 256
NONCE = 123456789  # fixed nonce, reference pasta_3_plain.cpp:10


class ShakeStream:
    """Incremental SHAKE128 squeeze, prefix-stable like Keccak_HashSqueeze."""

    def __init__(self, seed: bytes):
        self._h = hashlib.shake_128(seed)
        self._buf = b""
        self._pos = 0

    def read(self, n: int) -> bytes:
        need = self._pos + n
        if need > len(self._buf):
            # digest(k) returns the first k bytes of the XOF stream, so
            # re-requesting a longer prefix never changes earlier bytes.
            self._buf = self._h.digest(max(need, 2 * len(self._buf) + 512))
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        return out


def _shake_seed(nonce: int, block_counter: int) -> bytes:
    # big-endian (nonce, counter), reference pasta_3_plain.cpp:56-68
    return struct.pack(">QQ", nonce, block_counter)


def _bit_mask(p: int) -> int:
    return (1 << int(p).bit_length()) - 1


def _sample_exact(
    stream: ShakeStream, count: int, p: int, allow_zero: bool
) -> np.ndarray:
    """Strict-order rejection sampling: consumes exactly the draws the
    reference would, by walking the draw sequence and stopping at the draw
    that yields the `count`-th accepted element."""
    mask = _bit_mask(p)
    accepted: List[np.ndarray] = []
    n_acc = 0
    while n_acc < count:
        want = count - n_acc
        n_draw = max(32, int(want * 2.2) + 8)
        start = stream._pos
        raw = np.frombuffer(stream.read(8 * n_draw), dtype=">u8").astype(np.uint64)
        cand = raw & np.uint64(mask)
        ok = cand < p
        if not allow_zero:
            ok &= cand != 0
        idx = np.nonzero(ok)[0]
        if len(idx) >= want:
            last = idx[want - 1]
            # rewind stream to just after the accepting draw
            stream._pos = start + 8 * (int(last) + 1)
            accepted.append(cand[idx[:want]])
            n_acc = count
        else:
            accepted.append(cand[idx])
            n_acc += len(idx)
    return np.concatenate(accepted) if len(accepted) > 1 else accepted[0]


def _expand_matrix(first_row: np.ndarray, p: int) -> np.ndarray:
    """Sequential random matrix from its first row.

    Row recurrence (reference ``calculate_row``, pasta_3_plain.cpp:86-100):
    row_i[j] = first[j] * row_{i-1}[T-1] + row_{i-1}[j-1]  (mod p).
    """
    T = len(first_row)
    mat = np.empty((T, T), dtype=np.uint64)
    mat[0] = first_row
    prev = first_row
    pu = np.uint64(p)
    for i in range(1, T):
        shifted = np.empty_like(prev)
        shifted[0] = 0
        shifted[1:] = prev[:-1]
        row = (first_row * prev[T - 1] + shifted) % pu
        mat[i] = row
        prev = row
    return mat


# uncached block expansions by route: "native" (C++) or "python" (hashlib)
EXPANSIONS = {"native": 0, "python": 0}


@functools.lru_cache(maxsize=4096)
def block_randomness(
    p: int, nonce: int, block_counter: int
) -> Tuple[Tuple[np.ndarray, ...], ...]:
    """All SHAKE-derived randomness for one keystream block.

    Returns (mats1, mats2, rcs1, rcs2), each a tuple of PASTA_R+1 arrays.
    Draw order per linear layer r = 0..R: mat1 first row (no zero), mat2 first
    row (no zero), rc1 (zero ok), rc2 (zero ok) — matching both the plain
    keystream (pasta_3_plain.cpp:198-217) and the transcipher
    (pasta_3_seal.cpp:128-147) consumption order.

    Takes the native C++ expansion when ``native.available()``, else
    ``block_randomness_python``; ``EXPANSIONS`` says which ran.  A cache
    miss is the span ``hhe.pasta.shake``."""
    from .. import native

    with trace.span("hhe.pasta.shake"):
        if not native.available():
            EXPANSIONS["python"] += 1
            return block_randomness_python(p, nonce, block_counter)
        EXPANSIONS["native"] += 1
        m1, m2, r1, r2 = native.pasta_block_randomness(p, nonce, block_counter)
        for a in (m1, m2, r1, r2):
            a.setflags(write=False)
        return tuple(tuple(a[r] for r in range(PASTA_R + 1)) for a in (m1, m2, r1, r2))


def block_randomness_python(
    p: int, nonce: int, block_counter: int
) -> Tuple[Tuple[np.ndarray, ...], ...]:
    """``block_randomness`` in pure Python (hashlib SHAKE128 + numpy), not
    cached; one block costs a few ms."""
    stream = ShakeStream(_shake_seed(nonce, block_counter))
    mats1, mats2, rcs1, rcs2 = [], [], [], []
    for _ in range(PASTA_R + 1):
        m1 = _expand_matrix(_sample_exact(stream, PASTA_T, p, False), p)
        m2 = _expand_matrix(_sample_exact(stream, PASTA_T, p, False), p)
        r1 = _sample_exact(stream, PASTA_T, p, True)
        r2 = _sample_exact(stream, PASTA_T, p, True)
        mats1.append(m1)
        mats2.append(m2)
        rcs1.append(r1)
        rcs2.append(r2)
    # freeze for cache safety
    for arrs in (mats1, mats2, rcs1, rcs2):
        for a in arrs:
            a.setflags(write=False)
    return tuple(mats1), tuple(mats2), tuple(rcs1), tuple(rcs2)


def _sbox_feistel(state: np.ndarray, p: int) -> np.ndarray:
    # new[0] = s[0]; new[i] = s[i-1]^2 + s[i]  (pasta_3_plain.cpp:239-248)
    sq = (state * state) % np.uint64(p)
    out = state.copy()
    out[1:] = (out[1:] + sq[:-1]) % np.uint64(p)
    return out


def _sbox_cube(state: np.ndarray, p: int) -> np.ndarray:
    pu = np.uint64(p)
    sq = (state * state) % pu
    return (sq * state) % pu


def keystream(key: np.ndarray, p: int, nonce: int, block_counter: int) -> np.ndarray:
    """One 128-word keystream block (reference gen_keystream, pasta_3_plain.cpp:156-171)."""
    key = np.asarray(key, dtype=np.uint64)
    assert key.shape == (KEY_SIZE,), key.shape
    mats1, mats2, rcs1, rcs2 = block_randomness(p, nonce, block_counter)
    pu = np.uint64(p)
    s1 = key[:PASTA_T].copy()
    s2 = key[PASTA_T:].copy()

    big = int(p).bit_length() * 2 + 7 > 64  # 128-term dot overflows u64?

    def matvec(m, v):
        if big:
            return (m.astype(object) @ v.astype(object) % int(p)).astype(np.uint64)
        return (m @ v) % pu

    def linear_layer(s1, s2, r):
        s1 = (matvec(mats1[r], s1)) % pu
        s2 = (matvec(mats2[r], s2)) % pu
        s1 = (s1 + rcs1[r]) % pu
        s2 = (s2 + rcs2[r]) % pu
        tot = (s1 + s2) % pu  # mix = (2 1; 1 2), pasta_3_plain.cpp:254-262
        return (s1 + tot) % pu, (s2 + tot) % pu

    for r in range(PASTA_R):
        s1, s2 = linear_layer(s1, s2, r)
        if r == PASTA_R - 1:
            s1, s2 = _sbox_cube(s1, p), _sbox_cube(s2, p)
        else:
            s1, s2 = _sbox_feistel(s1, p), _sbox_feistel(s2, p)
    s1, s2 = linear_layer(s1, s2, PASTA_R)
    return s1


def keystream_for_length(key: np.ndarray, p: int, length: int, nonce: int = NONCE) -> np.ndarray:
    """Concatenated keystream covering `length` words."""
    num_block = -(-length // PASTA_T)
    ks = np.concatenate([keystream(key, p, nonce, b) for b in range(num_block)])
    return ks[:length]


class Pasta:
    """PASTA-3 cipher facade (reference class ``pasta::PASTA``)."""

    def __init__(self, secret_key, modulus: int):
        self.key = np.asarray(secret_key, dtype=np.uint64)
        if self.key.shape != (KEY_SIZE,):
            raise ValueError(f"invalid key length {self.key.shape}")
        self.p = int(modulus)

    def encrypt(self, plaintext, nonce: int = NONCE) -> np.ndarray:
        """Encrypt a vector or a batch [B, L] (keystream broadcasts over B)."""
        pt = np.asarray(plaintext, dtype=np.uint64)
        L = pt.shape[-1]
        ks = keystream_for_length(self.key, self.p, L, nonce)
        return (pt + ks) % np.uint64(self.p)

    def decrypt(self, ciphertext, nonce: int = NONCE) -> np.ndarray:
        ct = np.asarray(ciphertext, dtype=np.uint64)
        L = ct.shape[-1]
        ks = keystream_for_length(self.key, self.p, L, nonce)
        return (ct + np.uint64(self.p) - ks) % np.uint64(self.p)


def get_fixed_symmetric_key() -> np.ndarray:
    """The reference's fixed 256-word test key (``pastahelper.cpp:37-297``),
    stored as data in tests/data/pasta_golden.npz at repo root; falls back to
    the packaged copy."""
    import pathlib

    here = pathlib.Path(__file__).resolve()
    for base in [here.parents[2], pathlib.Path.cwd()]:
        f = base / "tests" / "data" / "pasta_golden.npz"
        if f.exists():
            return np.load(f)["key"]
    raise FileNotFoundError("pasta_golden.npz with fixed key not found")
