"""Plain PASTA-3 (Dobraunig et al., "Pasta: A Case for Hybrid Homomorphic
Encryption", 2021; the reference's ``pasta_3_plain.cpp``), independent of
the program under test: the user's symmetric encryption of the benchmark's
requests, for many nonces at once.

Per (nonce, block) a SHAKE128 stream seeded with the big-endian pair
(nonce, block) yields, for each of the R + 1 = 4 affine layers in turn, the
first row of matrix 1 and of matrix 2 (no zero entry) and the round
constants 1 and 2 (zero allowed), 128 words each, by rejection sampling of
big-endian 64-bit draws masked to the bit length of p.  Row i of a matrix
is first * row_{i-1}[127] + (row_{i-1} shifted right by one).  The state is
the 256-word key; each layer is (M1 s1 + rc1, M2 s2 + rc2) followed by the
mix (2 1; 1 2); rounds 1-2 end in the Feistel S-box s[i] += s[i-1]^2, round
3 in the cube; the keystream block is the first half after the last layer.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Sequence

import numpy as np
import torch

T = 128  # words a block
R = 3  # rounds
KEY_WORDS = 2 * T
I64 = torch.int64


def _draws(nonce: int, block: int, count: int) -> np.ndarray:
    seed = struct.pack(">QQ", nonce, block)
    return np.frombuffer(hashlib.shake_128(seed).digest(8 * count), dtype=">u8").astype(np.uint64)


def layer_material(nonce: int, block: int, p: int) -> np.ndarray:
    """[R + 1, 4, T] int64: per layer the first rows of matrix 1 and 2 and
    the round constants 1 and 2."""
    mask = np.uint64((1 << int(p).bit_length()) - 1)
    need = (R + 1) * 4 * T
    count = 3 * need  # acceptance is about 1/2 for t = 65537; grown if short
    while True:
        cand = _draws(nonce, block, count) & mask
        below = cand < p
        nonzero = below & (cand != 0)
        out = np.empty(((R + 1) * 4, T), np.int64)
        pos, ok = 0, True
        for seg in range((R + 1) * 4):
            acc = nonzero if seg % 4 < 2 else below
            idx = np.flatnonzero(acc[pos:])
            if len(idx) < T:
                ok = False
                break
            out[seg] = cand[pos + idx[:T]]
            pos += int(idx[T - 1]) + 1
        if ok:
            return out.reshape(R + 1, 4, T)
        count *= 2


def keystream(key: np.ndarray, nonces: Sequence[int], blocks: int, p: int, device) -> torch.Tensor:
    """Keystream words [len(nonces), blocks * T] (int64, on ``device``) of
    ``key`` (256 words below p) under each nonce.  The matrix products sum T
    products of two residues in int64: p has to be below 2^28."""
    if T * (p - 1) ** 2 >= 1 << 63:
        raise ValueError(f"p = {p}: the keystream's int64 products need p below 2^28")
    mat = torch.as_tensor(np.stack([layer_material(int(nc), b, p)
                                    for nc in nonces for b in range(blocks)]), device=device)
    first, rc = mat[:, :, :2], mat[:, :, 2:]  # [P, R+1, 2, T]
    rows = [first]
    prev = first
    for _ in range(T - 1):
        shifted = torch.nn.functional.pad(prev[..., :-1], (1, 0))
        prev = (first * prev[..., T - 1:] + shifted) % p
        rows.append(prev)
    mats = torch.stack(rows, -2)  # [P, R+1, 2, T(row), T(col)]
    key = torch.as_tensor(np.asarray(key, np.int64), device=device)
    s = key.reshape(2, T).expand(mat.shape[0], 2, T)
    for r in range(R + 1):
        s = ((mats[:, r] * s[:, :, None, :]).sum(-1) + rc[:, r]) % p
        s = (s + s.sum(1, keepdim=True)) % p  # mix: (2 s1 + s2, s1 + 2 s2)
        if r == R - 1:
            s = s * s % p * s % p
        elif r < R - 1:
            s = (s + torch.nn.functional.pad(s[..., :-1] * s[..., :-1] % p, (1, 0))) % p
    return s[:, 0].reshape(len(nonces), blocks * T)
