"""HE linear algebra helpers — counterpart of ``hhe_tpu.ops.helin``.

- model weight encryption/decryption (one batched ciphertext per transposed
  weight row)
- ``mask`` = multiply_plain by a 0/1 vector
- ``flatten`` = stitch per-block ciphertexts with rotations
- ``encrypted_vec_sum`` rotate-and-add reduction plus a log-depth variant.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..utils import trace
from . import bfv_eval
from .bfv import Ciphertext, Context, KSwitchKey, PublicKey, SecretKey


# ---------------------------------------------------------------------------
# Weight encryption
# ---------------------------------------------------------------------------


def encrypt_weight(ctx: Context, pk: PublicKey, weight: np.ndarray) -> List[Ciphertext]:
    """Encrypt each row of `weight` (rows are output-neuron weight vectors)
    into one batched ciphertext."""
    w = np.atleast_2d(np.asarray(weight, np.int64))
    return [ctx.encrypt(pk, ctx.encode(row)) for row in w]


def decrypt_weight(
    ctx: Context, sk: SecretKey, cts: Sequence[Ciphertext], length: int
) -> np.ndarray:
    out = [ctx.decode_signed(ctx.decrypt(sk, ct))[:length] for ct in cts]
    return np.stack(out)


def encrypt_bias(ctx: Context, pk: PublicKey, bias: np.ndarray) -> List[Ciphertext]:
    """One ciphertext per bias element, the scalar broadcast to every slot."""
    b = np.asarray(bias, np.int64).reshape(-1)
    return [
        ctx.encrypt(pk, ctx.encode(np.full(ctx.n, v % ctx.t, np.int64)))
        for v in b
    ]


def decrypt_bias(ctx: Context, sk: SecretKey, cts: Sequence[Ciphertext]) -> np.ndarray:
    """Inverse of encrypt_bias: one signed scalar per ciphertext."""
    return np.asarray(
        [int(ctx.decode_signed(ctx.decrypt(sk, ct))[0]) for ct in cts], np.int64
    )


# ---------------------------------------------------------------------------
# Masking / flattening
# ---------------------------------------------------------------------------


def make_mask(ctx: Context, num_ones: int) -> torch.Tensor:
    """plain_for_mul of a [1]*num_ones mask (the span ``hhe.helin.make_mask``:
    a host encode and NTT over every limb, and an upload)."""
    with trace.span("hhe.helin.make_mask"):
        vec = np.zeros(num_ones, np.int64) + 1
        return ctx.plain_for_mul(ctx.encode(vec))


def mask(ctx: Context, ct: Ciphertext, mask_pt: torch.Tensor) -> Ciphertext:
    return bfv_eval.multiply_plain(ctx, ct, mask_pt)


def flatten_galois_elts(ctx: Context, num_blocks: int, block: int = 128) -> List[int]:
    """Galois elements for flatten steps -block, -2*block, ..."""
    return [ctx.galois_elt_from_step(-i * block) for i in range(1, num_blocks)]


def flatten(
    ctx: Context,
    cts: Sequence[Ciphertext],
    gks: Dict[int, KSwitchKey],
    block: int = 128,
) -> Ciphertext:
    """Concatenate block ciphertexts: sum_i rotate_rows(ct_i, -i*block)."""
    acc = cts[0]
    for i, ct in enumerate(cts[1:], start=1):
        acc = bfv_eval.rotate_rows(ctx, ct, -i * block, gks, plus=acc)
    return acc


# ---------------------------------------------------------------------------
# Rotate-reduce sums
# ---------------------------------------------------------------------------


def encrypted_vec_sum(
    ctx: Context, ct: Ciphertext, gks: Dict[int, KSwitchKey], vec_size: int
) -> Ciphertext:
    """Naive reduction: cumulative rotate -1 and add; the sum of slots
    [0, vec_size) lands in slot vec_size-1."""
    acc = ct
    cur = ct
    for _ in range(vec_size - 1):
        cur = bfv_eval.rotate_rows(ctx, cur, -1, gks)
        acc = bfv_eval.add(ctx, acc, cur)
    return acc


def vec_sum_galois_elts(ctx: Context) -> List[int]:
    """Power-of-two rotation steps for the log-depth row sum."""
    half = ctx.n // 2
    return [ctx.galois_elt_from_step(1 << j) for j in range(int(math.log2(half)))]


def encrypted_vec_sum_log(
    ctx: Context, ct: Ciphertext, gks: Dict[int, KSwitchKey]
) -> Ciphertext:
    """Log-depth full-row sum: log2(N/2) rotations; every slot of each row
    ends up holding that row's total."""
    half = ctx.n // 2
    acc = ct
    for j in range(int(math.log2(half))):
        acc = bfv_eval.rotate_rows(ctx, acc, 1 << j, gks, plus=acc)
    return acc
