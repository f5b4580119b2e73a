"""RNS base machinery: CRT compose/decompose and fast base conversion —
counterpart of ``hhe_tpu.ops.rns``.

The host side uses exact Python bigints (CRT, constants); the tensor side
runs fast base conversion (FBC) as Montgomery arithmetic on int32 residues.

FBC from base A = {a_1..a_k} to modulus c:
    y_c = sum_j [x_j * (A/a_j)^{-1}]_{a_j} * (A/a_j)  mod c
which equals x + alpha*A for a small overflow 0 <= alpha < k.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import modular


# ---------------------------------------------------------------------------
# Host bigint CRT
# ---------------------------------------------------------------------------


class RnsBase:
    """A fixed ordered set of coprime moduli with host CRT precomputation."""

    def __init__(self, moduli: Sequence[int]):
        self.moduli: Tuple[int, ...] = tuple(int(m) for m in moduli)
        self.k = len(self.moduli)
        self.Q = math.prod(self.moduli)
        self.tilde = [self.Q // m for m in self.moduli]  # Q/a_j
        self.inv = [pow(t, -1, m) for t, m in zip(self.tilde, self.moduli)]
        # CRT units u_j = tilde_j * inv_j  (== 1 mod a_j, == 0 mod a_i)
        self.unit = [t * i for t, i in zip(self.tilde, self.inv)]

    def decompose(self, x) -> np.ndarray:
        """Integers (any shape, Python ints / object array) -> u32 [k, ...]."""
        arr = np.asarray(x, dtype=object)
        out = np.empty((self.k,) + arr.shape, np.uint32)
        for j, m in enumerate(self.moduli):
            out[j] = (arr % m).astype(np.uint64).astype(np.uint32)
        return out

    def compose(self, x_rns: np.ndarray) -> np.ndarray:
        """u32/u64 [k, ...] -> object array of exact integers in [0, Q)."""
        x = np.asarray(x_rns, np.uint64)
        acc = np.zeros(x.shape[1:], dtype=object)
        for j in range(self.k):
            acc += x[j].astype(object) * self.unit[j]
        return acc % self.Q

    def compose_centered(self, x_rns: np.ndarray) -> np.ndarray:
        v = self.compose(x_rns)
        half = self.Q // 2
        return np.where(v > half, v - self.Q, v)


# ---------------------------------------------------------------------------
# Fast base conversion
# ---------------------------------------------------------------------------


class FBC(NamedTuple):
    """Constants for FBC from base A (ka moduli) to base C (kc moduli)."""

    a_q: torch.Tensor  # [ka, 1] int64
    a_qinv: torch.Tensor  # [ka, 1] int64
    inv_mont: torch.Tensor  # [ka, 1] int64  (A/a_j)^-1 mod a_j, Mont(a_j)
    c_q: torch.Tensor  # [kc, 1] int64
    c_qinv: torch.Tensor  # [kc, 1] int64
    m_mont: torch.Tensor  # [ka, kc] int64  (A/a_j) mod c, Mont(c)


def build_fbc(src: RnsBase, dst_moduli: Sequence[int], device) -> FBC:
    dst = tuple(int(m) for m in dst_moduli)
    ka, kc = src.k, len(dst)
    a_q = np.array(src.moduli, np.uint32).reshape(ka, 1)
    a_qi = np.zeros((ka, 1), np.uint32)
    invm = np.zeros((ka, 1), np.uint32)
    for j, m in enumerate(src.moduli):
        qinv_neg, _, _ = modular.mont_constants(m)
        a_qi[j, 0] = qinv_neg
        invm[j, 0] = modular.to_mont_host(np.uint64(src.inv[j]), m)
    c_q = np.array(dst, np.uint32).reshape(kc, 1)
    c_qi = np.zeros((kc, 1), np.uint32)
    mm = np.zeros((ka, kc), np.uint32)
    for i, c in enumerate(dst):
        qinv_neg, _, _ = modular.mont_constants(c)
        c_qi[i, 0] = qinv_neg
        for j in range(ka):
            mm[j, i] = modular.to_mont_host(np.uint64(src.tilde[j] % c), c)
    return FBC(
        *(torch.from_numpy(a.astype(np.int64)).to(device)
          for a in (a_q, a_qi, invm, c_q, c_qi, mm))
    )


def fbc_digits(x: torch.Tensor, f: FBC) -> torch.Tensor:
    """tmp_j = [x_j * (A/a_j)^{-1}]_{a_j}: x [..., ka, N] -> same shape."""
    return modular.mont_mul(x, f.inv_mont, f.a_q, f.a_qinv)


def fbc_from_digits(tmp: torch.Tensor, f: FBC, chunk: int = 4) -> torch.Tensor:
    """FBC given precomputed digits: [..., ka, N] -> [..., kc, N].

    Multiply-accumulates over groups of ``chunk`` digits on the CPU (bounds
    the plain version's [..., chunk, kc, N] temporary); the kernel (K4)
    keeps no temporary and takes all ka digits in one launch."""
    ka = tmp.shape[-2]
    step = ka if tmp.is_cuda else chunk
    acc = None
    for s in range(0, ka, step):
        part = modular.mont_mac(
            tmp[..., s : s + step, None, :],
            f.m_mont[s : s + step, :, None],
            f.c_q,
            f.c_qinv,
            -3,
        )  # [..., kc, N]
        acc = part if acc is None else modular.add_mod(acc, part, f.c_q)
    return acc


def fbc_apply(x: torch.Tensor, f: FBC) -> torch.Tensor:
    """Approximate base conversion A -> C: result == x + alpha*A (alpha < ka)."""
    return fbc_from_digits(fbc_digits(x, f), f)


def fbc_digits_to_pow2(tmp: torch.Tensor, tilde_mod: torch.Tensor, bits: int) -> torch.Tensor:
    """FBC digits -> a power-of-two modulus 2^bits (bits <= 16); tilde_mod
    is the [k, 1] int64 column (A/a_j) mod 2^bits on tmp's device.

    Each term is below 2^32 and the int64 sum of k terms is exact, so masking
    the sum equals the JAX package's wrapping u32 sum modulo 2^bits."""
    mask = (1 << bits) - 1
    t = (tmp.to(torch.int64) & mask) * tilde_mod
    return (t.sum(dim=-2) & mask).to(tmp.dtype)


def reduce_u32(x: torch.Tensor, q) -> torch.Tensor:
    """Reduce values < 2^31 modulo q (q >= 2^29): exactly three conditional
    subtracts, over the broadcast of x and q, in x's dtype; a CUDA x goes to
    the K5 kernel (``mod_kernels.mod_elem``), a CPU x to
    ``reduce_u32_plain``."""
    if x.is_cuda:
        from . import mod_kernels

        return mod_kernels.mod_elem("reduce", x, 0, q)
    return reduce_u32_plain(x, q)


def reduce_u32_plain(x: torch.Tensor, q) -> torch.Tensor:
    """Plain version of ``reduce_u32`` (int64 PyTorch)."""
    r = x.to(torch.int64)
    q = q.to(torch.int64) if isinstance(q, torch.Tensor) else q
    for _ in range(3):
        r = torch.where(r >= q, r - q, r)
    return r.to(x.dtype)


def center_lift(x: torch.Tensor, m_mod_q, q, half: int) -> torch.Tensor:
    """x in [0, m) (below 2^31) taken as the centred residue mod m (x > half
    stands for x - m), lifted to q: reduce_u32(x, q), less m mod q where x >
    half -- the ``jnp.where`` of BEHZ's ``_bsk_to_q`` (alpha mod m_sk to q)
    and ``_to_bsk`` (r mod m_tilde to Bsk) in the JAX package; one K5 launch
    on the card (``mod_kernels.mod_center``), ``center_lift_plain`` on the
    CPU."""
    if x.is_cuda:
        from . import mod_kernels

        return mod_kernels.mod_center(x, m_mod_q, q, half)
    return center_lift_plain(x, m_mod_q, q, half)


def center_lift_plain(x: torch.Tensor, m_mod_q, q, half: int) -> torch.Tensor:
    """Plain version of ``center_lift`` (int64 PyTorch)."""
    r = reduce_u32_plain(x, q)
    return torch.where(x > half, modular.sub_mod_plain(r, m_mod_q, q), r)
