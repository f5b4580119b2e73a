"""Binary serialization of ciphertexts and keys — counterpart of
``hhe_tpu.utils.serial``: magic, version, kind tag, shape, raw little-endian
u32/int8 data, byte for byte what the JAX package writes and reads, with the
same optional zlib container (``compress`` / ``decompress``).

The loaders that return residue tensors take the device to put them on
(``load_ciphertext(buf, device)``); there is no default, so that no party
reads a key or ciphertext onto the CPU without asking for it.
``load_array`` and ``load_public_key`` return host numpy, as the JAX
package's do (``PublicKey`` holds numpy)."""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import bfv
from ..ops.ntt import u32_to_numpy, u32_to_torch

MAGIC = b"HHE1"
MAGIC_Z = b"HHEZ"  # zlib container (SEAL compr_mode_type::zlib, seal/util/ztools.h)
_KIND_U32 = 0
_KIND_I8 = 1

KIND_CT = 1
KIND_PK = 2
KIND_KSK = 3


def compress(buf: bytes, level: int = 6) -> bytes:
    """Wrap a serialized payload in a zlib container (SEAL's optional
    compressed save, seal/serialization.h + seal/util/ztools.h)."""
    return MAGIC_Z + struct.pack("<Q", len(buf)) + zlib.compress(buf, level)


def decompress(buf: bytes) -> bytes:
    """Transparently unwrap: returns the raw payload whether or not `buf`
    is a zlib container; a corrupt or truncated container raises
    ``ValueError``."""
    if buf[:4] != MAGIC_Z:
        return buf
    (raw_len,) = struct.unpack_from("<Q", buf, 4)
    try:
        out = zlib.decompress(buf[12:])
    except zlib.error as e:
        raise ValueError(f"corrupt compressed payload: {e}") from e
    if len(out) != raw_len:
        raise ValueError(
            f"corrupt compressed payload: expected {raw_len} bytes, got {len(out)}"
        )
    return out


def dump_array(arr) -> bytes:
    if isinstance(arr, torch.Tensor):  # residue tensors hold u32 bits
        arr = u32_to_numpy(arr)
    arr = np.asarray(arr)
    if arr.dtype == np.int8:
        kind, data = _KIND_I8, arr.astype(np.int8)
    else:
        kind, data = _KIND_U32, arr.astype(np.uint32)
    hdr = struct.pack("<4sBB", MAGIC, kind, data.ndim) + struct.pack(
        f"<{data.ndim}I", *data.shape
    )
    return hdr + data.tobytes()


def load_array(buf, offset: int = 0) -> Tuple[np.ndarray, int]:
    """One array (uint32 or int8 numpy) at `offset`; returns it and the
    offset past it."""
    magic, kind, ndim = struct.unpack_from("<4sBB", buf, offset)
    if magic != MAGIC:
        raise ValueError("bad serialization header")
    offset += 6
    shape = struct.unpack_from(f"<{ndim}I", buf, offset)
    offset += 4 * ndim
    n = int(np.prod(shape)) if ndim else 1
    if kind == _KIND_I8:
        arr = np.frombuffer(buf, np.int8, n, offset).reshape(shape)
        offset += n
    else:
        arr = np.frombuffer(buf, np.uint32, n, offset).reshape(shape)
        offset += 4 * n
    return arr.copy(), offset


def dump_ciphertext(ct: bfv.Ciphertext) -> bytes:
    return dump_array(ct.data)


def load_ciphertext(buf, device) -> bfv.Ciphertext:
    arr, _ = load_array(decompress(buf))
    return bfv.Ciphertext(u32_to_torch(arr, device))


def dump_public_key(pk: bfv.PublicKey) -> bytes:
    return dump_array(pk.data)


def load_public_key(buf) -> bfv.PublicKey:
    arr, _ = load_array(decompress(buf))
    return bfv.PublicKey(arr)


def dump_kswitch(k: bfv.KSwitchKey) -> bytes:
    a = dump_array(k.k0)
    b = dump_array(k.k1)
    return struct.pack("<I", len(a)) + a + b


def load_kswitch(buf, device) -> bfv.KSwitchKey:
    buf = decompress(buf)
    (la,) = struct.unpack_from("<I", buf, 0)
    k0, _ = load_array(buf, 4)
    k1, _ = load_array(buf, 4 + la)
    return bfv.KSwitchKey.of(u32_to_torch(k0, device), u32_to_torch(k1, device))


def dump_galois_keys(gks: dict) -> bytes:
    out = [struct.pack("<I", len(gks))]
    for g, k in sorted(gks.items()):
        kb = dump_kswitch(k)
        out.append(struct.pack("<II", g, len(kb)))
        out.append(kb)
    return b"".join(out)


def load_galois_keys(buf, device) -> dict:
    buf = memoryview(decompress(buf))  # frames are read in place, not copied
    (n,) = struct.unpack_from("<I", buf, 0)
    off = 4
    out = {}
    for _ in range(n):
        g, lk = struct.unpack_from("<II", buf, off)
        off += 8
        out[int(g)] = load_kswitch(buf[off : off + lk], device)
        off += lk
    return out


def dump_ciphertext_vec(cts: Sequence[bfv.Ciphertext]) -> bytes:
    """Size-prefix framed vector (reference CSP::writeHHEDecompositionDataToFile,
    CSP.cpp:495-517 / deserializeCiphertexts CSP.cpp:552-605)."""
    out = [struct.pack("<I", len(cts))]
    for ct in cts:
        b = dump_ciphertext(ct)
        out.append(struct.pack("<Q", len(b)))
        out.append(b)
    return b"".join(out)


def load_ciphertext_vec(buf, device) -> List[bfv.Ciphertext]:
    buf = memoryview(decompress(buf))
    (n,) = struct.unpack_from("<I", buf, 0)
    off = 4
    out = []
    for _ in range(n):
        (lb,) = struct.unpack_from("<Q", buf, off)
        off += 8
        out.append(load_ciphertext(buf[off : off + lb], device))
        off += lb
    return out
