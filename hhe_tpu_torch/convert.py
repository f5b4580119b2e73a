"""Carry keys, ciphertexts and training state between the JAX package and
this one.

The JAX package holds residues as ``uint32`` arrays; this package holds the
same bits as ``int32`` tensors on a device.  The functions here take the JAX
package's key and ciphertext objects (anything with the same fields whose
arrays ``np.asarray`` accepts) and return this package's, and back.  This is
how a JAX-side analyst's keys reach a PyTorch-side CSP, and how the tests
compare the two packages array for array.  The integer network's parameters
(``FCParams``, ``MLP``) become int32 tensors and the float baselines'
float32 tensors.  The way back is ``to_numpy`` for residues
(``to_numpy(ct.data)``, ``to_numpy(ksk.k0)``) and ``.cpu().numpy()`` for the
rest.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.pocketnn import MLP, FCParams
from .ops.bfv import Ciphertext, KSwitchKey, PublicKey, SecretKey
from .ops.ntt import u32_to_numpy as to_numpy  # the way back: tensor -> uint32
from .ops.ntt import u32_to_torch as to_torch  # array of residues -> int32 tensor


def secret_key(sk) -> SecretKey:
    return SecretKey(
        np.asarray(sk.s_small).astype(np.int8), np.asarray(sk.s_q).astype(np.uint32)
    )


def public_key(pk) -> PublicKey:
    return PublicKey(np.asarray(pk.data).astype(np.uint32))


def kswitch_key(ksk, device) -> KSwitchKey:
    return KSwitchKey.of(to_torch(ksk.k0, device), to_torch(ksk.k1, device))


def galois_keys(gks, device) -> Dict[int, KSwitchKey]:
    return {int(g): kswitch_key(k, device) for g, k in gks.items()}


def ciphertext(ct, device) -> Ciphertext:
    return Ciphertext(to_torch(ct.data, device))



def _int32(a, device):
    return None if a is None else torch.as_tensor(np.asarray(a).astype(np.int32), device=device)


def fc_params(p, device) -> FCParams:
    """The JAX package's ``FCParams`` (weight, bias and, where present, the
    DFA feedback, gamma and beta) as int32 tensors on `device`."""
    return FCParams(*(_int32(getattr(p, f), device) for f in FCParams._fields))


def mlp(m, device) -> MLP:
    return MLP(tuple(fc_params(p, device) for p in m.params))


def float_params(params, device) -> tuple:
    """The float baselines' parameter tuples ((w, b) for SpO2, (w1, b1, w2,
    b2) for MNIST) as float32 tensors on `device`."""
    return tuple(
        torch.as_tensor(np.array(p, np.float32), device=device) for p in params
    )
