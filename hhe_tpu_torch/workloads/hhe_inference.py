"""Single-process HHE protocol simulation of the encrypted ECG inference —
counterpart of the ECG part of ``hhe_tpu.workloads.hhe_inference``.

The user PASTA-encrypts the samples and HE-encrypts the PASTA key, the
analyst encrypts the model weights, the CSP transciphers the batch
(``csp_decompose``) and evaluates the FC layer as ct x ct multiply plus
relinearize (``csp_eval_1fc``), and the analyst batch-decrypts, sums the
slots and applies ``simple_pocket_sigmoid`` (reference
``hhe_pktnn_examples.cpp:63-383``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import pocketnn
from ..ops import bfv, bfv_eval, helin, pasta, transcipher
from ..ops.bfv import BFVParams, Ciphertext, Context
from ..utils import checks


@dataclasses.dataclass
class HHEStack:
    """Bundled parameter set + party keys for single-process simulations."""

    ctx: Context
    sk: bfv.SecretKey
    pk: bfv.PublicKey
    rk: bfv.KSwitchKey
    gks: Dict[int, bfv.KSwitchKey]
    tc: transcipher.Transcipher
    # The CSP's own secret key — distinct from the analyst's by protocol;
    # never used to decrypt analyst data.
    csp_sk: Optional[bfv.SecretKey] = None


def build_stack(
    params: Optional[BFVParams] = None,
    input_len: int = 300,
    device_keygen: bool = False,
    seed: int = 0,
    device=None,
) -> HHEStack:
    """Analyst-side setup: context + all keys the protocol needs.

    ``device`` defaults to CUDA and raises without a card unless
    ``device="cpu"`` is passed.  ``device_keygen`` generates the evaluation
    keys (relin + galois) on the device with a ``torch.Generator`` — host
    keygen of ~50 galois keys at N=16384 takes tens of minutes in numpy."""
    ctx = Context(params or BFVParams(), device=device)
    sk = ctx.keygen_secret()
    pk = ctx.keygen_public(sk)
    num_blocks = math.ceil(input_len / transcipher.T)
    elts = set(transcipher.galois_elts(ctx))
    elts.update(helin.flatten_galois_elts(ctx, num_blocks, transcipher.T))
    elts.update(helin.vec_sum_galois_elts(ctx))
    if device_keygen:
        rk, gks = ctx.keygen_eval_keys_device(
            sk, sorted(elts), include_relin=True, seed=seed
        )
    else:
        rk = ctx.keygen_relin(sk)
        gks = ctx.keygen_galois(sk, sorted(elts))
    tc = transcipher.Transcipher(ctx, rk, gks)
    # CSP key hygiene: the CSP's own keypair must differ from the analyst's
    csp_sk = ctx.keygen_secret()
    checks.are_same_he_sk(sk, csp_sk)
    return HHEStack(ctx, sk, pk, rk, gks, tc, csp_sk=csp_sk)


# ---------------------------------------------------------------------------
# CSP-side pipeline
# ---------------------------------------------------------------------------


def csp_decompose(
    stack: HHEStack, enc_key: Ciphertext, sym_data: np.ndarray, nonce: int = pasta.NONCE
) -> Ciphertext:
    """Transcipher + postprocess (mask tail, flatten) for a batch [B, L].
    Returns batched ct [2, B, k, N] holding each sample in slots [0, L)."""
    ctx = stack.ctx
    sym_data = np.atleast_2d(np.asarray(sym_data, np.uint64))
    L = sym_data.shape[1]
    blocks = stack.tc.decompose(enc_key, sym_data, nonce=nonce)
    tail = L % transcipher.T
    if tail != 0:
        blocks[-1] = helin.mask(ctx, blocks[-1], helin.make_mask(ctx, tail))
    if len(blocks) == 1:
        return blocks[0]
    return helin.flatten(ctx, blocks, stack.gks, transcipher.T)


def csp_eval_1fc(
    stack: HHEStack, data_ct: Ciphertext, weight_ct: Ciphertext, do_sum: bool
) -> Ciphertext:
    """Encrypted FC: data * weight (ct x ct), relinearize, optional
    log-depth rotate-reduce sum."""
    ctx = stack.ctx
    prod = bfv_eval.relinearize(ctx, bfv_eval.multiply(ctx, data_ct, weight_ct), stack.rk)
    if do_sum:
        prod = helin.encrypted_vec_sum_log(ctx, prod, stack.gks)
    return prod


# ---------------------------------------------------------------------------
# Analyst-side decryption
# ---------------------------------------------------------------------------


def _split_batch(ct: Ciphertext) -> List[Ciphertext]:
    data = ct.data
    if data.dim() == 3:
        return [Ciphertext(data)]
    return [Ciphertext(data[:, i]) for i in range(data.shape[1])]


def _decrypt_signed_slots(stack: HHEStack, result_ct: Ciphertext) -> np.ndarray:
    """Decrypt a (possibly batched) result ct to [B, N] signed slot values:
    full-level batched cts take ``Context.decrypt_batch``, anything else the
    per-sample host decrypt (bit-identical either way)."""
    ctx = stack.ctx
    data = result_ct.data
    if data.dim() == 4 and data.shape[2] == ctx.k:
        return ctx.decode_signed_batch(ctx.decrypt_batch(stack.sk, result_ct))
    return np.stack(
        [ctx.decode_signed(ctx.decrypt(stack.sk, ct)) for ct in _split_batch(result_ct)]
    )


def analyst_decrypt_sum_sigmoid(
    stack: HHEStack, result_ct: Ciphertext, length: int
) -> np.ndarray:
    """ECG pipeline: decrypt, host-sum `length` slots, simple_pocket_sigmoid,
    threshold > 64 -> prediction in {0, 128}."""
    slots = _decrypt_signed_slots(stack, result_ct)[:, :length]
    out = pocketnn.simple_pocket_sigmoid(slots.sum(1)).numpy()
    return np.where(out > 64, 128, 0)


def analyst_decrypt_slot_sigmoid(
    stack: HHEStack, result_ct: Ciphertext, input_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """SpO2/1fc pipeline: decrypt, read slot input_len-1, int_sigmoid.
    Returns (raw fc outputs, predictions)."""
    raw = _decrypt_signed_slots(stack, result_ct)[:, input_len - 1]
    preds = pocketnn.int_sigmoid(torch.as_tensor(raw)).numpy()
    return raw.astype(np.int64), preds


# ---------------------------------------------------------------------------
# Full protocol simulation
# ---------------------------------------------------------------------------


def hhe_ecg_inference(
    stack: HHEStack,
    weight: np.ndarray,
    samples: np.ndarray,
    labels: Optional[np.ndarray] = None,
) -> Dict[str, object]:
    """ECG pipeline (128-length, single block, host-side sum+sigmoid).

    Returns the predictions and the intermediate ciphertexts: the decomposed
    batch (``data_ct``) and the FC product (``prod_ct``)."""
    ctx = stack.ctx
    w = np.asarray(weight, np.int64).reshape(-1)
    samples = np.atleast_2d(np.asarray(samples, np.uint64))
    B, L = samples.shape
    if L != transcipher.T or w.shape != (L,):
        raise ValueError(f"ECG inputs and weights must have {transcipher.T} words")

    key = pasta.get_fixed_symmetric_key()
    sym = pasta.Pasta(key, ctx.t).encrypt(samples)
    enc_key = stack.tc.encrypt_key(stack.pk, key)
    weight_ct = helin.encrypt_weight(ctx, stack.pk, w[None, :])[0]

    data_ct = csp_decompose(stack, enc_key, sym)
    wct = Ciphertext(weight_ct.data[:, None] if data_ct.data.dim() == 4 else weight_ct.data)
    prod = csp_eval_1fc(stack, data_ct, wct, do_sum=False)
    preds = analyst_decrypt_sum_sigmoid(stack, prod, L)
    out = {"predictions": preds, "data_ct": data_ct, "prod_ct": prod}
    if labels is not None:
        out["accuracy"] = float(np.mean(preds == np.asarray(labels).reshape(-1)[:B]))
    return out
