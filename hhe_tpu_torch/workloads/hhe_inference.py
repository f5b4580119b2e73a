"""Single-process HHE protocol simulations of the encrypted ECG and SpO2
(1FC) inference — counterpart of that part of
``hhe_tpu.workloads.hhe_inference``.

The user PASTA-encrypts the samples and HE-encrypts the PASTA key, the
analyst encrypts the model weights, the CSP transciphers the batch
(``csp_decompose``: keystream, then mask and flatten when a sample spans
several blocks) and evaluates the FC layer as ct x ct multiply plus
relinearize (``csp_eval_1fc``), and the analyst batch-decrypts.

- ``hhe_ecg_inference``: 128 words, one block; the analyst sums the slots
  and applies ``simple_pocket_sigmoid`` (reference
  ``hhe_pktnn_examples.cpp:63-383``).
- ``hhe_1fc_inference``: long inputs (SpO2: 300 words); the CSP also sums
  the product's slots with a log-depth rotate-reduce; the analyst reads slot
  L-1 and applies ``int_sigmoid``, with the reference's hard plaintext-parity
  check and its experiment report (reference ``hhe_pktnn_examples.cpp:385-711``).
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
from ..utils import checks, metrics
from ..utils.config import Config, RunConfig


def _apply_run(samples, labels, run: Optional[RunConfig]):
    """Reference dry_run semantics (``configs/config.cpp:11-12``): cap the
    sample count; debugging handled at the call sites."""
    if run is None:
        return samples, labels
    lim = run.sample_limit(len(samples))
    return samples[:lim], (None if labels is None else np.asarray(labels).reshape(-1)[:lim])


def _debug_noise(stack: "HHEStack", ct: Ciphertext, tag: str, run: Optional[RunConfig]):
    """Per-stage noise telemetry when run.debugging (reference
    ``pasta_3_seal.cpp:73`` print_noise in the debug path)."""
    if run is None or not run.debugging:
        return
    first = _split_batch(ct)[0]
    print(f"[debug] noise budget after {tag}: "
          f"{stack.ctx.noise_budget(stack.sk, first)} bits", flush=True)


def _sync(ctx: Context):
    """Wait for the context's device, so that a timed phase holds its work."""
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


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
    config: Optional[Config] = None,
    device=None,
) -> HHEStack:
    """Analyst-side setup: context + all keys the protocol needs.

    ``device`` defaults to CUDA and raises without a card unless
    ``device="cpu"`` is passed.  ``device_keygen`` generates the evaluation
    keys (relin + galois) on the device with a ``torch.Generator`` — host
    keygen of ~50 galois keys at N=16384 takes tens of minutes in numpy.
    ``config`` (``utils.config.Config``) supplies the HE parameters (unless
    ``params`` is given) and the BSGS layout."""
    use_bsgs, n1, n2 = True, transcipher.BSGS_N1, transcipher.BSGS_N2
    if config is not None:
        params = params or config.he.to_bfv_params(seed)
        use_bsgs, n1, n2 = config.he.use_bsgs, config.he.bsgs_n1, config.he.bsgs_n2
    ctx = Context(params or BFVParams(), device=device)
    sk = ctx.keygen_secret()
    pk = ctx.keygen_public(sk)
    num_blocks = math.ceil(input_len / transcipher.T)
    elts = set(transcipher.galois_elts(ctx, use_bsgs, n1, n2))
    elts.update(helin.flatten_galois_elts(ctx, num_blocks, transcipher.T))
    elts.update(helin.vec_sum_galois_elts(ctx))
    if device_keygen:
        rk, gks = ctx.keygen_eval_keys_device(
            sk, sorted(elts), include_relin=True, seed=seed
        )
    else:
        rk = ctx.keygen_relin(sk)
        gks = ctx.keygen_galois(sk, sorted(elts))
    tc = transcipher.Transcipher(ctx, rk, gks, use_bsgs=use_bsgs, n1=n1, n2=n2)
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


def hhe_1fc_inference(
    stack: HHEStack,
    weight: np.ndarray,
    samples: np.ndarray,
    check_parity: bool = True,
    run: Optional[RunConfig] = None,
) -> Dict[str, object]:
    """Full SpO2-style pipeline on a batch: PASTA encrypt -> transcipher ->
    mask/flatten -> encrypted FC + sum -> decrypt slot -> int_sigmoid.

    weight: [L] or [L, 1] signed ints; samples: [B, L] uint.
    With check_parity, raises if HHE output != plaintext w . x
    (the reference's hard failure, hhe_pktnn_examples.cpp:692-699).
    Returns the raw FC outputs, the predictions and the experiment report."""
    ctx = stack.ctx
    w = np.asarray(weight, np.int64).reshape(-1)
    samples = np.atleast_2d(np.asarray(samples, np.uint64))
    samples, _ = _apply_run(samples, None, run)
    B, L = samples.shape
    if w.shape != (L,):
        raise ValueError(f"weights {w.shape} do not match samples of {L} words")
    timer, ledger = metrics.Timer(), metrics.CommLedger()

    # User: symmetric encryption + HE key encryption
    key = pasta.get_fixed_symmetric_key()
    cipher = pasta.Pasta(key, ctx.t)
    with timer.phase("user"):
        sym = cipher.encrypt(samples)
        enc_key = stack.tc.encrypt_key(stack.pk, key)
        _sync(ctx)
    ledger.add("analyst-user", metrics.he_pk_size(stack.pk))
    ledger.add(
        "user-csp",
        metrics.he_vec_size([enc_key]) + metrics.sym_enc_data_size(sym),
    )

    # Analyst: model encryption (transposed row -> one ct)
    with timer.phase("analyst"):
        weight_ct = helin.encrypt_weight(ctx, stack.pk, w[None, :])[0]
        _sync(ctx)
    ledger.add(
        "analyst-csp",
        metrics.he_key_size(stack.rk, stack.gks) + metrics.he_vec_size([weight_ct]),
    )

    # CSP: transcipher + evaluate
    with timer.phase("csp"):
        data_ct = csp_decompose(stack, enc_key, sym)
        _debug_noise(stack, data_ct, "decomposition+flatten", run)
        wct = Ciphertext(weight_ct.data[:, None] if data_ct.data.dim() == 4 else weight_ct.data)
        result = csp_eval_1fc(stack, data_ct, wct, do_sum=True)
        _sync(ctx)
    _debug_noise(stack, result, "encrypted FC + vec_sum", run)
    ledger.add("analyst-csp", metrics.he_vec_size(_split_batch(result)))

    # Analyst: decrypt
    with timer.phase("analyst"):
        raw, preds = analyst_decrypt_slot_sigmoid(stack, result, L)

    if check_parity:
        expect = (samples.astype(np.int64) @ w).astype(np.int64)
        if not np.array_equal(raw, expect):
            raise RuntimeError(
                "FC layer's plaintext results and HHE results are different: "
                f"{raw} vs {expect}"
            )
    report = metrics.experiment_report(timer, ledger)
    if run is not None and run.verbose:
        print(metrics.format_experiment_report(report), flush=True)
    return {"raw": raw, "predictions": preds, "report": report}


def hhe_ecg_inference(
    stack: HHEStack,
    weight: np.ndarray,
    samples: np.ndarray,
    labels: Optional[np.ndarray] = None,
    run: Optional[RunConfig] = None,
) -> Dict[str, object]:
    """ECG pipeline (128-length, single block, host-side sum+sigmoid).

    Returns the predictions and the intermediate ciphertexts: the decomposed
    batch (``data_ct``) and the FC product (``prod_ct``)."""
    ctx = stack.ctx
    w = np.asarray(weight, np.int64).reshape(-1)
    samples = np.atleast_2d(np.asarray(samples, np.uint64))
    samples, labels = _apply_run(samples, labels, run)
    B, L = samples.shape
    if L != transcipher.T or w.shape != (L,):
        raise ValueError(f"ECG inputs and weights must have {transcipher.T} words")

    key = pasta.get_fixed_symmetric_key()
    sym = pasta.Pasta(key, ctx.t).encrypt(samples)
    enc_key = stack.tc.encrypt_key(stack.pk, key)
    weight_ct = helin.encrypt_weight(ctx, stack.pk, w[None, :])[0]

    data_ct = csp_decompose(stack, enc_key, sym)
    _debug_noise(stack, data_ct, "decomposition", run)
    wct = Ciphertext(weight_ct.data[:, None] if data_ct.data.dim() == 4 else weight_ct.data)
    prod = csp_eval_1fc(stack, data_ct, wct, do_sum=False)
    _debug_noise(stack, prod, "encrypted weight product", run)
    preds = analyst_decrypt_sum_sigmoid(stack, prod, L)
    out = {"predictions": preds, "data_ct": data_ct, "prod_ct": prod}
    if labels is not None:
        out["accuracy"] = float(np.mean(preds == np.asarray(labels).reshape(-1)[:B]))
    return out
