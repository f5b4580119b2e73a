"""Single-process HHE protocol simulations of the encrypted inference
workloads — counterpart of ``hhe_tpu.workloads.hhe_inference``.

The user PASTA-encrypts the samples and HE-encrypts the PASTA key, the
analyst encrypts the model weights, the CSP transciphers the batch
(``csp_decompose``: keystream, then mask and flatten when a sample spans
several blocks) and evaluates the model on ciphertexts, and the analyst
batch-decrypts.

- ``hhe_ecg_inference``: 128 words, one block; ct x ct weight product; the
  analyst sums the slots and applies ``simple_pocket_sigmoid`` (reference
  ``hhe_pktnn_examples.cpp:63-383``).
- ``hhe_ecg_full_inference``: the same pipeline over the 13,245-sample
  MIT-BIH test set in chunks of ``batch`` samples, one keystream for all,
  with the reference's experiment report (surrogate inputs: the reference's
  input matrix is not shipped).
- ``hhe_1fc_inference``: long inputs (SpO2: 300 words); the CSP also sums
  the product's slots with a log-depth rotate-reduce; the analyst reads slot
  L-1 and applies ``int_sigmoid``, with the reference's hard plaintext-parity
  check and its experiment report (reference ``hhe_pktnn_examples.cpp:385-711``).
- ``hhe_2fc_inference``: MNIST-style 784 -> R -> square -> 10
  (``csp_eval_2fc``: fc1 as R ct x ct row products with rotate-reduce sums,
  the square as a ct x ct product, fc2 as small-norm scalar combinations),
  with mod-t parity (reference ``hhe_pktnn_examples.cpp:713-1010``, the fc2
  half completed homomorphically).
- ``hhe_fmnist_1fc_inference``: the FashionMNIST one-layer 784 -> 10 model
  with bias (``csp_eval_fc_multi``: C class rows in one batched pass), with
  mod-t parity and the experiment report.

Class- and row-batched passes broadcast a data ciphertext ``[2, B, 1, k, N]``
against stacked weight ciphertexts ``[2, 1, R, k, N]``; the evaluator works
on any leading shape.

The CSP's entry functions, which the parties' CSP (``parties.csp``) runs
too, are the spans ``hhe.csp_decompose``, ``hhe.csp_eval_1fc`` and
``hhe.csp_eval_2fc`` (``utils.trace``); the 2FC pass adds ``hhe.2fc.chunk`` for each row chunk and ``hhe.2fc.fc2_consts``
for its scalar constants.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import loaders, pocketnn
from ..ops import bfv, bfv_eval, heconv, helin, pasta, transcipher
from ..ops.bfv import BFVParams, Ciphertext, Context
from ..ops.modular import add_mod
from ..utils import checks, graphs, metrics, trace
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
    first = ct.data
    while first.dim() > 3:  # the first sample (and class) of a batched ct
        first = first[:, 0]
    print(f"[debug] noise budget after {tag}: "
          f"{stack.ctx.noise_budget(stack.sk, Ciphertext(first))} bits", flush=True)


@dataclasses.dataclass
class HHEStack:
    """Bundled parameter set + party keys: every key for the single-process
    simulations; a CSP's stack holds the analyst's public and evaluation
    keys and no secret key (``sk`` None)."""

    ctx: Context
    sk: Optional[bfv.SecretKey]
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
    keygen draws every key's randomness in numpy, as the JAX package does
    (the same keys, bit for bit), and is the slower of the two.
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
    stack: HHEStack,
    enc_key: Ciphertext,
    sym_data: np.ndarray,
    nonce: int = pasta.NONCE,
    mesh=None,
) -> Ciphertext:
    """Transcipher + postprocess (mask tail, flatten) for a batch [B, L].
    Returns batched ct [2, B, k, N] holding each sample in slots [0, L).

    With ``mesh`` the keystream is evaluated on the rank's limbs (where the
    mesh's limb axis divides k) and the sample batch is split over its
    batch axis (``Transcipher.decompose``); every rank returns the whole
    result."""
    with trace.span("hhe.csp_decompose"):
        ctx = stack.ctx
        sym_data = np.atleast_2d(np.asarray(sym_data, np.uint64))
        L = sym_data.shape[1]
        blocks = stack.tc.decompose(enc_key, sym_data, nonce=nonce, mesh=mesh)
        tail = L % transcipher.T
        if tail != 0:
            blocks[-1] = helin.mask(ctx, blocks[-1], helin.make_mask(ctx, tail))
        if len(blocks) == 1:
            return blocks[0]
        return helin.flatten(ctx, blocks, stack.gks, transcipher.T)


def csp_eval_1fc(
    stack: HHEStack, data_ct: Ciphertext, weight_ct: Ciphertext, do_sum: bool, mesh=None
) -> Ciphertext:
    """Encrypted FC: data * weight (ct x ct), relinearize, optional
    log-depth rotate-reduce sum.

    Without ``mesh`` it is one ``utils.graphs`` unit per stack and
    ``do_sum`` (the JAX package's ``_jit_1fc_{do_sum}``, kept on the stack
    as the JAX package keeps its jit): on the card, captured once per
    layout and replayed; the data and weight ciphertexts are its inputs,
    the keys its constants.  The parties' CSP evaluates each ciphertext
    through the ``do_sum=True`` unit of its analyst's stack.

    With ``mesh`` it runs eagerly on the rank's limbs
    (``Transcipher.on_limbs``'s view): ``data_ct`` is the rank's block
    (``mesh.shard_ciphertext_batch``), ``weight_ct`` whole or the rank's
    limbs, and so is the result, which ``gather_limbs`` and ``gather_batch``
    make whole; the analyst decrypts only whole ciphertexts."""
    with trace.span("hhe.csp_eval_1fc"):
        if mesh is None:
            key = f"_jit_1fc_{do_sum}"
            unit = stack.__dict__.get(key)
            if unit is None:
                unit = stack.__dict__[key] = graphs.jit(
                    functools.partial(_fc_body, stack.ctx, do_sum), "eval_1fc", stack.ctx)
            return Ciphertext(unit(data_ct.data, weight_ct.data, stack.rk, stack.gks))
        ctx = stack.tc.on_limbs(mesh).ctx
        return Ciphertext(_fc_body(ctx, do_sum, data_ct.data, weight_ct.data, stack.rk, stack.gks))


def _fc_body(ctx, do_sum: bool, dd: torch.Tensor, wd: torch.Tensor, rk, gks) -> torch.Tensor:
    """``csp_eval_1fc``'s evaluation on ciphertext data [2, (B,) k, N]."""
    prod = bfv_eval.relinearize(ctx, bfv_eval.multiply(ctx, Ciphertext(dd), Ciphertext(wd)), rk)
    if do_sum:
        prod = helin.encrypted_vec_sum_log(ctx, prod, gks)
    return prod.data


# ---------------------------------------------------------------------------
# Analyst-side decryption
# ---------------------------------------------------------------------------


def split_batch(ct: Ciphertext) -> List[Ciphertext]:
    """A batched [2, B, k, N] ciphertext -> B per-sample views [2, k, N]
    (the NTT wrappers make a view contiguous before a kernel reads it); an
    unbatched one -> itself."""
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
        [ctx.decode_signed(ctx.decrypt(stack.sk, ct)) for ct in split_batch(result_ct)]
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
        ctx.synchronize()
    ledger.add("analyst-user", metrics.he_pk_size(stack.pk))
    ledger.add(
        "user-csp",
        metrics.he_vec_size([enc_key]) + metrics.sym_enc_data_size(sym),
    )

    # Analyst: model encryption (transposed row -> one ct)
    with timer.phase("analyst"):
        weight_ct = helin.encrypt_weight(ctx, stack.pk, w[None, :])[0]
        ctx.synchronize()
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
        ctx.synchronize()
    _debug_noise(stack, result, "encrypted FC + vec_sum", run)
    ledger.add("analyst-csp", metrics.he_vec_size(split_batch(result)))

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


# ---------------------------------------------------------------------------
# MNIST-style 2FC: 784 -> R -> square -> 10
# ---------------------------------------------------------------------------


def _fc2_scalar_consts(ctx: Context, w2: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """The small-norm fc2's constants, ``heconv.scalar_fc_consts``: Montgomery
    |w2| per limb [R, C, k, 1] and the sign mask [R, C, 1, 1]."""
    with trace.span("hhe.2fc.fc2_consts"):
        return heconv.scalar_fc_consts(ctx, w2)


def _2fc_chunk(
    stack: HHEStack,
    dd: torch.Tensor,
    wstack: torch.Tensor,
    w2_mont: torch.Tensor,
    w2_neg: torch.Tensor,
    digit_chunk: Optional[int] = None,
) -> torch.Tensor:
    """One 2FC pass over a chunk of R hidden rows: BEHZ multiply of the data
    [2, B, k, N] with the stacked rows [2, R, k, N], relinearize, log-depth
    vec-sum, square, relinearize, and the chunk's fc2 partial [2, B, C, k, N]
    (``heconv.he_scalar_fc``, one ``mont_mac`` over the R rows; its sums are
    exact mod q, so the result is the JAX package's per-class tree, bit for
    bit).  ``digit_chunk`` bounds the relinearize hoist (bit-identical; see
    ``bfv_eval.keyswitch``)."""
    ctx = stack.ctx
    a = Ciphertext(dd[:, :, None])  # [2, B, 1, k, N]
    b = Ciphertext(wstack[:, None])  # [2, 1, R, k, N]
    prod = bfv_eval.relinearize(
        ctx, bfv_eval.multiply(ctx, a, b), stack.rk, digit_chunk=digit_chunk
    )
    sums = helin.encrypted_vec_sum_log(ctx, prod, stack.gks)  # [2, B, R, k, N]
    sq = bfv_eval.relinearize(
        ctx, bfv_eval.square(ctx, sums), stack.rk, digit_chunk=digit_chunk
    ).data
    return heconv.he_scalar_fc(ctx, Ciphertext(sq), w2_mont, w2_neg, "fc2").data  # [2, B, C, k, N]


def csp_eval_2fc(
    stack: HHEStack,
    data_ct: Ciphertext,
    w1_cts: List[Ciphertext],
    w2: np.ndarray,
    row_chunk: Optional[int] = None,
    digit_chunk: Optional[int] = None,
) -> Ciphertext:
    """Encrypted 2FC forward:

    1. fc1: the R output rows in batched passes — the data ct broadcast
       against the stacked encrypted weight rows, BEHZ multiply,
       relinearize, log-depth rotate-reduce (each row ct then holds its
       neuron's value in every slot);
    2. square activation: batched ct x ct square + relinearize;
    3. fc2: logit_c = sum_r w2[r,c] * sq_r — integer scalars across the
       rows (``heconv.he_scalar_fc``), costing ~log2(sum|w2|) noise bits
       instead of the ~log2(N*t) of a full-slot plaintext multiply.

    data_ct: [2, k, N] or batched [2, B, k, N].  Returns a class-batched
    ciphertext [2, B, C, k, N] (or [2, C, k, N] unbatched): logit c lives in
    every slot of class-ct c.  ``row_chunk`` bounds device memory: the R
    rows go ``row_chunk`` at a time and the partial logits are added
    (bit-identical to one pass)."""
    with trace.span("hhe.csp_eval_2fc"):
        ctx = stack.ctx
        w2 = np.asarray(w2, np.int64)
        dd = data_ct.data
        batched = dd.dim() == 4
        if not batched:
            dd = dd[:, None]  # [2, 1, k, N]
        rows = len(w1_cts)
        chunk = row_chunk if (row_chunk is not None and row_chunk < rows) else rows
        acc = None
        for s in range(0, rows, chunk):
            with trace.span("hhe.2fc.chunk"):
                wstack = torch.stack([w.data for w in w1_cts[s : s + chunk]], dim=1)
                w2_mont, w2_neg = _fc2_scalar_consts(ctx, w2[s : s + chunk])
                part = _2fc_chunk(stack, dd, wstack, w2_mont, w2_neg, digit_chunk)
                acc = part if acc is None else bfv_eval.add(ctx, Ciphertext(acc), Ciphertext(part)).data
        return Ciphertext(acc if batched else acc[:, 0])


def decrypt_2fc_logits(stack: HHEStack, logits_ct: Ciphertext) -> np.ndarray:
    """Class-batched logits ct [2, (B,) C, k, N] -> [B, C] signed logits
    (slot 0 of each class ct).  Full-level ciphertexts fold the (B, C) grid
    into one ``decrypt_batch``; others (mod-switched) are decrypted one by
    one on the host (bit-identical)."""
    ctx = stack.ctx
    data = logits_ct.data
    if data.dim() == 4:  # unbatched [2, C, k, N]
        data = data[:, None]
    size, B, C, kc, n = data.shape
    if kc == ctx.k:
        m = ctx.decrypt_batch(stack.sk, Ciphertext(data.reshape(size, B * C, kc, n)))
        return ctx.decode_signed_batch(m)[:, 0].reshape(B, C).astype(np.int64)
    logits = np.empty((B, C), np.int64)
    for i in range(B):
        for c in range(C):
            dec = ctx.decode_signed(ctx.decrypt(stack.sk, Ciphertext(data[:, i, c])))
            logits[i, c] = int(dec[0])
    return logits


def _encrypt_samples(stack: HHEStack, samples: np.ndarray) -> Ciphertext:
    """BFV-encrypt each sample directly (no PASTA stage): [2, B, k, N]."""
    ctx = stack.ctx
    return Ciphertext(
        torch.stack([ctx.encrypt(stack.pk, ctx.encode(s)).data for s in samples], dim=1)
    )


def hhe_2fc_inference(
    stack: HHEStack,
    w1: np.ndarray,
    w2: np.ndarray,
    samples: np.ndarray,
    labels: Optional[np.ndarray] = None,
    via_transcipher: bool = True,
    check_parity: bool = True,
    row_chunk: Optional[int] = None,
    digit_chunk: Optional[int] = None,
    run: Optional[RunConfig] = None,
) -> Dict[str, np.ndarray]:
    """MNIST/FMNIST-style 784 -> R -> 10 encrypted inference with square
    activation (reference hhe_pktnn_2fc_inference, hhe_pktnn_examples.cpp:713-
    1010, with the fc2 half completed homomorphically).

    w1 [in_dim, R], w2 [R, 10]; samples [B, in_dim] small non-negative ints.
    With via_transcipher=False the inputs are BFV-encrypted directly.  With
    check_parity, raises unless the logits equal the plaintext network's
    mod t (signed)."""
    ctx = stack.ctx
    w1 = np.asarray(w1, np.int64)
    w2 = np.asarray(w2, np.int64)
    samples = np.atleast_2d(np.asarray(samples, np.int64))
    samples, labels = _apply_run(samples, labels, run)
    B = samples.shape[0]

    w1_cts = helin.encrypt_weight(ctx, stack.pk, w1.T)  # one ct per output row

    if via_transcipher:
        key = pasta.get_fixed_symmetric_key()
        sym = pasta.Pasta(key, ctx.t).encrypt(samples.astype(np.uint64))
        enc_key = stack.tc.encrypt_key(stack.pk, key)
        data_ct = csp_decompose(stack, enc_key, sym)
    else:
        data_ct = _encrypt_samples(stack, samples)

    _debug_noise(stack, data_ct, "decomposition+flatten", run)
    logits_ct = csp_eval_2fc(
        stack, data_ct, w1_cts, w2, row_chunk=row_chunk, digit_chunk=digit_chunk
    )
    _debug_noise(stack, logits_ct, "2FC eval", run)
    logits = decrypt_2fc_logits(stack, logits_ct)
    preds = logits.argmax(1)

    if check_parity:
        t = ctx.t
        v1 = (samples @ w1) % t
        expect = ((v1 * v1) % t @ w2) % t
        expect = np.where(expect > t // 2, expect - t, expect)
        if not np.array_equal(logits, expect):
            raise RuntimeError("2FC HHE output != plaintext mod-t output")
    out = {"logits": logits, "predictions": preds}
    if labels is not None:
        out["accuracy"] = float(np.mean(preds == np.asarray(labels).reshape(-1)[:B]))
    return out


# ---------------------------------------------------------------------------
# FashionMNIST multi-class FC: 784 -> 10 with bias
# ---------------------------------------------------------------------------


FMNIST_WEIGHT_CSV = os.path.join(
    loaders.REFERENCE_ROOT, "weights", "fashion_mnist", "fc1_weight_200epochs_bs64_clamp128.csv"
)
FMNIST_BIAS_CSV = os.path.join(
    loaders.REFERENCE_ROOT, "weights", "fashion_mnist", "fc1_bias_200epochs_bs64_clamp128.csv"
)


def _fc_multi(
    stack: HHEStack,
    dd: torch.Tensor,
    wstack: torch.Tensor,
    bias_pt: torch.Tensor,
    digit_chunk: Optional[int] = None,
) -> torch.Tensor:
    """One pass of a multi-class FC layer: the data [2, B, k, N] broadcast
    against C stacked class-weight rows [2, C, k, N], BEHZ multiply,
    relinearize, log-depth rotate-sum, plain bias add: [2, B, C, k, N]."""
    ctx = stack.ctx
    a = Ciphertext(dd[:, :, None])  # [2, B, 1, k, N]
    b = Ciphertext(wstack[:, None])  # [2, 1, C, k, N]
    prod = bfv_eval.relinearize(
        ctx, bfv_eval.multiply(ctx, a, b), stack.rk, digit_chunk=digit_chunk
    )
    sums = helin.encrypted_vec_sum_log(ctx, prod, stack.gks)  # [2, B, C, k, N]
    c0 = add_mod(sums.data[0], bias_pt[None], ctx.tb_q.q)
    return torch.cat([c0[None], sums.data[1:]], 0)


def csp_eval_fc_multi(
    stack: HHEStack,
    data_ct: Ciphertext,
    w_cts: List[Ciphertext],
    bias: np.ndarray,
    digit_chunk: Optional[int] = None,
) -> Ciphertext:
    """Encrypted multi-class FC: logit_c = <x, w_c> + b_c for each of the C
    encrypted class-weight rows (the reference's per-row mult + relin +
    rotate-sum loop, ``hhe_pktnn_examples.cpp:960-992``, in one batched
    pass).  Returns a class-batched ct [2, B, C, k, N]; logit c lives in
    every slot of class-ct c, bias already added."""
    ctx = stack.ctx
    dd = data_ct.data
    if dd.dim() == 3:
        dd = dd[:, None]
    bias = np.asarray(bias, np.int64).reshape(-1)
    bias_slots = np.tile(bias[:, None], (1, ctx.n))
    bias_pt = ctx.plain_for_add_batch(ctx.encode_batch(bias_slots))
    wstack = torch.stack([w.data for w in w_cts], dim=1)
    return Ciphertext(_fc_multi(stack, dd, wstack, bias_pt, digit_chunk))


def hhe_fmnist_1fc_inference(
    stack: HHEStack,
    samples: Optional[np.ndarray] = None,
    batch: int = 4,
    via_transcipher: bool = True,
    check_parity: bool = True,
    seed: int = 0,
    run: Optional[RunConfig] = None,
    weight_csv: str = FMNIST_WEIGHT_CSV,
    bias_csv: str = FMNIST_BIAS_CSV,
) -> Dict[str, object]:
    """The reference's ``fmnist`` dataset switch
    (``hhe_pktnn_examples.h:86-88``) on its FashionMNIST one-layer model: the
    784x10 weights + bias (``weight_csv``, ``bias_csv``) through PASTA
    encrypt -> transcipher (7 blocks, mask + flatten) -> encrypted per-class
    product + rotate-sum + bias -> analyst decrypt -> argmax.

    When ``samples`` is None, deterministic surrogate 2-bit-quantized inputs
    in [0, 4] stand in for the images, which the reference does not ship;
    the hard encrypted-vs-plaintext mod-t parity is the contract.  With
    ``via_transcipher=False`` the inputs are BFV-encrypted directly."""
    ctx = stack.ctx
    w = np.asarray(pocketnn.read_csv_matrix(weight_csv), np.int64)
    bias = np.asarray(pocketnn.read_csv_matrix(bias_csv), np.int64).reshape(-1)
    in_dim, C = w.shape
    if (in_dim, C) != (784, 10) or bias.shape != (10,):
        raise ValueError(f"FMNIST model must be 784 x 10 with 10 biases, got {w.shape}, {bias.shape}")
    if samples is None:
        samples = np.random.default_rng(seed).integers(0, 5, (batch, in_dim))
    samples = np.atleast_2d(np.asarray(samples, np.int64))
    samples, _ = _apply_run(samples, None, run)
    timer, ledger = metrics.Timer(), metrics.CommLedger()

    key = pasta.get_fixed_symmetric_key()
    cipher = pasta.Pasta(key, ctx.t)
    with timer.phase("user"):
        if via_transcipher:
            sym = cipher.encrypt(samples.astype(np.uint64))
            enc_key = stack.tc.encrypt_key(stack.pk, key)
            ledger.add(
                "user-csp",
                metrics.he_vec_size([enc_key]) + metrics.sym_enc_data_size(sym),
            )
        else:
            data_ct = _encrypt_samples(stack, samples)
            ledger.add("user-csp", metrics.he_vec_size(split_batch(data_ct)))
        ctx.synchronize()
    ledger.add("analyst-user", metrics.he_pk_size(stack.pk))
    with timer.phase("analyst"):
        w_cts = helin.encrypt_weight(ctx, stack.pk, w.T)  # one ct per class
        ctx.synchronize()
    ledger.add(
        "analyst-csp",
        metrics.he_key_size(stack.rk, stack.gks) + metrics.he_vec_size(w_cts),
    )
    with timer.phase("csp"):
        if via_transcipher:
            data_ct = csp_decompose(stack, enc_key, sym)
            _debug_noise(stack, data_ct, "decomposition+flatten", run)
        logits_ct = csp_eval_fc_multi(stack, data_ct, w_cts, bias)
        ctx.synchronize()
    _debug_noise(stack, logits_ct, "fmnist 1fc eval", run)
    with timer.phase("analyst"):
        logits = decrypt_2fc_logits(stack, logits_ct)
    preds = logits.argmax(1)

    if check_parity:
        t = ctx.t
        expect = (samples @ w + bias) % t
        expect = np.where(expect > t // 2, expect - t, expect)
        if not np.array_equal(logits, expect):
            raise RuntimeError(
                "FMNIST FC layer's plaintext results and HHE results are different"
            )
    report = metrics.experiment_report(timer, ledger)
    if run is not None and run.verbose:
        print(metrics.format_experiment_report(report), flush=True)
    return {"logits": logits, "predictions": preds, "report": report}


# ---------------------------------------------------------------------------
# Full-dataset ECG run
# ---------------------------------------------------------------------------


ECG_WEIGHT_CSV = os.path.join(
    loaders.REFERENCE_ROOT, "weights", "ecg", "ecg_512", "fc1_weight_50epochs_bz4.csv"
)


def hhe_ecg_full_inference(
    stack: HHEStack,
    weight_path: str = ECG_WEIGHT_CSV,
    batch: int = 512,
    eval_batch: int = 64,
    seed: int = 0,
    run: Optional[RunConfig] = None,
    labels_root: str = loaders.MITBIH_ROOT,
) -> Dict[str, object]:
    """The reference's full-dataset ECG benchmark
    (``hhe_pktnn_ecg_inference``, ``hhe_pktnn_examples.cpp:63-383``): the
    13,245 MIT-BIH test samples through transcipher + encrypted weight
    product + analyst decrypt, with the agreement and the per-party and
    per-edge costs.

    The reference's input matrix ``mitbih_x_test_int.csv`` is not shipped,
    only its labels: the run sizes itself from the label file under
    ``labels_root`` and draws surrogate rows in [0, 64) from ``seed`` (the
    ecg_512 weights reach |w| = 508, so every slot product stays inside
    +/- t/2).  ``agreement`` (encrypted against plaintext predictions) is
    exact; ``label_accuracy`` is reported but not meaningful.

    Every sample shares the fixed nonce, so the CSP evaluates one keystream
    and reuses it for every chunk of ``batch`` samples (``Transcipher``
    caches it by key ciphertext and nonce).  The sample count is padded to a
    multiple of ``batch`` with repeated rows, discarded after; each chunk's
    product runs in ``eval_batch`` slices and is decrypted in one batch."""
    ctx = stack.ctx
    w = np.asarray(pocketnn.read_csv_matrix(weight_path), np.int64).reshape(-1)
    if w.shape != (transcipher.T,):
        raise ValueError(f"ECG weights must have {transcipher.T} words, got {w.shape}")

    labels = loaders.load_mitbih_labels("test", root=labels_root)
    n = run.sample_limit(len(labels)) if run is not None else len(labels)
    labels = labels[:n] * 128  # reference scales binary labels to {0, 128}
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 64, (n, transcipher.T)).astype(np.uint64)

    timer, ledger = metrics.Timer(), metrics.CommLedger()
    key = pasta.get_fixed_symmetric_key()
    cipher = pasta.Pasta(key, ctx.t)
    with timer.phase("user"):
        sym = cipher.encrypt(x)
        enc_key = stack.tc.encrypt_key(stack.pk, key)
        ctx.synchronize()
    ledger.add("analyst-user", metrics.he_pk_size(stack.pk))
    ledger.add(
        "user-csp", metrics.he_vec_size([enc_key]) + metrics.sym_enc_data_size(sym)
    )
    with timer.phase("analyst"):
        weight_ct = helin.encrypt_weight(ctx, stack.pk, w[None, :])[0]
        ctx.synchronize()
    ledger.add(
        "analyst-csp",
        metrics.he_key_size(stack.rk, stack.gks) + metrics.he_vec_size([weight_ct]),
    )

    pad = (-n) % batch
    sym_p = np.concatenate([sym, sym[:pad]], axis=0) if pad else sym
    eval_batch = min(eval_batch, batch)
    preds = []
    result_mb = 0.0
    for s in range(0, len(sym_p), batch):
        chunk = sym_p[s : s + batch]
        with timer.phase("csp"):
            data_ct = csp_decompose(stack, enc_key, chunk)
            dd = data_ct.data
            wct = Ciphertext(weight_ct.data[:, None] if dd.dim() == 4 else weight_ct.data)
            # the product runs in eval_batch slices: the BEHZ and key-switch
            # temporaries grow with the batch
            prods = [
                csp_eval_1fc(stack, Ciphertext(dd[:, e : e + eval_batch]), wct, do_sum=False)
                for e in range(0, chunk.shape[0], eval_batch)
            ]
            ctx.synchronize()
        # result size metered per sample frame from the shapes
        result_mb += sum(metrics.he_vec_size_analytic(p) for p in prods)
        with timer.phase("analyst"):
            merged = Ciphertext(torch.cat([p.data for p in prods], dim=1))
            preds.extend(analyst_decrypt_sum_sigmoid(stack, merged, transcipher.T))
    # meter only the n real samples (padded rows never cross the wire)
    ledger.add("analyst-csp", result_mb * (n / len(sym_p)))
    preds = np.asarray(preds)[:n]

    sums = (x.astype(np.int64) * w).sum(1)
    expect = np.where(pocketnn.simple_pocket_sigmoid(sums).numpy() > 64, 128, 0)
    agreement = float(np.mean(preds == expect))
    report = metrics.experiment_report(
        timer,
        ledger,
        accuracy=agreement,
        extra={
            "samples": n,
            "label_accuracy": float(np.mean(preds == labels)),
            "label_accuracy_note": (
                "surrogate inputs (mitbih_x_test_int.csv not shipped) — "
                "label_accuracy is not meaningful; 'accuracy' is the "
                "encrypted-vs-plaintext agreement"
            ),
        },
    )
    if run is not None and run.verbose:
        print(metrics.format_experiment_report(report), flush=True)
    return {"predictions": preds, "agreement": agreement, "report": report}
