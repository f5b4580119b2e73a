"""Pure-HE encrypted HCNN MNIST inference — the reference speedtest workload;
counterpart of ``hhe_tpu.workloads.he_conv``.

Equivalent of ``qat/src/speedtest_he_mnist_works.py`` (Pyfhel, BFV n=16384,
t_bits=47): a QAT-trained quantized HCNN

    conv(1->5, 5x5, s2) -> square -> conv(5->50, 5x5, s2)
    -> flatten -> square -> fc(800->10)

is evaluated on encrypted MNIST images with the rotation-conv kernels of
``hhe_tpu_torch.ops.heconv``, and must match the plaintext integer model's
logits EXACTLY (the reference's acc vs acc_he comparison,
``speedtest:470-520`` — here a hard parity throw like
``hhe_pktnn_examples.cpp:692-699``).  The report times the parts apart: QAT,
keygen, plaintext preparation, and per image the host encryption, the
device evaluation and the decrypt + decode; and gives the noise budget
after each stage.

The CSP's path is ``prepare_hcnn`` once (the analyst's model as conv and FC
plaintexts on the device), then ``csp_eval_hcnn`` an uploaded image: one
BFV ciphertext [2, 1, k, N], the image row-major in slots [0, H W), to the
class-batched logits [2, classes, k, N].  ``hcnn_stages`` is its one
composition of the layers, which the demo steps through stage by stage.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import loaders
from ..ops import bfv, heconv, primes
from ..ops.bfv import Ciphertext, Context
from ..utils import trace

STAGES = ("fresh", "conv1", "square1", "conv2", "square2", "fc")
STRIDE = 2  # both convs' (speedtest_he_mnist_works.py:277-357)


class HCNNModel(NamedTuple):
    """The analyst's HCNN as the CSP holds it, on the context's device."""

    spec1: heconv.ConvSpec
    spec2: heconv.ConvSpec
    pts1: torch.Tensor  # [taps, 1, C1, k, N] NTT + Montgomery
    pts2: torch.Tensor  # [taps, C1, C2, k, N]
    fc_pts: torch.Tensor  # [classes, C2, k, N]
    img_w: int


def hcnn_specs(k1: np.ndarray, k2: np.ndarray, img: int = 28) -> Tuple[heconv.ConvSpec, heconv.ConvSpec]:
    """The two conv layers on an img x img image's slot grid: conv 1 on the
    image, conv 2 on conv 1's output, which stays on the image's grid
    dilated by the stride."""
    spec1 = heconv.ConvSpec(k1, (1, img, img), STRIDE, 1)
    return spec1, heconv.ConvSpec(k2, heconv.conv_out_shape(spec1), STRIDE, STRIDE)


def prepare_hcnn(ctx: Context, k1: np.ndarray, k2: np.ndarray, fc: np.ndarray,
                 img: int = 28) -> HCNNModel:
    """Integer weights k1 [C1, 1, 5, 5], k2 [C2, C1, 5, 5] and fc [classes,
    C2 * oh * ow] (the flatten channel-major) -> the model's plaintexts."""
    spec1, spec2 = hcnn_specs(k1, k2, img)
    return HCNNModel(spec1, spec2, heconv.conv_plaintexts(ctx, spec1, img),
                     heconv.conv_plaintexts(ctx, spec2, img),
                     heconv.fc_plaintexts(ctx, fc, spec2, img), img)


def hcnn_stages(stack, ct: Ciphertext, model: HCNNModel) -> Iterator[Tuple[str, Ciphertext]]:
    """(stage, its output) for STAGES[1:] in order, from the encrypted image
    ``ct`` [2, 1, k, N]: the convs' channels batched [2, C, k, N], and last
    the FC's classes [2, classes, k, N] after the rotate-sum, every slot of
    row 0 holding that class's logit.  ``stack`` gives the context and the
    relinearisation and Galois keys."""
    ctx, w = stack.ctx, model.img_w
    a = heconv.he_conv2d(ctx, ct, model.spec1, model.pts1, stack.gks, w, "conv1")
    yield "conv1", a
    a = heconv.he_square(ctx, a, stack.rk)
    yield "square1", a
    a = heconv.he_conv2d(ctx, a, model.spec2, model.pts2, stack.gks, w, "conv2")
    yield "conv2", a
    a = heconv.he_square(ctx, a, stack.rk)
    yield "square2", a
    yield "fc", heconv.he_fc_from_conv(ctx, a, model.fc_pts, stack.gks)


def csp_eval_hcnn(stack, ct: Ciphertext, model: HCNNModel) -> Ciphertext:
    """The CSP's evaluation of one uploaded image: ``ct`` [2, 1, k, N] on
    the device -> the class-batched logits [2, classes, k, N]."""
    with trace.span("hhe.csp_eval_hcnn"):
        for _, out in hcnn_stages(stack, ct, model):
            pass
        return out


def conv_plain_t(n: int = 16384, bits: int = 47) -> int:
    """An NTT-friendly plaintext prime of ~`bits` bits (reference t_bits=47,
    ``speedtest_he_mnist_works.py:396``)."""
    m = 2 * n
    t = ((1 << bits) - 1) // m * m + 1
    while not primes.is_prime(t):
        t -= m
    return t


@dataclasses.dataclass
class HEConvReport:
    n_images: int
    int_acc: float  # plaintext integer model accuracy on the batch
    he_matches_int: bool  # encrypted logits == integer logits (hard check)
    per_image_s: float  # encrypt + device evaluation + decrypt/decode
    noise_left: int
    galois_keys: int = 0
    qat_s: float = 0.0  # 0 when the caller passes the weights
    keygen_s: float = 0.0  # secret and public key (host), evaluation keys (device)
    prep_s: float = 0.0  # the conv and FC plaintexts
    encrypt_s: float = 0.0  # per image, host encode + encrypt
    eval_s: float = 0.0  # per image, device, conv1 ... FC and rotate-sum
    decrypt_s: float = 0.0  # per image, batched decrypt of the classes + decode
    # least noise budget over the images after each stage, of channel (or
    # class) 0 of its output
    stage_budgets: Dict[str, int] = dataclasses.field(default_factory=dict)


def he_mnist_conv_inference(
    n_images: int = 2,
    train_subset: int = 3000,
    epochs: int = 2,
    n: int = 16384,
    data_limbs: int = 13,
    seed: int = 0,
    qat: Optional["object"] = None,
    verbose: bool = True,
    device=None,
    mnist_root: Optional[str] = None,
) -> HEConvReport:
    """``device=None`` runs on CUDA and raises without a card; `mnist_root`
    is the directory of the MNIST test split's idx files (default: under
    ``loaders.REFERENCE_ROOT``)."""
    from . import qat as qat_mod
    from .hhe_inference import HHEStack

    root = {} if mnist_root is None else {"root": mnist_root}
    x_all, y_all = loaders.load_mnist_test(limit=train_subset + 200, **root)
    # reference input scaling: int(pixel/255 * 3), levels 0..3 (speedtest:12)
    x_img = (x_all.reshape(-1, 1, 28, 28) * 3 + 2) // 4  # from 0..4 to 0..3
    xtr, ytr = x_img[:train_subset], y_all[:train_subset]
    xte, yte = x_img[train_subset : train_subset + 200], y_all[train_subset:][:200]

    ctx = bfv.Context(
        bfv.BFVParams(n=n, t=conv_plain_t(n), data_limbs=data_limbs, seed=seed), device=device
    )
    qat_s = 0.0
    if qat is None:
        t0 = time.perf_counter()
        qat = qat_mod.train_quant_hcnn(
            xtr, ytr, xte, yte, epochs=epochs, seed=seed, device=ctx.device
        )
        ctx.synchronize()
        qat_s = time.perf_counter() - t0
    if verbose:
        print(
            f"[QAT] HCNN float acc {qat.float_acc:.3f}  int acc {qat.int_acc:.3f}"
        )

    t0 = time.perf_counter()
    sk = ctx.keygen_secret()
    pk = ctx.keygen_public(sk)
    elts = heconv.conv_galois_elts(ctx, hcnn_specs(qat.k1_int, qat.k2_int), 28)
    rk, gks = ctx.keygen_eval_keys_device(sk, elts, include_relin=True, seed=seed)
    stack = HHEStack(ctx, sk, pk, rk, gks, None)
    ctx.synchronize()
    keygen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = prepare_hcnn(ctx, qat.k1_int, qat.k2_int, qat.fc_int)
    ctx.synchronize()
    prep_s = time.perf_counter() - t0

    sel = xte[:n_images].astype(np.int64)
    labels = yte[:n_images]
    want_logits = np.stack(
        [heconv.hcnn_forward_int(img, qat.k1_int, qat.k2_int, qat.fc_int) for img in sel]
    )

    got = np.zeros_like(want_logits)
    budgets = {}
    spent = dict.fromkeys(("encrypt", "eval", "decrypt"), 0.0)
    for i, img in enumerate(sel):
        t0 = time.perf_counter()
        ct = ctx.encrypt(pk, ctx.encode(img.reshape(-1)))
        ct = Ciphertext(ct.data[:, None])  # [size, Ci=1, k, N]
        ctx.synchronize()
        t1 = time.perf_counter()
        outs = dict(hcnn_stages(stack, ct, model))
        logits_ct = outs["fc"]
        ctx.synchronize()
        t2 = time.perf_counter()
        m = ctx.decrypt_batch(sk, logits_ct)  # [classes, N] mod t
        got[i] = ctx.decode_signed_batch(m)[:, 0]
        t3 = time.perf_counter()
        spent["encrypt"] += t1 - t0
        spent["eval"] += t2 - t1
        spent["decrypt"] += t3 - t2
        outs["fresh"] = ct
        for stage in STAGES:
            bits = ctx.noise_budget(sk, Ciphertext(outs[stage].data[:, 0]))
            budgets[stage] = min(budgets.get(stage, bits), bits)
    per_image = sum(spent.values()) / n_images
    noise_left = budgets["fc"]

    he_ok = bool(np.array_equal(got, want_logits))
    if not he_ok:
        raise AssertionError(
            f"encrypted HCNN logits diverge from the integer model:\n{got}\nvs\n{want_logits}"
        )
    int_acc = float(np.mean(want_logits.argmax(1) == labels))
    if verbose:
        print(
            f"[HE] {n_images} images, exact logit parity, "
            f"{per_image:.1f}s/image, min noise left {noise_left} bits, "
            f"batch int acc {int_acc:.2f}; noise budget by stage {budgets}"
        )
    return HEConvReport(
        n_images, int_acc, he_ok, per_image, noise_left,
        galois_keys=len(gks), qat_s=qat_s, keygen_s=keygen_s, prep_s=prep_s,
        encrypt_s=spent["encrypt"] / n_images, eval_s=spent["eval"] / n_images,
        decrypt_s=spent["decrypt"] / n_images, stage_budgets=budgets,
    )
