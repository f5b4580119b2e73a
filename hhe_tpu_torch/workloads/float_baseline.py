"""Float baseline models + float/integer/encrypted accuracy parity report —
counterpart of ``hhe_tpu.workloads.float_baseline``.

Equivalent of the reference's float notebooks (``notebooks/SpO2.ipynb``,
``notebooks/float_mitbih.ipynb``, ``notebooks/mnist_hhe_plain.ipynb``): the
float accuracies anchor the integer (PocketNN/QAT) and encrypted pipelines,
reported side by side the way the reference prints encrypted-vs-plaintext
accuracy (``hhe_pktnn_examples.cpp:338-361``).

Models (torch, ``torch.optim.Adam`` with optax's defaults):
- SpO2: logistic regression 300 -> 1 on the SIESTA recording-wise dataset
  (``data/Harpocrates_recordingwise_SIESTA_4percent`` under the reference
  root), its loss written so that its gradient at a zero logit is the JAX
  package's (max(l, 0) splits the tie, |l| takes the l >= 0 side);
- MNIST: float 2FC 784 -> R -> square -> 10 (same architecture the QAT
  2-bit model quantizes, ``qat/src/mnist.py``), its initial weights drawn
  from a ``torch.Generator`` (ROADMAP F16).

The integer columns are exact integer products on the device; the encrypted
column runs ``hhe_1fc_inference`` with its hard parity check.  Every
function takes ``device``: ``None`` means CUDA and raises without a card.
The reference's files are read under ``loaders.REFERENCE_ROOT`` unless the
caller passes other paths.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import loaders, pocketnn
from ..ops import bfv
from . import hhe_inference as hi

SIESTA_ROOT = os.path.join(
    loaders.REFERENCE_ROOT, "data", "Harpocrates_recordingwise_SIESTA_4percent"
)
MNIST_ROOT = os.path.join(loaders.REFERENCE_ROOT, "data", "mnist", "MNIST", "raw")
# the shipped quantized models, relative to the reference root
SPO2_WEIGHTS = os.path.join("weights", "SpO2", "qat", "quant_fc_5bits_data_2bits_weights.csv")
MNIST_FC1_WEIGHTS, MNIST_FC2_WEIGHTS = (
    os.path.join("weights", "mnist", "qat", f"quant_2fc_2bits_mnist_plain_2bits_weights_fc{i}.csv")
    for i in (1, 2)
)


def load_siesta(
    root: str = SIESTA_ROOT, limit_patients: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """All patients' recording rows: x [n, 300] float, y [n] in {0,1}
    (reference data layout: <patient>_data.txt + <patient>_binaryoutput.txt)."""
    xs, ys = [], []
    files = sorted(glob.glob(os.path.join(root, "*_data.txt")))
    if not files:
        raise FileNotFoundError(os.path.join(root, "*_data.txt"))
    if limit_patients is not None:
        files = files[:limit_patients]
    for f in files:
        x = np.loadtxt(f, delimiter=",", ndmin=2)
        y = np.loadtxt(f.replace("_data.txt", "_binaryoutput.txt"), ndmin=1)
        n = min(len(x), len(y))
        xs.append(x[:n])
        ys.append(y[:n])
    return np.concatenate(xs), np.concatenate(ys).astype(np.int64)


def _split(x, y, test_frac=0.2, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    n_test = int(len(x) * test_frac)
    te, tr = idx[:n_test], idx[n_test:]
    return x[tr], y[tr], x[te], y[te]


@dataclasses.dataclass
class FloatResult:
    train_acc: float
    test_acc: float
    params: tuple  # float32 tensors on the training device


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def train_float_spo2(
    limit_patients: Optional[int] = 40,
    epochs: int = 400,
    lr: float = 0.02,
    seed: int = 0,
    root: str = SIESTA_ROOT,
    device=None,
) -> FloatResult:
    """Float logistic regression on SIESTA SpO2 (reference SpO2.ipynb):
    full-batch Adam steps from zero weights."""
    dev = bfv.resolve_device(device)
    x, y = load_siesta(root, limit_patients=limit_patients)
    # standardize like the notebook pipelines do for float training
    mu, sd = x.mean(0), x.std(0) + 1e-6
    xs = (x - mu) / sd
    xtr, ytr, xte, yte = _split(xs, y, seed=seed)
    w = torch.zeros(xtr.shape[1], dtype=torch.float32, device=dev, requires_grad=True)
    b = torch.zeros((), dtype=torch.float32, device=dev, requires_grad=True)
    xtr_t, ytr_t = _f32(xtr, dev), _f32(ytr, dev)
    opt = torch.optim.Adam([w, b], lr=lr)
    for _ in range(epochs):
        opt.zero_grad()
        logits = xtr_t @ w + b
        # max(l, 0) and where(l >= 0, l, -l): the JAX package's gradients at
        # l = 0 (0.5 and 1), which the first step from zero weights meets
        abs_l = torch.where(logits >= 0, logits, -logits)
        loss = torch.mean(
            torch.maximum(logits, torch.zeros_like(logits))
            - logits * ytr_t
            + torch.log1p(torch.exp(-abs_l))
        )
        loss.backward()
        opt.step()
    params = (w.detach(), b.detach())

    def acc(xa, ya):
        with torch.no_grad():
            preds = (_f32(xa, dev) @ params[0] + params[1] > 0).cpu().numpy()
        return float(np.mean(preds == (ya > 0)))

    return FloatResult(acc(xtr, ytr), acc(xte, yte), params)


def init_float_mnist_2fc(hidden: int = 128, seed: int = 0, device=None) -> tuple:
    """(w1, b1, w2, b2): normal weights x 0.05 from a CPU ``torch.Generator``
    seeded with `seed` (so every device starts from the same draw), zero
    biases, on `device`."""
    dev = bfv.resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    w1 = torch.randn((784, hidden), generator=gen) * 0.05
    w2 = torch.randn((hidden, 10), generator=gen) * 0.05
    return tuple(t.to(dev) for t in (w1, torch.zeros(hidden), w2, torch.zeros(10)))


def _logits(p, xb):
    w1, b1, w2, b2 = p
    h = xb @ w1 + b1
    return (h * h) @ w2 + b2


def fit_float_mnist_2fc(
    params: tuple,
    epochs: int = 3,
    batch: int = 128,
    lr: float = 1e-3,
    train_limit: Optional[int] = 8000,
    seed: int = 0,
    root: str = MNIST_ROOT,
) -> FloatResult:
    """Adam from `params` (four float32 tensors, on the device to train on)
    over the MNIST test split's head, evaluated on its last 2,000 images
    (the JAX package's documented subset), batches in its numpy order."""
    dev = params[0].device
    x_all, y_all = loaders.load_mnist_test(root, limit=None, quantize=False)
    x_all = x_all.astype(np.float32) / 255.0
    n_train = min(train_limit or len(x_all) - 2000, len(x_all) - 2000)
    xtr, ytr = _f32(x_all[:n_train], dev), torch.as_tensor(y_all[:n_train], device=dev)
    xte, yte = _f32(x_all[-2000:], dev), torch.as_tensor(y_all[-2000:], device=dev)

    p = tuple(t.detach().clone().requires_grad_(True) for t in params)
    opt = torch.optim.Adam(p, lr=lr)
    nrng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = torch.as_tensor(nrng.permutation(n_train), device=dev)
        for i in range(0, n_train - batch + 1, batch):
            sel = order[i : i + batch]
            opt.zero_grad()
            logp = torch.log_softmax(_logits(p, xtr[sel]), dim=-1)
            loss = -logp.gather(1, ytr[sel][:, None]).mean()
            loss.backward()
            opt.step()
    p = tuple(t.detach() for t in p)

    def acc(xa, ya):
        with torch.no_grad():
            return float((_logits(p, xa).argmax(1) == ya).double().mean())

    return FloatResult(acc(xtr, ytr), acc(xte, yte), p)


def train_float_mnist_2fc(
    hidden: int = 128,
    epochs: int = 3,
    batch: int = 128,
    lr: float = 1e-3,
    train_limit: Optional[int] = 8000,
    seed: int = 0,
    root: str = MNIST_ROOT,
    device=None,
) -> FloatResult:
    """Float 784 -> hidden -> square -> 10 (the QAT model's float twin,
    reference qat/src/mnist.py SquareAct architecture)."""
    params = init_float_mnist_2fc(hidden, seed, device)
    return fit_float_mnist_2fc(params, epochs, batch, lr, train_limit, seed, root)


# ---------------------------------------------------------------------------
# Side-by-side accuracy parity report (reference hhe_pktnn_examples.cpp:338-361)
# ---------------------------------------------------------------------------


def _exact_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for integer-valued float64 tensors: exact, since every partial
    sum stays below 2^53 (checked; raises otherwise)."""
    bound = float(a.abs().max()) * float(b.abs().max()) * a.shape[-1]
    if bound >= 2.0**53:
        raise ValueError(f"integer product may exceed 2^53 (bound {bound:.3g})")
    return a @ b


def _int_values(a, dev) -> torch.Tensor:
    """An integer array as a float64 tensor on `dev` (for ``_exact_product``)."""
    return torch.as_tensor(np.asarray(a, np.int64), dtype=torch.float64, device=dev)


def spo2_integer_accuracy(
    limit_patients: Optional[int] = 40,
    weight_csv: str = os.path.join(loaders.REFERENCE_ROOT, SPO2_WEIGHTS),
    root: str = SIESTA_ROOT,
    device=None,
) -> float:
    """Shipped quantized 1FC model (config.cpp:66 default weights) evaluated
    with pure integer math on the SIESTA rows — the same computation the
    encrypted pipeline performs under HE: int_sigmoid(x @ w) against y."""
    dev = bfv.resolve_device(device)
    w = pocketnn.read_csv_matrix(weight_csv).reshape(-1, 1)
    x, y = load_siesta(root, limit_patients=limit_patients)
    raw = _exact_product(_int_values(x.astype(np.int64), dev), _int_values(w, dev))
    preds = pocketnn.int_sigmoid(raw[:, 0]).cpu().numpy()
    return float(np.mean(preds == y))


def mnist_integer_accuracy(
    limit: int = 2000,
    fc1_csv: str = os.path.join(loaders.REFERENCE_ROOT, MNIST_FC1_WEIGHTS),
    fc2_csv: str = os.path.join(loaders.REFERENCE_ROOT, MNIST_FC2_WEIGHTS),
    root: str = MNIST_ROOT,
    device=None,
) -> float:
    """Shipped 2-bit QAT 2FC model, integer math: argmax((x @ w1)^2 @ w2)
    (the encrypted 2FC computes this bit-exactly mod t)."""
    dev = bfv.resolve_device(device)
    w1 = _int_values(pocketnn.read_csv_matrix(fc1_csv), dev)
    w2 = _int_values(pocketnn.read_csv_matrix(fc2_csv), dev)
    x, y = loaders.load_mnist_test(root, limit=limit)
    v1 = _exact_product(_int_values(x, dev), w1)
    logits = _exact_product(v1 * v1, w2)
    return float(np.mean(logits.argmax(1).cpu().numpy() == y))


def accuracy_parity_report(
    limit_patients: Optional[int] = 40,
    mnist_limit: int = 2000,
    encrypted_samples: int = 2,
    stack=None,
    reference_root: str = loaders.REFERENCE_ROOT,
    device=None,
) -> Dict[str, Dict[str, float]]:
    """Float vs integer vs encrypted, side by side, from the reference's
    layout under `reference_root`.

    The encrypted column runs `encrypted_samples` real samples through the
    full HHE pipeline (N=1024, 13 limbs) with the hard parity check (raises
    on any mismatch with the integer path) — establishing that encrypted
    accuracy == integer accuracy, then reports the integer accuracy for it,
    exactly as the reference equates them after its parity check
    (``hhe_pktnn_examples.cpp:692-699``)."""
    dev = bfv.resolve_device(device)
    siesta = os.path.join(reference_root, "data", "Harpocrates_recordingwise_SIESTA_4percent")
    mnist = os.path.join(reference_root, "data", "mnist", "MNIST", "raw")
    spo2_csv = os.path.join(reference_root, SPO2_WEIGHTS)
    report: Dict[str, Dict[str, float]] = {}

    f_spo2 = train_float_spo2(limit_patients=limit_patients, root=siesta, device=dev)
    i_spo2 = spo2_integer_accuracy(limit_patients, spo2_csv, siesta, dev)
    report["spo2_1fc"] = {
        "float": f_spo2.test_acc,
        "integer": i_spo2,
        "encrypted": i_spo2,  # == integer, by parity (checked below)
    }

    f_mnist = train_float_mnist_2fc(root=mnist, device=dev)
    i_mnist = mnist_integer_accuracy(
        mnist_limit,
        os.path.join(reference_root, MNIST_FC1_WEIGHTS),
        os.path.join(reference_root, MNIST_FC2_WEIGHTS),
        mnist,
        dev,
    )
    report["mnist_2fc"] = {
        "float": f_mnist.test_acc,
        "integer": i_mnist,
        "encrypted": i_mnist,
    }

    if encrypted_samples:
        stack = stack or hi.build_stack(
            bfv.BFVParams(n=1024, data_limbs=13, seed=42), input_len=300, device=dev
        )
        w = pocketnn.read_csv_matrix(spo2_csv).reshape(-1)
        x, _ = load_siesta(siesta, limit_patients=2)
        hi.hhe_1fc_inference(
            stack,
            w,
            x[:encrypted_samples].astype(np.uint64),
            check_parity=True,  # raises if encrypted != integer
        )
        report["spo2_1fc"]["encrypted_parity_checked_samples"] = float(
            encrypted_samples
        )
    return report
