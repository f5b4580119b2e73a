"""Quantization-aware training producing HHE-ready integer weights —
counterpart of ``hhe_tpu.workloads.qat``.

Equivalent of the reference's brevitas QAT subsystem (``qat/src/mnist.py``,
``qat/notebooks/*_fc_train.ipynb``, ``mnist_conv_train.ipynb``,
``SpO2_qat.ipynb``): trains low-bit symmetric weight fake-quantization
(straight-through estimator) with a **square** activation (``SquareAct``,
reference qat/src/mnist.py:27-32), then exports integer weight CSVs consumed
by the encrypted pipelines — the format of ``weights/mnist/qat/*.csv``.

Inputs are quantized to 2 bits as in the reference
(``qat/src/export_weights_mnist_py.py:47``: int(x*4)).

The JAX package's trainers already run torch on the CPU; these are the same
models, draws and steps (``torch.manual_seed``, the CPU ``randperm`` order),
so on the CPU they give its weights and accuracies bit for bit.  Each
trainer takes ``device``: ``None`` means CUDA and raises without a card
(``bfv.resolve_device``).  Initial weights are drawn on the CPU and the
batch order stays on the CPU, so a CUDA run starts where a CPU run does;
its cuDNN arithmetic makes the trained weights differ.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..models import pocketnn
from ..ops import bfv, heconv


def _quantize_int(w: torch.Tensor, bits: int):
    """Integer weights + positive scalar scale for a float tensor.

    2-bit uses TWN-style threshold ternarization (delta = 0.7 mean|w|,
    alpha = mean |w| over the survivors) — a max-based scale at ternary
    levels zeroes ~95% of a Gaussian-init weight tensor and caps the
    trained model near chance.  Higher bit widths use symmetric
    max-scaled rounding (the reference's brevitas Int8/4 behavior)."""
    if bits == 2:
        delta = 0.7 * w.abs().mean()
        mask = (w.abs() > delta).to(w.dtype)
        w_int = torch.sign(w) * mask
        alpha = (w.abs() * mask).sum() / mask.sum().clamp(min=1)
        return w_int, alpha.clamp(min=1e-8)
    qmax = 2 ** (bits - 1) - 1
    alpha = w.abs().max().clamp(min=1e-8) / qmax
    return torch.clamp(torch.round(w / alpha), -qmax, qmax), alpha


class _FakeQuant(torch.autograd.Function):
    """Symmetric per-tensor weight quantizer with STE backward."""

    @staticmethod
    def forward(ctx, w, bits):
        w_int, alpha = _quantize_int(w, bits)
        return w_int * alpha

    @staticmethod
    def backward(ctx, g):
        return g, None


def _int_weight(weight: torch.Tensor, bits: int) -> np.ndarray:
    with torch.no_grad():
        return _quantize_int(weight, bits)[0].cpu().numpy().astype(np.int64)


class QuantLinear(nn.Module):
    def __init__(self, in_f, out_f, bits=2):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(in_f, out_f) / in_f**0.5)
        self.bits = bits

    def forward(self, x):
        return x @ _FakeQuant.apply(self.weight, self.bits)

    def int_weight(self) -> np.ndarray:
        return _int_weight(self.weight, self.bits)


class Quant2FCSquare(nn.Module):
    """784 -> hidden -> square -> 10 (reference quant_2fc_* models).

    Training inserts *scalar* activation/logit normalizations — positive
    per-tensor scalars leave the integer forward's argmax unchanged
    (argmax((a v)^2 @ W2 * b) = argmax(v^2 @ W2)), so the deployed
    integer model is exactly the quantized weights with no scales."""

    def __init__(self, in_dim=784, hidden=128, n_classes=10, bits=2):
        super().__init__()
        self.fc1 = QuantLinear(in_dim, hidden, bits)
        self.fc2 = QuantLinear(hidden, n_classes, bits)

    def forward(self, x):
        h = self.fc1(x)
        h = h / h.detach().pow(2).mean().sqrt().clamp(min=1e-8)
        out = self.fc2(h * h)  # SquareAct
        return out / out.detach().std().clamp(min=1e-8)


class QuantSpO2FC(nn.Module):
    """300 -> 1 bias-free quantized FC + sigmoid — the reference's
    SpO2OneFCQuantModel (``notebooks/SpO2_qat.ipynb``: brevitas
    QuantLinear(300, 1, bias=False, weight_bit_width=2..4) trained with
    BCE).  The deployed artifact is the bare integer weight column
    (``weights/SpO2/qat/quant_fc_5bits_data_{2,3,4}bits_weights.csv``,
    the default model per ``configs/config.cpp:66``): a positive scalar
    weight scale leaves sign(x @ w) — hence the int_sigmoid
    prediction — unchanged, so no scale ships."""

    def __init__(self, in_dim=300, bits=2):
        super().__init__()
        self.fc1 = QuantLinear(in_dim, 1, bits)

    def forward(self, x):
        return torch.sigmoid(self.fc1(x))

    def logits(self, x):
        return self.fc1(x)


class QuantConv2d(nn.Module):
    """Stride-2, no-padding, bias-free quantized conv (reference
    ``qat/notebooks/mnist_conv_train.ipynb`` QuantConv2d settings)."""

    def __init__(self, in_ch, out_ch, ksize=5, stride=2, bits=2):
        super().__init__()
        fan_in = in_ch * ksize * ksize
        self.weight = nn.Parameter(
            torch.randn(out_ch, in_ch, ksize, ksize) / fan_in**0.5
        )
        self.stride = stride
        self.bits = bits

    def forward(self, x):
        w = _FakeQuant.apply(self.weight, self.bits)
        return torch.nn.functional.conv2d(x, w, stride=self.stride)

    def int_weight(self) -> np.ndarray:
        return _int_weight(self.weight, self.bits)


class QuantHCNN(nn.Module):
    """conv(1->c1,5,s2) -> square -> conv(c1->c2,5,s2) -> flatten ->
    square -> fc (the reference MNISTConvQuantModel,
    ``qat/notebooks/mnist_conv_train.ipynb``).  Scalar activation
    normalizations as in Quant2FCSquare (argmax-invariant)."""

    def __init__(self, c1=5, c2=50, n_classes=10, bits=2, img=28):
        super().__init__()
        self.conv1 = QuantConv2d(1, c1, 5, 2, bits)
        self.conv2 = QuantConv2d(c1, c2, 5, 2, bits)
        o1 = (img - 5) // 2 + 1
        o2 = (o1 - 5) // 2 + 1
        self.fc1 = QuantLinear(c2 * o2 * o2, n_classes, bits)

    def _norm(self, v):
        return v / v.detach().pow(2).mean().sqrt().clamp(min=1e-8)

    def forward(self, x):
        out = self._norm(self.conv1(x))
        out = out * out
        out = self._norm(self.conv2(out))
        out = out.reshape(out.shape[0], -1)
        out = out * out
        out = self.fc1(out)
        return out / out.detach().std().clamp(min=1e-8)


def _fit(model, lossf, forward, xt, yt, epochs, lr, batch):
    """Adam over `epochs` passes in CPU ``randperm`` order (the JAX
    package's loop): forward(xb) -> loss against yb."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    n = len(xt)
    for _ in range(epochs):
        perm = torch.randperm(n)
        for i in range(0, n, batch):
            sel = perm[i : i + batch]
            opt.zero_grad()
            loss = lossf(forward(xt[sel]), yt[sel])
            loss.backward()
            opt.step()


@dataclasses.dataclass
class QATSpO2Result:
    w_int: np.ndarray  # [in_dim] integer weight column
    float_acc: float
    int_acc: float


def train_quant_spo2_1fc(
    x: np.ndarray,
    y: np.ndarray,
    x_test: np.ndarray,
    y_test: np.ndarray,
    weight_bits: int = 2,
    epochs: int = 60,
    lr: float = 1e-3,
    batch: int = 64,
    seed: int = 0,
    export_path: Optional[str] = None,
    device=None,
) -> QATSpO2Result:
    """SpO2 QAT (reference ``notebooks/SpO2_qat.ipynb``): 5-bit SpO2 rows
    (values in [0, 31]) -> 300 -> 1 with `weight_bits`-bit STE fake-quant
    weights, BCE loss, Adam.

    Inputs are scaled by the positive scalar 1/31 for optimization only —
    scalar input/weight scales cannot flip sign(x @ w), so the integer
    deployment (x_int @ w_int, int_sigmoid threshold at 0) is evaluated on
    the RAW integer rows, exactly as the C++ pipeline consumes the CSV
    (``Analyst.cpp:386-441``).

    Exports the shipped CSV format: one integer per line, in_dim lines
    (``weights/SpO2/qat/*.csv``).

    Deviation from the notebook (documented): BCE runs with
    pos_weight = #neg/#pos — the SIESTA labels are ~78/22 imbalanced and
    unweighted BCE converges to the majority class at these bit widths."""
    dev = bfv.resolve_device(device)
    torch.manual_seed(seed)
    model = QuantSpO2FC(x.shape[1], weight_bits).to(dev)
    scale = 1.0 / max(float(np.max(x)), 1.0)
    xt = torch.tensor(x, dtype=torch.float32, device=dev) * scale
    yt = torch.tensor(y, dtype=torch.float32, device=dev).reshape(-1, 1)
    n_pos = max(float(np.sum(y == 1)), 1.0)
    lossf = nn.BCEWithLogitsLoss(
        pos_weight=torch.tensor([(len(y) - n_pos) / n_pos], device=dev)
    )
    _fit(model, lossf, model.logits, xt, yt, epochs, lr, batch)

    with torch.no_grad():
        fl = (
            model(torch.tensor(x_test, dtype=torch.float32, device=dev) * scale)
            .cpu()
            .numpy()
            .reshape(-1)
            .round()
        )
    float_acc = float(np.mean(fl == y_test))

    w = model.fc1.int_weight().reshape(-1)  # [in_dim]
    raw = x_test.astype(np.int64) @ w
    int_acc = float(np.mean((raw > 0).astype(np.int64) == y_test))

    if export_path:
        pocketnn.save_csv_matrix(export_path, w.reshape(-1, 1))
    return QATSpO2Result(w, float_acc, int_acc)


@dataclasses.dataclass
class QATResult:
    w1_int: np.ndarray  # [in_dim, hidden]
    w2_int: np.ndarray  # [hidden, n_classes]
    float_acc: float
    int_acc: float


def train_quant_2fc(
    x: np.ndarray,
    y: np.ndarray,
    x_test: np.ndarray,
    y_test: np.ndarray,
    hidden: int = 128,
    bits: int = 2,
    epochs: int = 10,
    lr: float = 3e-3,
    batch: int = 64,
    seed: int = 0,
    export_prefix: Optional[str] = None,
    device=None,
) -> QATResult:
    """x: [n, 784] 2-bit-quantized ints (0..4); y: labels."""
    dev = bfv.resolve_device(device)
    torch.manual_seed(seed)
    model = Quant2FCSquare(x.shape[1], hidden, int(y.max()) + 1, bits).to(dev)
    xt = torch.tensor(x, dtype=torch.float32, device=dev)
    yt = torch.tensor(y, dtype=torch.long, device=dev)
    _fit(model, nn.CrossEntropyLoss(), model, xt, yt, epochs, lr, batch)

    with torch.no_grad():
        xe = torch.tensor(x_test, dtype=torch.float32, device=dev)
        fl = model(xe).argmax(1).cpu().numpy()
    float_acc = float(np.mean(fl == y_test))

    w1 = model.fc1.int_weight()
    w2 = model.fc2.int_weight()
    v1 = x_test.astype(np.int64) @ w1
    logits = (v1 * v1) @ w2
    int_acc = float(np.mean(logits.argmax(1) == y_test))

    if export_prefix:
        pocketnn.save_csv_matrix(f"{export_prefix}_fc1.csv", w1)
        pocketnn.save_csv_matrix(f"{export_prefix}_fc2.csv", w2)
    return QATResult(w1, w2, float_acc, int_acc)


@dataclasses.dataclass
class QATConvResult:
    k1_int: np.ndarray  # [c1, 1, 5, 5]
    k2_int: np.ndarray  # [c2, c1, 5, 5]
    fc_int: np.ndarray  # [classes, c2*o2*o2]
    float_acc: float
    int_acc: float


def train_quant_hcnn(
    x: np.ndarray,
    y: np.ndarray,
    x_test: np.ndarray,
    y_test: np.ndarray,
    c1: int = 5,
    c2: int = 50,
    bits: int = 2,
    epochs: int = 3,
    lr: float = 1e-3,
    batch: int = 64,
    seed: int = 0,
    export_prefix: Optional[str] = None,
    device=None,
) -> QATConvResult:
    """x: [n, 1, 28, 28] 2-bit-quantized ints (0..3, reference input scaling
    ``speedtest_he_mnist_works.py:12``); y: labels.  Returns integer weights
    whose plain integer forward (``heconv.hcnn_forward_int``) is the exact
    parity target for the encrypted pipeline."""
    dev = bfv.resolve_device(device)
    torch.manual_seed(seed)
    img = x.shape[-1]
    model = QuantHCNN(c1, c2, int(y.max()) + 1, bits, img).to(dev)
    xt = torch.tensor(x, dtype=torch.float32, device=dev)
    yt = torch.tensor(y, dtype=torch.long, device=dev)
    _fit(model, nn.CrossEntropyLoss(), model, xt, yt, epochs, lr, batch)

    with torch.no_grad():
        xe = torch.tensor(x_test, dtype=torch.float32, device=dev)
        fl = model(xe).argmax(1).cpu().numpy()
    float_acc = float(np.mean(fl == y_test))

    k1 = model.conv1.int_weight()
    k2 = model.conv2.int_weight()
    fc = model.fc1.int_weight().T  # [classes, features]

    logits = np.stack(
        [heconv.hcnn_forward_int(xi, k1, k2, fc) for xi in x_test.astype(np.int64)]
    )
    int_acc = float(np.mean(logits.argmax(1) == y_test))

    if export_prefix:
        pocketnn.save_csv_matrix(f"{export_prefix}_conv1.csv", k1.reshape(c1, -1))
        pocketnn.save_csv_matrix(f"{export_prefix}_conv2.csv", k2.reshape(c2, -1))
        pocketnn.save_csv_matrix(f"{export_prefix}_fc.csv", fc)
    return QATConvResult(k1, k2, fc, float_acc, int_acc)
