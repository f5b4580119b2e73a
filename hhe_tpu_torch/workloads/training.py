"""Integer-DFA training workloads — the pktnn_examples training equivalents;
counterpart of ``hhe_tpu.workloads.training``.

Reference ``src/examples/pktnn_examples.cpp``: MNIST 3-layer DFA training
(``fc_int_dfa_mnist``, :64-249), SpO2 300->1 one-layer training with lr
halving and epoch-best checkpointing (``fc_int_dfa_spo2_one_layer``,
:896-1069), ECG 128->1 (``fc_int_dfa_ecg_one_layer``, :570-865).

The minibatch update is the eager ``pocketnn.dfa_train_step``; epochs
stream minibatches through it in the JAX package's numpy permutation order.
The data, the parameters and the batch indices live on ``device`` (``None``
means CUDA and raises without a card); every product is exact, so a run on
the card gives a CPU run's weights bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import pocketnn as pk
from ..ops.bfv import resolve_device
from ..utils.config import RunConfig


def _limit(run: Optional[RunConfig], *arrays):
    """Reference dry_run semantics: cap the training-set size at
    run.dry_run_num_samples (``configs/config.cpp:11-12``)."""
    if run is None:
        return arrays
    lim = run.sample_limit(len(arrays[0]))
    return tuple(a[:lim] for a in arrays)


@dataclasses.dataclass
class TrainResult:
    model: pk.MLP
    specs: Tuple[pk.FCSpec, ...]
    history: List[Dict]
    best_test_acc: float
    best_params: pk.MLP


def _forward(model, specs, x) -> np.ndarray:
    """The model's output on x (an array, or an int32 tensor), on the host."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.int32))
    out, _ = pk.mlp_forward(model, specs, x.to(model.params[0].weight.device))
    return out.cpu().numpy()


def _binary_accuracy(model, specs, x, labels01) -> float:
    """Threshold accuracy: output > 64 -> positive (reference spo2/ecg loops,
    pktnn_examples.cpp:1029-1051).  x: an array or a tensor."""
    out = _forward(model, specs, x)
    return float(np.mean((out[:, 0] > 64) == (np.asarray(labels01) > 0)))


def _multiclass_accuracy(model, specs, x, labels) -> float:
    return float(np.mean(_forward(model, specs, x).argmax(1) == np.asarray(labels)))


def _run_training(
    specs,
    x_train,
    y_train,
    x_test,
    labels_test,
    acc_fn,
    labels_train,
    epochs: int,
    mini_batch: int,
    lr_inv: int,
    lr_halving_every: Optional[int],
    seed: int,
    save_best_path: Optional[str] = None,
    device=None,
) -> TrainResult:
    dev = resolve_device(device)
    model, specs = pk.mlp_init(seed, specs, device=dev)
    rng = np.random.default_rng(seed)
    n = x_train.shape[0]
    xj = torch.as_tensor(np.asarray(x_train, np.int32), device=dev)
    yj = torch.as_tensor(np.asarray(y_train, np.int32), device=dev)
    xt = torch.as_tensor(np.asarray(x_test, np.int32), device=dev)
    history: List[Dict] = []
    best_acc, best_params = -1.0, model
    cur_lr = lr_inv
    for ep in range(epochs):
        if lr_halving_every and ep > 0 and ep % lr_halving_every == 0:
            cur_lr *= 2  # reference: lr_inv doubles -> lr halves (:972-986)
        idx = torch.as_tensor(rng.permutation(n), device=dev)
        # the JAX package adds float(loss) per step; every partial sum is an
        # integer below 2^53, so an int64 sum read once per epoch is the same
        total_loss = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(0, n - mini_batch + 1, mini_batch):
            sel = idx[i : i + mini_batch]
            model, loss = pk.dfa_train_step(model, specs, xj[sel], yj[sel], cur_lr, -127, 128)
            total_loss += loss
        train_acc = acc_fn(model, specs, xj, labels_train)
        test_acc = acc_fn(model, specs, xt, labels_test)
        history.append(
            {"epoch": ep, "loss": float(total_loss), "train_acc": train_acc, "test_acc": test_acc}
        )
        if test_acc > best_acc:
            best_acc, best_params = test_acc, model
            if save_best_path:
                # epoch-best checkpoints, one CSV per layer (reference
                # saveWeight calls, pktnn_examples.cpp:1043-1050,1193-1196)
                for li, p in enumerate(best_params.params):
                    path = (
                        save_best_path
                        if len(best_params.params) == 1
                        else f"{save_best_path}.fc{li + 1}.csv"
                    )
                    pk.save_csv_matrix(path, p.weight.cpu().numpy())
    return TrainResult(model, specs, history, best_acc, best_params)


def initial_stats(
    model, specs, x: np.ndarray, labels_scaled: np.ndarray, process: str = "train"
) -> float:
    """Pre-training threshold accuracy report (reference ``initial_stats``,
    pktnn_examples.cpp:867-894: output > 64 -> 128, compare to scaled label)."""
    out = _forward(model, specs, x)
    pred = np.where(out[:, 0] > 64, 128, 0)
    acc = float(np.mean(pred == np.asarray(labels_scaled).reshape(-1)))
    n_correct = int(np.sum(pred == np.asarray(labels_scaled).reshape(-1)))
    print(
        f"Initial {process} correct predictions: {n_correct} "
        f"(out of {len(pred)} examples)\n"
        f"Initial {process} accuracy: {acc * 100}%"
    )
    return acc


def train_spo2_one_layer(
    data: np.ndarray,
    labels: np.ndarray,
    test_data: Optional[np.ndarray] = None,
    test_labels: Optional[np.ndarray] = None,
    epochs: int = 50,
    mini_batch: int = 4,
    lr_inv: int = 50,
    seed: int = 0,
    save_best_path: Optional[str] = None,
    run: Optional[RunConfig] = None,
    device=None,
) -> TrainResult:
    """300 -> 1 pocket_sigmoid DFA training (reference
    fc_int_dfa_spo2_one_layer: labels x128, minibatch 4, lr halves every 10
    epochs, epoch-best weights saved)."""
    if test_data is None:
        test_data, test_labels = data, labels
    data, labels = _limit(run, data, np.asarray(labels).reshape(-1))
    labels01 = np.asarray(labels).reshape(-1)
    y = (labels01 * 128).reshape(-1, 1)
    specs = [pk.FCSpec(data.shape[1], 1, "pocket_sigmoid")]
    return _run_training(
        specs,
        data,
        y,
        test_data,
        np.asarray(test_labels).reshape(-1),
        _binary_accuracy,
        labels01,
        epochs,
        mini_batch,
        lr_inv,
        lr_halving_every=10,
        seed=seed,
        save_best_path=save_best_path,
        device=device,
    )


def train_ecg_one_layer(
    data: np.ndarray,
    labels: np.ndarray,
    epochs: int = 50,
    mini_batch: int = 4,
    lr_inv: int = 50,
    seed: int = 0,
    run: Optional[RunConfig] = None,
    device=None,
) -> TrainResult:
    """128 -> 1 pocket_sigmoid DFA (reference fc_int_dfa_ecg_one_layer)."""
    data, labels = _limit(run, data, np.asarray(labels).reshape(-1))
    labels01 = np.asarray(labels).reshape(-1)
    y = (labels01 * 128).reshape(-1, 1)
    specs = [pk.FCSpec(data.shape[1], 1, "pocket_sigmoid")]
    return _run_training(
        specs, data, y, data, labels01, _binary_accuracy, labels01,
        epochs, mini_batch, lr_inv, None, seed, device=device,
    )


def train_spo2_square(
    data: np.ndarray,
    labels: np.ndarray,
    test_data: Optional[np.ndarray] = None,
    test_labels: Optional[np.ndarray] = None,
    hidden: int = 128,
    epochs: int = 50,
    mini_batch: int = 4,
    lr_inv: int = 50,
    seed: int = 0,
    save_best_path: Optional[str] = None,
    run: Optional[RunConfig] = None,
    device=None,
) -> TrainResult:
    """SpO2 2FC square net: 300 -> 128 pocket_tanh -> 1 square, DFA training
    with lr halving every 10 epochs and epoch-best per-layer checkpoints
    (reference ``fc_int_dfa_spo2_square``, pktnn_examples.cpp:1205-1299,
    via the generic ``train()`` helper :1071-1203).  As in the JAX package,
    the square layer starts at zero weights, its grad_inv 2x is 0 there, and
    it never leaves zero (ROADMAP F14)."""
    if test_data is None:
        test_data, test_labels = data, labels
    data, labels = _limit(run, data, np.asarray(labels).reshape(-1))
    labels01 = np.asarray(labels).reshape(-1)
    y = (labels01 * 128).reshape(-1, 1)
    specs = [
        pk.FCSpec(data.shape[1], hidden, "pocket_tanh"),
        pk.FCSpec(hidden, 1, "square"),
    ]
    return _run_training(
        specs,
        data,
        y,
        test_data,
        np.asarray(test_labels).reshape(-1),
        _binary_accuracy,
        labels01,
        epochs,
        mini_batch,
        lr_inv,
        lr_halving_every=10,
        seed=seed,
        save_best_path=save_best_path,
        device=device,
    )


def train_mnist_one_layer(
    x_train: np.ndarray,
    labels_train: np.ndarray,
    x_test: np.ndarray,
    labels_test: np.ndarray,
    epochs: int = 3,
    mini_batch: int = 20,
    lr_inv: int = 1000,
    seed: int = 0,
    run: Optional[RunConfig] = None,
    device=None,
) -> TrainResult:
    """Single-FC 784 -> 10 pocket_tanh DFA training (reference
    ``fc_int_dfa_mnist_one_layer``, pktnn_examples.cpp:334-568)."""
    return train_mnist_dfa(
        x_train,
        labels_train,
        x_test,
        labels_test,
        dims=(x_train.shape[1], 10),
        epochs=epochs,
        mini_batch=mini_batch,
        lr_inv=lr_inv,
        seed=seed,
        run=run,
        device=device,
    )


def train_mnist_dfa(
    x_train: np.ndarray,
    labels_train: np.ndarray,
    x_test: np.ndarray,
    labels_test: np.ndarray,
    dims: Sequence[int] = (784, 100, 50, 10),
    epochs: int = 3,
    mini_batch: int = 20,
    lr_inv: int = 1000,
    seed: int = 0,
    run: Optional[RunConfig] = None,
    device=None,
) -> TrainResult:
    """3-layer pocket_tanh DFA training (reference fc_int_dfa_mnist:
    one-hot targets x UNSIGNED_4BIT_MAX=15, minibatch 20, lrInv 1000)."""
    x_train, labels_train = _limit(run, x_train, np.asarray(labels_train).reshape(-1))
    n_classes = dims[-1]
    y = np.zeros((len(labels_train), n_classes), np.int32)
    y[np.arange(len(labels_train)), labels_train] = pk.UNSIGNED_4BIT_MAX
    specs = [
        pk.FCSpec(dims[i], dims[i + 1], "pocket_tanh") for i in range(len(dims) - 1)
    ]
    return _run_training(
        specs,
        x_train,
        y,
        x_test,
        labels_test,
        _multiclass_accuracy,
        labels_train,
        epochs,
        mini_batch,
        lr_inv,
        None,
        seed,
        device=device,
    )
