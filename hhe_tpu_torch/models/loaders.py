"""Dataset loaders — counterpart of ``hhe_tpu.models.loaders`` (numpy).

Reference ``libs/pocketnn/src/pktnn_loader.cpp:197-475``: MNIST /
FashionMNIST idx-ubyte parsing (gzip-transparent here) and time-series CSV
loading, plus the QAT input quantization used by the shipped 2-bit models
(``qat/src/export_weights_mnist_py.py:47``: x -> int(x*4), "Scaling to 2bit").

The reference project's shipped assets (its ``weights/`` and ``data/``
trees) are read from ``REFERENCE_ROOT``: the directory that the environment
variable ``HHE_REFERENCE_ROOT`` names, else ``reference/`` at the root of
the checkout.
"""

from __future__ import annotations

import gzip
import os
import pathlib
import struct
from typing import Optional, Tuple

import numpy as np

from . import pocketnn

REFERENCE_ROOT = os.environ.get(
    "HHE_REFERENCE_ROOT", str(pathlib.Path(__file__).resolve().parents[2] / "reference")
)


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def load_idx_images(path: str, limit: Optional[int] = None) -> np.ndarray:
    """idx3-ubyte -> [n, rows*cols] uint8 (reference pktnn_loader MNIST path)."""
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: not an idx3 image file (magic {magic})")
        if limit is not None:
            n = min(n, limit)
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows * cols)


def load_idx_labels(path: str, limit: Optional[int] = None) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: not an idx1 label file (magic {magic})")
        if limit is not None:
            n = min(n, limit)
        return np.frombuffer(f.read(n), np.uint8).astype(np.int64)


def quantize_2bit(images: np.ndarray) -> np.ndarray:
    """QAT input quantization: int(pixel/255 * 4), levels 0..4
    (reference qat/src/export_weights_mnist_py.py:47)."""
    return (images.astype(np.float64) / 255.0 * 4).astype(np.int64)


def load_mnist_test(
    root: str = os.path.join(REFERENCE_ROOT, "data", "mnist", "MNIST", "raw"),
    limit: Optional[int] = None,
    quantize: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    x = load_idx_images(os.path.join(root, "t10k-images-idx3-ubyte"), limit)
    y = load_idx_labels(os.path.join(root, "t10k-labels-idx1-ubyte"), limit)
    if quantize:
        x = quantize_2bit(x)
    return x, y


def load_fmnist_test(
    root: str = os.path.join(REFERENCE_ROOT, "data", "fmnist", "FashionMNIST", "raw"),
    limit: Optional[int] = None,
    quantize: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    return load_mnist_test(root, limit, quantize)


def load_time_series_csv(path: str) -> np.ndarray:
    """Time-series rows (reference loadTimeSeriesData, pktnn_loader.cpp:429-475)."""
    return pocketnn.read_csv_matrix(path)


MITBIH_ROOT = os.path.join(REFERENCE_ROOT, "data", "mit-bih", "csv")


def load_mitbih_labels(
    split: str = "test", balanced: bool = False, root: str = MITBIH_ROOT
) -> np.ndarray:
    """MIT-BIH binary labels (13,245 test rows; the reference's ECG workload
    scale, ``hhe_pktnn_examples.cpp:185-207``).  The matching input file
    ``mitbih_x_{split}_int.csv`` (``hhe_pktnn_examples.cpp:188``) is not
    shipped with the reference's data, only these label files."""
    name = f"mitbih_{'balanced_' if balanced else ''}bin_y_{split}.csv"
    return np.loadtxt(os.path.join(root, name)).astype(np.int64)


def load_spo2_recording(
    path: str = os.path.join(
        REFERENCE_ROOT, "data", "Harpocrates_recordingwise_SIESTA_4percent", "c000101_data.txt"
    ),
) -> np.ndarray:
    """SIESTA SpO2 per-patient recording: rows of 300 values."""
    return pocketnn.read_csv_matrix(path)
