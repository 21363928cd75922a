"""Pure-numpy dataset file readers — no torchvision dependency.

The reference loaded MNIST/CIFAR through torchvision
(``src/util.py:20-106``); this module parses the same on-disk artifacts
directly so the real-data path runs in any environment that has the files:

- MNIST: IDX format (``train-images-idx3-ubyte`` etc., optionally gzipped) —
  the exact files torchvision caches under ``<root>/MNIST/raw/`` and the
  reference checked in under ``PyTorch-parameter-server/mnist_data/MNIST/raw/``.
- CIFAR-10/100: the python pickle batches (``cifar-10-batches-py/data_batch_*``,
  ``cifar-100-python/train``) torchvision caches verbatim.
- SVHN: the ``.mat`` files, via scipy when present.

Format spec: IDX magic = ``0x00 0x00 <dtype> <ndim>`` then ``ndim`` big-endian
uint32 dims, then row-major payload (yann.lecun.com/exdb/mnist layout).
"""

from __future__ import annotations

import gzip
import os
import pickle

import numpy as np

_IDX_DTYPES = {
    0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
    0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64,
}


def _read_bytes(path: str) -> bytes:
    """Read a file, transparently gunzipping (sniffed by magic, not suffix)."""
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        data = f.read()
    if head == b"\x1f\x8b":
        return gzip.decompress(data)
    return data


def read_idx(path: str) -> np.ndarray:
    """Parse one IDX file (images or labels), plain or gzipped."""
    data = _read_bytes(path)
    if len(data) < 4 or data[0] != 0 or data[1] != 0:
        raise ValueError(f"{path}: not an IDX file (bad magic {data[:4]!r})")
    dtype_code, ndim = data[2], data[3]
    if dtype_code not in _IDX_DTYPES:
        raise ValueError(f"{path}: unknown IDX dtype code 0x{dtype_code:02x}")
    dims = np.frombuffer(data, ">u4", count=ndim, offset=4)
    dt = np.dtype(_IDX_DTYPES[dtype_code]).newbyteorder(">")
    expect = 4 + 4 * ndim + int(np.prod(dims)) * dt.itemsize
    if len(data) < expect:
        raise ValueError(
            f"{path}: truncated IDX payload ({len(data)} < {expect} bytes)")
    arr = np.frombuffer(data, dt, count=int(np.prod(dims)), offset=4 + 4 * ndim)
    return arr.reshape(tuple(int(d) for d in dims)).astype(_IDX_DTYPES[dtype_code])


def _find(root: str, stem: str) -> str | None:
    """Locate ``stem`` or ``stem.gz`` under root."""
    for name in (stem, stem + ".gz"):
        p = os.path.join(root, name)
        if os.path.isfile(p):
            return p
    return None


def _mnist_roots(data_dir: str):
    """Candidate directories holding the raw IDX files, covering both the
    torchvision cache layout (``<root>/MNIST/raw``) and the reference's
    checked-in layout (``mnist_data/MNIST/raw``)."""
    return [
        os.path.join(data_dir, "mnist_data", "MNIST", "raw"),
        os.path.join(data_dir, "MNIST", "raw"),
        os.path.join(data_dir, "mnist_data"),
        data_dir,
    ]


def load_mnist(data_dir: str, train: bool):
    """(images uint8 [N,28,28,1], labels int) or None if files absent."""
    stem_img = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    stem_lab = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
    for root in _mnist_roots(data_dir):
        img_p, lab_p = _find(root, stem_img), _find(root, stem_lab)
        if img_p and lab_p:
            images = read_idx(img_p)
            labels = read_idx(lab_p)
            if images.ndim != 3 or len(images) != len(labels):
                raise ValueError(f"{img_p}: inconsistent MNIST split")
            return images[..., None], labels
    return None


def load_mnist10k(data_dir: str, train: bool, train_count: int = 9000):
    """Real-MNIST split carved from the 10k test set.

    The repository ships the real MNIST test set
    (``mnist_data/MNIST/raw/t10k-*``) but not the train images. This split
    is a deterministic shuffle of the 10,000 real test digits, the first
    ``train_count`` as train and the rest as eval (the JAX package's split).
    """
    full = load_mnist(data_dir, train=False)
    if full is None:
        return None
    images, labels = full
    order = np.random.RandomState(0xD161).permutation(len(images))
    sel = order[:train_count] if train else order[train_count:]
    return images[sel], labels[sel]


def _cifar_batch(path: str):
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    data = np.asarray(d["data"], np.uint8).reshape(-1, 3, 32, 32)
    labels = d.get("labels", d.get("fine_labels"))
    return data.transpose(0, 2, 3, 1), np.asarray(labels)


def load_cifar(data_dir: str, name: str, train: bool):
    """(images uint8 NHWC, labels) from the pickle batches, or None."""
    if name == "cifar10":
        sub = "cifar-10-batches-py"
        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    else:
        sub = "cifar-100-python"
        files = ["train"] if train else ["test"]
    for parent in (os.path.join(data_dir, f"{name}_data"), data_dir):
        root = os.path.join(parent, sub)
        paths = [os.path.join(root, f) for f in files]
        if all(os.path.isfile(p) for p in paths):
            parts = [_cifar_batch(p) for p in paths]
            images = np.concatenate([p[0] for p in parts])
            labels = np.concatenate([p[1] for p in parts])
            return images, labels
    return None


def load_svhn(data_dir: str, train: bool):
    """SVHN ``.mat`` via scipy (absent -> None)."""
    try:
        from scipy.io import loadmat
    except Exception:
        return None
    fname = "train_32x32.mat" if train else "test_32x32.mat"
    for parent in (os.path.join(data_dir, "svhn_data"), data_dir):
        p = os.path.join(parent, fname)
        if os.path.isfile(p):
            mat = loadmat(p)
            images = np.transpose(mat["X"], (3, 0, 1, 2))
            labels = mat["y"].ravel().astype(np.int64) % 10  # class '10' is digit 0
            return images, labels
    return None
