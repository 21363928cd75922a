"""Dataset pipelines (``ewdml_tpu/data/datasets.py``, numpy, copied).

MNIST / mnist10k / Cifar10 / Cifar100 / SVHN with the reference's
normalization constants (reference ``src/util.py:20-106``); real data loads
from on-disk caches through the pure-numpy readers and never downloads, and
``synthetic`` mode generates the same deterministic, learnable split as the
JAX package for the same seed. ``raw`` carries the uint8 pixels of the
``--feed u8`` path, which normalizes on the device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

# Reference normalization constants (util.py:26, :35-36, :62-63, :91-94).
MNIST_MEAN, MNIST_STD = (0.1307,), (0.3081,)
CIFAR_MEAN = tuple(x / 255.0 for x in (125.3, 123.0, 113.9))
CIFAR_STD = tuple(x / 255.0 for x in (63.0, 62.1, 66.7))
SVHN_MEAN, SVHN_STD = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)

_SPECS = {
    "mnist": dict(shape=(28, 28, 1), classes=10, mean=MNIST_MEAN, std=MNIST_STD,
                  n_train=60000, n_test=10000, augment=False),
    "mnist10k": dict(shape=(28, 28, 1), classes=10, mean=MNIST_MEAN, std=MNIST_STD,
                     n_train=9000, n_test=1000, augment=False),
    # 28->32 zero-padded variants: real digits through the 32x32-input conv
    # stacks (VGG11/ResNet).
    "mnist32": dict(shape=(32, 32, 1), classes=10, mean=MNIST_MEAN, std=MNIST_STD,
                    n_train=60000, n_test=10000, augment=False),
    "mnist10k32": dict(shape=(32, 32, 1), classes=10, mean=MNIST_MEAN, std=MNIST_STD,
                       n_train=9000, n_test=1000, augment=False),
    "cifar10": dict(shape=(32, 32, 3), classes=10, mean=CIFAR_MEAN, std=CIFAR_STD,
                    n_train=50000, n_test=10000, augment=True),
    "cifar100": dict(shape=(32, 32, 3), classes=100, mean=CIFAR_MEAN, std=CIFAR_STD,
                     n_train=50000, n_test=10000, augment=True),
    "svhn": dict(shape=(32, 32, 3), classes=10, mean=SVHN_MEAN, std=SVHN_STD,
                 n_train=73257, n_test=26032, augment=True),
}


@dataclasses.dataclass
class Dataset:
    """In-memory split: images NHWC float32 (normalized), labels int32.

    ``source`` records whether the split came from real on-disk files or the
    synthetic generator. ``raw`` (uint8 NHWC, when available) carries the
    un-normalized pixels of the ``--feed u8`` path; the step normalizes on
    the device with the constants of ``_SPECS``
    (``train/trainer.make_train_step``).
    """

    images: np.ndarray
    labels: np.ndarray
    num_classes: int
    augment: bool = False
    source: str = "real"
    raw: np.ndarray | None = None

    def __len__(self):
        return len(self.images)


def _synthetic_split(name: str, train: bool, seed: int, size: int | None) -> Dataset:
    """Deterministic learnable problem: per-class Gaussian blob in pixel space.

    Classes are linearly separable with noise, so small CNNs reach high
    accuracy in a few steps.
    """
    spec = _SPECS[name]
    n = size or (2048 if train else 512)
    rng = np.random.RandomState(seed + (0 if train else 1))
    labels = rng.randint(0, spec["classes"], size=n).astype(np.int32)
    h, w, c = spec["shape"]
    proto_rng = np.random.RandomState(1234)  # class prototypes shared by splits
    protos = proto_rng.randn(spec["classes"], h, w, c).astype(np.float32)
    blobs = protos[labels] + 0.3 * rng.randn(n, h, w, c).astype(np.float32)
    # Pixel-space generation: map the ~N(0,1) blobs affinely into [0,255]
    # (128 + 48x keeps ±2.6σ inside the range — <1% tail clipping) and
    # derive the float32 view FROM the uint8 pixels with the spec's
    # normalization, exactly like a real dataset. The u8 and f32 feeds then
    # see the SAME distribution (naively inverting normalization instead
    # would clip ~34% of mass to 0 under MNIST's mean=0.13).
    raw = np.clip(128.0 + 48.0 * blobs, 0, 255).astype(np.uint8)
    images = _normalize(raw, spec["mean"], spec["std"])
    return Dataset(images, labels, spec["classes"], augment=False,
                   source="synthetic", raw=raw)


def _normalize(x_uint8: np.ndarray, mean, std) -> np.ndarray:
    x = x_uint8.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _load_real(name: str, data_dir: str, train: bool) -> Dataset | None:
    """Load from local on-disk caches via pure-numpy readers; never downloads.

    Covers both the torchvision cache layout and the reference's checked-in
    layout (``mnist_data/MNIST/raw``, ``cifar10_data/cifar-10-batches-py`` —
    reference ``src/util.py:20-106`` roots).
    """
    from ewdml_tpu_torch.data import readers

    spec = _SPECS[name]
    pad32 = name in ("mnist32", "mnist10k32")
    try:
        if name in ("mnist", "mnist32"):
            pair = readers.load_mnist(data_dir, train)
        elif name in ("mnist10k", "mnist10k32"):
            pair = readers.load_mnist10k(data_dir, train)
        elif name in ("cifar10", "cifar100"):
            pair = readers.load_cifar(data_dir, name, train)
        elif name == "svhn":
            pair = readers.load_svhn(data_dir, train)
        else:
            return None
    except Exception as e:
        # A corrupt/truncated cache file (stripped-blob placeholder, torn
        # pickle, bad gzip stream — UnpicklingError/EOFError/zlib.error are
        # not ValueError/OSError) must degrade to the synthetic fallback,
        # loudly, not abort training.
        import logging

        logging.getLogger("ewdml_tpu_torch.data").warning(
            "on-disk %s cache unreadable (%s); using synthetic fallback",
            name, e)
        return None
    if pair is None:
        return None
    images, labels = pair
    if pad32:
        # Zero-pad raw pixels 28->32 BEFORE normalization (black border),
        # keeping normalization constants identical to plain MNIST.
        images = np.pad(images, ((0, 0), (2, 2), (2, 2), (0, 0)))
    return Dataset(
        _normalize(images, spec["mean"], spec["std"]),
        labels.astype(np.int32),
        spec["classes"],
        augment=train and spec["augment"],
        raw=np.ascontiguousarray(images),
    )


#: has_real verdicts per (name, directory, split): the probe is a full load,
#: and the experiments registry asks once per cell a sweep plans.
_HAS_REAL_CACHE: dict = {}


def has_real(name: str, data_dir: str = "data/", train: bool = True) -> bool:
    """Whether a real on-disk split of ``name`` loads from ``data_dir``.

    The experiments registry's choice between the paper's dataset and the
    committed stand-in. A load attempt, not a path check, so a corrupt
    cache counts as absent as it does for :func:`load`. Memoized per
    (name, directory, split); only the verdict is kept."""
    key = (name.lower(), os.path.abspath(data_dir), train)
    if key not in _HAS_REAL_CACHE:
        _HAS_REAL_CACHE[key] = (key[0] in _SPECS and
                                _load_real(key[0], data_dir, train)
                                is not None)
    return _HAS_REAL_CACHE[key]


def load(name: str, data_dir: str = "data/", train: bool = True,
         synthetic: bool = False, seed: int = 0,
         synthetic_size: int | None = None,
         require_real: bool = False) -> Dataset:
    """``prepare_data`` equivalent for one split; falls back to the
    synthetic split when the on-disk files are absent, unless
    ``require_real`` is set: a published-table cell never trains on
    synthetic data, so it gets a ``FileNotFoundError`` instead."""
    key = name.lower()
    if key not in _SPECS:
        raise ValueError(f"unknown dataset {name!r}; choose from {sorted(_SPECS)}")
    if require_real and synthetic:
        raise ValueError("require_real=True contradicts synthetic=True")
    if not synthetic:
        real = _load_real(key, data_dir, train)
        if real is not None:
            return real
    if require_real:
        raise FileNotFoundError(
            f"no real on-disk files for {name!r} under {data_dir!r} "
            "(require_real=True refuses the synthetic fallback)")
    return _synthetic_split(key, train, seed, synthetic_size)
