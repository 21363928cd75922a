"""Dataset pre-download (``ewdml_tpu/data/prepare.py``): fetch MNIST,
CIFAR-10, CIFAR-100 or SVHN into the on-disk layout *before* a parallel run
starts, so that N worker processes do not race the same download (the
reference's ``src/data/data_prepare.py``).

The fetch, the extraction and the seeding use the standard library only:
the raw artifacts (IDX gz, pickle tarballs, ``.mat``) are fetched with
``urllib`` and laid out where ``ewdml_tpu_torch/data/readers.py`` looks
(``mnist_data/MNIST/raw/``, ``cifar10_data/cifar-10-batches-py/``, ...).
``--from-local SRC`` seeds the layout from an existing tree instead of the
network (copying whatever intact artifacts SRC holds: another machine's
torchvision cache, or a checkout with the files committed); ``--mirror
BASE`` fetches every artifact from ``BASE/<dataset>/<basename>``.

Usage: ``python -m ewdml_tpu_torch.data.prepare [--data-dir data/]
[--datasets ...] [--from-local SRC] [--mirror BASE]``
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
import tarfile

logger = logging.getLogger("ewdml_tpu_torch.data.prepare")

ALL = ("mnist", "cifar10", "cifar100", "svhn")

_MNIST_FILES = (
    "train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz",
    "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz",
)
_URLS = {
    "mnist": [("https://ossci-datasets.s3.amazonaws.com/mnist/" + f,
               os.path.join("mnist_data", "MNIST", "raw", f))
              for f in _MNIST_FILES],
    "cifar10": [("https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
                 os.path.join("cifar10_data", "cifar-10-python.tar.gz"))],
    "cifar100": [("https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz",
                  os.path.join("cifar100_data", "cifar-100-python.tar.gz"))],
    "svhn": [("http://ufldl.stanford.edu/housenumbers/train_32x32.mat",
              os.path.join("svhn_data", "train_32x32.mat")),
             ("http://ufldl.stanford.edu/housenumbers/test_32x32.mat",
              os.path.join("svhn_data", "test_32x32.mat"))],
}
_EXTRACTED_DIR = {"cifar10": "cifar-10-batches-py",
                  "cifar100": "cifar-100-python"}


def _fetch(url: str, dest: str) -> bool:
    """Download ``url`` to ``dest`` through a ``.part`` file (kept only
    when whole); an existing ``dest`` is not fetched again. A failure is
    logged and returns False."""
    import urllib.request

    if os.path.isfile(dest):
        return True
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = dest + ".part"
    try:
        with urllib.request.urlopen(url, timeout=60) as r, \
                open(tmp, "wb") as f:
            shutil.copyfileobj(r, f)
        os.replace(tmp, dest)
        return True
    except Exception as e:
        logger.warning("fetch %s failed: %s", url, e)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _extract_tars(data_dir: str, name: str) -> None:
    """Unpack the dataset's tarballs beside them, once (an extracted
    directory is not extracted again)."""
    root = os.path.join(data_dir, f"{name}_data")
    if not os.path.isdir(root):
        return
    if os.path.isdir(os.path.join(root, _EXTRACTED_DIR.get(name, ""))):
        return
    for f in os.listdir(root):
        if f.endswith(".tar.gz"):
            with tarfile.open(os.path.join(root, f)) as t:
                try:
                    t.extractall(root, filter="data")
                except TypeError:
                    # Python patch levels before 3.9.17/3.10.12/3.11.4
                    # lack filter=; these are fixed-layout dataset
                    # tarballs from known URLs.
                    t.extractall(root)  # noqa: S202


def prepare(name: str, data_dir: str = "data/",
            mirror: str | None = None) -> bool:
    """Fetch one dataset's artifacts into the reader layout. Returns
    whether both splits load as real data afterwards (a test-only cache
    must not report ready, or training would fall back to synthetic data).
    ``mirror`` rewrites every URL to ``mirror/<dataset>/<basename>``."""
    from ewdml_tpu_torch.data import datasets

    if name not in ALL:
        raise ValueError(f"unknown dataset {name!r}; choose from {ALL}")
    for url, rel in _URLS[name]:
        if mirror:
            url = "/".join((mirror.rstrip("/"), name,
                            url.rsplit("/", 1)[-1]))
        _fetch(url, os.path.join(data_dir, rel))
    _extract_tars(data_dir, name)
    ok = all(datasets.load(name, data_dir, train=t).source == "real"
             for t in (True, False))
    logger.info("%s %s under %s", name, "ready" if ok else "NOT available",
                data_dir)
    return ok


def seed_from_local(src: str, data_dir: str = "data/") -> int:
    """Copy intact dataset artifacts from a local tree into the layout.

    Walks ``src`` for known artifact names (IDX files, CIFAR batch
    directories, SVHN mats) and copies those that exist and are not
    placeholders (under 64 bytes), unless the layout already holds one at
    least as large. Returns the number of files copied."""
    copied = 0
    idx_names = {f: os.path.join("mnist_data", "MNIST", "raw", f)
                 for f in (_MNIST_FILES + tuple(f[:-3] for f in _MNIST_FILES))}
    cifar_dirs = {"cifar-10-batches-py": "cifar10_data",
                  "cifar-100-python": "cifar100_data"}
    mats = {"train_32x32.mat": "svhn_data", "test_32x32.mat": "svhn_data"}
    for root, _dirs, files in os.walk(src):
        for f in files:
            rel = idx_names.get(f) or (
                os.path.join(mats[f], f) if f in mats else None)
            base = os.path.basename(root)
            if rel is None and base in cifar_dirs and not f.endswith(".html"):
                rel = os.path.join(cifar_dirs[base], base, f)
            if rel is None:
                continue
            srcp = os.path.join(root, f)
            dest = os.path.join(data_dir, rel)
            if os.path.getsize(srcp) < 64:
                continue
            if (os.path.isfile(dest)
                    and os.path.getsize(dest) >= os.path.getsize(srcp)):
                continue
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            shutil.copyfile(srcp, dest)
            copied += 1
            logger.info("seeded %s from %s", rel, srcp)
    return copied


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", default="data/")
    p.add_argument("--datasets", nargs="*", default=list(ALL),
                   choices=list(ALL))
    p.add_argument("--from-local", default=None, metavar="SRC",
                   help="seed the layout from a local tree instead of the "
                        "network")
    p.add_argument("--mirror", default=None, metavar="BASE",
                   help="fetch every artifact from BASE/<dataset>/<basename> "
                        "instead of the upstream URL")
    ns = p.parse_args(argv)
    if ns.from_local:
        n = seed_from_local(ns.from_local, ns.data_dir)
        logger.info("seeded %d files from %s", n, ns.from_local)
        from ewdml_tpu_torch.data import datasets

        ok = any(datasets.load(d, ns.data_dir, train=False).source == "real"
                 for d in ns.datasets)
        return 0 if ok else 1
    ok = all([prepare(d, ns.data_dir, mirror=ns.mirror) for d in ns.datasets])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
