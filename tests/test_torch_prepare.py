"""The dataset pre-download tool, ``ewdml_tpu_torch/data/prepare.py``: the
port's counterpart of ``tests/test_prepare.py``, case for case, plus the
seeding held against the JAX module's.

Oracles (all exact): the files a seeding copies, byte for byte and path for
path, against ``ewdml_tpu.data.prepare`` on the same local tree; the
fetch path (``urllib`` download, tar extraction, the load check) against a
loopback ``http.server`` origin standing in for the upstream hosts
(``mirror=``), with the port's readers loading what it laid out.
"""

import gzip
import os
import struct
import tarfile

import numpy as np
import torch

from ewdml_tpu.data import prepare as jprepare
from ewdml_tpu_torch.data import prepare, readers

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _idx_bytes(arr: np.ndarray) -> bytes:
    header = struct.pack(">BBBB", 0, 0, 0x08, arr.ndim)
    header += b"".join(struct.pack(">I", d) for d in arr.shape)
    return header + arr.astype(np.uint8).tobytes()


def _tree(root) -> dict:
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _local_tree(src):
    """A checkout-like tree: MNIST files (one a placeholder), a CIFAR
    batch directory with an html file beside it, an SVHN mat."""
    raw = src / "deep" / "MNIST" / "raw"
    raw.mkdir(parents=True)
    rs = np.random.RandomState(0)
    (raw / "t10k-images-idx3-ubyte.gz").write_bytes(gzip.compress(
        _idx_bytes(rs.randint(0, 255, (100, 28, 28), np.uint8))))
    (raw / "t10k-labels-idx1-ubyte").write_bytes(
        _idx_bytes(np.arange(5, dtype=np.uint8).repeat(20)))
    (raw / "train-images-idx3-ubyte").write_bytes(b"placeholder")
    cifar = src / "other" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    (cifar / "data_batch_1").write_bytes(b"x" * 300)
    (cifar / "readme.html").write_bytes(b"y" * 300)
    (src / "test_32x32.mat").write_bytes(b"z" * 200)


class TestSeedFromLocal:
    def test_copies_intact_skips_placeholders(self, tmp_path):
        src = tmp_path / "somecheckout" / "deep" / "MNIST" / "raw"
        src.mkdir(parents=True)
        imgs = np.random.RandomState(0).randint(0, 255, (100, 28, 28),
                                                np.uint8)
        (src / "t10k-images-idx3-ubyte.gz").write_bytes(
            gzip.compress(_idx_bytes(imgs)))
        (src / "t10k-labels-idx1-ubyte").write_bytes(
            _idx_bytes(np.arange(5, dtype=np.uint8).repeat(20)))
        (src / "train-images-idx3-ubyte").write_bytes(b"placeholder")
        dest = tmp_path / "cache"
        n = prepare.seed_from_local(str(tmp_path / "somecheckout"), str(dest))
        assert n == 2
        got = readers.load_mnist(str(dest), train=False)
        np.testing.assert_array_equal(got[0][..., 0], imgs)
        assert len(got[1]) == 100
        assert not os.path.exists(
            dest / "mnist_data" / "MNIST" / "raw" / "train-images-idx3-ubyte")

    def test_idempotent(self, tmp_path):
        src = tmp_path / "src" / "MNIST" / "raw"
        src.mkdir(parents=True)
        (src / "t10k-labels-idx1-ubyte").write_bytes(
            _idx_bytes(np.zeros(100, np.uint8)))
        dest = str(tmp_path / "cache")
        assert prepare.seed_from_local(str(tmp_path / "src"), dest) == 1
        assert prepare.seed_from_local(str(tmp_path / "src"), dest) == 0

    def test_same_tree_as_the_jax_module(self, tmp_path):
        """exact: one local tree through both packages gives the same
        files, path for path and byte for byte, and the same count."""
        _local_tree(tmp_path / "src")
        a, b = tmp_path / "port", tmp_path / "jax"
        n = prepare.seed_from_local(str(tmp_path / "src"), str(a))
        assert n == jprepare.seed_from_local(str(tmp_path / "src"), str(b))
        assert n == 4
        assert _tree(a) == _tree(b)

    def test_cli_from_the_repo_data_as_the_jax_module(self, tmp_path):
        """exact: ``--from-local data/`` (the committed MNIST files) seeds
        the same files through both CLIs, and both exit 0."""
        data = os.path.join(REPO, "data")
        a, b = str(tmp_path / "port"), str(tmp_path / "jax")
        assert prepare.main(["--from-local", data, "--data-dir", a,
                             "--datasets", "mnist"]) == 0
        assert jprepare.main(["--from-local", data, "--data-dir", b,
                              "--datasets", "mnist"]) == 0
        tree = _tree(a)
        assert tree and tree == _tree(b)
        assert all(p.startswith(os.path.join("mnist_data", "MNIST", "raw"))
                   for p in tree)


class TestExtractTars:
    def test_extracts_once(self, tmp_path):
        root = tmp_path / "cifar10_data"
        root.mkdir()
        inner = tmp_path / "stage" / "cifar-10-batches-py"
        inner.mkdir(parents=True)
        (inner / "data_batch_1").write_bytes(b"x" * 100)
        with tarfile.open(root / "cifar-10-python.tar.gz", "w:gz") as t:
            t.add(inner, arcname="cifar-10-batches-py")
        prepare._extract_tars(str(tmp_path), "cifar10")
        target = root / "cifar-10-batches-py" / "data_batch_1"
        assert target.is_file()
        first_mtime = target.stat().st_mtime_ns
        prepare._extract_tars(str(tmp_path), "cifar10")  # no re-extract
        assert target.stat().st_mtime_ns == first_mtime


class TestHTTPFetchPath:
    """``prepare()``'s download, extraction and load check, end to end,
    against a loopback origin (``mirror=``); only the host differs from an
    upstream fetch."""

    @staticmethod
    def _serve(directory):
        import functools
        import http.server
        import threading

        handler = functools.partial(
            http.server.SimpleHTTPRequestHandler, directory=str(directory))
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return srv, f"http://127.0.0.1:{srv.server_address[1]}/"

    @staticmethod
    def _mnist_origin(origin):
        origin.mkdir(parents=True, exist_ok=True)
        rs = np.random.RandomState(1)
        for stem, shape in (("train", (64, 28, 28)), ("t10k", (32, 28, 28))):
            imgs = rs.randint(0, 255, shape, np.uint8)
            labs = rs.randint(0, 10, (shape[0],), np.uint8)
            (origin / f"{stem}-images-idx3-ubyte.gz").write_bytes(
                gzip.compress(_idx_bytes(imgs)))
            (origin / f"{stem}-labels-idx1-ubyte.gz").write_bytes(
                gzip.compress(_idx_bytes(labs)))

    def test_mnist_fetch_verify_load(self, tmp_path):
        origin = tmp_path / "origin"
        self._mnist_origin(origin / "mnist")
        srv, base = self._serve(origin)
        try:
            cache = tmp_path / "cache"
            assert prepare.prepare("mnist", str(cache), mirror=base)
            raw = cache / "mnist_data" / "MNIST" / "raw"
            assert sorted(os.listdir(raw)) == sorted(prepare._MNIST_FILES)
            got = readers.load_mnist(str(cache), train=True)
            assert got is not None and len(got[1]) == 64
            # The JAX module lays out the same bytes from the same origin.
            jcache = tmp_path / "jcache"
            assert jprepare.prepare("mnist", str(jcache), mirror=base)
            assert _tree(cache) == _tree(jcache)
        finally:
            srv.shutdown()

    def test_cifar10_fetch_extracts_tar(self, tmp_path):
        import io
        import pickle

        origin = tmp_path / "origin" / "cifar10"
        origin.mkdir(parents=True)
        rs = np.random.RandomState(2)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as t:
            for fname in [f"data_batch_{i}" for i in range(1, 6)] + [
                    "test_batch"]:
                payload = pickle.dumps({
                    "data": rs.randint(0, 255, (8, 3072), np.uint8),
                    "labels": rs.randint(0, 10, (8,)).tolist(),
                })
                info = tarfile.TarInfo(f"cifar-10-batches-py/{fname}")
                info.size = len(payload)
                t.addfile(info, io.BytesIO(payload))
        (origin / "cifar-10-python.tar.gz").write_bytes(buf.getvalue())
        srv, base = self._serve(origin.parent)
        try:
            cache = tmp_path / "cache"
            assert prepare.prepare("cifar10", str(cache), mirror=base)
            got = readers.load_cifar(str(cache), "cifar10", train=True)
            assert got is not None and got[0].shape == (40, 32, 32, 3)
        finally:
            srv.shutdown()

    def test_missing_artifact_reports_not_ready(self, tmp_path):
        origin = tmp_path / "origin" / "mnist"  # only the test split
        origin.mkdir(parents=True)
        (origin / "t10k-images-idx3-ubyte.gz").write_bytes(
            gzip.compress(_idx_bytes(np.zeros((4, 28, 28), np.uint8))))
        (origin / "t10k-labels-idx1-ubyte.gz").write_bytes(
            gzip.compress(_idx_bytes(np.zeros(4, np.uint8))))
        srv, base = self._serve(origin.parent)
        try:
            cache = tmp_path / "cache"
            assert prepare.prepare("mnist", str(cache), mirror=base) is False
            raw = cache / "mnist_data" / "MNIST" / "raw"
            assert not [f for f in os.listdir(raw) if f.endswith(".part")]
        finally:
            srv.shutdown()

    def test_mirror_cli(self, tmp_path):
        origin = tmp_path / "origin"
        self._mnist_origin(origin / "mnist")
        srv, base = self._serve(origin)
        try:
            rc = prepare.main(["--data-dir", str(tmp_path / "cache"),
                               "--datasets", "mnist", "--mirror", base])
            assert rc == 0
        finally:
            srv.shutdown()
