"""Durable state plane for the parameter server
(``ewdml_tpu/parallel/server_state.py``, copied: the port imports nothing
of the JAX package, and the files are the same byte for byte, so a
directory written by either package recovers in the other).

A spot preemption SIGKILLs the PS process with no warning; everything the
server holds in RAM — params + version, optimizer state, the homomorphic
scale contract, policy membership, the federated round position — dies with
it. This module is the disk half of the recovery story:

- **Snapshot**: one self-contained file, written atomically (tmp → flush →
  ``fsync`` → ``os.replace`` → directory ``fsync`` — the checkpoint tmp/replace
  idiom *plus* the fsyncs a preemption actually requires). Layout is a fixed
  header (magic + meta length), a JSON meta dict (version, plan_version,
  scale CRC, policy/fed state, applied push-ids), then an opaque msgpack blob
  (params / opt state / delta shadow; flax's ``to_bytes`` layout, written by
  ``utils/msgpack.py``). A CRC over the blob makes a corrupt
  snapshot fail loudly instead of silently training from garbage.
- **WAL**: a JSONL journal of applied-batch records between snapshots, one
  fsync'd line per apply (``json.dumps(sort_keys=True)``, flush,
  ``os.fsync``), with a torn-tail-tolerant reader: a record half-written at the kill is
  dropped, never mis-parsed. The WAL is rotated (truncated) after each
  successful snapshot, so replay work after a kill is bounded by the snapshot
  cadence.

Crash-ordering contract: the snapshot is replaced atomically FIRST, then the
WAL is truncated. A kill between the two leaves WAL records the snapshot
already subsumes — replay skips records with ``version <= snapshot.version``,
so the window is harmless. Recovery therefore loses at most the single
in-flight apply whose WAL record had not reached disk.

The store itself is lock-free: every call happens on the server's apply path
under ``_update_lock`` (journal/snapshot ordering must be serial with
applies), which the callers in ``parallel/ps.py`` annotate.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import struct
import zlib
from typing import Optional

import numpy as np

logger = logging.getLogger("ewdml_tpu_torch.server_state")

#: Snapshot container header: magic + little-endian meta length.
_MAGIC = b"EWSS"
_HDR = struct.Struct("<4sQ")

SNAPSHOT_NAME = "snapshot.bin"
WAL_NAME = "wal.jsonl"


def encode_bufs(bufs) -> list:
    """uint8 payload buffers -> base64 strings (JSON-safe WAL form)."""
    return [base64.b64encode(np.asarray(b, dtype=np.uint8).tobytes())
            .decode("ascii") for b in bufs]


def decode_bufs(encoded) -> list:
    """Inverse of :func:`encode_bufs` (WAL replay)."""
    return [np.frombuffer(base64.b64decode(s), dtype=np.uint8)
            for s in encoded]


class ServerStateStore:
    """Snapshot + WAL persistence rooted at one ``--server-state-dir``."""

    def __init__(self, state_dir: str):
        self.dir = str(state_dir)
        os.makedirs(self.dir, exist_ok=True)
        self._wal_f = None

    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.dir, SNAPSHOT_NAME)

    @property
    def wal_path(self) -> str:
        return os.path.join(self.dir, WAL_NAME)

    # -- snapshot plane ----------------------------------------------------

    def write_snapshot(self, meta: dict, blob: bytes) -> None:
        """Atomically replace the snapshot with (``meta``, ``blob``).

        Durability order: write+fsync the tmp file, ``os.replace`` it over
        the live name, fsync the directory (the rename itself must survive
        the kill), THEN rotate the WAL — see the module docstring for why
        this order is the safe one.
        """
        meta = dict(meta)
        meta["blob_crc"] = zlib.crc32(blob) & 0xFFFFFFFF
        meta_json = json.dumps(meta, sort_keys=True).encode("utf-8")
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_HDR.pack(_MAGIC, len(meta_json)))
            f.write(meta_json)
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snapshot_path)
        self._fsync_dir()
        self.rotate_wal()

    def load_snapshot(self) -> Optional[tuple]:
        """``(meta, blob)`` of the live snapshot, or None when absent.

        Raises ``ValueError`` on a corrupt container (bad magic / CRC) —
        recovering from garbage must fail loudly, not train from it.
        """
        path = self.snapshot_path
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < _HDR.size:
            raise ValueError(f"snapshot {path!r}: truncated header")
        magic, meta_len = _HDR.unpack_from(data)
        if magic != _MAGIC:
            raise ValueError(f"snapshot {path!r}: bad magic {magic!r}")
        meta_end = _HDR.size + meta_len
        if len(data) < meta_end:
            raise ValueError(f"snapshot {path!r}: truncated meta")
        meta = json.loads(data[_HDR.size:meta_end].decode("utf-8"))
        blob = data[meta_end:]
        if (zlib.crc32(blob) & 0xFFFFFFFF) != meta.get("blob_crc"):
            raise ValueError(f"snapshot {path!r}: blob CRC mismatch")
        return meta, blob

    def peek_meta(self) -> Optional[dict]:
        """Snapshot meta only (no blob validation cost beyond the read)."""
        snap = self.load_snapshot()
        return None if snap is None else snap[0]

    def _fsync_dir(self) -> None:
        fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    # -- WAL plane ---------------------------------------------------------

    def _wal(self):
        if self._wal_f is None or self._wal_f.closed:
            self._wal_f = open(self.wal_path, "a", encoding="utf-8")
        return self._wal_f

    def append_wal(self, record: dict) -> None:
        """Journal one applied-batch record; durable when the call returns."""
        f = self._wal()
        f.write(json.dumps(record, sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())

    def rotate_wal(self) -> None:
        """Truncate the WAL — the snapshot now subsumes every journaled
        apply (only ever called right after a successful snapshot)."""
        if self._wal_f is not None and not self._wal_f.closed:
            self._wal_f.close()
        self._wal_f = open(self.wal_path, "w", encoding="utf-8")
        self._wal_f.flush()
        os.fsync(self._wal_f.fileno())

    def read_wal(self) -> list:
        """All intact WAL records in journal order; a torn tail (the record
        in flight at the kill) is dropped, and anything after the first
        undecodable line is ignored — the journal is append-only, so a
        broken line can only be the end."""
        if not os.path.exists(self.wal_path):
            return []
        out = []
        with open(self.wal_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    break
        return out

    def close(self) -> None:
        if self._wal_f is not None and not self._wal_f.closed:
            self._wal_f.close()
