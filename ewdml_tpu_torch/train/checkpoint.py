"""Checkpoint save and restore (``ewdml_tpu/train/checkpoint.py``).

The file is the JAX package's, byte for byte: ``{"step", "world",
"worker"}`` in flax's msgpack (``utils/msgpack.py``), ``worker`` the Flax
state dict of ``WorkerState`` (``train/state.state_tree``), at the
reference's constant name ``train_dir + "model_step_"``. So a checkpoint
written by either package restores in the other.

- The write is atomic (a temporary file, then a rename), so a polling
  evaluator never reads a torn file.
- ``world >= 1`` is a full checkpoint: every leaf has a leading ``[W]``
  axis (Method 6's local phases, per-replica BatchNorm statistics and
  error-feedback residuals survive a resume). ``world == 0`` is the
  collapsed single-worker view.
"""

from __future__ import annotations

import logging
import mmap
import os
import tempfile

import torch

from ewdml_tpu_torch.utils.msgpack import (Reader, dtype_name, pack_into,
                                           unpackb)

logger = logging.getLogger("ewdml_tpu_torch.checkpoint")

CKPT_BASENAME = "model_step_"  # the reference's constant filename


def save(train_dir: str, worker_tree: dict, step: int = 0,
         world: int = 0) -> str:
    """Write a checkpoint of ``worker_tree`` (nested dicts of tensors, on
    any device) at global ``step`` into ``train_dir/model_step_``.
    ``world`` as in the module docstring."""
    os.makedirs(train_dir, exist_ok=True)
    path = os.path.join(train_dir, CKPT_BASENAME)
    chunks: list = []
    pack_into({"step": int(step), "world": int(world),
                       "worker": worker_tree}, chunks)
    # A temporary name of this writer's own: two processes saving into one
    # directory never write the same temporary file.
    fd, tmp = tempfile.mkstemp(prefix=CKPT_BASENAME + ".", suffix=".tmp", dir=train_dir)
    try:
        os.fchmod(fd, 0o644)  # mkstemp's 0600 would hide it from a reader
        with os.fdopen(fd, "wb") as f:
            f.writelines(chunks)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _read(path: str) -> dict:
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"checkpoint {path} changed while it was read")
    raw = unpackb(buf)
    if not isinstance(raw, dict):
        raise ValueError(f"checkpoint {path} is not a msgpack map")
    return raw


def _policy_pair(d: torch.dtype) -> bool:
    return d in (torch.float32, torch.bfloat16)


def _reconcile(tmpl, got, prefix: str = ""):
    if not isinstance(tmpl, dict):
        # A leaf must match what the model expects; the only adaptations
        # are across the leading worker axis and the precision policy's
        # f32 <-> bf16 pair on the optimizer state and the residuals.
        if not isinstance(got, torch.Tensor):
            raise ValueError(f"checkpoint field {prefix!r} is not an array")
        g = got
        if tmpl.dtype != g.dtype:
            policy_leaf = prefix.startswith(("opt_state/", "residual/"))
            if policy_leaf and _policy_pair(tmpl.dtype) \
                    and _policy_pair(g.dtype):
                logger.warning("checkpoint field %s restored %s -> %s "
                               "(--precision-policy changed since save?)",
                               prefix, g.dtype, tmpl.dtype)
                g = g.to(tmpl.dtype)
            else:
                raise ValueError(
                    f"checkpoint field {prefix!r} has dtype "
                    f"{dtype_name(g.dtype)} but the model expects "
                    f"{dtype_name(tmpl.dtype)} — wrong "
                    "--network/optimizer for this train_dir?")
        t_shape, g_shape = tuple(tmpl.shape), tuple(g.shape)
        if t_shape == g_shape:
            return g
        if len(g_shape) == len(t_shape) + 1 and g_shape[1:] == t_shape:
            return g[0]  # full blob -> one-worker template: worker 0
        if len(t_shape) == len(g_shape) + 1 and t_shape[1:] == g_shape:
            return g.expand(t_shape)  # collapsed blob -> every worker
        raise ValueError(
            f"checkpoint field {prefix!r} has shape {g_shape} but the model "
            f"expects {t_shape} — wrong --network/optimizer/--num-workers "
            "for this train_dir?")
    got = got if isinstance(got, dict) else {}
    out = {}
    for k, v in tmpl.items():
        if k in got:
            out[k] = _reconcile(v, got[k], f"{prefix}{k}/")
        else:
            logger.warning("checkpoint missing %s%s; keeping the template's "
                           "value (schema added a field?)", prefix, k)
            out[k] = v
    for k in got:
        if k not in tmpl:
            logger.warning("checkpoint field %s%s not in current schema; "
                           "dropped", prefix, k)
    return out


def restore(path: str, template: dict):
    """Load ``(worker_tree, step, world)`` against ``template``, a worker
    tree of the shape the caller holds (leaves may be ``meta`` tensors:
    only their shape and dtype are read).

    - A field of the template missing from the blob keeps the template's
      leaf; a field of the blob missing from the template is dropped.
    - A full ``[W, ...]`` blob restored into a one-worker template gives
      worker 0's slice; a collapsed blob restored into a stacked template is
      broadcast to every worker (an ``expand`` view).
    - A shape or dtype mismatch raises, except f32 <-> bf16 under
      ``opt_state/`` and ``residual/`` (cast, with a warning).

    The leaves returned from the blob are CPU tensors. ``world`` is the
    worker count recorded at save time (0 for a collapsed blob)."""
    raw = _read(path)
    worker = _reconcile(template, raw.get("worker", {}))
    return worker, int(raw.get("step", 0)), int(raw.get("world", 0))


def peek_step(path: str) -> int:
    """The global step recorded in a checkpoint, read without a template
    and without reading the worker tree (``save`` writes ``step`` first)."""
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        reader = Reader(mm, arrays=False)
        try:
            for _ in range(reader.map_len()):
                if reader.value() == "step":
                    return int(reader.value())
                reader.value()
            return 0
        finally:
            reader.release()


def latest_path(train_dir: str) -> str | None:
    """The constant-name checkpoint if present, else the highest-step one."""
    const = os.path.join(train_dir, CKPT_BASENAME)
    if os.path.isfile(const):
        return const
    if not os.path.isdir(train_dir):
        return None
    steps = []
    for fn in os.listdir(train_dir):
        suffix = fn[len(CKPT_BASENAME):]
        if fn.startswith(CKPT_BASENAME) and suffix.isdigit():
            steps.append(int(suffix))
    if not steps:
        return None
    return os.path.join(train_dir, CKPT_BASENAME + str(max(steps)))
