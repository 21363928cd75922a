"""Train state with an explicit worker axis (``ewdml_tpu/train/state.py``).

The JAX package stacks every state leaf ``[W, ...]`` over the data axis;
here the state is a list with one :class:`WorkerState` per worker: its own
model replica (parameters and BatchNorm statistics), momentum buffers and
error-feedback residual. The fully synchronous methods keep all replicas
equal; Method 6's local phases and per-replica BN statistics let them
differ, as in the JAX package.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch

from ewdml_tpu_torch.models.convert import leaf_specs
from ewdml_tpu_torch.optim import AdamState


@dataclass
class WorkerState:
    model: torch.nn.Module
    opt_state: object
    # Error-feedback residual in JAX leaf order and layout; [] unless EF.
    residual: list = field(default_factory=list)


@dataclass
class TrainState:
    step: int
    workers: list


def leaf_params(model: torch.nn.Module, specs=None) -> list:
    """The model's parameters in the JAX tree's leaf order."""
    specs = specs or leaf_specs(model)
    named = dict(model.named_parameters())
    return [named[s.torch_name] for s in specs]


def make_train_state(model: torch.nn.Module, optimizer, num_workers: int,
                     device, error_feedback: bool = False,
                     residual_dtype=None) -> TrainState:
    """``num_workers`` identical replicas of ``model`` on ``device`` (the
    JAX package tiles one init over the worker axis): all W, or a
    process's L local workers, ``model`` being the same seed-deterministic
    init on every process. ``residual_dtype`` stores the
    error-feedback residuals at the precision policy's wire dtype
    (``state.py:53-82``; default f32)."""
    specs = leaf_specs(model)
    workers = []
    dtype = residual_dtype or torch.float32
    for _ in range(num_workers):
        replica = copy.deepcopy(model).to(device)
        params = leaf_params(replica, specs)
        residual = ([torch.zeros(s.jax_shape, dtype=dtype, device=device)
                     for s in specs] if error_feedback else [])
        workers.append(WorkerState(replica, optimizer.init(params), residual))
    return TrainState(step=0, workers=workers)


# -- the Flax state dict of WorkerState (the checkpoint's "worker" tree) ------

def _nested(pairs) -> dict:
    """A nested dict from ``(Flax path, value)`` pairs, every level's keys
    in sorted order (the order ``jax.tree`` gives a dict, and so the order
    of a JAX checkpoint's maps)."""
    out: dict = {}
    for path, value in sorted(pairs, key=lambda kv: tuple(kv[0].split("/"))):
        *parents, leaf = path.split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def _flat(tree: dict, prefix: str = "") -> dict:
    """``{Flax path: leaf}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _stat_buffers(model: torch.nn.Module) -> list:
    from ewdml_tpu_torch.models.convert import _stat_paths

    buffers = dict(model.named_buffers())
    return [(path, buffers[name]) for name, path in _stat_paths(model)]


def state_tree(workers: list, specs=None, stacked: bool = False,
               leaf=None) -> dict:
    """The Flax state dict of the JAX package's ``WorkerState`` for
    ``workers``: ``params``, ``opt_state`` (``SGDState``: ``momentum_buf``
    and ``initialized``; ``AdamState``: ``count``, ``mu`` and ``nu``),
    ``batch_stats`` and ``residual`` (``{}`` without error feedback), in
    Flax paths and layouts. ``stacked`` gives every
    leaf a leading ``[W]`` axis (a full checkpoint); otherwise the tree is
    worker 0's. ``leaf(tensors)`` turns the W workers' tensors of one leaf
    into the tree's leaf (default: worker 0's, or their stack)."""
    from ewdml_tpu_torch.models.convert import to_jax

    model0 = workers[0].model
    specs = specs or leaf_specs(model0)
    if leaf is None:
        leaf = torch.stack if stacked else (lambda ts: ts[0])

    def per_spec(get):
        lists = [get(ws) for ws in workers]
        return _nested((s.name, leaf([to_jax(ts[i], s.kind) for ts in lists]))
                       for i, s in enumerate(specs))

    params = per_spec(lambda ws: leaf_params(ws.model, specs))
    if isinstance(workers[0].opt_state, AdamState):
        opt_state = {"count": leaf([ws.opt_state.count for ws in workers]),
                     "mu": per_spec(lambda ws: ws.opt_state.mu),
                     "nu": per_spec(lambda ws: ws.opt_state.nu)}
    else:
        opt_state = {
            "momentum_buf": per_spec(lambda ws: ws.opt_state.momentum_buf),
            "initialized": leaf([torch.tensor(bool(ws.opt_state.initialized))
                                 for ws in workers])}
    stats = [_stat_buffers(ws.model) for ws in workers]
    batch_stats = _nested((path, leaf([s[j][1] for s in stats]))
                          for j, (path, _) in enumerate(stats[0]))
    residual = ({} if not workers[0].residual else
                _nested((s.name, leaf([ws.residual[i] for ws in workers]))
                        for i, s in enumerate(specs)))
    return {"params": params, "opt_state": opt_state,
            "batch_stats": batch_stats, "residual": residual}


def state_template(workers: list, specs=None, stacked: bool = False,
                   size: int | None = None) -> dict:
    """:func:`state_tree`'s shapes and dtypes as ``meta`` tensors (no
    memory): the template ``train/checkpoint.restore`` reconciles against.
    ``size`` is the stacked axis's length (default: one row a worker; the
    world's W where ``workers`` are a process's L)."""
    def meta(ts):
        t = ts[0]
        shape = ((size or len(ts),) if stacked else ()) + tuple(t.shape)
        return torch.empty(shape, dtype=t.dtype, device="meta")

    return state_tree(workers, specs, leaf=meta)


@torch.no_grad()
def load_state_tree(workers: list, tree: dict, specs=None,
                    stacked: bool = False, rows=None) -> None:
    """Copy a worker tree into ``workers``' own tensors, in place: the
    parameters, momentum buffers, BatchNorm statistics and residuals keep
    their storage (a CUDA graph captured before reads the loaded values).
    ``stacked``: the tree's leaves are ``[W, ...]``, the j-th worker takes
    row ``rows[j]`` (default j: a process's workers pass their global
    ranks); otherwise every worker takes the same leaf. ``meta`` leaves
    (fields the blob did not hold) leave the worker's value as it is."""
    from ewdml_tpu_torch.models.convert import from_jax

    specs = specs or leaf_specs(workers[0].model)
    rows = list(range(len(workers)) if rows is None else rows)

    def row(t, w):
        return t[rows[w]] if stacked else t

    def put(dst, src, w, kind="vector"):
        if src.device.type != "meta":
            dst.copy_(from_jax(row(src, w), kind))

    params = _flat(tree["params"])
    opt = tree["opt_state"]
    adam = isinstance(workers[0].opt_state, AdamState)
    bufs = ({k: _flat(opt[k]) for k in ("mu", "nu")} if adam
            else {"momentum_buf": _flat(opt["momentum_buf"])})
    stats = _flat(tree["batch_stats"])
    residual = _flat(tree["residual"])
    for w, ws in enumerate(workers):
        for i, (p, s) in enumerate(zip(leaf_params(ws.model, specs), specs)):
            put(p, params[s.name], w, s.kind)
            for k, flat in bufs.items():
                put(getattr(ws.opt_state, k)[i], flat[s.name], w, s.kind)
            if ws.residual:
                put(ws.residual[i], residual[s.name], w)
        if adam:
            put(ws.opt_state.count, opt["count"], w)
        elif opt["initialized"].device.type != "meta":
            ws.opt_state.initialized = bool(row(opt["initialized"], w))
        for path, buf in _stat_buffers(ws.model):
            put(buf, stats[path], w)
