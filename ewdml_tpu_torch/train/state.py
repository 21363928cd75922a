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
                     device, error_feedback: bool = False) -> TrainState:
    """W identical replicas of ``model`` on ``device`` (the JAX package
    tiles one init over the worker axis)."""
    specs = leaf_specs(model)
    workers = []
    for _ in range(num_workers):
        replica = copy.deepcopy(model).to(device)
        params = leaf_params(replica, specs)
        residual = ([torch.zeros(s.jax_shape, dtype=torch.float32, device=device)
                     for s in specs] if error_feedback else [])
        workers.append(WorkerState(replica, optimizer.init(params), residual))
    return TrainState(step=0, workers=workers)
