"""The single-device trainer (``ewdml_tpu/train/single.py``; reference
``NN_Trainer``, ``src/nn_ops.py:28-104``): build a model, run train and
validate epochs on one device, no workers and no exchange. It is the
non-distributed baseline and the smallest drive of a model.

Each step is forward, backward and the explicit-gradient SGD of
``optim/sgd.py`` on a host-normalized f32 batch of the JAX package's index
stream (``data/loader.global_batches`` with one worker, seed ``seed +
epoch``); the dropout stream of step ``t`` is seeded from
``step_key(key(seed), t)``, as in the JAX package.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ewdml_tpu_torch.core.world import resolve_device
from ewdml_tpu_torch.data import datasets, loader
from ewdml_tpu_torch.models import build_model, convert, num_classes_for
from ewdml_tpu_torch.optim import make_optimizer
from ewdml_tpu_torch.train.loop import to_device
from ewdml_tpu_torch.train.state import leaf_params
from ewdml_tpu_torch.train.trainer import cross_entropy
from ewdml_tpu_torch.utils import prng

logger = logging.getLogger("ewdml_tpu_torch.single")


@dataclass
class EpochResult:
    epoch: int
    train_loss: float
    val_loss: float
    val_top1: float


class NNTrainer:
    """``NN_Trainer``'s counterpart: ``build_model`` then
    ``train_and_validate``. Runs on CUDA unless ``platform='cpu'`` (or
    ``device``) asks for the CPU; a CUDA trainer without a GPU raises."""

    def __init__(self, network: str = "LeNet", dataset: str = "MNIST",
                 batch_size: int = 128, lr: float = 0.01,
                 momentum: float = 0.9,
                 optimizer: str = "sgd", seed: int = 42,
                 synthetic_data: bool = False, data_dir: str = "data/",
                 platform: str | None = None, device=None):
        self.network, self.dataset = network, dataset
        self.batch_size, self.seed = batch_size, seed
        self.synthetic_data, self.data_dir = synthetic_data, data_dir
        self.device = resolve_device(platform, device)
        self.optimizer = make_optimizer(optimizer, lr, momentum)
        self.build_model()

    def build_model(self):
        self.model = build_model(self.network, num_classes_for(self.dataset),
                                 dataset=self.dataset,
                                 seed=self.seed).to(self.device)
        self.specs = convert.leaf_specs(self.model)
        self.params = leaf_params(self.model, self.specs)
        self.opt_state = self.optimizer.init(self.params)

    def load_flax_state(self, params: dict, batch_stats: dict | None = None):
        """Start from Flax ``params``/``batch_stats`` (numpy nested dicts),
        e.g. the JAX ``NNTrainer``'s."""
        self.model.load_state_dict(
            convert.flax_to_torch(self.model, params, batch_stats))

    def _train_step(self, images, labels, key) -> torch.Tensor:
        self.model.zero_grad(set_to_none=True)
        logits = self.model(images, train=True,
                            generator=prng.generator(key, self.device))
        loss = cross_entropy(logits.float(), labels.long())
        loss.backward()
        self.optimizer.update([p.grad for p in self.params], self.opt_state,
                              self.params)
        return loss.detach()

    def train_and_validate(self, epochs: int = 1,
                           max_steps_per_epoch: int | None = None) -> list:
        """Reference ``train_and_validate`` (``nn_ops.py:47``): per epoch a
        training pass and a full validation; a list of
        :class:`EpochResult`."""
        train_ds = datasets.load(self.dataset, self.data_dir, train=True,
                                 synthetic=self.synthetic_data, seed=self.seed)
        key = prng.key(self.seed)
        results = []
        for epoch in range(epochs):
            batches = loader.global_batches(train_ds, self.batch_size, 1,
                                            seed=self.seed + epoch,
                                            feed="f32")
            steps = len(train_ds) // self.batch_size
            if max_steps_per_epoch:
                steps = min(steps, max_steps_per_epoch)
            losses = []
            for step in range(steps):
                x, y = to_device(*next(batches), self.device)
                losses.append(self._train_step(
                    x, y, prng.step_key(key, epoch * steps + step)))
            train_loss = (float(torch.stack(losses).mean()) if losses
                          else float("nan"))
            val = self.validate()
            results.append(EpochResult(epoch, train_loss, val["loss"],
                                       val["top1"]))
            logger.info("epoch %d: train_loss=%.4f val_loss=%.4f top1=%.4f",
                        epoch, train_loss, val["loss"], val["top1"])
        return results

    @torch.no_grad()
    def validate(self, batch: int = 500) -> dict:
        """Reference ``validate`` (``nn_ops.py:89``): loss and top-1 over
        the test split."""
        ds = datasets.load(self.dataset, self.data_dir, train=False,
                           synthetic=self.synthetic_data, seed=self.seed)
        total, loss_sum, top1_sum = 0, 0.0, 0.0
        for images, labels, mask in loader.eval_batches(ds, batch):
            x, y = to_device(images, labels, self.device)
            logits = self.model(x, train=False).float()
            y = y.long()
            logp = torch.log_softmax(logits, dim=-1)
            loss = -logp.gather(1, y[:, None])[:, 0]
            top1 = (logits.argmax(dim=1) == y).float()
            m = torch.from_numpy(np.asarray(mask, np.float32)).to(self.device)
            loss_sum += float((loss * m).sum())
            top1_sum += float((top1 * m).sum())
            total += int(mask.sum())
        return {"loss": loss_sum / total, "top1": top1_sum / total}
