"""Per-client non-IID shards of a dataset (``ewdml_tpu/data/partition.py``,
numpy only, copied: the port imports nothing of the JAX package).

Each registered client of a federated pool owns a fixed, private shard of
the training split; heterogeneity across shards is the experimental axis
(``--partition`` / ``--partition-alpha``). Three schemes, deterministic
functions of ``(labels, pool_size, seed)``:

- ``iid``: one global shuffle cut into ``pool_size`` near-equal shards;
- ``dirichlet``: for every class, a Dirichlet(``alpha``) draw over the
  clients splits that class's examples (small ``alpha`` concentrates each
  class on few clients);
- ``shard``: sort by label, cut into ``pool_size * shards_per_client``
  contiguous shards and deal ``shards_per_client`` to each client.

The shards are an exact disjoint cover of the dataset and every shard is
non-empty; the draws are the JAX package's, so the shards are bit-equal.
"""

from __future__ import annotations

import numpy as np

PARTITION_SCHEMES = ("iid", "dirichlet", "shard")


def partition_indices(labels: np.ndarray, pool_size: int, scheme: str,
                      seed: int, alpha: float = 0.5,
                      shards_per_client: int = 2) -> list[np.ndarray]:
    """``pool_size`` disjoint index arrays exactly covering ``labels``.

    Deterministic per ``(labels, pool_size, scheme, seed, alpha)`` — the
    per-client data assignment is part of a federated run's replayable
    identity, like the cohort sampler's draws.
    """
    n = int(len(labels))
    pool_size = int(pool_size)
    if pool_size < 1:
        raise ValueError(f"pool_size must be >= 1, got {pool_size}")
    if n < pool_size:
        raise ValueError(
            f"cannot partition {n} examples over a pool of {pool_size} "
            f"clients (every client needs a non-empty shard)")
    if scheme not in PARTITION_SCHEMES:
        raise ValueError(f"unknown partition scheme {scheme!r}; "
                         f"choose from {PARTITION_SCHEMES}")
    rng = np.random.default_rng([int(seed) & 0x7FFFFFFF, 0xFED5, pool_size])
    if scheme == "iid":
        shards = [np.sort(s) for s in
                  np.array_split(rng.permutation(n), pool_size)]
    elif scheme == "dirichlet":
        shards = _dirichlet_shards(np.asarray(labels), pool_size, rng,
                                   float(alpha))
    else:
        shards = _label_shards(np.asarray(labels), pool_size, rng,
                               int(shards_per_client))
    _rebalance_empty(shards, rng)
    assert sum(len(s) for s in shards) == n
    return shards


def _dirichlet_shards(labels, pool_size, rng, alpha):
    """Label-Dirichlet split: per class, proportions ~ Dir(alpha) over
    clients cut that class's shuffled indices (exact cover via cumulative
    rounding — no example dropped or duplicated)."""
    if alpha <= 0:
        raise ValueError(f"--partition-alpha must be > 0, got {alpha}")
    out: list[list] = [[] for _ in range(pool_size)]
    for cls in np.unique(labels):
        idx = rng.permutation(np.flatnonzero(labels == cls))
        props = rng.dirichlet(np.full(pool_size, alpha))
        # Cumulative rounding: split points are round(cumsum * n_cls), so
        # the per-client counts sum to n_cls exactly.
        cuts = np.round(np.cumsum(props) * len(idx)).astype(int)[:-1]
        for client, part in enumerate(np.split(idx, cuts)):
            out[client].append(part)
    return [np.sort(np.concatenate(parts)) if parts else
            np.empty(0, np.int64) for parts in out]


def _label_shards(labels, pool_size, rng, shards_per_client):
    """Sort-by-label shards, ``shards_per_client`` dealt per client."""
    if shards_per_client < 1:
        raise ValueError(
            f"shards_per_client must be >= 1, got {shards_per_client}")
    # Stable sort keeps the within-class order deterministic.
    order = np.argsort(labels, kind="stable")
    n_shards = pool_size * shards_per_client
    if len(labels) < n_shards:
        raise ValueError(
            f"shard partition needs >= {n_shards} examples "
            f"({pool_size} clients x {shards_per_client} shards), "
            f"got {len(labels)}")
    pieces = np.array_split(order, n_shards)
    deal = rng.permutation(n_shards)
    return [np.sort(np.concatenate([pieces[deal[c * shards_per_client + j]]
                                    for j in range(shards_per_client)]))
            for c in range(pool_size)]


def _rebalance_empty(shards: list, rng) -> None:
    """Move one example from the largest shard into any empty one (a
    sufficiently skewed Dirichlet draw can starve a client; every client
    must be trainable when sampled). In place, deterministic."""
    for c, s in enumerate(shards):
        if len(s):
            continue
        donor = int(np.argmax([len(x) for x in shards]))
        take = shards[donor][-1:]
        shards[donor] = shards[donor][:-1]
        shards[c] = np.asarray(take)
    _ = rng  # reserved: a future policy may randomize the donor choice


def label_histogram(labels: np.ndarray, indices: np.ndarray,
                    num_classes: int) -> np.ndarray:
    """Per-class counts of one client's shard — the heterogeneity
    statistic the Dirichlet tests (and the experiments rows) report."""
    return np.bincount(np.asarray(labels)[indices], minlength=num_classes)


def skew_stat(labels: np.ndarray, shards: list, num_classes: int) -> float:
    """Mean over clients of the max label fraction in their shard —
    1/num_classes for a perfectly uniform split, → 1.0 as shards become
    single-label. The one scalar the sweep's heterogeneity axis reports."""
    fracs = []
    for s in shards:
        h = label_histogram(labels, s, num_classes)
        tot = max(1, h.sum())
        fracs.append(h.max() / tot)
    return float(np.mean(fracs))
