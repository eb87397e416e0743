# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Federated data partitioning (numpy only).

* ``partition_iid`` — uniform random split.
* ``partition_noniid`` — sort-and-shard (Zhao et al. / McMahan et al.):
  sort by label, cut into ``shards_per_client * n`` shards, deal each client
  ``shards_per_client`` shards, so each client sees only a few classes.
* ``partition_by_topic`` — the same split over the latent topics of token
  streams, so each client's corpus covers only a few Markov topics.
"""
from __future__ import annotations

from typing import List

import numpy as np


def partition_iid(n_items: int, n_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    order = rng.permutation(n_items)
    return [np.sort(chunk) for chunk in np.array_split(order, n_clients)]


def partition_noniid(labels: np.ndarray, n_clients: int,
                     shards_per_client: int = 2,
                     seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    n_shards = n_clients * shards_per_client
    shards = np.array_split(order, n_shards)
    assignment = rng.permutation(n_shards)
    out = []
    for c in range(n_clients):
        mine = assignment[c * shards_per_client:(c + 1) * shards_per_client]
        out.append(np.sort(np.concatenate([shards[s] for s in mine])))
    return out


def partition_by_topic(topics: np.ndarray, n_clients: int,
                       topics_per_client: int = 2,
                       seed: int = 0) -> List[np.ndarray]:
    """Non-IID token streams: sort documents by topic and deal each client
    ``topics_per_client`` contiguous shards."""
    return partition_noniid(topics, n_clients,
                            shards_per_client=topics_per_client, seed=seed)
