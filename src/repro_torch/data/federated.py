# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Federated data partitioning (numpy only).

* ``partition_iid`` — uniform random split.
* ``partition_noniid`` — sort-and-shard (Zhao et al. / McMahan et al.):
  sort by label, cut into ``shards_per_client * n`` shards, deal each client
  ``shards_per_client`` shards, so each client sees only a few classes.
* ``partition_by_topic`` — the same split over the latent topics of token
  streams, so each client's corpus covers only a few Markov topics.

Every partition has a ``*_lazy`` twin that is index-for-index equal but
stores O(1) shared state instead of ``n_clients`` index arrays: a client's
indices are materialized (``np.asarray``) only when the engines draw its
batches, so a population-scale run holds no per-client copy.
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


def _split_bounds(n: int, k: int) -> np.ndarray:
    """Chunk boundaries of ``np.array_split(range(n), k)``: the first
    ``n % k`` chunks get one extra item.  BOTH lazy partitions derive their
    slices from this, so eager/lazy index-equality rests on one formula."""
    sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
    return np.concatenate([[0], np.cumsum(sizes)])


class _LazyView:
    """One client's sorted index slice, materialized on demand.

    Behaves like an ndarray wherever the adapters need one (``len`` for the
    replacement decision, ``np.asarray`` for the actual draw) without
    holding a per-client copy.
    """

    __slots__ = ("_perm", "_lo", "_hi")

    def __init__(self, perm: np.ndarray, lo: int, hi: int):
        self._perm, self._lo, self._hi = perm, lo, hi

    def __len__(self) -> int:
        return self._hi - self._lo

    def __array__(self, dtype=None, copy=None):
        out = np.sort(self._perm[self._lo:self._hi])
        return out.astype(dtype) if dtype is not None else out


class LazyParts:
    """List-like IID partition over ``n_clients`` that stores ONE shared
    permutation instead of ``n_clients`` index arrays.

    Produces exactly the same per-client indices as :func:`partition_iid`
    for the same seed (same permutation, same ``array_split`` boundaries),
    so population-scale engines can swap it in without changing draws.
    """

    def __init__(self, perm: np.ndarray, n_clients: int):
        self._perm = perm
        self._bounds = _split_bounds(len(perm), n_clients)

    def __len__(self) -> int:
        return len(self._bounds) - 1

    def __getitem__(self, i: int) -> _LazyView:
        if i < 0:
            i += len(self)
        return _LazyView(self._perm, int(self._bounds[i]),
                         int(self._bounds[i + 1]))


def partition_iid_lazy(n_items: int, n_clients: int,
                       seed: int = 0) -> LazyParts:
    """IID split that never materializes per-client arrays (N=4096-scale
    populations); index-for-index equal to :func:`partition_iid`."""
    rng = np.random.default_rng(seed)
    return LazyParts(rng.permutation(n_items), n_clients)


class _LazyShardView:
    """One client's dealt shards, materialized (sorted + concatenated) on
    demand — the non-IID counterpart of :class:`_LazyView`."""

    __slots__ = ("_order", "_bounds", "_shards")

    def __init__(self, order: np.ndarray, bounds: np.ndarray,
                 shards: np.ndarray):
        self._order, self._bounds, self._shards = order, bounds, shards

    def __len__(self) -> int:
        return int(sum(self._bounds[s + 1] - self._bounds[s]
                       for s in self._shards))

    def __array__(self, dtype=None, copy=None):
        out = np.sort(np.concatenate(
            [self._order[self._bounds[s]:self._bounds[s + 1]]
             for s in self._shards]))
        return out.astype(dtype) if dtype is not None else out


class LazyShardParts:
    """List-like sort-and-shard partition that stores ONE label ordering +
    ONE shard assignment instead of ``n_clients`` index arrays.

    Index-for-index equal to :func:`partition_noniid` for the same seed:
    the same stable argsort, the same ``array_split`` shard boundaries, the
    same permuted deal — only the per-client concatenation is deferred to
    the clients actually sampled into a cohort.
    """

    def __init__(self, order: np.ndarray, n_clients: int,
                 shards_per_client: int, assignment: np.ndarray):
        self._order = order
        self._spc = shards_per_client
        self._assignment = assignment
        self._bounds = _split_bounds(len(order),
                                     n_clients * shards_per_client)
        self._n_clients = n_clients

    def __len__(self) -> int:
        return self._n_clients

    def __getitem__(self, c: int) -> _LazyShardView:
        if c < 0:
            c += len(self)
        # the end of the sequence, so iteration stops after the last client
        if not 0 <= c < len(self):
            raise IndexError(f"client {c} of {len(self)}")
        mine = self._assignment[c * self._spc:(c + 1) * self._spc]
        return _LazyShardView(self._order, self._bounds, mine)


def partition_noniid_lazy(labels: np.ndarray, n_clients: int,
                          shards_per_client: int = 2,
                          seed: int = 0) -> LazyShardParts:
    """Sort-and-shard non-IID split without materializing per-client index
    arrays; index-for-index equal to :func:`partition_noniid`."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    assignment = rng.permutation(n_clients * shards_per_client)
    return LazyShardParts(order, n_clients, shards_per_client, assignment)


def partition_by_topic_lazy(topics: np.ndarray, n_clients: int,
                            topics_per_client: int = 2,
                            seed: int = 0) -> LazyShardParts:
    """Lazy variant of :func:`partition_by_topic` (same deal, deferred
    materialization) for population-scale federated LM streams."""
    return partition_noniid_lazy(topics, n_clients,
                                 shards_per_client=topics_per_client,
                                 seed=seed)


def label_distribution(labels: np.ndarray, parts: List[np.ndarray],
                       num_classes: int) -> np.ndarray:
    """(clients, classes) histogram — used to verify Non-IID skew in tests."""
    return np.stack([np.bincount(labels[p], minlength=num_classes)
                     for p in parts])
