# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Heterogeneous model aggregation (Section VI.B, Eq. 10) + variants.

* ``alpha_weighted`` (paper): client n is weighted alpha_n = r_n / sum(r_m),
  r_n = its selected-neuron ratio.
* ``masked_mean``: per-COORDINATE weighted mean over the clients that
  trained each coordinate; coordinates nobody trained keep the global value.
* ``uniform``: plain FedAvg (the Syn. FL baseline).
* :func:`mix`: the async schemes' per-event mixing, discounted by
  :func:`staleness_weight` under afo.
* the stacked variants (``*_stacked``): client params with a leading client
  axis, one reduction per leaf; :func:`mix_bucket` / :func:`mix_bucket_ring`
  fold a bucket of async events in event order, the latter snapshotting
  every intermediate global into a :class:`SnapshotRing` row, whose slots
  :class:`RingAllocator` manages on the host.

Parameters are dicts of tensors, flat (CNN) or nested (LM); sums run in
float32 in client order, leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.module import tree_leaves, tree_map

Params = Dict[str, Any]


def alpha_weights(ratios: Sequence, device=None) -> torch.Tensor:
    """r_n / sum(r_m) in float32; ``ratios`` a sequence of scalars or a
    (C,) tensor."""
    r = ratios.float() if torch.is_tensor(ratios) else torch.stack(
        [torch.as_tensor(x, dtype=torch.float32, device=device)
         for x in ratios])
    return r / torch.clamp(r.sum(), min=1e-9)


def _device(params: Params):
    return tree_leaves(params)[0].device


def aggregate_alpha(global_params: Params, client_params: Sequence[Params],
                    ratios: Sequence) -> Params:
    """Eq. 10: theta = sum_n alpha_n theta_n."""
    a = alpha_weights(ratios, _device(global_params))

    def leaf(g, *cps):
        acc = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for i, cp in enumerate(cps):
            acc = acc + a[i] * cp.float()
        return acc.to(g.dtype)

    return tree_map(leaf, global_params, *client_params)


def aggregate_masked_mean(global_params: Params,
                          client_params: Sequence[Params],
                          client_masks: Sequence[Params],
                          ratios: Optional[Sequence] = None) -> Params:
    """Per-coordinate mean over the clients whose mask covers the coordinate,
    alpha-weighted within the covered set when ``ratios`` is given."""
    n = len(client_params)
    dev = _device(global_params)
    a = alpha_weights(ratios, dev) if ratios is not None else \
        torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)

    def leaf(g, *rest):
        cps, ms = rest[:n], rest[n:]
        num = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        den = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for i in range(n):
            num = num + a[i] * ms[i] * cps[i].float()
            den = den + a[i] * ms[i]
        return torch.where(den > 0, num / torch.clamp(den, min=1e-9),
                           g.float()).to(g.dtype)

    return tree_map(leaf, global_params, *client_params, *client_masks)


def aggregate_uniform(global_params: Params,
                      client_params: Sequence[Params]) -> Params:
    return aggregate_alpha(global_params, client_params,
                           [1.0] * len(client_params))


def aggregate(cfg_mode: str, global_params: Params,
              client_params: Sequence[Params], ratios=None,
              client_masks=None) -> Params:
    if cfg_mode == "alpha_weighted":
        return aggregate_alpha(global_params, client_params, ratios)
    if cfg_mode == "masked_mean":
        return aggregate_masked_mean(global_params, client_params,
                                     client_masks, ratios)
    if cfg_mode == "uniform":
        return aggregate_uniform(global_params, client_params)
    raise ValueError(cfg_mode)


def staleness_weight(staleness: int, a: float = 0.5) -> float:
    """AFO (Xie et al. 2019) polynomial staleness discount (t - tau + 1)^-a,
    a host float."""
    return float((staleness + 1.0) ** (-a))


def mix(global_params: Params, client_params: Params,
        weight: float) -> Params:
    """Async mixing: theta <- (1-w) theta + w theta_client in float32, cast
    back to the global's dtype.  Builds new tensors: the async loop keeps
    earlier globals by reference as its snapshots, so an in-place update
    here would move a straggler's base."""
    return tree_map(
        lambda g, c: ((1 - weight) * g.float()
                      + weight * c.float()).to(g.dtype),
        global_params, client_params)


# ---------------------------------------------------------------------------
# stacked (batched-client) variants: client param leaves carry a leading
# client axis (C, ...)
# ---------------------------------------------------------------------------


def aggregate_alpha_stacked(global_params: Params, stacked_params: Params,
                            ratios: torch.Tensor) -> Params:
    """Eq. 10 over a stacked client axis.  ratios: (C,) selected fractions."""
    a = alpha_weights(ratios)
    return tree_map(lambda g, t: torch.tensordot(a, t.float(), dims=1)
                    .to(g.dtype), global_params, stacked_params)


def aggregate_uniform_stacked(global_params: Params,
                              stacked_params: Params) -> Params:
    t = tree_leaves(stacked_params)[0]
    return aggregate_alpha_stacked(global_params, stacked_params,
                                   torch.ones(t.shape[0], device=t.device))


def aggregate_masked_mean_stacked(global_params: Params,
                                  stacked_params: Params,
                                  stacked_masks: Params,
                                  ratios: Optional[torch.Tensor] = None
                                  ) -> Params:
    """Per-coordinate weighted mean over the stacked client axis.
    stacked_masks: params-shaped 0/1 trees with leaves (C,) + param.shape
    (``masking.cnn_expand_masks_batch``)."""
    t0 = tree_leaves(stacked_params)[0]
    n = t0.shape[0]
    a = alpha_weights(ratios) if ratios is not None else \
        torch.full((n,), 1.0 / n, dtype=torch.float32, device=t0.device)

    def leaf(g, m, t):
        w = a.reshape((n,) + (1,) * g.dim())
        num = (w * m * t.float()).sum(dim=0)
        den = (w * m).sum(dim=0)
        return torch.where(den > 0, num / torch.clamp(den, min=1e-9),
                           g.float()).to(g.dtype)

    return tree_map(leaf, global_params, stacked_masks, stacked_params)


def aggregate_stacked(cfg_mode: str, global_params: Params,
                      stacked_params: Params, ratios=None,
                      stacked_masks=None) -> Params:
    if cfg_mode == "alpha_weighted":
        return aggregate_alpha_stacked(global_params, stacked_params, ratios)
    if cfg_mode == "masked_mean":
        return aggregate_masked_mean_stacked(global_params, stacked_params,
                                             stacked_masks, ratios)
    if cfg_mode == "uniform":
        return aggregate_uniform_stacked(global_params, stacked_params)
    raise ValueError(cfg_mode)


def staleness_weights(staleness: torch.Tensor, a: float = 0.5
                      ) -> torch.Tensor:
    """:func:`staleness_weight` over a (B,) tensor of staleness counts, in
    float32 on its device."""
    return (staleness.float() + 1.0) ** (-a)


def _mix_leaf(g: torch.Tensor, p: torch.Tensor, w: torch.Tensor):
    return ((1 - w) * g.float() + w * p.float()).to(g.dtype)


def mix_bucket(global_params: Params, stacked_params: Params,
               weights: torch.Tensor) -> Params:
    """:func:`mix` of a bucket's client params into the global, one event
    after another: ``stacked_params`` leaves carry a leading (B,) event
    axis, ``weights`` the (B,) per-event weights (0 leaves the global as
    it is)."""
    g = global_params
    for i in range(weights.shape[0]):
        g = tree_map(lambda gg, pp: _mix_leaf(gg, pp[i], weights[i]), g,
                     stacked_params)
    return g


def mix_bucket_ring(global_params: Params, ring_params: Params,
                    slots: Sequence[int], stacked_params: Params,
                    weights: torch.Tensor):
    """:func:`mix_bucket` that also writes each event's post-mix global into
    ring row ``slots[i]`` (a :class:`SnapshotRing`'s rows, updated in
    place).  A padding event (weight 0) points at the ring's scratch row.
    Returns (global, ring_params)."""
    g = global_params
    for i, s in enumerate(slots):
        g = tree_map(lambda gg, pp: _mix_leaf(gg, pp[i], weights[i]), g,
                     stacked_params)
        tree_map(lambda r, gg: r[s].copy_(gg), ring_params, g)
    return g, ring_params


# ---------------------------------------------------------------------------
# snapshot ring buffer (bucketed async engine)
# ---------------------------------------------------------------------------


class RingAllocator:
    """Anchor-aware slot allocator for a fixed ring of snapshot rows.

    Host-side bookkeeping only (the rows live in :class:`SnapshotRing`).
    Each snapshot is identified by its aggregation id (the global mix
    counter at creation); clients anchor the id they last pulled from via
    retain / release refcounts.  Allocation reuses the oldest slot with
    refcount 0, so a live anchor is never evicted.  The last slot is the
    scratch row padding events write to.
    """

    def __init__(self, slots: int):
        if slots < 2:
            raise ValueError("RingAllocator needs at least one data slot "
                             "and the scratch slot")
        self.slots = slots
        self._slot_agg = np.full(slots, -1, np.int64)
        self._refcnt = np.zeros(slots, np.int64)
        self._agg_slot: Dict[int, int] = {}
        self.anchor_misses = 0
        self.peak_live = 0

    @property
    def scratch(self) -> int:
        return self.slots - 1

    def seed(self, agg: int, slot: int = 0) -> None:
        """Install the initial snapshot id into a slot."""
        self._slot_agg[slot] = agg
        self._agg_slot[agg] = slot

    def slot_of(self, agg: int) -> int:
        s = self._agg_slot.get(agg)
        if s is None:
            self.anchor_misses += 1
            raise KeyError(f"snapshot {agg} evicted while still anchored")
        return s

    def retain(self, agg: int) -> None:
        self._refcnt[self.slot_of(agg)] += 1
        self.peak_live = max(self.peak_live,
                             int(np.count_nonzero(self._refcnt)))

    def release(self, agg: int) -> None:
        s = self.slot_of(agg)
        if self._refcnt[s] <= 0:
            raise RuntimeError(f"release of unanchored snapshot {agg}")
        self._refcnt[s] -= 1

    def alloc(self, agg: int) -> int:
        """Slot for a new snapshot ``agg``: the oldest unanchored data slot
        (never scratch, never a slot some client still reads through)."""
        free = np.where(self._refcnt[:-1] == 0)[0]
        if free.size == 0:
            raise RuntimeError(
                f"snapshot ring full: all {self.slots - 1} data slots are "
                "anchored (ring must be sized >= live anchors + 1)")
        s = int(free[np.argmin(self._slot_agg[free])])
        old = int(self._slot_agg[s])
        if old >= 0:
            del self._agg_slot[old]
        self._slot_agg[s] = agg
        self._agg_slot[agg] = s
        return s

    def live_slots(self) -> int:
        return int(np.count_nonzero(self._refcnt))


class SnapshotRing:
    """Device-side stacked snapshot store of the bucketed async engine and
    of the delayed scheme's stale globals (:meth:`put`), in full precision (the reference's ``mode="fp32"``; its lossy modes are
    not ported).

    ``params`` is one tree whose leaves carry a leading (slots,) axis: row
    r holds the global params as of some aggregation step.  Capacity is
    ``max(cap, anchors + 1)`` data slots + 1 scratch, so the store is
    bounded as the sequential loop's snapshot dict is (cap + live anchors).
    """

    def __init__(self, params: Params, cap: int, n_anchors: int):
        self.alloc = RingAllocator(max(cap, n_anchors + 1) + 1)
        slots = self.alloc.slots

        def rows(x):
            r = torch.zeros((slots,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device)
            r[0] = x
            return r

        self.params = tree_map(rows, params)
        self.alloc.seed(0, slot=0)

    @property
    def scratch(self) -> int:
        return self.alloc.scratch

    def read(self, agg: int) -> Params:
        """Snapshot ``agg``: views of its rows."""
        s = self.alloc.slot_of(agg)
        return tree_map(lambda x: x[s], self.params)

    def put(self, agg: int, params: Params) -> int:
        """Store ``params`` as snapshot ``agg`` from the host loop (the
        delayed scheme's once-a-round write; the bucket engine writes in
        :func:`mix_bucket_ring`).  Allocation recycles the oldest unanchored
        slot, which may be the slot a caller just :meth:`read`: the write is
        out of place (as the reference's ``.at[s].set``), so views taken by
        an earlier ``read`` keep their values."""
        s = self.alloc.alloc(agg)
        idx = torch.tensor([s], device=_device(self.params))
        self.params = tree_map(lambda r, x: r.index_copy(0, idx, x[None]),
                               self.params, params)
        return s
