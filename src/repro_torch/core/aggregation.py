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
  :class:`RingAllocator` manages on the host;
* the lossy ring (the uplink codec's memory leg): :func:`lossy_roundtrip`,
  :func:`ring_gather_lossy`, :func:`mix_bucket_ring_lossy` and
  :class:`SnapshotRing`'s ``quant`` / ``delta`` modes keep anchors as int
  codes with one f32 scale a leaf, and the newest ones in full precision.

Parameters are dicts of tensors, flat (CNN) or nested (LM); sums run in
float32 in client order, leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.module import (tree_leaves, tree_map, tree_paths,
                                       unflatten)
from repro_torch.optim import compression as CP

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
    (``FamilyAdapter.expand_masks_batch``)."""
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


def _lossy_delta(leaf: torch.Tensor, ref_leaf: Optional[torch.Tensor]):
    """A snapshot leaf in encode space: its f32 value (``quant``) or its
    difference from the fixed reference (``delta``)."""
    x = leaf.float()
    return x if ref_leaf is None else x - ref_leaf.float()


def _ref_leaves(tree, ref) -> list:
    return [None] * len(tree_leaves(tree)) if ref is None else \
        tree_leaves(ref)


def _from_leaves(tree, leaves: list) -> Params:
    return unflatten(dict(zip((k for k, _ in tree_paths(tree)), leaves)))


def lossy_roundtrip(params: Params, ref: Optional[Params], bits: int
                    ) -> Params:
    """What a lossy ring row decodes to for a stale anchor: quantize(theta
    [- ref]) -> dequantize [+ ref], leaf by leaf, cast to the leaf's dtype.
    The bucket engine pays this at write time (:func:`mix_bucket_ring_lossy`),
    the sequential loop at read time; both give the same bits."""
    out = []
    for p, r in zip(tree_leaves(params), _ref_leaves(params, ref)):
        dec = CP.dequantize(*CP.quantize(_lossy_delta(p, r), bits))
        if r is not None:
            dec = dec + r.float()
        out.append(dec.to(p.dtype))
    return _from_leaves(params, out)


def ring_gather_lossy(ring_q: Params, ring_scales: Params, fresh_buf: Params,
                      ref: Optional[Params], base_slots: Sequence[int],
                      fresh_idx: Sequence[int], is_fresh: Sequence[float]
                      ) -> Params:
    """Each event's base params out of a lossy ring: an anchor inside the
    freshness window (``is_fresh`` 1, the ``stale < window`` rule) reads
    its full-precision row ``fresh_idx`` (agg % window); a staler one
    dequantizes its int row ``base_slots`` (+ ref for ``delta``).  Leaves
    come back stacked (B,) + shape."""
    dev = _device(fresh_buf)
    slots = torch.as_tensor(base_slots, device=dev)
    fidx = torch.as_tensor(fresh_idx, device=dev)
    sel = torch.as_tensor(is_fresh, dtype=torch.float32, device=dev)
    out = []
    for qL, scL, fL, rL in zip(tree_leaves(ring_q), tree_leaves(ring_scales),
                               tree_leaves(fresh_buf),
                               _ref_leaves(ring_q, ref)):
        bshape = (-1,) + (1,) * (qL.dim() - 1)
        deq = qL.index_select(0, slots).float() * \
            scL.index_select(0, slots).reshape(bshape)
        if rL is not None:
            deq = deq + rL.float()
        fp = fL.index_select(0, fidx).float()
        out.append(torch.where(sel.reshape(bshape) > 0, fp, deq)
                   .to(fL.dtype))
    return _from_leaves(fresh_buf, out)


def mix_bucket_ring_lossy(global_params: Params, ring_q: Params,
                          ring_scales: Params, fresh_buf: Params,
                          ref: Optional[Params], write_slots: Sequence[int],
                          fresh_slots: Sequence[int], stacked_params: Params,
                          weights: torch.Tensor, bits: int):
    """:func:`mix_bucket_ring` for a lossy ring: each event's post-mix
    global is written twice, quantized (int codes and one f32 scale a
    leaf) into ring row ``write_slots[i]`` and in full precision into
    fresh row ``fresh_slots[i]`` (agg % window).  A padding event (weight
    0) writes the scratch rows.  The rows are updated in place; the bucket
    read its anchors before.  Returns (global, ring_q, ring_scales,
    fresh_buf)."""
    g = global_params
    q_leaves, s_leaves = tree_leaves(ring_q), tree_leaves(ring_scales)
    r_leaves = _ref_leaves(ring_q, ref)
    for i, (s, fs) in enumerate(zip(write_slots, fresh_slots)):
        g = tree_map(lambda gg, pp: _mix_leaf(gg, pp[i], weights[i]), g,
                     stacked_params)
        for qL, scL, gL, rL in zip(q_leaves, s_leaves, tree_leaves(g),
                                   r_leaves):
            codes, scale = CP.quantize(_lossy_delta(gL, rL), bits)
            qL[s].copy_(codes)
            scL[s] = scale
        tree_map(lambda f, gg: f[fs].copy_(gg), fresh_buf, g)
    return g, ring_q, ring_scales, fresh_buf


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
    of the delayed scheme's stale globals (:meth:`put`).

    ``mode`` is the anchors' precision (the uplink codec's memory leg):
    ``fp32`` keeps ``params``, one tree whose leaves carry a leading
    (slots,) axis, row r the global as of some aggregation step;
    ``quant`` / ``delta`` keep ``q``, int-``bits`` codes of each row, and
    ``scales``, one f32 scale a (slot, leaf) (``delta`` encodes against
    ``ref``, the params the ring was built from), plus ``fresh_buf``, the
    last ``fresh_window`` globals in full precision (row agg % window) and
    a scratch row, so only anchors staler than the window pay the
    quantization.  Capacity is ``max(cap, anchors + 1)`` data slots + 1
    scratch, so the store is bounded as the sequential loop's snapshot
    dict is (cap + live anchors).
    """

    def __init__(self, params: Params, cap: int, n_anchors: int,
                 mode: str = "fp32", bits: int = 8, fresh_window: int = 8):
        self.alloc = RingAllocator(max(cap, n_anchors + 1) + 1)
        self.mode, self.bits = mode, bits
        self.fresh_window = max(1, fresh_window)
        slots = self.alloc.slots

        def rows(x, n):
            r = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device)
            r[0] = x
            return r

        if mode == "fp32":
            self.params = tree_map(lambda x: rows(x, slots), params)
        elif mode in ("quant", "delta"):
            self.ref = tree_map(lambda x: x.detach().float().clone(),
                                params) if mode == "delta" else None
            qs, scs = [], []
            for p, r in zip(tree_leaves(params), _ref_leaves(params,
                                                             self.ref)):
                codes, scale = CP.quantize(_lossy_delta(p, r), bits)
                qs.append(rows(codes, slots))
                sc = torch.ones(slots, dtype=torch.float32, device=p.device)
                sc[0] = scale
                scs.append(sc)
            self.q = _from_leaves(params, qs)
            self.scales = _from_leaves(params, scs)
            self.fresh_buf = tree_map(lambda x: rows(x, self.fresh_window + 1),
                                      params)
        else:
            raise ValueError(f"SnapshotRing: bad mode {mode!r}")
        self.alloc.seed(0, slot=0)

    @property
    def scratch(self) -> int:
        return self.alloc.scratch

    def read(self, agg: int, stale: Optional[int] = None) -> Params:
        """Snapshot ``agg``.  ``fp32``: views of its rows.  Lossy modes:
        a reader ``stale`` < ``fresh_window`` aggregation steps behind gets
        views of the full-precision row, any other the decoded int row."""
        s = self.alloc.slot_of(agg)
        if self.mode == "fp32":
            return tree_map(lambda x: x[s], self.params)
        if stale is not None and stale < self.fresh_window:
            return tree_map(lambda x: x[agg % self.fresh_window],
                            self.fresh_buf)
        return tree_map(lambda x: x[0], ring_gather_lossy(
            self.q, self.scales, self.fresh_buf, self.ref, [s], [0], [0.0]))

    def put(self, agg: int, params: Params) -> int:
        """Store ``params`` as snapshot ``agg`` from the host loop (the
        delayed scheme's once-a-round write; the bucket engine writes in
        :func:`mix_bucket_ring`).  Allocation recycles the oldest unanchored
        slot, which may be the slot a caller just :meth:`read`: the write is
        out of place (as the reference's ``.at[s].set``), so views taken by
        an earlier ``read`` keep their values.  ``fp32`` only, as in the
        reference: the sync ring is small and read exactly."""
        if self.mode != "fp32":
            raise ValueError(
                f"SnapshotRing.put requires mode='fp32', got {self.mode!r}")
        s = self.alloc.alloc(agg)
        idx = torch.tensor([s], device=_device(self.params))
        self.params = tree_map(lambda r, x: r.index_copy(0, idx, x[None]),
                               self.params, params)
        return s

    def nbytes(self) -> int:
        """Device bytes of the anchor store: the rows, and in the lossy
        modes the codes, scales, fresh rows and reference."""
        trees = (self.params,) if self.mode == "fp32" else \
            (self.q, self.scales, self.fresh_buf) + \
            ((self.ref,) if self.ref is not None else ())
        return sum(x.numel() * x.element_size() for t in trees
                   for x in tree_leaves(t))
