# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Heterogeneous model aggregation (Section VI.B, Eq. 10) + variants.

* ``alpha_weighted`` (paper): client n is weighted alpha_n = r_n / sum(r_m),
  r_n = its selected-neuron ratio.
* ``masked_mean``: per-COORDINATE weighted mean over the clients that
  trained each coordinate; coordinates nobody trained keep the global value.
* ``uniform``: plain FedAvg (the Syn. FL baseline).
* :func:`mix`: the async schemes' per-event mixing, discounted by
  :func:`staleness_weight` under afo.

Parameters are dicts of tensors, flat (CNN) or nested (LM); sums run in
float32 in client order, leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.models.module import tree_leaves, tree_map

Params = Dict[str, Any]


def alpha_weights(ratios: Sequence, device=None) -> torch.Tensor:
    r = torch.stack([torch.as_tensor(x, dtype=torch.float32, device=device)
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
