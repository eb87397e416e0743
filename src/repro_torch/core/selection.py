# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Neuron selection (paper Eq. 2) + rotation regulation (Section VI.A).

Per layer, per unit type, with volume fraction P and contribution scores U:

  selected = TopK(U) ∪ Rand(rest) ∪ Forced(C_s over threshold)
  |TopK| = P_s * P * n      (primary convergence guarantee, Prop. 2)
  |Rand| = (1-P_s) * P * n  (rotation -> model integrity)

Top-k is a threshold on the sorted scores with ``>=`` (not ``torch.topk``,
whose tie handling would change masks).  The counts are host integers
computed in float32 with round-half-even, as the reference computes them.
Forced units (skipped for C_s > threshold cycles) preempt the random draw.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import keys as KY


def _counts(volume, n: int, p_s: float) -> Tuple[int, int]:
    """(k_total, k_top) = (clip(round(P·n), 1, n), round(p_s·k_total)),
    float32 arithmetic, round-half-even."""
    k_total = int(np.clip(np.round(np.float32(volume) * np.float32(n)), 1, n))
    k_top = int(np.round(np.float32(p_s) * np.float32(k_total)))
    return k_total, k_top


def _row_select(u: torch.Tensor, forced: torch.Tensor, k_total: int,
                k_top: int, noise: torch.Tensor,
                rand: torch.Tensor) -> torch.Tensor:
    """Rows of one unit type.  u, noise, rand: (L, n) float32; forced:
    (L, n) bool.  Returns (L, n) float 0/1 with k_total ones per row."""
    n = u.shape[-1]
    u = u + noise                                         # random tie-break
    su = torch.sort(u, dim=-1).values
    thresh = su[:, min(max(n - k_top, 0), n - 1)][:, None]
    is_top = u >= thresh if k_top > 0 else torch.zeros_like(u, dtype=torch.bool)
    # priority: forced >> top >> random
    prio = forced.float() * 4.0 + is_top.float() * 2.0 + rand
    sp = torch.sort(prio, dim=-1).values
    pthresh = sp[:, min(max(n - k_total, 0), n - 1)][:, None]
    return (prio >= pthresh).float()


def _pool_blocks(u: torch.Tensor, block: int, reduce: str) -> torch.Tensor:
    """(L, n) unit values -> (L, ceil(n/block)) per-block values.  ``mean``
    averages over the REAL entries of a ragged tail block; ``max`` is any-of."""
    L, n = u.shape
    nb = -(-n // block)
    grouped = F.pad(u, (0, nb * block - n)).reshape(L, nb, block)
    if reduce == "mean":
        cnt = torch.clamp(n - torch.arange(nb, device=u.device) * block,
                          max=block).to(torch.float32)
        return grouped.sum(-1) / cnt[None, :]
    return grouped.amax(-1)


def _expand_blocks(bm: torch.Tensor, block: int, n: int) -> torch.Tensor:
    """Inverse of :func:`_pool_blocks` for 0/1 masks: block-constant (L, n)."""
    return bm.repeat_interleave(block, dim=-1)[..., :n]


def select_masks(scores: Dict[str, torch.Tensor],
                 forced: Dict[str, torch.Tensor],
                 volume: float,
                 p_s: float,
                 key: KY.Key,
                 block: int = 0) -> Dict[str, torch.Tensor]:
    """Eq. 2 across all unit types.  scores/forced: {key: (L, n)}.

    Returns masks {key: (L, n) float 0/1} with ~P·n ones per row.  The
    random numbers come from ``key``'s path: unit type ``i`` (in sorted key
    order) uses ``key.fold_in(i).split(L)[row]`` for its tie-break noise and
    ``.fold_in(1)`` of that for its random priorities.

    ``block`` > 0 runs Eq. 2 at BLOCK granularity for unit types with
    n >= 4·block: mean-pooled block scores, any-pooled forced flags, a draw
    of ~P·(n/block) blocks on ``key.fold_in(0xB10C)``, expanded
    block-constant; the other unit types draw unit-granular on
    ``key.fold_in(0x0A11)``.  When no unit type qualifies, everything runs
    unit-granular on ``key`` itself (seed-compatible with ``block=0``).
    """
    if not 0.0 <= float(p_s) <= 1.0:
        raise ValueError(f"select_masks: p_s={p_s} outside [0, 1]")
    if block:
        pooled = {k for k, u in scores.items() if u.shape[-1] >= 4 * block}
        if not pooled:
            return select_masks(scores, forced, volume, p_s, key)
        bscores = {k: _pool_blocks(scores[k], block, "mean") for k in pooled}
        bforced = {k: _pool_blocks(forced[k].float(), block, "max") > 0
                   for k in pooled if k in forced}
        bmasks = select_masks(bscores, bforced, volume, p_s,
                              key.fold_in(0xB10C))
        unit = select_masks({k: u for k, u in scores.items()
                             if k not in pooled},
                            {k: f for k, f in forced.items()
                             if k not in pooled}, volume, p_s,
                            key.fold_in(0x0A11))
        return {k: _expand_blocks(bmasks[k], block, scores[k].shape[-1])
                if k in pooled else unit[k] for k in scores}
    out = {}
    for i, (k, u) in enumerate(sorted(scores.items())):
        if u.dim() != 2:
            raise ValueError(f"select_masks: scores[{k!r}] must be (L, n), "
                             f"got shape {tuple(u.shape)}")
        L, n = u.shape
        k_total, k_top = _counts(volume, n, p_s)
        rows = key.fold_in(i).split(L)
        noise = torch.stack([KY.uniform(r, n, 0.0, 1e-6, u.device)
                             for r in rows])
        rand = torch.stack([KY.uniform(r.fold_in(1), n, 0.0, 1.0, u.device)
                            for r in rows])
        f = forced.get(k)
        if f is None:
            f = torch.zeros_like(u, dtype=torch.bool)
        out[k] = _row_select(u, f, k_total, k_top, noise, rand)
    return out


def update_skip_counts(skip_counts: Dict[str, torch.Tensor],
                       masks: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """C_s: 0 when the unit joined this cycle, else +1."""
    return {k: torch.where(masks[k] > 0, torch.zeros_like(v), v + 1)
            for k, v in skip_counts.items()}


def rotation_threshold(volume: float, auto: bool = True,
                       fixed: int = 4) -> float:
    """Section VI.A: threshold = 1 + m / sum(p_i n_i) = 1 + 1/P (float32)."""
    if not auto:
        return float(np.float32(fixed))
    one = np.float32(1.0)
    return float(one + one / np.maximum(np.float32(volume), np.float32(1e-3)))


def forced_units(skip_counts: Dict[str, torch.Tensor],
                 threshold: float) -> Dict[str, torch.Tensor]:
    return {k: v.float() >= threshold for k, v in skip_counts.items()}


def init_skip_counts(schema: Dict[str, Tuple[int, int]], device):
    return {k: torch.zeros(s, dtype=torch.int32, device=device)
            for k, s in schema.items()}


def init_scores(schema: Dict[str, Tuple[int, int]], device):
    return {k: torch.zeros(s, dtype=torch.float32, device=device)
            for k, s in schema.items()}
