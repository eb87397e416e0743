# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Expand per-unit Helios masks into parameter-space masks (CNN testbed)."""
from __future__ import annotations

from typing import Dict

import torch


def cnn_expand_masks(unit_masks: Dict[str, torch.Tensor],
                     params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Params-shaped 0/1 masks: a schema key masks the OUTPUT channel (last
    dim) of ``<key>_w`` and ``<key>_b``; every other parameter gets ones."""
    out = {}
    for path, arr in params.items():
        m = torch.ones(arr.shape, dtype=torch.float32, device=arr.device)
        for key, um in unit_masks.items():
            v = um[0] if um.dim() == 2 else um
            if path == f"{key}_w" and arr.shape[-1] == v.shape[0]:
                m = m * v.reshape((1,) * (arr.dim() - 1) + (-1,))
            elif path == f"{key}_b" and arr.shape[0] == v.shape[0]:
                m = m * v
        out[path] = m
    return out


def selected_fraction(unit_masks: Dict[str, torch.Tensor]) -> torch.Tensor:
    """r_n of Eq. 10: fraction of maskable units selected on this client
    (a device scalar: the hot loop does not wait for it)."""
    tot = sum(m.numel() for m in unit_masks.values())
    sel = sum(m.sum() for m in unit_masks.values())
    return sel / max(tot, 1)
