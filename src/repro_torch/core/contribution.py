# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Collaboration-contribution metric (paper Eq. 1).

U^{ij}(S_k) = theta^{ij}(S_k) - theta^{ij}(S_{k-1}) per neuron, reduced with
an L1 norm over each unit's fan-in entries plus its bias.  For the CNN
testbed the mask-schema keys are parameter-name prefixes (conv0, fc1, ...)
and the unit dim is the LAST dim of the weight (HWIO / (din, dout)).
"""
from __future__ import annotations

from typing import Dict

import torch


def cnn_unit_scores(delta_tree: Dict[str, torch.Tensor],
                    schema: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """Per-unit |delta| L1 scores: {schema_key: (1, units) float32}."""
    out = {}
    for key, shape in schema.items():
        w = delta_tree.get(f"{key}_w")
        b = delta_tree.get(f"{key}_b")
        dev = next(iter(delta_tree.values())).device
        acc = torch.zeros(shape[-1], dtype=torch.float32, device=dev)
        if w is not None:
            acc = acc + w.float().abs().sum(dim=tuple(range(w.dim() - 1)))
        if b is not None:
            acc = acc + b.float().abs()
        out[key] = acc[None]                              # (1, units)
    return out


def delta(params_new: Dict[str, torch.Tensor],
          params_old: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: params_new[k].float() - params_old[k].float()
            for k in params_new}


def ema_update(scores_prev: Dict[str, torch.Tensor],
               scores_new: Dict[str, torch.Tensor], decay: float):
    return {k: decay * scores_prev[k] + (1 - decay) * scores_new[k]
            for k in scores_new}
