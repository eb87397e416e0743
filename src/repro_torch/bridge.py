# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Weight bridge between numpy parameter dicts and the port's tensors.

The port keeps the reference's parameter names, nesting and layouts (HWIO
conv kernels, (din, dout) dense weights, stacked (L, d, H, hd) attention
weights), so the bridge is a per-leaf copy over flat or nested dicts: the
same keys, shapes and dtypes on both sides.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.module import tree_map


def params_from_numpy(arrays: Mapping[str, Any],
                      device: DeviceLike = None) -> Dict[str, Any]:
    """{name: array or subtree} -> the same tree of tensors on ``device``
    (copies, contiguous)."""
    dev = resolve_device(device)
    return tree_map(lambda v: torch.tensor(np.array(v), device=dev),
                    dict(arrays))


def params_to_numpy(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_numpy` (host copies)."""
    return tree_map(lambda v: v.detach().cpu().numpy(), dict(params))
