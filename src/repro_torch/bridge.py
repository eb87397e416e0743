# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Weight bridge between numpy parameter dicts and the port's tensors.

The port keeps the reference's parameter names and layouts (HWIO conv
kernels, (din, dout) dense weights), so the bridge is a per-leaf copy:
the same keys, shapes and dtypes on both sides.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """{name: array} -> {name: tensor} on ``device`` (copies, contiguous)."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.array(v), device=dev) for k, v in arrays.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_numpy` (host copies)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
