"""Model API of the port (the CNN family of the paper's testbed)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models import cnn
from repro_torch.models import module as M


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Random parameters of ``cfg`` from ``seed``, on ``device`` (default
    ``cuda``; raises when there is no GPU and the CPU was not asked for)."""
    return M.init_params(cnn.cnn_spec(cfg), seed, device, dtype)


__all__ = ["init_params"]
