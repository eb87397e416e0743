# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU by name.  A
missing GPU is an error, never a quiet move to the CPU: a run that silently
trained on the CPU would report CPU numbers under a GPU run's name.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU explicitly")
    return dev

