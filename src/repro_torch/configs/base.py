# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Configuration dataclasses for the PyTorch port (the fields the CNN slice reads).

* :class:`ModelConfig`  — architecture of one paper-testbed CNN.
* :class:`HeliosConfig` — the paper's soft-training knobs (Sections IV-VI).

Frozen dataclasses, field for field the same names and defaults as the JAX
package's configs, so a configuration carries over by name.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (``family`` is ``cnn`` for every model here)."""

    name: str
    family: str
    image_size: int = 0
    in_channels: int = 0
    num_classes: int = 0
    cnn_channels: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class HeliosConfig:
    """Soft-training knobs (paper Sections IV-VI)."""

    enabled: bool = True
    p_s: float = 0.1                      # top-contribution fraction (Section VI.A)
    contribution: str = "delta"           # delta (Eq. 1) | grad_ema
    contribution_ema: float = 0.9
    # rotation regulation (Section VI.A): threshold = 1 + m / sum(p_i n_i)
    rotation_threshold_auto: bool = True
    rotation_threshold: int = 4
    # block-granular Eq. 2 selection: 0 = unit-granular (paper-exact); > 0
    # pools scores per block of this many units so the masked-matmul kernels
    # skip dead blocks structurally (match the kernels' mask block, 128)
    mask_block: int = 0
    aggregation: str = "alpha_weighted"   # alpha_weighted (Eq. 10) | masked_mean | uniform
    # volume adaptation (Section IV.C): move P toward the deadline match
    adapt_volume: bool = True
    adapt_gain: float = 0.5
    min_volume: float = 0.125
