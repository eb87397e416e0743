# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Optimization-target determination (Section IV.C) + dynamic adaptation.

* ``volume_from_profile`` — white-box: pick P so the modeled cycle time of
  the compressed model matches the collaboration pace.  Soft-training FLOPs
  scale ~linearly in P (both matmuls of a masked hidden unit vanish), so the
  first-order solve is P = pace / straggler_time;
* ``adapt_volume`` — the controller that then corrects any modeling error.
"""
from __future__ import annotations

import numpy as np


def volume_from_profile(straggler_time: float, pace_time: float,
                        min_volume: float = 0.125) -> float:
    """White-box target: modeled time scales ~P -> P = pace / time."""
    if straggler_time <= pace_time:
        return 1.0
    return float(np.clip(pace_time / straggler_time, min_volume, 1.0))


def adapt_volume(volume: float, observed_time: float, deadline: float,
                 gain: float = 0.5, min_volume: float = 0.125) -> float:
    """Multiplicative controller: move P toward the deadline match.

    P_new = P * (deadline / observed)^gain — gain < 1 damps oscillation
    (the paper adjusts "during the first several training cycles").
    """
    if observed_time <= 0:
        return volume
    ratio = deadline / observed_time
    return float(np.clip(volume * ratio ** gain, min_volume, 1.0))
