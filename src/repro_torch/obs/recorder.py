# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Always-on accounting counters of a run.

The engine's history rows, byte accounting (``downlink_bytes``) and the
async loop's read-only views (``events_processed``, ``snapshot_peak``, ...)
read these host integers; incrementing one costs a dict update and never waits
for the device.  :meth:`Recorder.accum` keeps a running sum of device
scalars (the uplink codec's ``uplink_coords``) on the device, and
:meth:`Recorder.accum_value` is its one wait.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


class Recorder:
    def __init__(self) -> None:
        self.counters: Dict[str, int] = {}
        self._accums: Dict[str, torch.Tensor] = {}

    def inc(self, name: str, n: int = 1) -> int:
        self.counters[name] = self.counters.get(name, 0) + n
        return self.counters[name]

    def set(self, name: str, value: int) -> None:
        self.counters[name] = value

    def set_max(self, name: str, value: int) -> None:
        self.counters[name] = max(self.counters.get(name, value), value)

    def count(self, name: str, default: int = 0) -> int:
        return self.counters.get(name, default)

    def accum(self, name: str, value: torch.Tensor) -> None:
        """Add a device scalar to a running sum kept on the device (the
        sum is in the value's dtype, in the order of the calls)."""
        prev = self._accums.get(name)
        self._accums[name] = value if prev is None else prev + value

    def accum_raw(self, name: str, default=None) -> Optional[torch.Tensor]:
        """The running sum itself, still on the device."""
        return self._accums.get(name, default)

    def accum_value(self, name: str, default: float = 0.0) -> float:
        """The running sum as a host float: waits for the device."""
        v = self._accums.get(name)
        if v is None:
            return default
        return float(v)                        # repro: noqa[R3]
