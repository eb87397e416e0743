# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Always-on accounting counters of a run.

The engine's history rows, byte accounting (``downlink_bytes``) and the
async loop's read-only views (``events_processed``, ``snapshot_peak``, ...)
read these host integers; incrementing one costs a dict update and never waits
for the device.
"""
from __future__ import annotations

from typing import Dict


class Recorder:
    def __init__(self) -> None:
        self.counters: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> int:
        self.counters[name] = self.counters.get(name, 0) + n
        return self.counters[name]

    def set(self, name: str, value: int) -> None:
        self.counters[name] = value

    def set_max(self, name: str, value: int) -> None:
        self.counters[name] = max(self.counters.get(name, value), value)

    def count(self, name: str, default: int = 0) -> int:
        return self.counters.get(name, default)
