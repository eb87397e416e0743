# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Heterogeneous-device simulator (paper Table I + Fig. 1).

Client wall time is SIMULATED with the paper's cost model: a training cycle
takes ``t = T_base * speed_factor * volume`` time units (soft-training FLOPs
scale ~linearly in the volume P, Section IV.C).  ``speed_factor`` values
derive from Table I time costs normalized to a capable reference device.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.identification import DeviceProfile

#: paper Table I: 4 straggler settings running AlexNet on CIFAR-10.
TABLE_I = [
    DeviceProfile("jetson-nano-cpu", compute_gflops=7.0, memory_mb=252,
                  mem_bandwidth=4_000, net_bandwidth=100, speed_factor=2.5),
    DeviceProfile("raspberry-pi", compute_gflops=6.0, memory_mb=150,
                  mem_bandwidth=2_000, net_bandwidth=100, speed_factor=2.9),
    DeviceProfile("deeplens-gpu", compute_gflops=5.5, memory_mb=100,
                  mem_bandwidth=3_000, net_bandwidth=100, speed_factor=3.3),
    DeviceProfile("deeplens-cpu", compute_gflops=4.5, memory_mb=110,
                  mem_bandwidth=2_500, net_bandwidth=100, speed_factor=4.15),
]

CAPABLE = DeviceProfile("jetson-nano-gpu", compute_gflops=25.0,
                        memory_mb=400, mem_bandwidth=8_000,
                        net_bandwidth=100, speed_factor=1.0)


def make_fleet(num_capable: int, num_stragglers: int) -> List[DeviceProfile]:
    """Paper settings: (2 capable + 2 stragglers) or (3 + 3)."""
    out = [dataclasses.replace(CAPABLE, name=f"capable-{i}")
           for i in range(num_capable)]
    for i in range(num_stragglers):
        out.append(dataclasses.replace(TABLE_I[i % len(TABLE_I)],
                                       name=f"straggler-{i}"))
    return out


def cycle_time(profile: DeviceProfile, volume: float = 1.0,
               base: float = 1.0) -> float:
    return base * profile.speed_factor * max(volume, 1e-3)
