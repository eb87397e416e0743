# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Straggler identification (Section IV.B).

* Time-based approximation (BLACK BOX): run a lightweight test bench (a few
  training iterations) per device, rank by observed time, take the top-k as
  potential stragglers.
* Resource-based profiling (WHITE BOX): the paper's cost model
  ``Te = W/C_cpu + M/V_mc + M/B_n`` fed with device resources.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Hardware resources of one collaboration device.

    Units: compute GFLOP/s, memory MB, mem bandwidth MB/s, net MB/s.
    ``speed_factor`` scales simulated step time (heterogeneity simulator).
    """

    name: str
    compute_gflops: float
    memory_mb: float
    mem_bandwidth: float
    net_bandwidth: float
    speed_factor: float = 1.0


def time_cost_model(workload_gflop: float, memory_mb: float,
                    dev: DeviceProfile) -> float:
    """Te = W/C_cpu + M/V_mc + M/B_n (paper Section IV.B)."""
    return (workload_gflop / dev.compute_gflops
            + memory_mb / dev.mem_bandwidth
            + memory_mb / dev.net_bandwidth)


def identify_resource_based(workload_gflop: float, memory_mb: float,
                            devices: Sequence[DeviceProfile],
                            num_stragglers: Optional[int] = None,
                            slack: float = 1.5):
    """White-box: model Te per device; stragglers are the top-k slowest (or
    everything slower than slack x median when k is not given).

    Returns (times, straggler_indices) with times in the T-index order
    convention (T_1 = longest).
    """
    times = [time_cost_model(workload_gflop, memory_mb, d) for d in devices]
    order = sorted(range(len(times)), key=lambda i: -times[i])
    if num_stragglers is None:
        # slack x FASTEST device: robust even when most devices straggle
        fastest = min(times)
        stragglers = [i for i in order if times[i] > slack * fastest]
    else:
        stragglers = order[:num_stragglers]
    return times, stragglers


def identify_time_based(bench_fn: Callable[[int], None],
                        num_devices: int,
                        probe_iters: int = 3,
                        num_stragglers: Optional[int] = None,
                        timer: Callable[[], float] = time.perf_counter,
                        simulated_times: Optional[Sequence[float]] = None):
    """Black-box: time a probe bench per device and rank.

    ``bench_fn(device_index)`` runs one probe iteration on that device.  In
    the simulator, ``simulated_times`` short-circuits wall-clock measurement.
    """
    if simulated_times is not None:
        times = list(simulated_times)
    else:
        times = []
        for dev in range(num_devices):
            t0 = timer()
            for _ in range(probe_iters):
                bench_fn(dev)
            times.append((timer() - t0) / probe_iters)
    order = sorted(range(num_devices), key=lambda i: -times[i])
    if num_stragglers is None:
        fastest = min(times)
        stragglers = [i for i in order if times[i] > 1.5 * fastest]
    else:
        stragglers = order[:num_stragglers]
    return times, stragglers
