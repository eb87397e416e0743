# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Per-scheme update policies for the paper's schemes.

The engine knows HOW to run a round; a :class:`Scheme` says WHAT the round
means: which clients soft-train, which HeliosConfig they see, how the
server aggregates, and at what volume a straggler's simulated time is
billed.  The engine reads only this interface, never a scheme name.

  helios   — soft-training stragglers + Eq. 10 aggregation (this paper)
  syn      — Synchronized FL: everyone trains the full model, wait for all
  st_only  — soft-training WITHOUT the Eq. 10 optimization (§VII.C)
  random   — Caldas et al. [12]: random sub-model, no top-k / rotation
  asyn     — asynchronous FL: constant-weight mixing on arrival
  afo      — asynchronous federated optimization: staleness-discounted
             mixing (Xie et al. 2019)

asyn and afo run on ``FLRun.run_async``, the sequential event loop.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Type

from repro_torch.configs.base import HeliosConfig
from repro_torch.core import aggregation as AG


def _random_hcfg(hcfg: HeliosConfig) -> HeliosConfig:
    """Caldas et al. [12]: pure random selection, no top-k / rotation."""
    return dataclasses.replace(hcfg, p_s=0.0, rotation_threshold_auto=False,
                               rotation_threshold=10 ** 9)


class Scheme:
    """The common synchronous full-model policy; subclasses flip flags and
    override hooks."""

    name = "base"
    #: stragglers run Eq. 2 mask selection + helios_state evolution
    soft_training = False
    #: native event-driven scheme (run on ``FLRun.run_async``)
    async_native = False
    #: asynchronously mixed updates are discounted by (staleness+1)^-a
    staleness_discount = False
    #: §IV.C volume adaptation moves straggler volumes toward the pace
    adapt_volume = False
    #: cycle scores come from the local update delta (False = keep the
    #: previous scores, the random baseline's no-op)
    use_delta_scores = True
    #: simulated cycle cost: stragglers work at full volume (no sub-model)
    full_volume = False

    def effective_hcfg(self, hcfg: HeliosConfig) -> HeliosConfig:
        """The HeliosConfig soft-training sees (begin_cycle AND end_cycle)."""
        return hcfg

    def agg_mode(self, hcfg: HeliosConfig) -> str:
        """Server aggregation mode (core.aggregation)."""
        return "uniform"

    def effective_volume(self, client) -> float:
        """The volume a client's simulated cycle time is billed at."""
        if self.full_volume or not client.is_straggler:
            return 1.0
        return client.volume

    def round_duration(self, times, cclients) -> float:
        """Simulated wall-clock of one synchronous round (critical path)."""
        return max(times)

    def async_weight(self, mix_weight: float, stale: int,
                     staleness_a: float) -> float:
        """Per-event mix weight of the async loop."""
        if self.staleness_discount:
            return mix_weight * AG.staleness_weight(stale, staleness_a)
        return mix_weight

    # -- per-run state -------------------------------------------------
    def init_run(self, run) -> None:
        """Attach scheme-owned state to a freshly constructed run."""

    def round_start(self, run) -> None:
        """Host hook before a sync round's cohort trains."""

    def round_end(self, run) -> None:
        """Host hook after a sync round aggregated."""


class HeliosScheme(Scheme):
    name = "helios"
    soft_training = True
    adapt_volume = True

    def agg_mode(self, hcfg):
        return hcfg.aggregation


class StOnlyScheme(Scheme):
    """Helios soft-training WITHOUT Eq. 10 aggregation (§VII.C)."""
    name = "st_only"
    soft_training = True


class RandomScheme(Scheme):
    """Caldas et al. [12]: random sub-model of the expected volume."""
    name = "random"
    soft_training = True
    use_delta_scores = False

    def effective_hcfg(self, hcfg):
        return _random_hcfg(hcfg)


class SynScheme(Scheme):
    """Synchronized FL: full models, wait for the slowest."""
    name = "syn"
    full_volume = True


class AsynScheme(Scheme):
    """Asynchronous FL: constant-weight mixing on arrival."""
    name = "asyn"
    async_native = True


class AfoScheme(Scheme):
    """Asynchronous Federated Optimization: staleness-discounted mixing."""
    name = "afo"
    async_native = True
    staleness_discount = True


#: registry, in the reference's display order
SCHEMES: Dict[str, Type[Scheme]] = {
    cls.name: cls for cls in (HeliosScheme, SynScheme, StOnlyScheme,
                              RandomScheme, AsynScheme, AfoScheme)
}


def make_scheme(name: str) -> Scheme:
    try:
        return SCHEMES[name]()
    except KeyError:
        raise ValueError(f"unknown scheme {name!r}: the port supports "
                         f"{tuple(SCHEMES)}") from None
