# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Per-scheme update policies for the synchronous paper schemes.

The engine knows HOW to run a round; a :class:`Scheme` says WHAT the round
means: which clients soft-train, which HeliosConfig they see, how the
server aggregates, and at what volume a straggler's simulated time is
billed.  The engine reads only this interface, never a scheme name.

  helios   — soft-training stragglers + Eq. 10 aggregation (this paper)
  syn      — Synchronized FL: everyone trains the full model, wait for all
  st_only  — soft-training WITHOUT the Eq. 10 optimization (§VII.C)
  random   — Caldas et al. [12]: random sub-model, no top-k / rotation
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Type

from repro_torch.configs.base import HeliosConfig


def _random_hcfg(hcfg: HeliosConfig) -> HeliosConfig:
    """Caldas et al. [12]: pure random selection, no top-k / rotation."""
    return dataclasses.replace(hcfg, p_s=0.0, rotation_threshold_auto=False,
                               rotation_threshold=10 ** 9)


class Scheme:
    """The common synchronous full-model policy; subclasses flip flags."""

    name = "base"
    #: stragglers run Eq. 2 mask selection + helios_state evolution
    soft_training = False
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


SCHEMES: Dict[str, Type[Scheme]] = {
    cls.name: cls for cls in (HeliosScheme, SynScheme, StOnlyScheme,
                              RandomScheme)
}


def make_scheme(name: str) -> Scheme:
    try:
        return SCHEMES[name]()
    except KeyError:
        raise ValueError(f"unknown scheme {name!r}: the port supports "
                         f"{tuple(SCHEMES)}") from None
