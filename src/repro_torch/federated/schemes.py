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

The published straggler baselines of the scheme gauntlet:

  scaffold — SCAFFOLD control variates (Karimireddy et al.): every client
             trains the full model with its gradient corrected by
             c_global - c_i, at 2x uplink (the control delta rides dense)
  fluid    — FLuID invariant dropout (Wang et al.): Eq. 2 masking at
             p_s = 1.0 without rotation, masked-mean aggregation
  delayed  — delayed-gradient hybrid (Xu et al.): stragglers train the full
             model from a ``delay``-round-stale global; their discounted
             update is virtualized onto the current global, and the round
             clock is the capable cohort's

asyn and afo run on the bucketed event engine (``AsyncFLRun``) or on
``FLRun.run_async``, the sequential event loop, which every other scheme's
``run_async`` falls back to.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Type

import torch

from repro_torch.configs.base import HeliosConfig
from repro_torch.core import aggregation as AG
from repro_torch.models.module import tree_map
from repro_torch.optim.compression import HostErrorStore


def _random_hcfg(hcfg: HeliosConfig) -> HeliosConfig:
    """Caldas et al. [12]: pure random selection, no top-k / rotation."""
    return dataclasses.replace(hcfg, p_s=0.0, rotation_threshold_auto=False,
                               rotation_threshold=10 ** 9)


def _fluid_hcfg(hcfg: HeliosConfig) -> HeliosConfig:
    """FLuID invariant dropout as an Eq. 2 special case: p_s = 1.0 makes the
    selection pure top-k on the scores, and an unreachable rotation
    threshold keeps invariant neurons frozen."""
    return dataclasses.replace(hcfg, p_s=1.0, rotation_threshold_auto=False,
                               rotation_threshold=10 ** 9)


class Scheme:
    """The common synchronous full-model policy; subclasses flip flags and
    override hooks."""

    name = "base"
    #: stragglers run Eq. 2 mask selection + helios_state evolution
    soft_training = False
    #: native event-driven scheme (the bucketed event engine); every other
    #: scheme's ``run_async`` is the sequential event loop
    async_native = False
    #: asynchronously mixed updates are discounted by (staleness+1)^-a
    staleness_discount = False
    #: §IV.C volume adaptation moves straggler volumes toward the pace
    adapt_volume = False
    #: cycle scores come from the local update delta (False = keep the
    #: previous scores, the random baseline's no-op)
    use_delta_scores = True
    #: SCAFFOLD-style control variates: local training is corrected by
    #: c_global - c_i and the engines carry per-client control rows
    uses_control = False
    #: delayed-gradient hybrid: stragglers train from a stale snapshot and
    #: their update is virtualized onto the current global
    uses_stale_base = False
    #: simulated cycle cost: stragglers work at full volume (no sub-model)
    full_volume = False
    #: extra dense f32 param-sized trees uploaded per update (control deltas)
    extra_dense_uplink = 0

    def manifest(self) -> Dict[str, object]:
        """Flag census: which policy switches this scheme flips."""
        return {"name": self.name,
                "soft_training": self.soft_training,
                "async_native": self.async_native,
                "staleness_discount": self.staleness_discount,
                "adapt_volume": self.adapt_volume,
                "use_delta_scores": self.use_delta_scores,
                "uses_control": self.uses_control,
                "uses_stale_base": self.uses_stale_base,
                "full_volume": self.full_volume,
                "extra_dense_uplink": self.extra_dense_uplink}

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


class ScaffoldScheme(Scheme):
    """SCAFFOLD control variates (option II).

    Every client trains the full model with each step's gradient corrected
    by ``c_global - c_i``; after K local steps its control becomes
    ``c_i + (x - y) / (K * lr) - c_global``.  The server folds
    ``c_global += dc / N`` over the population's N.  Client controls live
    in a lazily materialized :class:`HostErrorStore` (zero rows are the
    SCAFFOLD init); the control delta rides the uplink dense.
    """
    name = "scaffold"
    full_volume = True
    uses_control = True
    extra_dense_uplink = 1

    def init_run(self, run) -> None:
        run._c_global = tree_map(
            lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device), run.global_params)
        run._ctrl_store = HostErrorStore(run.global_params)
        run._dc_buf = []


class FluidScheme(Scheme):
    """FLuID invariant dropout: Eq. 2 masking at p_s = 1.0 (pure
    update-magnitude top-k, rotation off) + masked-mean patching."""
    name = "fluid"
    soft_training = True
    adapt_volume = True

    def effective_hcfg(self, hcfg):
        return _fluid_hcfg(hcfg)

    def agg_mode(self, hcfg):
        return "masked_mean"


class DelayedScheme(Scheme):
    """Delayed-gradient hybrid: stragglers train the full model from a
    ``delay``-round-stale global (an f32 :class:`SnapshotRing` of
    ``delay + 1`` rows written once a round), and their update is
    virtualized onto the current global with a staleness discount::

        p_virtual = global + (stale + 1)^-a * (y - base)

    so it rides the uniform aggregation.  Stragglers never gate the round
    clock (:meth:`round_duration` is the capable cohort's).
    """
    name = "delayed"
    full_volume = True
    uses_stale_base = True
    staleness_discount = True          # the async fallback mixes like afo
    #: stragglers read the global from this many rounds back
    delay = 2
    staleness_a = 0.5

    def init_run(self, run) -> None:
        run._delay_ring = AG.SnapshotRing(run.global_params,
                                          cap=self.delay + 1, n_anchors=0)

    def round_start(self, run) -> None:
        run._stale_base = run._delay_ring.read(max(0, run.round - self.delay))
        run._stale_disc = AG.staleness_weight(min(run.round, self.delay),
                                              self.staleness_a)

    def round_end(self, run) -> None:
        run._delay_ring.put(run.round + 1, run.global_params)

    def round_duration(self, times, cclients) -> float:
        capable = [t for t, c in zip(times, cclients) if not c.is_straggler]
        return max(capable) if capable else max(times)


#: registry, in the reference's display order
SCHEMES: Dict[str, Type[Scheme]] = {
    cls.name: cls for cls in (HeliosScheme, SynScheme, StOnlyScheme,
                              RandomScheme, AsynScheme, AfoScheme,
                              ScaffoldScheme, FluidScheme, DelayedScheme)
}


def make_scheme(name: str) -> Scheme:
    try:
        return SCHEMES[name]()
    except KeyError:
        raise ValueError(f"unknown scheme {name!r}: the port supports "
                         f"{tuple(SCHEMES)}") from None
