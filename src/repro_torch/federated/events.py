# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Discrete-event core of the async event loop (asyn / afo).

Real heterogeneous fleets are event-driven: clients pull the current global
model, train at their own pace, and their updates arrive whenever they
arrive.  This module is the simulator's backbone for that regime:

* :class:`SimClock` — a deterministic virtual clock.  The event heap is
  keyed ``(time, cid)``, so **equal-time completions always pop in client-id
  order**, not in incidental insertion order.  That determinism is what
  makes a fixed-seed async trajectory reproducible draw for draw.
* :meth:`SimClock.pop_bucket` — pops a *bucket* of near-simultaneous
  completion events (all events within ``horizon`` of the earliest pending
  one).  With ``horizon=0.0`` a bucket is exactly one tie-group.
* Pluggable **arrival** and **dropout** processes.  Each process owns its
  own host RNG stream (re-seeded from the run seed at every ``run_async``
  call) and is invoked once per event *in pop order*, so a jittered or
  lossy fleet replays identically for a fixed seed.

Only client ids live in the heap; what a completion *means* (train, mix,
snapshot) is the engine's business (:mod:`repro_torch.federated.runtime`).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    """One client-completion event: orderable by (time, cid)."""

    time: float
    cid: int


class SimClock:
    """Deterministic event-driven virtual clock.

    The heap is keyed ``(time, cid)``: ties pop in client-id order by
    construction.  ``now`` is monotone — re-inserting an already-popped
    event never rewinds it.
    """

    def __init__(self):
        self.now = 0.0
        #: high-water queue depth
        self.peak_depth = 0
        self._q: list = []

    def schedule(self, delay: float, cid: int) -> None:
        heapq.heappush(self._q, (self.now + delay, cid))
        self.peak_depth = max(self.peak_depth, len(self._q))

    def schedule_at(self, time: float, cid: int) -> None:
        """Absolute-time (re)insertion: an unprocessed event goes back
        exactly where it was."""
        heapq.heappush(self._q, (time, cid))
        self.peak_depth = max(self.peak_depth, len(self._q))

    def pop(self) -> int:
        t, cid = heapq.heappop(self._q)
        self.now = max(self.now, t)
        return cid

    def pop_bucket(self, horizon: float = 0.0,
                   max_size: int = 0) -> List[Event]:
        """Pop every event within ``horizon`` of the earliest pending one
        (at most ``max_size`` when positive), in (time, cid) order.

        Each client has at most one outstanding completion, so a bucket
        never contains the same cid twice.
        """
        evs: List[Event] = []
        if not self._q:
            return evs
        t0 = self._q[0][0]
        while self._q and self._q[0][0] <= t0 + horizon and \
                (not max_size or len(evs) < max_size):
            t, cid = heapq.heappop(self._q)
            self.now = max(self.now, t)
            evs.append(Event(t, cid))
        return evs

    def peek_time(self) -> float:
        return self._q[0][0] if self._q else float("inf")

    def empty(self) -> bool:
        return not self._q

    def __len__(self) -> int:
        return len(self._q)


# ---------------------------------------------------------------------------
# pluggable event processes
# ---------------------------------------------------------------------------


class ArrivalProcess:
    """Maps a client's nominal cycle time to its next completion delay.

    The default is the identity — the paper's deterministic Table-I cost
    model.  Subclasses may hold an RNG; ``reset(seed)`` is called at the
    start of every ``run_async`` so that a fixed run seed gives the
    identical delay sequence (delays are requested once per event, in pop
    order).
    """

    def reset(self, seed: int) -> None:
        pass

    def delay(self, cid: int, base: float) -> float:
        return base


class JitteredArrival(ArrivalProcess):
    """Lognormal multiplicative jitter on the nominal cycle time — the
    completion-time noise real fleets show (thermal throttling, contending
    apps, network variance)."""

    def __init__(self, sigma: float = 0.1):
        self.sigma = sigma
        self._rng = np.random.default_rng(0)

    def reset(self, seed: int) -> None:
        self._rng = np.random.default_rng((seed, 0xA221))

    def delay(self, cid: int, base: float) -> float:
        return base * float(self._rng.lognormal(0.0, self.sigma))


class DropoutProcess:
    """Decides, per completion event, whether the client's update is lost.

    A dropped completion contributes nothing to the global model (no
    training, no mixing, no snapshot) and the client retries after
    ``penalty`` times its next arrival delay.  Owns its own RNG stream so
    enabling dropout never perturbs arrival jitter draws.
    """

    penalty: float = 1.0

    def reset(self, seed: int) -> None:
        pass

    def drops(self, cid: int) -> bool:
        return False


class BernoulliDropout(DropoutProcess):
    """I.i.d. per-event drop with probability ``p``."""

    def __init__(self, p: float = 0.1, penalty: float = 1.0):
        self.p = p
        self.penalty = penalty
        self._rng = np.random.default_rng(0)

    def reset(self, seed: int) -> None:
        self._rng = np.random.default_rng((seed, 0xD809))

    def drops(self, cid: int) -> bool:
        return bool(self._rng.random() < self.p)
