# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Federated round engines: ``FLRun``, ``AsyncFLRun`` and ``BatchedFLRun``.

The algorithm lives behind :mod:`repro_torch.federated.schemes`; this module
owns execution.  Time is simulated (``heterogeneity.cycle_time``,
:mod:`repro_torch.federated.events`); the metric is real: models train on
real tensors on the run's device.

* ``run_sync``, one round: draw the cohort (everyone unless
  ``participation`` samples a few) -> §IV.C pace over the cohort ->
  simulated times -> each member's cycle (Eq. 2 masks, masked local SGD,
  Eq. 1 scores) -> aggregation (Eq. 10) -> volume adaptation -> history.
* ``run_async``, the event loop: one client cycle per completion event,
  trained from the snapshot of the global the client last pulled and mixed
  into the current global on arrival (SCAFFOLD's control folded after each
  event).
* ``add_client`` / ``remove_client``: §VI.C elastic membership.
* ``compression``: each client -> server update through a lossy codec
  with per-client error feedback (``optim.compression``) at the
  aggregation boundary of every engine; under quant / delta the async
  anchors are kept as int codes (``SnapshotRing``'s lossy modes).

Every sync engine runs the one host protocol of :meth:`FLRun.run_sync`
and overrides its hooks (``_train_cohort``, ``_write_volumes``,
``_finish_sync``), never the loop:

* :class:`FLRun` — the sequential reference: one local training per
  client, one event at a time in ``run_async``.
* :class:`AsyncFLRun` — the bucketed async engine (asyn / afo, CNN
  testbed): a bucket of equal-time completions trains under one
  ``torch.func.vmap`` from the rows of a device-side snapshot ring and is
  mixed in event order.  Same seed, same global-param trajectory as
  ``FLRun.run_async`` up to rounding.
* :class:`BatchedFLRun` — the batched sync engine (CNN testbed): a round
  runs the soft-training stragglers and the capable clients as two
  cohorts, each local step of a cohort one vmapped step whose masked
  products are one kernel launch for the whole cohort.  Inherits the
  bucketed async path.

The loops never wait for the device except in ``evaluate`` and the history
row behind the eval gate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import HeliosConfig, ModelConfig
from repro_torch.core import aggregation as AG
from repro_torch.core import masking as MK
from repro_torch.core import soft_train as ST
from repro_torch.core import volume as VOL
from repro_torch.core.identification import (DeviceProfile,
                                             identify_resource_based,
                                             identify_time_based)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated.adapter import (CNNAdapter, FamilyAdapter,
                                           make_adapter)
from repro_torch.federated.events import (ArrivalProcess, DropoutProcess,
                                          SimClock)
from repro_torch.federated.heterogeneity import cycle_time
from repro_torch.federated.schemes import Scheme, make_scheme
from repro_torch.kernels.ops import CUDA, REFERENCE, canonical_impl
from repro_torch.models import init_params as _init_params
from repro_torch.models.module import tree_map, tree_paths, unflatten
from repro_torch.obs.recorder import Recorder
from repro_torch.optim import apply_updates, make_optimizer
from repro_torch.optim import compression as CP

#: most events a bucket of the async engine trains at once: bounds the
#: memory of the vmapped local training
MAX_BUCKET = 128


def _make_local_train(adapter: FamilyAdapter, opt):
    """E masked local SGD steps (a Python loop over the leading
    ``local_steps`` axis of ``batches``); the optimizer state restarts each
    cycle.  ``corr`` (SCAFFOLD: ``c_global - c_i``) is added to every
    step's gradient before the optimizer sees it.  Returns (new params,
    mean loss as a device scalar)."""

    def local_train(params, batches, masks, corr=None):
        opt_state = opt.init(params)
        losses = []
        for i in range(next(iter(batches.values())).shape[0]):
            batch = {k: v[i] for k, v in batches.items()}
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            loss = adapter.loss_fn(leaves, batch, masks)
            paths = tree_paths(leaves)
            grads = unflatten(dict(zip(
                (k for k, _ in paths),
                torch.autograd.grad(loss, [v for _, v in paths]))))
            if corr is not None:
                grads = tree_map(torch.add, grads, corr)
            updates, opt_state = opt.update(grads, opt_state, params, 0)
            params = apply_updates(params, updates)
            losses.append(loss.detach())
            # a full-width LM step holds several model-sized trees: free
            # this step's before the next one's backward allocates its own
            del grads, updates
        return params, torch.stack(losses).mean()

    return local_train


def _make_batched_local_train(adapter: FamilyAdapter, opt):
    """A cohort's E masked local SGD steps: each step's losses and gradients
    for every client under one ``torch.func.vmap`` of ``grad_and_value``
    (the reference vmaps its ``lax.scan``), the momentum update on the
    stacked trees.  ``params`` and ``masks`` either carry a leading client
    axis or are shared by the cohort (``stacked_params`` /
    ``stacked_masks`` False: the global params of a round's first step, a
    capable cohort's full masks); ``batches`` leaves are (C, E, ...);
    ``corr`` (SCAFFOLD) holds one gradient correction a client, (C, ...)
    leaves.  Returns (stacked params, (C,) mean losses as device values)."""
    step = torch.func.grad_and_value(adapter.loss_fn)

    def local_train(params, batches, masks, stacked_params: bool,
                    stacked_masks: bool, corr=None):
        opt_state = opt.init(params)
        m_dim = 0 if stacked_masks else None
        losses = []
        for i in range(next(iter(batches.values())).shape[1]):
            batch = {k: v[:, i] for k, v in batches.items()}
            grads, loss = torch.func.vmap(
                step, in_dims=(0 if stacked_params else None, 0, m_dim))(
                    params, batch, masks)
            if corr is not None:
                grads = tree_map(torch.add, grads, corr)
            updates, opt_state = opt.update(grads, opt_state, params, 0)
            params = apply_updates(params, updates)
            stacked_params = True
            losses.append(loss)
            del grads, updates
        return params, torch.stack(losses).mean(dim=0)

    return local_train


def _median_pace(capable_times: Sequence[float]) -> float:
    """Median capable-device cycle time, 1.0 for an all-straggler cohort."""
    return float(np.median(capable_times)) if capable_times else 1.0


def _collab_pace(clients: Sequence["Client"]) -> float:
    """§IV.C collaboration pace over a client list."""
    return _median_pace([cycle_time(c.profile, 1.0) for c in clients
                         if not c.is_straggler])


@dataclasses.dataclass
class Client:
    cid: int
    profile: DeviceProfile
    data_idx: np.ndarray
    volume: float = 1.0
    helios_state: Optional[dict] = None
    is_straggler: bool = False
    staleness_anchor: int = 0          # agg step the client last pulled from


@dataclasses.dataclass
class FLRun:
    """One sequential engine run: the global params + per-client state."""

    cfg: ModelConfig
    hcfg: HeliosConfig
    scheme: str
    clients: List[Client]
    train_data: Dict[str, np.ndarray]
    test_data: Dict[str, np.ndarray]
    batch_size: int = 32
    local_steps: int = 5
    lr: float = 0.05
    seed: int = 0
    eval_batch: int = 512              # eval CHUNK size (full set is scored)
    #: partial participation: sample this many clients per round (0 = all).
    #: The population's Helios state persists across rounds; only the
    #: sampled cohort trains, and §IV.C pace/volume adaptation runs over it.
    participation: int = 0
    #: cohort sampler: "uniform", or "time_weighted" (p ∝ 1/cycle_time, so
    #: fast devices are drawn more often and the round critical path drops)
    sampler: str = "uniform"
    #: async event processes (federated.events): completion-delay jitter and
    #: per-event update loss.  None = the deterministic Table-I cost model.
    arrival: Optional[ArrivalProcess] = None
    dropout: Optional[DropoutProcess] = None
    #: soft-training substrate: "reference" (plain masked ops) or "cuda"
    #: (block-sparse masked-matmul kernels, flash attention for the LM,
    #: the SSD intra-chunk kernel for the hybrid; "pallas" is an alias).
    #: None: "cuda" on a CUDA device, "reference" on the CPU
    kernels: Optional[str] = None
    #: kernel skip granularity; 0 follows HeliosConfig.mask_block (128 when
    #: that is 0 too), so selection blocks and kernel blocks agree
    mask_block: int = 0
    #: "cuda" unless "cpu" is asked for; no GPU and no CPU request raises
    device: DeviceLike = None
    #: initial global params (tensors or numpy arrays keyed like the spec);
    #: None draws them from ``seed``
    init_params: Optional[Mapping] = None
    #: uplink compression: "none", or a lossy codec applied to each
    #: client -> server delta at the aggregation boundary, with per-client
    #: error feedback and the Eq. 2 masks gating the encoder: "topk" (the
    #: top ``comp_frac`` coordinates a leaf, fp16 values), "quant" (dense
    #: int-``comp_bits``), "delta" (top-k with int-``comp_bits`` values).
    #: quant / delta also keep the async snapshot anchors in that form
    compression: str = "none"
    comp_frac: float = 0.05
    comp_bits: int = 8
    #: async anchors staler than this many aggregation steps decode from
    #: the lossy ring; fresher ones read full precision
    comp_fresh: int = 8
    #: the first ``comp_warmup`` sync rounds upload dense (the uncompressed
    #: round exactly); the async loops always compress
    comp_warmup: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._scheme: Scheme = make_scheme(self.scheme)
        self.kernels = canonical_impl(self.kernels or (
            CUDA if self.device.type == "cuda" else REFERENCE))
        self.mask_block = self.mask_block or self.hcfg.mask_block or 128
        self.adapter = make_adapter(self.cfg, self.kernels, self.mask_block,
                                    self.device)
        if self.init_params is None:
            self.global_params = _init_params(self.cfg, self.seed, self.device)
        else:
            self.global_params = tree_map(
                lambda v: (v.detach() if torch.is_tensor(v) else
                           torch.tensor(np.array(v))).to(self.device,
                                                         copy=True),
                dict(self.init_params))
        self.opt = make_optimizer("momentum", self.lr)
        self.rng = np.random.default_rng(self.seed)
        # participation draws live on their own stream, so full
        # participation stays draw-for-draw unchanged when sampling is off
        self.sample_rng = np.random.default_rng((self.seed, 0x5EED))
        self.cohort_log: List[List[int]] = []
        self.history: List[dict] = []
        self.round = 0
        if self.compression not in CP.MODES:
            raise ValueError(f"compression must be one of {CP.MODES}, "
                             f"got {self.compression!r}")
        if self.comp_fresh < 1:
            raise ValueError("comp_fresh must be >= 1 (the ring keeps at "
                             "least the newest anchor full-precision)")
        if self.comp_warmup < 0:
            raise ValueError("comp_warmup must be >= 0")
        self._n_params, self._n_leaves = CP.param_census(self.global_params)
        self.rec = Recorder()
        # the encoded coordinates, summed on the device in f32 (update by
        # update in FLRun, bucket by bucket and round by round in the
        # stacked engines, as in the reference); read by uplink_bytes()
        self.rec.accum("uplink_coords", torch.zeros((), device=self.device))
        if self.compression != "none":
            self._err_store = CP.HostErrorStore(self.global_params)
        for c in self.clients:
            c.helios_state = ST.init_state(self.adapter.schema,
                                           volume=c.volume, seed=c.cid,
                                           device=self.device)
        self._local_train = _make_local_train(self.adapter, self.opt)
        self._scheme.init_run(self)

    # -- the uplink codec --------------------------------------------------
    def _compress_one(self, base, new_params, err, pmasks):
        """One update through the codec: (base + decoded sent, the new error
        row, the encoded-coordinate count as a device scalar)."""
        delta = tree_map(lambda n, b: n.float() - b.float(), new_params, base)
        sent, new_err, coords = CP.compress_update(
            delta, err, self.compression, self.comp_frac, self.comp_bits,
            pmasks)
        hat = tree_map(lambda b, x: (b.float() + x).to(b.dtype), base, sent)
        return hat, new_err, coords

    def _ring_mode(self) -> str:
        """The async anchors' precision: quant / delta keep them in the
        matching lossy form; none / topk in fp32."""
        return self.compression \
            if self.compression in ("quant", "delta") else "fp32"

    def _comp_active(self) -> bool:
        """Whether this sync round's uplink goes through the codec (not in
        the first ``comp_warmup`` rounds)."""
        return self.compression != "none" and self.round >= self.comp_warmup

    # -- accounting ------------------------------------------------------
    def uplink_bytes(self) -> float:
        """Simulated client->server bytes.  ``none`` moves the dense f32
        params an update; the lossy modes bill their wire format
        (:func:`optim.compression.uplink_bytes`, one wait for the coordinate
        count), warmup rounds dense; a scheme's side channel (SCAFFOLD's
        control deltas) moves ``extra_dense_uplink`` dense trees an
        update."""
        dense = float(self.uplink_extra_updates) * self._n_params * 4.0
        if self.compression == "none":
            return dense + float(self.uplink_updates) * self._n_params * 4.0
        coords = self.rec.accum_value("uplink_coords")
        comp_updates = self.uplink_updates - self.uplink_dense_updates
        return (dense
                + float(self.uplink_dense_updates) * self._n_params * 4.0
                + CP.uplink_bytes(self.compression, coords, self._n_params,
                                  self._n_leaves * comp_updates,
                                  self.comp_bits))

    def downlink_bytes(self) -> float:
        """Simulated server->client bytes: every participant pulls the dense
        f32 global."""
        return float(self.downlink_updates) * self._n_params * 4.0

    # -- read-only counter views (the recorder is the single surface) ----
    @property
    def downlink_updates(self) -> int:
        return self.rec.count("downlink_updates")

    @property
    def uplink_updates(self) -> int:
        return self.rec.count("uplink_updates")

    @property
    def uplink_extra_updates(self) -> int:
        return self.rec.count("uplink_extra_updates")

    @property
    def uplink_dense_updates(self) -> int:
        return self.rec.count("uplink_dense_updates")

    @property
    def uplink_coords(self) -> torch.Tensor:
        return self.rec.accum_raw("uplink_coords")

    @property
    def events_processed(self) -> int:
        return self.rec.count("events_processed")

    @property
    def events_dropped(self) -> int:
        return self.rec.count("events_dropped")

    @property
    def agg_counter(self) -> int:
        return self.rec.count("agg_counter")

    @property
    def snapshot_peak(self) -> int:
        return self.rec.count("snapshot_peak", 1)

    @property
    def snapshot_anchor_misses(self) -> int:
        return self.rec.count("snapshot_anchor_misses")

    # -- one client's cycle ------------------------------------------------
    def _sample_batches(self, client: Client) -> dict:
        return self.adapter.sample_batch(self.rng, self.train_data,
                                         client.data_idx, self.local_steps,
                                         self.batch_size)

    def _client_masks(self, client: Client) -> dict:
        if self._scheme.soft_training and client.is_straggler:
            return client.helios_state["masks"]
        return ST.full_masks(self.adapter.schema, self.device)

    def _client_cycle(self, client: Client, base_params):
        """One local training cycle; returns (new_params, masks, ratio, loss)."""
        sch = self._scheme
        soft = sch.soft_training and client.is_straggler
        hcfg = sch.effective_hcfg(self.hcfg)
        if soft:
            client.helios_state = ST.begin_cycle(client.helios_state, hcfg)
        masks = self._client_masks(client)
        batches = self._sample_batches(client)
        if sch.uses_control:
            ci = self._ctrl_store.row(client.cid)
            corr = tree_map(torch.sub, self._c_global, ci)
            new_params, loss = self._local_train(base_params, batches, masks,
                                                 corr)
            # option-II control update from the raw trained params:
            # dc = (x - y) / (K * lr) - c_global
            inv = 1.0 / (self.local_steps * self.lr)
            dc = tree_map(lambda b, y, cg: (b.float() - y.float()) * inv - cg,
                          base_params, new_params, self._c_global)
            self._ctrl_store.set_row(
                client.cid, tree_map(lambda c, d: c.float() + d, ci, dc))
            self._dc_buf.append(dc)
        else:
            new_params, loss = self._local_train(base_params, batches, masks)
        if soft:
            if sch.use_delta_scores:
                scores = self.adapter.cycle_scores(new_params, base_params)
            else:                                          # random [12]
                scores = client.helios_state["scores"]
            client.helios_state = ST.end_cycle(client.helios_state, scores,
                                               hcfg)
        # a device scalar: converted behind the eval gate (_record_round)
        ratio = MK.selected_fraction(masks)
        return new_params, masks, ratio, loss

    def _apply_control(self) -> None:
        """Fold the buffered control deltas into ``c_global`` one after
        another, each over the population's size: after the cohort in a
        sync round (every client corrected by the round-start control),
        after each event in ``run_async``."""
        n = float(len(self.clients))
        for dc in self._dc_buf:
            self._c_global = tree_map(lambda c, d: c + d / n,
                                      self._c_global, dc)
        self._dc_buf = []

    def _aggregate(self, results) -> None:
        """results: list of (params, masks, ratio, loss)."""
        params = [r[0] for r in results]
        ratios = [r[2] for r in results]
        mode = self._scheme.agg_mode(self.hcfg)
        masks = None
        if mode == "masked_mean":
            masks = [self.adapter.expand_masks(r[1], self.global_params)
                     for r in results]
        self.global_params = AG.aggregate(mode, self.global_params, params,
                                          ratios=ratios, client_masks=masks)

    def evaluate(self) -> float:
        """Full-test-set metric (accuracy, or cross-entropy for the LM) in
        chunks of ``eval_batch`` (the one place the loop waits for the
        device)."""
        n = self.adapter.num_examples(self.test_data)
        total = weight = 0.0
        for lo in range(0, n, self.eval_batch):
            chunk = self.adapter.eval_slice(self.test_data, lo,
                                            min(lo + self.eval_batch, n))
            s, w = self.adapter.eval_chunk(self.global_params, chunk)
            total += float(s)
            weight += float(w)
        return total / max(weight, 1e-9)

    # -- the sync round ----------------------------------------------------
    def _draw_cohort(self) -> List[int]:
        """This round's participant indices (sorted, duplicate-free).

        Full participation returns every client and draws nothing.
        Sampling consumes one ``sample_rng`` draw per round;
        ``time_weighted`` weights clients by inverse simulated cycle time
        at their current volume (``_round_times`` over the fleet).
        """
        n = len(self.clients)
        k = self.participation
        if not k or k >= n:
            return list(range(n))
        if self.sampler == "uniform":
            p = None
        elif self.sampler == "time_weighted":
            t = np.asarray(self._round_times())
            w = 1.0 / np.maximum(t, 1e-9)
            p = w / w.sum()
        else:
            raise ValueError(f"unknown sampler {self.sampler!r}")
        idx = self.sample_rng.choice(n, size=k, replace=False, p=p)
        return sorted(int(i) for i in idx)

    def _round_times(self, clients: Optional[Sequence[Client]] = None) \
            -> List[float]:
        """Simulated wall time per client (the whole fleet by default) for
        one round, billed at the scheme's effective volume."""
        return [cycle_time(c.profile, self._scheme.effective_volume(c))
                for c in (self.clients if clients is None else clients)]

    def _train_cohort(self, cohort: List[int], cclients: List[Client]):
        """Train the drawn cohort against the current global params
        (consuming ``self.rng`` in cohort order) and aggregate; returns
        per-client (losses, ratios) in cohort order.  Under the delayed
        scheme a straggler trains from the stale base instead, and its
        update is virtualized onto the current global with the discount,
        so it rides the normal aggregation."""
        sch = self._scheme
        results = []
        for c in cclients:
            stale = sch.uses_stale_base and c.is_straggler
            base = self._stale_base if stale else self.global_params
            r = self._client_cycle(c, base)
            if stale:
                disc = self._stale_disc
                p = tree_map(lambda g, y, b: (g.float() + disc * (
                    y.float() - b.float())).to(g.dtype),
                    self.global_params, r[0], base)
                r = (p,) + r[1:]
            results.append(r)
        if sch.uses_control:
            self._apply_control()
        if self._comp_active():
            results = self._compress_results(cclients, results)
        self._aggregate(results)
        return [r[3] for r in results], [r[2] for r in results]

    def _compress_results(self, cclients: List[Client], results):
        """The lossy uplink: each client's new params become base + its
        decoded update, the un-sent residual goes into its error row; its
        Eq. 2 masks gate the encoder."""
        base = self.global_params
        out = []
        for c, r in zip(cclients, results):
            pmasks = self.adapter.expand_masks(r[1], base)
            hat, new_err, coords = self._compress_one(
                base, r[0], self._err_store.row(c.cid), pmasks)
            self._err_store.set_row(c.cid, new_err)
            self.rec.accum("uplink_coords", coords)
            out.append((hat,) + r[1:])
        return out

    def _adapt_volumes(self, cohort: List[int], cclients: List[Client],
                       times: List[float], pace: float) -> None:
        """Move straggler volumes toward the collaboration pace (§IV.C); the
        write into the Helios state is the engine's (``_write_volumes``)."""
        if not (self._scheme.adapt_volume and self.hcfg.adapt_volume):
            return
        upd = [j for j, c in enumerate(cclients) if c.is_straggler]
        for j in upd:
            c = cclients[j]
            c.volume = VOL.adapt_volume(c.volume, times[j], pace,
                                        self.hcfg.adapt_gain,
                                        self.hcfg.min_volume)
        if upd:
            self._write_volumes(cclients, upd)

    def _write_volumes(self, cclients: List[Client], upd: List[int]) -> None:
        for j in upd:
            cclients[j].helios_state = ST.set_volume(
                cclients[j].helios_state, cclients[j].volume)

    def _finish_sync(self) -> None:
        pass

    def _record_round(self, r: int, rounds: int, eval_every: int,
                      clock: float, losses, ratios) -> None:
        """History row (eval_every=0 disables evaluation/history); converts
        the per-client device scalars to host floats here."""
        if eval_every > 0 and (r % eval_every == 0 or r == rounds - 1):
            self.history.append({
                "scheme": self.scheme, "cycle": r + 1, "time": clock,
                "record_cadence": "round",
                self.adapter.metric_name: self.evaluate(),
                "loss": float(torch.stack(losses).mean()),
                "ratios": [float(x) for x in torch.stack(ratios).cpu()],
                "volumes": [c.volume for c in self.clients],
                "downlink_mb": self.downlink_bytes() / 1e6})

    def run_sync(self, rounds: int, eval_every: int = 1) -> List[dict]:
        """``rounds`` synchronous rounds: draw the cohort -> pace over the
        cohort -> simulated times -> ``round_start`` -> train -> volume
        adaptation -> ``round_end`` -> clock -> record.  Unsampled clients
        keep their Helios state untouched."""
        clock = 0.0
        for r in range(rounds):
            cohort = self._draw_cohort()
            self.cohort_log.append(cohort)
            cclients = [self.clients[i] for i in cohort]
            pace = _collab_pace(cclients)
            times = self._round_times(cclients)
            self.rec.inc("downlink_updates", len(cohort))   # global broadcast
            self._scheme.round_start(self)
            losses, ratios = self._train_cohort(cohort, cclients)
            self.rec.inc("uplink_updates", len(cohort))
            if self.compression != "none" and not self._comp_active():
                self.rec.inc("uplink_dense_updates", len(cohort))  # warmup
            self.rec.inc("uplink_extra_updates",
                         len(cohort) * self._scheme.extra_dense_uplink)
            self._adapt_volumes(cohort, cclients, times, pace)
            self._scheme.round_end(self)
            clock += self._scheme.round_duration(times, cclients)
            self.round += 1
            self._record_round(r, rounds, eval_every, clock, losses, ratios)
        self._finish_sync()
        return self.history

    # -- the async event loop ----------------------------------------------
    def _next_delay(self, client: Client) -> float:
        """Delay until this client's next completion: the Table-I cost
        model, optionally perturbed by the arrival process."""
        base = cycle_time(client.profile, 1.0)
        return self.arrival.delay(client.cid, base) if self.arrival else base

    def _reset_async_processes(self) -> None:
        for p in (self.arrival, self.dropout):
            if p is not None:
                p.reset(self.seed)

    def run_async(self, capable_cycles: int, mix_weight: float = 0.5,
                  staleness_a: float = 0.5, eval_every: int = 1,
                  snapshot_cap: int = 64) -> List[dict]:
        """One client cycle per completion event, until the capable
        clients completed ``capable_cycles`` cycles (asyn / afo, and every
        other scheme's event semantics).

        A client trains from the global it pulled at its last completion
        (``snapshots[staleness_anchor]``, kept by reference: every update
        builds new tensors) and its result is mixed into the current global
        at the scheme's weight.  Snapshots are evicted oldest first beyond
        ``snapshot_cap``, never the newest one nor a live anchor, so the
        dict stays within ``snapshot_cap + len(clients) + 1``.
        """
        clock = SimClock()
        self._reset_async_processes()
        snapshots = {0: self.global_params}
        # the lossy ring's semantics: snapshots stay full precision here,
        # and an anchor read past the freshness window decodes through the
        # quantize -> dequantize the bucket engine's rows pay when written
        ring_mode = self._ring_mode()
        ring_ref = tree_map(lambda x: x.float().clone(), self.global_params) \
            if ring_mode == "delta" else None
        self.rec.set("snapshot_peak", 1)
        self.rec.set("snapshot_anchor_misses", 0)
        self.rec.set("events_processed", 0)
        self.rec.set("events_dropped", 0)
        for c in self.clients:
            c.staleness_anchor = 0
            clock.schedule(self._next_delay(c), c.cid)
        done_fast = 0
        agg_counter = 0
        by_id = {c.cid: c for c in self.clients}
        while done_fast < capable_cycles and not clock.empty():
            cid = clock.pop()
            c = by_id[cid]
            if self.dropout is not None and self.dropout.drops(cid):
                self.rec.inc("events_dropped")
                clock.schedule(self._next_delay(c) * self.dropout.penalty,
                               cid)
                continue
            # anchors are never evicted (below): this lookup cannot miss
            base = snapshots[c.staleness_anchor]
            stale = agg_counter - c.staleness_anchor
            if ring_mode != "fp32" and stale >= self.comp_fresh:
                base = AG.lossy_roundtrip(base, ring_ref, self.comp_bits)
            new_params, masks, _, loss = self._client_cycle(c, base)
            if self.compression != "none":
                new_params, new_err, coords = self._compress_one(
                    base, new_params, self._err_store.row(c.cid),
                    self.adapter.expand_masks(masks, base))
                self._err_store.set_row(c.cid, new_err)
                self.rec.accum("uplink_coords", coords)
            self.rec.inc("uplink_updates")
            self.rec.inc("uplink_extra_updates",
                         self._scheme.extra_dense_uplink)
            w = self._scheme.async_weight(mix_weight, stale, staleness_a)
            self.global_params = AG.mix(self.global_params, new_params, w)
            if self._scheme.uses_control:
                self._apply_control()          # per event: async semantics
            agg_counter += 1
            snapshots[agg_counter] = self.global_params
            c.staleness_anchor = agg_counter
            if len(snapshots) > snapshot_cap:
                anchored = {cl.staleness_anchor for cl in self.clients}
                for k in sorted(snapshots):
                    if len(snapshots) <= snapshot_cap:
                        break
                    if k != agg_counter and k not in anchored:
                        del snapshots[k]
                self.rec.inc("snapshot_anchor_misses", sum(
                    cl.staleness_anchor not in snapshots
                    for cl in self.clients))
            self.rec.set_max("snapshot_peak", len(snapshots))
            clock.schedule(self._next_delay(c), cid)
            self.rec.inc("events_processed")
            self.rec.inc("downlink_updates")   # the event's snapshot pull
            if not c.is_straggler:
                done_fast += 1
                if eval_every > 0 and done_fast % eval_every == 0:
                    self.history.append({
                        "scheme": self.scheme, "cycle": done_fast,
                        "time": clock.now,
                        "record_cadence": "event",
                        self.adapter.metric_name: self.evaluate(),
                        # behind the eval gate: evaluate() just synced
                        "loss": float(loss),  # repro: noqa[R3]
                        "staleness": stale,
                        "downlink_mb": self.downlink_bytes() / 1e6})
        self.rec.set("agg_counter", agg_counter)
        self.rec.set("queue_peak", clock.peak_depth)
        return self.history

    # -- elastic membership (§VI.C) ----------------------------------------
    def add_client(self, profile: DeviceProfile, data_idx: np.ndarray,
                   white_box: bool = True) -> Client:
        """A device joins mid-flight: identify -> assign volume -> admit."""
        cid = max((c.cid for c in self.clients), default=-1) + 1
        if white_box:
            _, stragglers = identify_resource_based(
                workload_gflop=100.0, memory_mb=200.0,
                devices=[c.profile for c in self.clients] + [profile])
            is_straggler = len(self.clients) in stragglers or \
                profile.speed_factor > 1.5
        else:
            sim = [cycle_time(c.profile, 1.0) for c in self.clients] + \
                [cycle_time(profile, 1.0)]
            _, stragglers = identify_time_based(
                lambda d: None, len(sim), simulated_times=sim)
            is_straggler = len(self.clients) in stragglers
        pace = _collab_pace(self.clients)
        vol = VOL.volume_from_profile(cycle_time(profile, 1.0), pace,
                                      self.hcfg.min_volume) \
            if is_straggler else 1.0
        c = Client(cid=cid, profile=profile, data_idx=data_idx, volume=vol,
                   is_straggler=is_straggler)
        c.helios_state = ST.init_state(self.adapter.schema, volume=vol,
                                       seed=cid, device=self.device)
        self.clients.append(c)
        return c

    def remove_client(self, cid: int) -> None:
        """A device leaves: it drops out of the next aggregation."""
        self.clients = [c for c in self.clients if c.cid != cid]


class AsyncFLRun(FLRun):
    """Bucketed event engine for the async schemes (asyn / afo) on the CNN
    testbed.

    The event semantics are ``FLRun.run_async``'s, executed in bulk:

    * the event core (:class:`SimClock`) pops a bucket of exactly one
      equal-time group of completions (at most :data:`MAX_BUCKET`), which
      cannot reorder events against the sequential loop, since a client's
      next completion is strictly later than its current one;
    * each event trains from its own anchor, a row of a device-side
      :class:`core.aggregation.SnapshotRing`, and the whole bucket's local
      training runs as one vmapped training (anchors predate the bucket);
    * the mixes fold over the bucket in event order
      (:func:`core.aggregation.mix_bucket_ring`), each post-mix global
      written to the ring row its client re-anchors to;
    * buckets are padded to the next power of two (padding repeats slot 0's
      batch without a host draw, mixes at weight 0 and writes the ring's
      scratch row), as in the reference.

    Batch, arrival and dropout draws, anchoring and mixing order replay
    the sequential loop, so a fixed seed gives the same global params up to
    rounding.  History is recorded at most once per bucket, after its
    mixes (``record_cadence: "bucket"``), where the sequential loop records
    at every ``eval_every``-th capable completion.  Schemes that are not
    async-native (per-event soft-training state) run the sequential loop,
    as in the reference.
    """

    def __post_init__(self):
        super().__post_init__()
        if not isinstance(self.adapter, CNNAdapter):
            raise NotImplementedError(
                f"{type(self).__name__} runs the CNN testbed only: the "
                f"{self.cfg.family!r} family needs vmap rules for its "
                "flash_attention / ssd_diag Functions, the moe family a "
                "vmapped expert dispatch too (ROADMAP.md item 19)")
        #: one tensor per key for the whole run, so the kernels' live tables
        #: of a capable cohort are built once
        self._ones = ST.full_masks(self.adapter.schema, self.device)
        self._train_batched = _make_batched_local_train(self.adapter,
                                                        self.opt)

    def _bucket(self, ring: AG.SnapshotRing, base_slots: List[int],
                write_slots: List[int], batches: dict, stales: List[int],
                b: int, mix_weight: float, staleness_a: float, err=None,
                fresh_read=(), fresh_write=(), is_fresh=()):
        """One bucket of ``len(base_slots)`` events (the first ``b`` real):
        train every event from its anchor row, then mix in event order.
        Returns the (B,) losses as device values and, under compression,
        (the new error rows, the real events' encoded coordinates as a
        device scalar), else None.

        Under compression ``err`` holds the events' error rows: the anchors
        decode from the ring (a lossy ring's int row or, inside the
        freshness window, its full-precision row ``fresh_read``), each
        event's delta goes through the codec without masks (asyn / afo
        train full models) and the decoded updates are mixed; a lossy ring
        re-encodes each post-mix global into its slot and into fresh row
        ``fresh_write``."""
        dev = self.device
        lossy = ring.mode != "fp32"
        if lossy:
            base = AG.ring_gather_lossy(ring.q, ring.scales, ring.fresh_buf,
                                        ring.ref, base_slots, fresh_read,
                                        is_fresh)
        else:
            idx = torch.as_tensor(base_slots, device=dev)
            base = tree_map(lambda r: r.index_select(0, idx), ring.params)
        trained, losses = self._train_batched(base, batches, self._ones,
                                              True, False)
        w = torch.full((len(base_slots),), float(mix_weight), device=dev)
        if self._scheme.staleness_discount:
            w = w * AG.staleness_weights(
                torch.as_tensor(stales, dtype=torch.float32, device=dev),
                staleness_a)
        valid = torch.as_tensor([1.0] * b + [0.0] * (len(base_slots) - b),
                                device=dev)
        w = w * valid
        if err is None:
            self.global_params, ring.params = AG.mix_bucket_ring(
                self.global_params, ring.params, write_slots, trained, w)
            return losses, None
        delta = tree_map(lambda t, x: t.float() - x.float(), trained, base)
        sent, new_err, coords = CP.compress_update_stacked(
            delta, err, self.compression, self.comp_frac, self.comp_bits)
        hat = tree_map(lambda x, y: (x.float() + y).to(x.dtype), base, sent)
        if lossy:
            self.global_params, ring.q, ring.scales, ring.fresh_buf = \
                AG.mix_bucket_ring_lossy(
                    self.global_params, ring.q, ring.scales, ring.fresh_buf,
                    ring.ref, write_slots, fresh_write, hat, w,
                    self.comp_bits)
        else:
            self.global_params, ring.params = AG.mix_bucket_ring(
                self.global_params, ring.params, write_slots, hat, w)
        return losses, (new_err, (coords * valid).sum())

    def run_async(self, capable_cycles: int, mix_weight: float = 0.5,
                  staleness_a: float = 0.5, eval_every: int = 1,
                  snapshot_cap: int = 64) -> List[dict]:
        if not self._scheme.async_native:
            return super().run_async(capable_cycles, mix_weight,
                                     staleness_a, eval_every, snapshot_cap)
        clock = SimClock()
        self._reset_async_processes()
        by_id = {c.cid: c for c in self.clients}
        ring = AG.SnapshotRing(self.global_params, snapshot_cap,
                               len(self.clients), mode=self._ring_mode(),
                               bits=self.comp_bits,
                               fresh_window=self.comp_fresh)
        F = ring.fresh_window
        for c in self.clients:
            c.staleness_anchor = 0
            ring.alloc.retain(0)
            clock.schedule(self._next_delay(c), c.cid)
        for name in ("agg_counter", "events_processed", "events_dropped"):
            self.rec.set(name, 0)
        self.bucket_sizes: List[int] = []
        done_fast = 0
        next_rec = eval_every if eval_every > 0 else 0
        while done_fast < capable_cycles and not clock.empty():
            evs = clock.pop_bucket(0.0, MAX_BUCKET)
            # dropout draws and the capable budget, in event order: the
            # sequential loop stops mid-group when the budget runs out, so
            # the bucket cuts at the same event and puts the tail back
            exec_evs, drop_cids = [], set()
            budget = capable_cycles - done_fast
            cut = None
            for i, ev in enumerate(evs):
                if self.dropout is not None and self.dropout.drops(ev.cid):
                    drop_cids.add(ev.cid)
                    continue
                exec_evs.append(ev)
                if not by_id[ev.cid].is_straggler:
                    budget -= 1
                    if budget == 0:
                        cut = i + 1
                        break
            handled = evs if cut is None else evs[:cut]
            for ev in evs[len(handled):]:
                clock.schedule_at(ev.time, ev.cid)
            b = len(exec_evs)
            if b:
                bpad = 1 << (b - 1).bit_length()
                batches = self.adapter.sample_cohort(
                    self.rng, self.train_data,
                    [by_id[ev.cid].data_idx for ev in exec_evs],
                    self.local_steps, self.batch_size, pad_to=bpad)
                agg0 = self.agg_counter
                base_slots, write_slots, stales = [], [], []
                fresh_read, fresh_write, is_fresh = [], [], []
                for i, ev in enumerate(exec_evs):
                    c = by_id[ev.cid]
                    base_slots.append(ring.alloc.slot_of(c.staleness_anchor))
                    stales.append(agg0 + i - c.staleness_anchor)
                    # freshness per event, the sequential loop's
                    # stale < window rule; an anchor inside the window
                    # still has its full-precision row (one write an agg)
                    fresh_read.append(c.staleness_anchor % F)
                    is_fresh.append(1.0 if stales[-1] < F else 0.0)
                    ring.alloc.release(c.staleness_anchor)
                    write_slots.append(ring.alloc.alloc(agg0 + i + 1))
                    ring.alloc.retain(agg0 + i + 1)
                    c.staleness_anchor = agg0 + i + 1
                    fresh_write.append((agg0 + i + 1) % F)
                self.rec.set("agg_counter", agg0 + b)
                pad = bpad - b
                args = (ring, base_slots + [0] * pad,
                        write_slots + [ring.scratch] * pad, batches,
                        stales + [0] * pad, b, mix_weight, staleness_a)
                if self.compression == "none":
                    losses, _ = self._bucket(*args)
                else:
                    # padding rows read cids[0]'s error row and write the
                    # scratch rows at weight 0; only the real rows go back
                    cids = [ev.cid for ev in exec_evs]
                    losses, (new_err, coords) = self._bucket(
                        *args, err=self._err_store.gather(
                            cids + [cids[0]] * pad),
                        fresh_read=fresh_read + [0] * pad,
                        fresh_write=fresh_write + [F] * pad,
                        is_fresh=is_fresh + [1.0] * pad)
                    self.rec.accum("uplink_coords", coords)
                    self._err_store.scatter(
                        cids, tree_map(lambda x: x[:b], new_err))
                self.rec.inc("uplink_updates", b)
                self.rec.inc("events_processed", b)
                self.rec.inc("downlink_updates", b)   # per-event ring pulls
                self.bucket_sizes.append(b)
                done_fast += sum(not by_id[ev.cid].is_straggler
                                 for ev in exec_evs)
            # every handled event rescheduled in event order (the arrival
            # stream's order in the sequential loop)
            for ev in handled:
                delay = self._next_delay(by_id[ev.cid])
                if ev.cid in drop_cids:
                    delay *= self.dropout.penalty
                clock.schedule_at(ev.time + delay, ev.cid)
            self.rec.inc("events_dropped", len(drop_cids))
            if next_rec and b and done_fast >= next_rec:
                self.history.append({
                    "scheme": self.scheme, "cycle": done_fast,
                    "time": clock.now,
                    "record_cadence": "bucket",
                    self.adapter.metric_name: self.evaluate(),
                    # behind the eval gate: evaluate() just synced
                    "loss": float(losses[:b].mean()),  # repro: noqa[R3]
                    "staleness": float(np.mean(stales)),
                    "bucket": b,
                    "downlink_mb": self.downlink_bytes() / 1e6})
                next_rec = (done_fast // eval_every + 1) * eval_every
        self.rec.set("snapshot_peak", ring.alloc.peak_live)
        self.rec.set("snapshot_anchor_misses", ring.alloc.anchor_misses)
        self.rec.set("queue_peak", clock.peak_depth)
        return self.history


class BatchedFLRun(AsyncFLRun):
    """Batched sync engine: a round as one vmapped training per cohort.

    Clients split into two cohorts, so each cohort's control flow is
    uniform: the soft-training stragglers (Eq. 2 selection, masked local
    training, Eq. 1 scores, all under their per-client Helios state stacked
    along a leading client axis) and the capable clients (full-model local
    training from the shared global params).  Each local step of a cohort
    is one vmapped step, so the masked kernels launch once a step per
    cohort, whatever the cohort's size.  Eq. 2 selection runs client by
    client (each client's draws are a host-named stream); the Eq. 10 /
    masked-mean aggregation runs over the stacked rows in the original
    client order.  Batch draws replay the sequential engine's client order,
    so a fixed seed gives its trajectory up to rounding.  The scheme's
    extra round inputs and outputs (SCAFFOLD's control rows, the delayed
    scheme's stale base) pass through :meth:`_round_extras` and
    :meth:`_apply_round_outs`, as in the reference; like the reference's
    batched program, SCAFFOLD folds ``c += sum(dc) / N`` and a delayed
    capable row is ``g + 1 * (y - g)``, where ``FLRun`` folds dc by dc and
    keeps ``y``.

    Under full participation the stacked straggler state persists between
    rounds (``sync_client_states`` writes it back into each client's
    ``helios_state``, as every ``run_sync`` does at its end); a sampled
    cohort stacks and unstacks its members' states each round.  The async
    schemes run on the inherited bucketed engine.
    """

    def __post_init__(self):
        super().__post_init__()
        self._build_batched()

    def _split(self, clients: Sequence[Client]):
        """(straggler positions, capable positions, the permutation that
        puts the two cohorts' rows back into ``clients`` order)."""
        soft = self._scheme.soft_training
        s_pos = [j for j, c in enumerate(clients) if soft and c.is_straggler]
        c_pos = [j for j, c in enumerate(clients)
                 if not (soft and c.is_straggler)]
        unperm = torch.as_tensor(np.argsort(np.asarray(s_pos + c_pos)),
                                 device=self.device)
        return s_pos, c_pos, unperm

    def _build_batched(self) -> None:
        self._s_idx, self._c_idx, self._unperm = self._split(self.clients)
        # sampled cohorts change membership each round: each client's
        # helios_state stays the state of record (_train_cohort stacks them)
        self._sstate = None if self.participation or not self._s_idx else \
            ST.stack_states([self.clients[i].helios_state
                             for i in self._s_idx])

    def _round(self, sstate, s_batch, c_batch, unperm, extras=(), err=None):
        """Both cohorts' cycles and the aggregation.  ``extras`` are the
        scheme's inputs in :meth:`_round_extras`' order; ``err`` the rows'
        error rows when the round compresses.  Returns (the new stacked
        straggler state, losses, ratios, the scheme's outputs for
        :meth:`_apply_round_outs`, and under compression (the new error
        rows, the round's encoded coordinates) else None), rows in client
        order."""
        sch, g = self._scheme, self.global_params
        hcfg = sch.effective_hcfg(self.hcfg)
        extras = list(extras)
        if sch.uses_control:
            c_global, c_rows = extras.pop(0), extras.pop(0)
        if sch.uses_stale_base:
            stale_base, flags, discs = extras
        parts_p, parts_r, parts_l, parts_m = [], [], [], []
        if sstate is not None:
            n_s = len(sstate["rng"])
            sstate = ST.stack_states([ST.begin_cycle(st, hcfg) for st in
                                      ST.unstack_states(sstate, n_s)])
            masks = sstate["masks"]
            p, loss = self._train_batched(g, s_batch, masks, False, True)
            if sch.use_delta_scores:
                scores = torch.func.vmap(
                    lambda pp: self.adapter.cycle_scores(pp, g))(p)
            else:                                          # random [12]
                scores = sstate["scores"]
            sstate = ST.end_cycle(sstate, scores, hcfg)
            parts_p.append(p)
            parts_r.append(MK.selected_fractions(masks))
            parts_l.append(loss)
            parts_m.append(masks)
        if c_batch is not None:
            n_c = next(iter(c_batch.values())).shape[0]
            if sch.uses_control:
                p, loss = self._train_batched(
                    g, c_batch, self._ones, False, False,
                    tree_map(torch.sub, c_global, c_rows))
            elif sch.uses_stale_base:
                # each row trains from its own base (the stale global for a
                # straggler), then is virtualized onto the current global:
                # a capable row is g + 1 * (y - g), as in the reference
                def rows(v, x):
                    return v.view((n_c,) + (1,) * x.dim())

                base = tree_map(lambda sb, gg: torch.where(
                    rows(flags, gg) > 0, sb, gg), stale_base, g)
                p, loss = self._train_batched(base, c_batch, self._ones,
                                              True, False)
                p = tree_map(lambda gg, y, b: (gg.float() + rows(discs, gg) * (
                    y.float() - b.float())).to(gg.dtype), g, p, base)
            else:
                p, loss = self._train_batched(g, c_batch, self._ones, False,
                                              False)
            parts_p.append(p)
            parts_r.append(torch.ones(n_c, device=self.device))
            parts_l.append(loss)
            parts_m.append(tree_map(lambda v: v.expand(n_c, *v.shape),
                                    self._ones))

        def cat(parts):
            return tree_map(lambda *xs: torch.cat(xs).index_select(0, unperm),
                            *parts)

        stacked, ratios, losses = cat(parts_p), cat(parts_r), cat(parts_l)
        outs = ()
        if sch.uses_control:
            # option-II control update from the raw trained rows
            inv = 1.0 / (self.local_steps * self.lr)
            dc = tree_map(lambda gg, t, cg: (gg.float() - t.float()) * inv
                          - cg, g, stacked, c_global)
            outs = (tree_map(torch.add, c_rows, dc),
                    tree_map(lambda d: d.sum(dim=0), dc))
        mode = sch.agg_mode(self.hcfg)
        pmasks = self.adapter.expand_masks_batch(cat(parts_m), g) \
            if mode == "masked_mean" or err is not None else None
        codec = None
        if err is not None:
            # every row's delta through the codec under its expanded Eq. 2
            # masks (a capable row's are ones), the decoded rows aggregated
            delta = tree_map(lambda t, gg: t.float() - gg.float(), stacked, g)
            sent, new_err, coords = CP.compress_update_stacked(
                delta, err, self.compression, self.comp_frac, self.comp_bits,
                pmasks)
            stacked = tree_map(lambda gg, x: (gg.float() + x).to(gg.dtype),
                               g, sent)
            codec = new_err, coords.sum()
        self.global_params = AG.aggregate_stacked(
            mode, g, stacked, ratios, pmasks if mode == "masked_mean" else None)
        return sstate, losses, ratios, outs, codec

    def _round_extras(self, row_clients: Sequence[Client]) -> tuple:
        """The scheme's round inputs: SCAFFOLD's control and the clients'
        control rows; the delayed scheme's stale base, straggler flags and
        discounts.  The schemes that take extras have no soft cohort, so
        the rows follow ``row_clients``."""
        sch, dev = self._scheme, self.device
        extras = ()
        if sch.uses_control:
            extras += (self._c_global, self._ctrl_store.gather(
                [c.cid for c in row_clients]))
        if sch.uses_stale_base:
            flags = torch.tensor([1.0 if c.is_straggler else 0.0
                                  for c in row_clients], device=dev)
            discs = torch.tensor([self._stale_disc if c.is_straggler else 1.0
                                  for c in row_clients], dtype=torch.float32,
                                 device=dev)
            extras += (self._stale_base, flags, discs)
        return extras

    def _apply_round_outs(self, row_clients: Sequence[Client], outs) -> None:
        """SCAFFOLD: write the new control rows back by cid and fold
        ``c_global += sum(dc) / N`` over the population's N."""
        if self._scheme.uses_control:
            new_rows, dc_sum = outs
            self._ctrl_store.scatter([c.cid for c in row_clients], new_rows)
            n = float(len(self.clients))
            self._c_global = tree_map(lambda c, d: c + d / n,
                                      self._c_global, dc_sum)

    def _train_cohort(self, cohort: List[int], cclients: List[Client]):
        """Both cohorts of the drawn clients, batches drawn in cohort order
        (the sequential engine's draw order).  Under sampling the members'
        states are stacked for the round and written back after it."""
        if self.participation:
            s_pos, c_pos, unperm = self._split(cclients)
            sstate = ST.stack_states([cclients[j].helios_state
                                      for j in s_pos]) if s_pos else None
        else:
            s_pos, c_pos, unperm = self._s_idx, self._c_idx, self._unperm
            sstate = self._sstate
        per = [self._sample_batches(c) for c in cclients]

        def stack(pos):
            return {k: torch.stack([per[j][k] for j in pos])
                    for k in per[0]} if pos else None

        # error rows follow the rows' order, cclients' (warmup rounds run
        # the uncompressed round exactly)
        cids = [c.cid for c in cclients]
        sstate, losses, ratios, outs, codec = self._round(
            sstate, stack(s_pos), stack(c_pos), unperm,
            self._round_extras(cclients),
            self._err_store.gather(cids) if self._comp_active() else None)
        if codec is not None:
            new_err, coords = codec
            self.rec.accum("uplink_coords", coords)
            self._err_store.scatter(cids, new_err)
        self._apply_round_outs(cclients, outs)
        if self.participation:
            for j, st in zip(s_pos, ST.unstack_states(sstate, len(s_pos))
                             if s_pos else ()):
                cclients[j].helios_state = st
        else:
            self._sstate = sstate
        # device values: _record_round converts them behind the eval gate
        return list(losses.unbind()), list(ratios.unbind())

    def _write_volumes(self, cclients: List[Client], upd: List[int]) -> None:
        if self.participation:
            super()._write_volumes(cclients, upd)
        elif self._s_idx:
            self._sstate = ST.set_volumes(
                self._sstate, [self.clients[i].volume for i in self._s_idx])

    def _finish_sync(self) -> None:
        # callers that inspect clients never see round-0 state
        self.sync_client_states()

    def run_async(self, *args, **kwargs) -> List[dict]:
        if self._scheme.async_native:
            return super().run_async(*args, **kwargs)      # bucketed engine
        # the sequential event loop (through AsyncFLRun) evolves each
        # client's helios_state: write the stacked state back, run, restack
        self.sync_client_states()
        hist = super().run_async(*args, **kwargs)
        self._build_batched()
        return hist

    def sync_client_states(self) -> None:
        """Write the stacked straggler state back into each client's
        ``helios_state``."""
        if self._sstate is not None:
            for i, st in zip(self._s_idx, ST.unstack_states(
                    self._sstate, len(self._s_idx))):
                self.clients[i].helios_state = st

    def add_client(self, profile: DeviceProfile, data_idx: np.ndarray,
                   white_box: bool = True) -> Client:
        self.sync_client_states()
        c = super().add_client(profile, data_idx, white_box)
        self._build_batched()                 # the cohorts changed
        return c

    def remove_client(self, cid: int) -> None:
        self.sync_client_states()
        super().remove_client(cid)
        self._build_batched()


def setup_clients(profiles: Sequence[DeviceProfile],
                  parts: Sequence[np.ndarray],
                  hcfg: HeliosConfig,
                  identification: str = "resource",
                  device: DeviceLike = None) -> List[Client]:
    """Straggler identification (§IV.B) + volume targets (§IV.C).

    ``device`` is checked here (``cuda`` unless ``cpu`` is asked for), so a
    fleet meant for a GPU that is not there fails before any run starts.
    """
    resolve_device(device)
    n = len(profiles)
    sim_times = [cycle_time(p, 1.0) for p in profiles]
    if identification == "resource":
        _, stragglers = identify_resource_based(
            workload_gflop=100.0, memory_mb=200.0, devices=list(profiles))
    else:
        _, stragglers = identify_time_based(lambda d: None, n,
                                            simulated_times=sim_times)
    pace = _median_pace([t for i, t in enumerate(sim_times)
                         if i not in stragglers])
    clients = []
    for i, p in enumerate(profiles):
        is_s = i in stragglers
        vol = VOL.volume_from_profile(sim_times[i], pace, hcfg.min_volume) \
            if is_s else 1.0
        clients.append(Client(cid=i, profile=p, data_idx=parts[i],
                              volume=vol, is_straggler=is_s))
    return clients
