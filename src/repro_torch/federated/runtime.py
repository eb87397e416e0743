# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Federated round engines: ``FLRun``, ``AsyncFLRun``, ``BatchedFLRun`` and
``ShardedFLRun``.

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
* :class:`AsyncFLRun` — the bucketed async engine (asyn / afo; every
  family ``FLRun`` federates): a bucket of equal-time completions trains
  under one ``torch.func.vmap`` from the rows of a device-side snapshot
  ring and is mixed in event order.  Same seed, same global-param trajectory as
  ``FLRun.run_async`` up to rounding.
* :class:`BatchedFLRun` — the batched sync engine (every family
  ``FLRun`` federates): a round runs the soft-training stragglers and
  the capable clients as two cohorts, each local step of a cohort one
  vmapped step whose masked products, flash attention and ``ssd_diag``
  calls are one kernel launch each for the whole cohort.  Inherits the
  bucketed async path.
* :class:`ShardedFLRun` — the population-scale engine: a persistent
  population's Helios state in host rows, a sampled cohort padded to a
  multiple of the clients group's ranks, each rank's block of slots one
  vmapped step a local step, partial sums joined by one ``all_reduce``.

The loops never wait for the device except in ``evaluate`` and the history
row behind the eval gate.

Telemetry (``repro_torch.obs``): the run's :class:`Recorder` holds the
engines' counters; armed, it also takes the reference's spans
(``scheme.round_start`` / ``train_cohort`` / ``scheme.round_end`` /
``publish``), events (``round``, ``volumes``, ``history``, ``completion``,
``drop``, ``bucket``, ``publish``, ``error_store``) and histograms
(``staleness``, ``queue_depth``, ``bucket_size``), all from host values
the loops already hold.  ``publish_dir`` makes every ``publish_every``-th
sync round write the global params as an atomic checkpoint for a
``launch.serve.ServeLoop`` to pick up.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from numpy.typing import ArrayLike

from repro_torch import checkpoint as CKPT
from repro_torch.configs.base import HeliosConfig, ModelConfig
from repro_torch.core import aggregation as AG
from repro_torch.core import masking as MK
from repro_torch.core import soft_train as ST
from repro_torch.core import volume as VOL
from repro_torch.core.identification import (DeviceProfile,
                                             identify_resource_based,
                                             identify_time_based)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated.adapter import FamilyAdapter, make_adapter
from repro_torch.federated.events import (ArrivalProcess, DropoutProcess,
                                          SimClock)
from repro_torch.federated.heterogeneity import cycle_time
from repro_torch.federated.schemes import Scheme, make_scheme
from repro_torch.kernels.ops import CUDA, REFERENCE, canonical_impl
from repro_torch.launch.mesh import ClientGroup, make_client_group
from repro_torch.models import init_params as _init_params
from repro_torch.models.module import (tree_leaves, tree_map, tree_paths,
                                       unflatten)
from repro_torch.obs import recorder as OBS
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
    #: the client's example indices: an array or a lazy partition view
    #: (``data.federated.*_lazy``), materialized by ``np.asarray`` only
    #: when its batches are drawn
    data_idx: ArrayLike
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
    #: telemetry recorder; None builds one, armed only under
    #: ``REPRO_OBS=on`` (or an ``obs.override``).  Pass one to arm it or to
    #: share it with other runs and the serving plane.  The engine's
    #: counters (``uplink_updates``, ``events_processed``, ...) are views
    #: onto it.
    recorder: Optional[OBS.Recorder] = None
    #: serve while you train: every ``publish_every``-th sync round writes
    #: the global params to this directory as an atomic checkpoint
    #: (``repro_torch.checkpoint``) with ``{"round", "sim_time", "scheme"}``
    #: metadata, the newest ``publish_keep`` kept
    publish_dir: Optional[str] = None
    publish_every: int = 1
    publish_keep: int = 3

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
        if self.publish_every < 1:
            raise ValueError("publish_every must be >= 1")
        self._n_params, self._n_leaves = CP.param_census(self.global_params)
        self.rec = self.recorder if self.recorder is not None \
            else OBS.Recorder()
        # the encoded coordinates, summed on the device in f32 (update by
        # update in FLRun, bucket by bucket and round by round in the
        # stacked engines, as in the reference); read by uplink_bytes()
        self.rec.accum("uplink_coords", torch.zeros((), device=self.device))
        if self.compression != "none":
            self._err_store = CP.HostErrorStore(self.global_params)
        self._init_helios()
        self._local_train = _make_local_train(self.adapter, self.opt)
        self._scheme.init_run(self)
        if self.rec.armed:                 # the manifest is emission-side
            self.rec.manifest.update(self._obs_manifest())

    def _init_helios(self) -> None:
        """Each client's Helios state, seeded by its cid."""
        for c in self.clients:
            c.helios_state = ST.init_state(self.adapter.schema,
                                           volume=c.volume, seed=c.cid,
                                           device=self.device)

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

    # -- telemetry -----------------------------------------------------------
    def _obs_manifest(self) -> dict:
        """The run's identity for the run log: engine, scheme and its flag
        census, family, the kernel and codec knobs, the fleet, seeds and
        the git sha."""
        return {"engine": type(self).__name__,
                "scheme": self.scheme,
                "scheme_flags": self._scheme.manifest(),
                "family": self.cfg.family,
                "model": self.cfg.name,
                "kernels": self.kernels,
                "mask_block": self.mask_block,
                "device": str(self.device),
                "compression": self.compression,
                "comp_frac": self.comp_frac,
                "comp_bits": self.comp_bits,
                "comp_warmup": self.comp_warmup,
                "clients": len(self.clients),
                "participation": self.participation,
                "sampler": self.sampler,
                "local_steps": self.local_steps,
                "batch_size": self.batch_size,
                "lr": self.lr,
                "seed": self.seed,
                "git_sha": OBS.git_sha()}

    def _obs_finish(self, seam: str) -> None:
        """End-of-run telemetry, armed only (a disarmed run does no extra
        work and waits for nothing here): the byte gauges and the error
        store's census."""
        if not self.rec.armed:
            return
        self.rec.gauge("uplink_mb", self.uplink_bytes() / 1e6)
        self.rec.gauge("downlink_mb", self.downlink_bytes() / 1e6)
        if self.compression != "none":
            self.rec.event("error_store", seam=seam,
                           **self._err_store.stats())

    def _publish_round(self, r: int, clock: float) -> None:
        """Round-end publish (serve while you train): the global params as
        an atomic snapshot a polling ``ServeLoop`` can swap to."""
        with self.rec.span("publish", sim=clock, round=r):
            CKPT.save(self.publish_dir, self.round, self.global_params,
                      keep=self.publish_keep,
                      metadata={"round": self.round, "sim_time": clock,
                                "scheme": self.scheme})
        self.rec.inc("published_snapshots")
        self.rec.event("publish", sim=clock, round=r, step=self.round)

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
            self._write_volumes(cohort, cclients, upd)

    def _write_volumes(self, cohort: List[int], cclients: List[Client],
                       upd: List[int]) -> None:
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
            row = self.history[-1]
            self.rec.event("history", sim=row["time"],
                           **{k: v for k, v in row.items() if k != "time"})

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
            with self.rec.span("scheme.round_start", sim=clock, round=r):
                self._scheme.round_start(self)
            with self.rec.maybe_profile(r), \
                    self.rec.span("train_cohort", sim=clock, round=r):
                losses, ratios = self._train_cohort(cohort, cclients)
            self.rec.inc("uplink_updates", len(cohort))
            if self.compression != "none" and not self._comp_active():
                self.rec.inc("uplink_dense_updates", len(cohort))  # warmup
            self.rec.inc("uplink_extra_updates",
                         len(cohort) * self._scheme.extra_dense_uplink)
            self._adapt_volumes(cohort, cclients, times, pace)
            with self.rec.span("scheme.round_end", sim=clock, round=r):
                self._scheme.round_end(self)
            dur = self._scheme.round_duration(times, cclients)
            clock += dur
            self.round += 1
            self.rec.event("round", sim=clock, round=r, cohort=len(cohort),
                           pace=pace, duration=dur)
            self.rec.event("volumes", sim=clock, round=r,
                           volumes=[self._scheme.effective_volume(c)
                                    for c in cclients if c.is_straggler])
            if self.publish_dir and (r + 1) % self.publish_every == 0:
                self._publish_round(r, clock)
            self._record_round(r, rounds, eval_every, clock, losses, ratios)
        self._finish_sync()
        self._obs_finish("run_sync")
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
                self.rec.event("drop", sim=clock.now, cid=cid)
                clock.schedule(self._next_delay(c) * self.dropout.penalty,
                               cid)
                continue
            # anchors are never evicted (below): this lookup cannot miss
            base = snapshots[c.staleness_anchor]
            stale = agg_counter - c.staleness_anchor
            self.rec.event("completion", sim=clock.now, cid=cid, stale=stale)
            self.rec.observe("staleness", stale)
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
            self.rec.observe("queue_depth", len(clock))
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
                    row = self.history[-1]
                    self.rec.event("history", sim=row["time"],
                                   **{k: v for k, v in row.items()
                                      if k != "time"})
        self.rec.set("agg_counter", agg_counter)
        self.rec.set("queue_peak", clock.peak_depth)
        self._obs_finish("run_async[seq]")
        return self.history

    # -- elastic membership (§VI.C) ----------------------------------------
    def add_client(self, profile: DeviceProfile, data_idx: ArrayLike,
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
    """Bucketed event engine for the async schemes (asyn / afo) on every
    family ``FLRun`` federates (the CNN testbed and the token LMs).

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
                    self.rec.event("drop", sim=ev.time, cid=ev.cid)
                    continue
                # one completion an executed event, in pop order with the
                # drops between them, staleness before the bucket's mixes
                # (the sequential loop's stream)
                self.rec.event("completion", sim=ev.time, cid=ev.cid,
                               stale=self.agg_counter + len(exec_evs)
                               - by_id[ev.cid].staleness_anchor)
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
                for st in stales:
                    self.rec.observe("staleness", st)
                pad = bpad - b
                bt0 = time.perf_counter() if self.rec.armed else 0.0
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
                self.rec.observe("bucket_size", b)
                self.rec.observe("queue_depth", len(clock))
                self.rec.event(
                    "bucket", sim=clock.now, size=b, pad=pad,
                    queue=len(clock),
                    wall_ms=(time.perf_counter() - bt0) * 1e3)
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
                row = self.history[-1]
                self.rec.event("history", sim=row["time"],
                               **{k: v for k, v in row.items()
                                  if k != "time"})
                next_rec = (done_fast // eval_every + 1) * eval_every
        self.rec.set("snapshot_peak", ring.alloc.peak_live)
        self.rec.set("snapshot_anchor_misses", ring.alloc.anchor_misses)
        self.rec.set("queue_peak", clock.peak_depth)
        self._obs_finish("run_async[bucket]")
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

    def _write_volumes(self, cohort: List[int], cclients: List[Client],
                       upd: List[int]) -> None:
        if self.participation:
            super()._write_volumes(cohort, cclients, upd)
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

    def add_client(self, profile: DeviceProfile, data_idx: ArrayLike,
                   white_box: bool = True) -> Client:
        self.sync_client_states()
        c = super().add_client(profile, data_idx, white_box)
        self._build_batched()                 # the cohorts changed
        return c

    def remove_client(self, cid: int) -> None:
        self.sync_client_states()
        super().remove_client(cid)
        self._build_batched()



@dataclasses.dataclass
class ShardedFLRun(BatchedFLRun):
    """Population-scale sync engine: the batched round over a clients group
    of ranks (:mod:`repro_torch.launch.mesh`), the reference's
    ``shard_map`` over a ``("clients",)`` mesh.

    Three things on top of :class:`BatchedFLRun`, as in the reference:

    * **Persistent population state.**  Every client's Helios state is one
      host row (``core.soft_train.init_population``, no per-client dicts).
      A round gathers its soft-training slots' rows onto the device and
      scatters them back in place; other rows are never touched.
    * **Padded cohort slots.**  The cohort is padded to ``ceil(K / shards)
      · shards`` slots (``_kpad``); a padding slot repeats the first
      client's batch without a host draw and gets weight 0.  Soft-training
      slots train under their Eq. 2 masks, capable and padding slots under
      all-ones masks, all in one vmapped step a local step; capable and
      padding slots keep their state as it was.
    * **Client-parallel rounds.**  Rank r trains slots ``[r·b, (r+1)·b)``
      (``b = _kpad / shards``) as one ``torch.func.vmap`` step a local step,
      so the masked kernels launch once a step and rank block.  Eq. 10 /
      masked-mean aggregation is each rank's weighted partial sum plus one
      ``all_reduce``; every rank receives the slots' new rows (state,
      losses, ratios, error and control rows) by ``all_gather``, so every
      rank's host population stays identical.

    Every rank runs the same host loop from the same seeds, so each draws
    the same cohort and batches.  Eq. 2 draws are host-named streams, so
    ``begin_cycle`` / ``end_cycle`` run for a rank's soft slots only, where
    the reference's program runs them for every slot and discards the
    others' (no number differs).  The reference's compiled-program cache
    (``_get_sharded_fn``) and its compile budget have no counterpart: the
    port compiles nothing.  Same seed, same trajectory as ``FLRun`` and
    ``BatchedFLRun`` up to rounding.
    """

    #: the clients group; None builds one over the default process group
    #: (world 1 without one) with its training ranks capped at the cohort
    group: Optional[ClientGroup] = None

    def _init_helios(self) -> None:
        # the population's rows are built stacked in _build_batched;
        # sync_client_states writes them back into dicts on demand
        pass

    def _build_batched(self) -> None:
        # _draw_cohort never returns more than the population, so the
        # slot count is capped there too
        k = min(self.participation, len(self.clients)) or len(self.clients)
        self._group = self.group if self.group is not None \
            else make_client_group(k, self.device)
        if self._group.device.type != self.device.type:
            raise ValueError(f"the clients group lives on "
                             f"{self._group.device}, the run on {self.device}")
        d = self._group.shards
        self._kpad = -(-k // d) * d
        if all(c.helios_state is None for c in self.clients):
            self._pop_state = ST.init_population(
                self.adapter.schema, [c.volume for c in self.clients],
                [c.cid for c in self.clients])
        else:
            # membership changed after sync_client_states materialized
            # every row: restack the dicts
            self._pop_state = ST.host_states(ST.stack_states(
                [c.helios_state for c in self.clients]))

    def sync_client_states(self) -> None:
        """Materialize each client's ``helios_state`` from its row
        (checkpointing, inspection, elastic membership)."""
        for i, c in enumerate(self.clients):
            c.helios_state = self.client_state(i)

    def client_state(self, i: int) -> dict:
        """Row ``i`` (client-list position) of the population, as a state
        dict on the run's device (a copy: rows change in place)."""
        return ST.unstack_states(
            ST.gather_states_host(self._pop_state, [i], self.device), 1)[0]

    # -- template hooks ----------------------------------------------------
    def _round_extras(self, row_clients: Sequence[Client]) -> tuple:
        """The scheme's round inputs padded to ``_kpad`` slots: a padding
        slot reads the first client's control row (its dc is masked out by
        ``valid``) and trains from the current global at discount 1."""
        sch, dev = self._scheme, self.device
        pad = self._kpad - len(row_clients)
        extras = ()
        if sch.uses_control:
            cids = [c.cid for c in row_clients]
            extras += (self._c_global,
                       self._ctrl_store.gather(cids + [cids[0]] * pad))
        if sch.uses_stale_base:
            flags = torch.tensor([1.0 if c.is_straggler else 0.0
                                  for c in row_clients] + [0.0] * pad,
                                 device=dev)
            discs = torch.tensor([self._stale_disc if c.is_straggler else 1.0
                                  for c in row_clients] + [1.0] * pad,
                                 dtype=torch.float32, device=dev)
            extras += (self._stale_base, flags, discs)
        return extras

    def _apply_round_outs(self, row_clients: Sequence[Client], outs) -> None:
        """SCAFFOLD: the real slots' control rows back by cid, and
        ``c_global += dc_sum / N`` (dc summed over valid slots only)."""
        if self._scheme.uses_control:
            new_rows, dc_sum = outs
            k = len(row_clients)
            self._ctrl_store.scatter([c.cid for c in row_clients],
                                     tree_map(lambda x: x[:k], new_rows))
            n = float(len(self.clients))
            self._c_global = tree_map(lambda c, d: c + d / n,
                                      self._c_global, dc_sum)

    def _row_template(self, b: int, comp: bool) -> Dict[str, torch.Tensor]:
        """Zero (b,) + shape leaves of everything a rank gathers for its
        block, keyed ``part/name``: every rank sends the same shapes, and a
        rank that trains nothing sends these."""
        dev, g = self.device, self.global_params
        rows = {"loss": torch.zeros(b, device=dev),
                "ratio": torch.zeros(b, device=dev)}
        if self._scheme.soft_training:
            for part, dt in (("masks", torch.float32),
                             ("scores", torch.float32),
                             ("skip_counts", torch.int32)):
                for k, shape in self.adapter.schema.items():
                    rows[f"{part}/{k}"] = torch.zeros((b,) + tuple(shape),
                                                      dtype=dt, device=dev)
            for k in ("splits", "cycle"):
                rows[k] = torch.zeros(b, dtype=torch.int64, device=dev)
        for part, on in (("err", comp), ("ctrl", self._scheme.uses_control)):
            if on:
                for path, v in tree_paths(g):
                    rows[f"{part}/{path}"] = torch.zeros(
                        (b,) + tuple(v.shape), dtype=torch.float32,
                        device=dev)
        return rows

    def _train_block(self, block: slice, slots: List[int],
                     soft: List[bool], valid: torch.Tensor, batches: dict,
                     extras: tuple, err, rows: Dict[str, torch.Tensor]
                     ) -> tuple:
        """This rank's ``block`` of the padded cohort's ``slots``
        (population positions): Eq. 2 masks for the soft slots, one vmapped
        training, scores and state for the soft slots, the scheme's and
        the codec's per-slot work; ``extras`` and ``err`` as
        :meth:`_round_extras` and the error store give them for every slot.
        Fills ``rows`` in place; returns (trained or decoded params,
        params-space masks or None, the codec's coordinates over valid
        slots, SCAFFOLD's dc summed over valid slots), the last two None
        when off."""
        sch, g, dev = self._scheme, self.global_params, self.device
        hcfg = sch.effective_hcfg(self.hcfg)
        slots, soft, valid = slots[block], soft[block], valid[block]
        batches = {n: v[block] for n, v in batches.items()}
        b = len(slots)
        s_pos = [j for j in range(b) if soft[j]]
        masks = tree_map(lambda o: o.expand((b,) + tuple(o.shape)).clone(),
                         self._ones)
        if s_pos:
            s_idx = torch.tensor(s_pos, device=dev)
            sstate = ST.stack_states([
                ST.begin_cycle(st, hcfg) for st in ST.unstack_states(
                    ST.gather_states_host(self._pop_state,
                                          [slots[j] for j in s_pos], dev),
                    len(s_pos))])
            for k, m in masks.items():
                m.index_copy_(0, s_idx, sstate["masks"][k])

        def per_slot(v, x):
            return v.view((b,) + (1,) * x.dim())

        params, stacked, corr = g, False, None
        if sch.uses_control:
            c_global = extras[0]
            c_rows = tree_map(lambda x: x[block], extras[1])
            corr = tree_map(torch.sub, c_global, c_rows)
        if sch.uses_stale_base:
            stale_base, flags, discs = (extras[0], extras[1][block],
                                        extras[2][block])
            params = tree_map(lambda sb, gg: torch.where(
                per_slot(flags, gg) > 0, sb, gg), stale_base, g)
            stacked = True
        p, loss = self._train_batched(params, batches, masks, stacked, True,
                                      corr)
        if sch.uses_stale_base:
            # a capable or padding slot is g + 1 * (y - g), as in the
            # reference
            p = tree_map(lambda gg, y, bb: (gg.float() + per_slot(discs, gg)
                                            * (y.float() - bb.float())
                                            ).to(gg.dtype), g, p, params)
        fr = MK.selected_fractions(masks)
        soft_t = torch.tensor(soft, device=dev)
        rows["loss"] = loss
        rows["ratio"] = torch.where(soft_t, fr, torch.ones_like(fr))
        if s_pos:
            if sch.use_delta_scores:
                scores = torch.func.vmap(
                    lambda pp: self.adapter.cycle_scores(pp, g))(
                        tree_map(lambda t: t.index_select(0, s_idx), p))
            else:                                          # random [12]
                scores = sstate["scores"]
            sstate = ST.end_cycle(sstate, scores, hcfg)
            for part in ("masks", "scores", "skip_counts"):
                for k, v in sstate[part].items():
                    rows[f"{part}/{k}"].index_copy_(0, s_idx, v)
            rows["splits"][s_idx] = torch.tensor(
                [ST.key_row(key)[1] for key in sstate["rng"]], device=dev)
            rows["cycle"][s_idx] = torch.as_tensor(sstate["cycle"],
                                                   device=dev)
        dc_sum = None
        if sch.uses_control:
            # option-II control update from the raw trained rows
            inv = 1.0 / (self.local_steps * self.lr)
            dc = tree_map(lambda gg, t, cg: (gg.float() - t.float()) * inv
                          - cg, g, p, c_global)
            for path, v in tree_paths(tree_map(torch.add, c_rows, dc)):
                rows[f"ctrl/{path}"] = v
            dc_sum = tree_map(lambda d: (d * per_slot(valid, d[0])).sum(0),
                              dc)
        mode = sch.agg_mode(self.hcfg)
        pm = self.adapter.expand_masks_batch(masks, g) \
            if mode == "masked_mean" or err is not None else None
        coords = None
        if err is not None:
            # the codec runs on the block's own rows; only the coordinate
            # count crosses ranks
            delta = tree_map(lambda t, gg: t.float() - gg.float(), p, g)
            sent, new_err, c = CP.compress_update_stacked(
                delta, err, self.compression, self.comp_frac, self.comp_bits,
                pm)
            p = tree_map(lambda gg, x: (gg.float() + x).to(gg.dtype), g,
                         sent)
            for path, v in tree_paths(new_err):
                rows[f"err/{path}"] = v
            coords = (c * valid).sum()
        return p, (pm if mode == "masked_mean" else None), coords, dc_sum

    def _train_cohort(self, cohort: List[int], cclients: List[Client]):
        """The padded cohort: batches drawn in cohort order on every rank,
        this rank's block trained, rows gathered, Eq. 10 / masked mean as
        partial sums and one ``all_reduce``, the real slots' rows written
        back."""
        sch, grp, g, dev = (self._scheme, self._group, self.global_params,
                            self.device)
        k, kpad = len(cohort), self._kpad
        pad, b = kpad - k, kpad // grp.shards
        slots = cohort + [cohort[0]] * pad
        soft = [sch.soft_training and c.is_straggler for c in cclients] \
            + [False] * pad
        valid = torch.tensor([1.0] * k + [0.0] * pad, device=dev)
        batches = self.adapter.sample_cohort(
            self.rng, self.train_data, [c.data_idx for c in cclients],
            self.local_steps, self.batch_size, pad_to=kpad)
        comp = self._comp_active()
        mode = sch.agg_mode(self.hcfg)
        cids = [c.cid for c in cclients]
        rows = self._row_template(b, comp)
        block = slice(grp.rank * b, (grp.rank + 1) * b)
        if grp.trains:
            err = self._err_store.gather((cids + [cids[0]] * pad)[block]) \
                if comp else None
            p, pm, coords, dc_sum = self._train_block(
                block, slots, soft, valid, batches,
                self._round_extras(cclients), err, rows)
        else:
            # a rank past the shards trains nothing: its slots weigh 0, so
            # it adds zeros to every sum
            p = tree_map(lambda x: x.expand((b,) + tuple(x.shape)), g)
            pm = tree_map(torch.ones_like, p) if mode == "masked_mean" \
                else None
            coords = torch.zeros((), device=dev)
            dc_sum = tree_map(torch.zeros_like, g)
        rows = grp.all_gather(rows)
        ratios = rows["ratio"]
        w = (ratios if mode != "uniform" else torch.ones_like(ratios)) * valid
        a = (w / torch.clamp(w.sum(), min=1e-9))[block] if grp.trains \
            else torch.zeros(b, device=dev)

        def wa(x):
            return a.view((b,) + (1,) * (x.dim() - 1))

        if mode == "masked_mean":
            sums = [(wa(t) * m * t.float()).sum(0) for m, t in
                    zip(tree_leaves(pm), tree_leaves(p))] + \
                [(wa(m) * m).sum(0) for m in tree_leaves(pm)]
        else:
            sums = [torch.tensordot(a, t.float(), dims=1)
                    for t in tree_leaves(p)]
        if comp:
            sums.append(coords)
        if sch.uses_control:
            sums += tree_leaves(dc_sum)
        sums = grp.all_reduce_sum(sums)
        leaves = tree_leaves(g)
        n = len(leaves)
        paths = [path for path, _ in tree_paths(g)]
        if mode == "masked_mean":
            new = [torch.where(de > 0, nu / torch.clamp(de, min=1e-9),
                               gg.float()).to(gg.dtype)
                   for gg, nu, de in zip(leaves, sums[:n], sums[n:2 * n])]
            at = 2 * n
        else:
            new = [t.to(gg.dtype) for gg, t in zip(leaves, sums[:n])]
            at = n
        self.global_params = unflatten(dict(zip(paths, new)))
        if comp:
            self.rec.accum("uplink_coords", sums[at])
            at += 1
            self._err_store.scatter(cids, unflatten(
                {path: rows[f"err/{path}"][:k] for path in paths}))
        outs = ()
        if sch.uses_control:
            outs = (unflatten({path: rows[f"ctrl/{path}"] for path in paths}),
                    unflatten(dict(zip(paths, sums[at:at + n]))))
        self._apply_round_outs(cclients, outs)
        upd = [j for j in range(k) if soft[j]]
        if upd:
            sel = torch.tensor(upd, device=dev)
            idx = [slots[j] for j in upd]
            sub = {part: {key: rows[f"{part}/{key}"].index_select(0, sel)
                          for key in self.adapter.schema}
                   for part in ("masks", "scores", "skip_counts")}
            seeds = self._pop_state["rng"]["seed"][np.asarray(idx)]
            sub["rng"] = [ST.row_key(s, n) for s, n in
                          zip(seeds, rows["splits"][sel].tolist())]
            sub["cycle"] = rows["cycle"][sel].cpu().numpy()
            sub["volume"] = self._pop_state["volume"][np.asarray(idx)]
            ST.scatter_states_host(self._pop_state, idx, sub)
        # device values: _record_round converts them behind the eval gate
        return list(rows["loss"][:k].unbind()), list(ratios[:k].unbind())

    def _write_volumes(self, cohort: List[int], cclients: List[Client],
                       upd: List[int]) -> None:
        self._pop_state["volume"][np.asarray([cohort[j] for j in upd])] = \
            np.asarray([cclients[j].volume for j in upd], np.float32)

    def _finish_sync(self) -> None:
        pass                # the population rows are the state of record


def setup_clients(profiles: Sequence[DeviceProfile],
                  parts: Sequence[ArrayLike],
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
