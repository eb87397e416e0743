# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Serve while you train: batched generation and lock-free snapshot swaps.

The serving plane; three pieces make "traffic against the live global
model" (``python -m repro_torch.launch.serve`` is the standalone
generation bench):

* :class:`GenerationServer`: batched greedy generation through the
  families' prefill and decode (:mod:`repro_torch.models`) with all-ones
  Helios masks.  The prefill cache is padded once to the prompt plus the
  generated tokens, so every decode step writes its own slot (the
  reference decodes into a cache as long as the prompt and its clamped
  writes overwrite the last slot: ROADMAP §3); an encoder-decoder's
  cross-attention cache keeps the encoder's length.  As in the reference's
  code, attention takes ``rt["attn_impl"]`` and the MLP its plain form;
  ``kernels="cuda"`` reaches the hybrid's prefill, whose chunked SSD runs
  ``ssd_diag``.
* :class:`ServeLoop`: snapshot swaps behind an eval-gated promotion rule.
  The training loop publishes atomic snapshots (``FLRun.publish_dir`` ->
  :func:`repro_torch.checkpoint.save`); :meth:`ServeLoop.poll` restores a
  newer step into NEW tensors and rebinds one reference to an immutable
  :class:`_Served`, never writing into the tensors being served.  A
  request reads that reference once and takes no lock.  On a GPU the
  serving plane runs on a CUDA stream of its own and a request waits for
  an event recorded after its last token, never for the whole device (the
  training thread's kernels).
* :class:`PoissonTraffic` and :func:`run_traffic`: an open-loop Poisson
  load from a seed; a request's latency is its completion minus its
  scheduled arrival, so queueing under overload counts.

Telemetry goes to the shared :class:`repro_torch.obs.Recorder`:
``request_ms`` / ``serve_staleness`` histograms, ``serve_requests`` /
``serve_swaps`` / ``serve_promotions`` / ``serve_rejections`` counters,
``swap`` / ``promotion`` events and a ``restore`` span a poll that reads
a snapshot, so ``python -m repro_torch.obs report``
shows the serving plane beside the training rounds.

  python -m repro_torch.launch.serve --arch xlstm-125m --reduced \\
      --batch 8 --prompt-len 64 --gen 32 [--ckpt-dir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import checkpoint as CKPT
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import markov_tokens
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import CUDA, REFERENCE, canonical_impl
from repro_torch.models import (build, default_runtime, init_params,
                                make_full_masks)
from repro_torch.models.module import tree_leaves
from repro_torch.obs import recorder as OBS


def serve_batch(prompts: np.ndarray, device: DeviceLike = None,
                cfg: Optional[ModelConfig] = None,
                rng: Optional[np.random.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """The model-input dict of a prompt batch (B, S) on ``device``; a VLM
    ``cfg`` adds its stub image prefix, ``image_embeds`` (B,
    num_image_tokens, d_model), an encoder-decoder ``cfg`` its stub frame
    embeddings, ``enc_embeds`` (B, S, d_model), each drawn from ``rng`` as
    the reference draws it."""
    dev = resolve_device(device)
    batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                       device=dev)}
    n, s = batch["tokens"].shape
    if cfg is not None and cfg.family == "vlm":
        batch["image_embeds"] = torch.as_tensor(
            rng.normal(size=(n, cfg.num_image_tokens, cfg.d_model)),
            dtype=torch.float32, device=dev)
    elif cfg is not None and cfg.family == "encdec":
        batch["enc_embeds"] = torch.as_tensor(
            rng.normal(size=(n, s, cfg.d_model)), dtype=torch.float32,
            device=dev)
    return batch


#: cache leaf name -> the axis its sequence runs along, counted from the
#: end: attention K / V (..., S, KV, hd) and MLA's latent and RoPE key
#: (..., S, width)
CACHE_SEQ_AXIS = {"k": -3, "v": -3, "c_kv": -2, "k_rope": -2}


def pad_cache(cache, length: int):
    """The cache with every self-attention leaf (``k`` / ``v``, MLA's
    ``c_kv`` / ``k_rope``) zero-padded along its sequence axis to
    ``length`` positions (new tensors).  An encoder-decoder's ``cross``
    K / V keep the encoder's length: cross-attention masks no key, so a
    padded one would take probability mass."""
    if isinstance(cache, dict):
        out = {}
        for k, v in cache.items():
            if k == "cross":
                out[k] = v
            elif k in CACHE_SEQ_AXIS:
                pad = [0, 0] * (-CACHE_SEQ_AXIS[k])
                pad[-1] = length - v.shape[CACHE_SEQ_AXIS[k]]
                out[k] = F.pad(v, pad)
            else:
                out[k] = pad_cache(v, length)
        return out
    if isinstance(cache, list):
        return [pad_cache(v, length) for v in cache]
    return cache


def wait(x: torch.Tensor) -> None:
    """Wait until the work that produces ``x`` on the current stream is
    done (an event; never a device-wide synchronize)."""
    if x.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(x.device))
        ev.synchronize()


class GenerationServer:
    """Batched greedy generation for one (batch, prompt_len) cell; the
    params are an argument of every call, so a swap changes nothing here.

    ``kernels``: "reference" (plain), "cuda" (the hybrid's prefill on
    ``ssd_diag``; alias "pallas"), or None: "cuda" on a GPU device.
    Calls run under ``torch.inference_mode``.
    """

    def __init__(self, cfg: ModelConfig, batch: int, prompt_len: int,
                 gen: int = 8, kernels: Optional[str] = None,
                 device: DeviceLike = None):
        if gen < 1:
            raise ValueError(f"gen must be >= 1, got {gen}")
        self.cfg = cfg
        self.batch = batch
        self.prompt_len = prompt_len
        self.gen = gen
        self.device = resolve_device(device)
        self.api = build(cfg)
        if self.api.prefill_fn is None:
            raise ValueError(f"family {cfg.family!r} has no prefill/decode "
                             "serving path")
        self.rt = default_runtime()
        self.rt["kernels"] = canonical_impl(kernels or (
            CUDA if self.device.type == "cuda" else REFERENCE))
        self.masks = make_full_masks(cfg, self.device)

    def prefill(self, params, batch):
        """(last-position logits, cache exactly as long as the prompt)."""
        with torch.inference_mode():
            return self.api.prefill_fn(params, batch, self.cfg, self.rt,
                                       self.masks)

    def decode(self, params, token, cache):
        """One step: (logits, cache); the cache must have room at
        ``cache["pos"]``."""
        with torch.inference_mode():
            return self.api.decode_fn(params, token, cache, self.cfg,
                                      self.rt, self.masks)

    def __call__(self, params, batch) -> torch.Tensor:
        """Greedy-decode ``gen`` tokens: (B, gen) int32."""
        shape = tuple(batch["tokens"].shape)
        if shape != (self.batch, self.prompt_len):
            raise ValueError(f"request of shape {shape}; this server's cell "
                             f"is ({self.batch}, {self.prompt_len})")
        with torch.inference_mode():
            logits, cache = self.prefill(params, batch)
            cache = pad_cache(cache, cache["pos"] + self.gen)
            token = logits.argmax(-1)[:, None].to(torch.int32)
            out = [token]
            for _ in range(self.gen - 1):
                logits, cache = self.decode(params, token, cache)
                token = logits.argmax(-1)[:, None].to(torch.int32)
                out.append(token)
            return torch.cat(out, dim=1)


@dataclasses.dataclass(frozen=True)
class _Served:
    """The snapshot being served; a swap builds a new one."""
    step: int
    round: int
    params: Any
    metric: Optional[float]


class ServeLoop:
    """Snapshot swaps behind an eval-gated promotion rule.

    :meth:`poll` (the swap path: restore and held-out eval) and
    :meth:`handle` (the request path, lock-free) run on the serving thread
    between requests; the training loop publishes from its own thread by
    ``checkpoint.save``'s atomic rename.  ``handle`` reads ``_served`` once;
    ``poll`` only rebinds it to a new :class:`_Served` holding newly
    restored tensors, so a request computes on one complete snapshot and
    the tensors it uses are never written.

    The first complete snapshot is promoted; a later one only if its
    held-out metric does not regress beyond ``tol`` against the served
    snapshot's (``higher_is_better`` orients it).  A rejected step is
    remembered and not evaluated again.

    With the template on a GPU the loop owns a CUDA stream, and restores,
    evaluations and requests run on it.
    """

    def __init__(self, ckpt_dir: str, template_params: Any,
                 request_fn: Callable[[Any, Any], Any],
                 eval_fn: Optional[Callable[[Any], float]] = None,
                 higher_is_better: bool = False, tol: float = 0.0,
                 recorder: Optional[OBS.Recorder] = None):
        self.ckpt_dir = ckpt_dir
        self.template = template_params
        self.request_fn = request_fn
        self.eval_fn = eval_fn
        self.higher_is_better = higher_is_better
        self.tol = float(tol)
        self.rec = recorder if recorder is not None else OBS.Recorder()
        self._served: Optional[_Served] = None
        self._last_decided_step: Optional[int] = None
        self.latest_round: int = 0         # the newest published round seen
        leaf = next(iter(tree_leaves(template_params)), None)
        self.stream = torch.cuda.Stream(leaf.device) \
            if torch.is_tensor(leaf) and leaf.is_cuda else None

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()

    # -- the swap path (never on the request path) --------------------------
    def poll(self) -> bool:
        """Look for a newer published snapshot; eval-gate it and maybe swap.
        True iff a swap happened."""
        step = CKPT.latest_step(self.ckpt_dir)
        if step is None or step == self._last_decided_step:
            return False
        with self._on_stream(), torch.inference_mode():
            try:
                with self.rec.span("restore", step=step):
                    params, _, meta = CKPT.load(self.ckpt_dir, self.template,
                                                step=step)
            except FileNotFoundError:
                # GC'd between listdir and read: a newer complete snapshot
                # exists, the next poll takes it
                self.rec.inc("serve_poll_misses")
                return False
            rnd = int(meta.get("round", step))
            self.latest_round = max(self.latest_round, rnd)
            self._last_decided_step = step
            metric = float(self.eval_fn(params)) if self.eval_fn else None
        promoted = self._served is None or metric is None or \
            self._gate(metric, self._served.metric)
        self.rec.inc("serve_promotions" if promoted else "serve_rejections")
        self.rec.event("promotion", step=step, round=rnd, promoted=promoted,
                       metric=metric,
                       served_metric=None if self._served is None
                       else self._served.metric)
        if not promoted:
            return False
        self._served = _Served(step, rnd, params, metric)
        self.rec.inc("serve_swaps")
        self.rec.event("swap", step=step, round=rnd,
                       staleness=self.latest_round - rnd)
        return True

    def _gate(self, candidate: float, served: Optional[float]) -> bool:
        if served is None:
            return True
        if self.higher_is_better:
            return candidate >= served - self.tol
        return candidate <= served + self.tol

    # -- the request path (lock-free) ---------------------------------------
    def handle(self, batch):
        """Serve one request on the current snapshot: one reference read,
        no lock; waits only for this request's own result."""
        served = self._served                  # the one read
        if served is None:
            raise RuntimeError(
                f"nothing promoted yet (no checkpoints in {self.ckpt_dir}?)")
        with self._on_stream(), torch.inference_mode():
            out = self.request_fn(served.params, batch)
            if torch.is_tensor(out):
                wait(out)
        self.rec.inc("serve_requests")
        self.rec.observe("serve_staleness", self.latest_round - served.round)
        return out

    @property
    def served_step(self) -> Optional[int]:
        s = self._served
        return None if s is None else s.step

    @property
    def served_round(self) -> Optional[int]:
        s = self._served
        return None if s is None else s.round

    @property
    def served_metric(self) -> Optional[float]:
        s = self._served
        return None if s is None else s.metric

    @property
    def served_params(self):
        s = self._served
        return None if s is None else s.params


def make_ce_eval(cfg: ModelConfig, held_out: Dict[str, torch.Tensor],
                 rt: Optional[dict] = None) -> Callable[[Any], float]:
    """Held-out cross-entropy gate for token-LM serving (lower is better:
    pair it with ``higher_is_better=False``)."""
    api = build(cfg)
    rt = rt or default_runtime()

    def ce(params) -> float:
        with torch.inference_mode():
            return float(api.loss_fn(params, held_out, cfg, rt, None))

    return ce


# ---------------------------------------------------------------------------
# deterministic Poisson load
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PoissonTraffic:
    """Open-loop Poisson arrivals: the schedule (cumulative arrival times in
    seconds) is fixed by the seed, whatever the service times."""

    rate_hz: float
    seed: int = 0

    def schedule(self) -> Iterator[float]:
        if self.rate_hz <= 0:
            raise ValueError(f"rate_hz must be > 0, got {self.rate_hz}")
        rng = np.random.default_rng((self.seed, 0x7AFF1C))
        t = 0.0
        while True:
            t += rng.exponential(1.0 / self.rate_hz)
            yield t


def run_traffic(serve: ServeLoop, traffic: PoissonTraffic,
                make_batch: Callable[[int], Any],
                should_stop: Callable[[], bool],
                min_requests: int = 1,
                max_requests: Optional[int] = None,
                poll: bool = True) -> Dict[str, Any]:
    """Drive the arrival schedule against ``serve`` until ``should_stop()``
    and at least ``min_requests`` served.  A request's latency is its
    completion minus its SCHEDULED arrival (wall clock), so it holds the
    time queued behind earlier requests and polls; its service time is
    the ``handle`` call alone.  ``poll`` looks for a new snapshot between
    requests, on the serving thread."""
    sched = traffic.schedule()
    lat_ms: List[float] = []
    svc_ms: List[float] = []
    t0 = time.perf_counter()
    n = 0
    while not (should_stop() and n >= min_requests):
        if max_requests is not None and n >= max_requests:
            break
        arrival = next(sched)
        now = time.perf_counter() - t0
        if arrival > now:
            time.sleep(arrival - now)
        start = time.perf_counter() - t0
        serve.handle(make_batch(n))
        done = time.perf_counter() - t0
        ms = (done - arrival) * 1e3
        lat_ms.append(ms)
        svc_ms.append((done - start) * 1e3)
        serve.rec.observe("request_ms", ms)
        serve.rec.observe("service_ms", svc_ms[-1])
        if poll:
            serve.poll()
        n += 1
    wall = time.perf_counter() - t0
    return {"requests": n, "wall_s": wall,
            "requests_per_sec": n / max(wall, 1e-9),
            "offered_rate_hz": traffic.rate_hz, "latency_ms": lat_ms,
            "service_ms": svc_ms}


def serve_while_training(train_fn: Callable[[], Any], serve: ServeLoop,
                         traffic: PoissonTraffic,
                         make_batch: Callable[[int], Any],
                         min_requests: int = 1,
                         max_requests: Optional[int] = None,
                         final_poll: bool = True) -> Dict[str, Any]:
    """Run ``train_fn`` on a background thread while this thread serves
    traffic; returns the traffic stats.  An exception of the training
    thread is raised here once the traffic loop has drained."""
    err: List[BaseException] = []

    def target():
        try:
            train_fn()
        except BaseException as e:          # raised on the caller below
            err.append(e)

    th = threading.Thread(target=target, name="fl-train", daemon=True)
    th.start()
    try:
        stats = run_traffic(serve, traffic, make_batch,
                            should_stop=lambda: not th.is_alive(),
                            min_requests=min_requests,
                            max_requests=max_requests)
    finally:
        th.join()
    if err:
        raise err[0]
    if final_poll:
        serve.poll()                        # the last round's publish
    return stats


# ---------------------------------------------------------------------------
# CLI: the standalone generation bench
# ---------------------------------------------------------------------------


def main(argv=None, report: Optional[dict] = None):
    """Prefill a Markov-token prompt batch and greedy-decode ``--gen``
    tokens; returns the (B, gen) tokens.  ``report``, when given, receives
    the run's config, params, batch, server, prefill logits and the
    prefill / decode seconds (for a caller that checks the generation)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default=None,
                    choices=("reference", "cuda", "pallas"),
                    help="default: cuda on a GPU, reference on the CPU")
    ap.add_argument("--device", default=None,
                    help="default cuda (raises without a GPU); cpu on ask")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the newest snapshot of a training run's "
                         "publish_dir instead of fresh random params")
    args = ap.parse_args(argv)

    cfg = get_model_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    srv = GenerationServer(cfg, args.batch, args.prompt_len, gen=args.gen,
                           kernels=args.kernels, device=dev)
    params = init_params(cfg, args.seed, dev)
    if args.ckpt_dir:
        params, step = CKPT.restore(args.ckpt_dir, params)
        print(f"restored snapshot step {step} from {args.ckpt_dir}")
    prompts = markov_tokens(args.batch, args.prompt_len, cfg.padded_vocab,
                            seed=args.seed)
    batch = serve_batch(prompts, dev, cfg, np.random.default_rng(args.seed))

    t0 = time.perf_counter()
    logits, cache = srv.prefill(params, batch)
    wait(logits)
    t_prefill = time.perf_counter() - t0
    print(f"prefill: {args.batch} x {args.prompt_len} tokens in "
          f"{t_prefill:.4f}s")

    cache = pad_cache(cache, cache["pos"] + args.gen)
    token = logits.argmax(-1)[:, None].to(torch.int32)
    wait(token)                       # the padding is queued before it
    generated = [token]
    decoded = args.gen - 1
    t0 = time.perf_counter()
    for _ in range(decoded):
        logits_t, cache = srv.decode(params, token, cache)
        token = logits_t.argmax(-1)[:, None].to(torch.int32)
        generated.append(token)
    # the steps stay queued; the clock stops at the final token's event.
    # --gen 1 decodes nothing: no rate is printed rather than a 0/0
    t_decode = None
    if decoded:
        wait(token)
        t_decode = time.perf_counter() - t0
        print(f"decode: {args.batch} x {decoded} tokens in {t_decode:.4f}s "
              f"({args.batch * decoded / max(t_decode, 1e-9):.1f} tok/s)")
    else:
        print("decode: skipped (--gen 1 is prefill-only; tok/s undefined)")
    toks = torch.cat(generated, dim=1)
    print("sample:", toks[0, :16].tolist())
    if not (bool((toks >= 0).all()) and bool((toks < cfg.padded_vocab).all())):
        raise AssertionError("generated token ids outside the vocabulary")
    if report is not None:
        report.update(cfg=cfg, params=params, batch=batch, server=srv,
                      prefill_logits=logits, cache=cache, tokens=toks,
                      prefill_s=t_prefill, decode_s=t_decode)
    return toks
