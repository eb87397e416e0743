# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Serve generation traffic against the live global model while it trains.

The port's twin of ``examples/serve_while_train.py``, in one process:

* an ``FLRun`` trains a token LM on Non-IID Markov-topic streams and
  publishes the global params every ``publish_every`` rounds
  (``publish_dir`` -> atomic ``checkpoint.save``: tmp write, fsync,
  ``os.replace``).  The reference trains a ``BatchedFLRun``; this driver
  keeps ``FLRun``, and the publish seam is the same on every engine that
  runs ``run_sync``;
* a ``ServeLoop`` on the calling thread serves batched greedy generation
  (``GenerationServer``) and polls the publish directory between
  requests behind an eval-gated promotion rule (held-out CE within
  ``tol`` of the served snapshot's);
* an open-loop Poisson load from a seed; a request's latency is its
  completion minus its scheduled arrival, its service time the request
  alone.  Restores and evaluations run between requests on the serving
  thread, so arrivals queue behind them: when the offered rate comes
  near the service rate, the latency percentiles read that queue, and
  the service percentiles the serving plane.

Both planes share one armed recorder, so the run log holds the training
rounds and the serving plane (swaps, promotions, latency, staleness, the
publish and restore spans):

    python -m repro_torch.drivers.serve_while_train --reduced --device cpu
    python -m repro_torch.obs report chiprun_out/serve_demo
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Optional

from repro_torch import checkpoint as CKPT
from repro_torch.configs import HeliosConfig, ModelConfig, get_model_config
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.data.federated import partition_by_topic
from repro_torch.data.synthetic import markov_tokens, markov_topic_tokens
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated import FLRun, make_fleet, setup_clients
from repro_torch.launch.serve import (GenerationServer, PoissonTraffic,
                                      ServeLoop, make_ce_eval, serve_batch,
                                      serve_while_training)
from repro_torch.models.module import tree_leaves
from repro_torch.obs import Recorder


def _span_ms(rec: Recorder, name: str) -> list:
    return [e["wall_ms"] for e in rec.events
            if e["kind"] == "span" and e["name"] == name]


def serve_while_train(cfg: ModelConfig, clients: int = 4, rounds: int = 2,
                      local_steps: int = 1, batch_size: int = 4,
                      seq_len: int = 32, rate_hz: float = 20.0,
                      batch: int = 4, prompt_len: int = 16, gen: int = 4,
                      tol: float = 0.05, min_requests: int = 10,
                      device: DeviceLike = None,
                      kernels: Optional[str] = None,
                      out: Optional[str] = None) -> dict:
    """Train ``rounds`` helios rounds of ``cfg`` on a half-straggler fleet
    while serving Poisson traffic from its published snapshots; returns the
    traffic stats, the serving counters, the publish / restore times and
    rates, and the recorder (flushed to ``out`` when given).  Snapshots go
    to a temporary directory, removed at the end."""
    dev = resolve_device(device)
    vocab = cfg.vocab_size
    tokens, topics = markov_topic_tokens(256, seq_len, vocab, n_topics=8,
                                         seed=0)
    test_tokens, _ = markov_topic_tokens(64, seq_len, vocab, n_topics=8,
                                         seed=99)
    hcfg = HeliosConfig()
    parts = partition_by_topic(topics, clients, topics_per_client=2)
    fleet = setup_clients(make_fleet(clients - clients // 2, clients // 2),
                          parts, hcfg, device=dev)
    rec = Recorder(armed=True)
    pub = tempfile.mkdtemp(prefix="serve_pub_")
    run = FLRun(cfg, hcfg, "helios", fleet, {"tokens": tokens},
                {"tokens": test_tokens}, local_steps=local_steps,
                batch_size=batch_size, lr=0.1, seed=0, eval_batch=64,
                device=dev, kernels=kernels, recorder=rec, publish_dir=pub,
                publish_every=1)
    srv = GenerationServer(cfg, batch, prompt_len, gen=gen, kernels=kernels,
                           device=dev)
    held = serve_batch(test_tokens[:32], dev)
    serve = ServeLoop(pub, run.global_params, request_fn=srv,
                      eval_fn=make_ce_eval(cfg, held),
                      higher_is_better=False, tol=tol, recorder=rec)
    # the round-0 model, so traffic has a snapshot from its first request
    with rec.span("publish", sim=0.0, round=-1):
        CKPT.save(pub, 0, run.global_params, keep=run.publish_keep,
                  metadata={"round": 0, "sim_time": 0.0,
                            "scheme": run.scheme})
    serve.poll()
    req = serve_batch(markov_tokens(batch, prompt_len, cfg.padded_vocab,
                                    seed=7), dev)
    serve.handle(req)                                  # warm-up request
    stats = serve_while_training(
        lambda: run.run_sync(rounds), serve,
        PoissonTraffic(rate_hz=rate_hz, seed=0), lambda i: req,
        min_requests=min_requests)

    def pct(xs, q):
        xs = sorted(xs)
        return xs[min((q * len(xs)) // 100, len(xs) - 1)]

    lat = stats["latency_ms"]
    nbytes = sum(v.numel() * v.element_size()
                 for v in tree_leaves(run.global_params))
    shutil.rmtree(pub, ignore_errors=True)
    pub_ms, res_ms = _span_ms(rec, "publish"), _span_ms(rec, "restore")
    result = {
        "requests": stats["requests"],
        "requests_per_sec": stats["requests_per_sec"],
        "offered_rate_hz": rate_hz,
        "p50_ms": pct(lat, 50), "p99_ms": pct(lat, 99),
        "service_p50_ms": pct(stats["service_ms"], 50),
        "service_p99_ms": pct(stats["service_ms"], 99),
        "max_wait_ms": max(a - b for a, b in zip(lat, stats["service_ms"])),
        "swaps": rec.count("serve_swaps"),
        "promotions": rec.count("serve_promotions"),
        "rejections": rec.count("serve_rejections"),
        "published": rec.count("published_snapshots") + 1,
        "served_round": serve.served_round,
        "served_ce": serve.served_metric,
        "snapshot_mb": nbytes / 1e6,
        "codec": CKPT.codec_name(),
        "publish_ms": pub_ms, "restore_ms": res_ms,
        "publish_mb_s": [nbytes / 1e3 / t for t in pub_ms],
        "restore_mb_s": [nbytes / 1e3 / t for t in res_ms],
        "history": run.history, "recorder": rec,
    }
    print(f"served {result['requests']} requests at "
          f"{result['requests_per_sec']:.2f} req/s (offered {rate_hz:g} Hz):"
          f" latency p50={result['p50_ms']:.1f}ms "
          f"p99={result['p99_ms']:.1f}ms, service "
          f"p50={result['service_p50_ms']:.1f}ms "
          f"p99={result['service_p99_ms']:.1f}ms, longest queue wait "
          f"{result['max_wait_ms']:.1f}ms")
    print(f"swaps={result['swaps']} promotions={result['promotions']} "
          f"rejections={result['rejections']} "
          f"published={result['published']}; now serving round "
          f"{serve.served_round} (ce={serve.served_metric:.4f})")
    print(f"snapshot {nbytes / 1e6:.1f} MB through {result['codec']}: "
          f"publish ms {[round(t, 1) for t in pub_ms]}, restore ms "
          f"{[round(t, 1) for t in res_ms]}")
    if out:
        rec.flush(out)
        print(f"run log -> {out} (python -m repro_torch.obs report {out})")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced test size")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--rate-hz", type=float, default=20.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=4)
    ap.add_argument("--tol", type=float, default=0.05,
                    help="promotion tolerance on held-out CE")
    ap.add_argument("--kernels", default=None,
                    choices=("reference", "cuda", "pallas"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "serve_demo"),
                    help="run-log directory for `repro_torch.obs report`")
    args = ap.parse_args(argv)
    cfg = get_model_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    serve_while_train(cfg, clients=args.clients, rounds=args.rounds,
                      rate_hz=args.rate_hz, batch=args.batch,
                      prompt_len=args.prompt_len, gen=args.gen,
                      tol=args.tol, device=args.device, kernels=args.kernels,
                      out=args.out)


if __name__ == "__main__":
    main()
