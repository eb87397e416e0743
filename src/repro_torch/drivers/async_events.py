# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Event-driven async federated learning at population scale.

Real fleets don't run in rounds: every client pulls the current global
model, trains at its own pace, and its update arrives whenever it arrives
(the asyn / afo schemes, paper §VII.A).  The sequential engine
(``FLRun.run_async``) replays that event by event, one local training and
one snapshot a completion.  ``AsyncFLRun`` keeps the event semantics but
pops *buckets* of equal-time completions and trains each bucket as one
``torch.func.vmap`` step from the rows of a device-side snapshot ring.
The fleet is half Table-I stragglers over a lazy non-IID deal
(``partition_noniid_lazy``: one label ordering and one shard assignment,
no per-client index arrays); one local step of batch 16 at lr 0.05.  Each
engine runs the event budget once as a warm-up and once timed.

The reference's line also reports the bucket engine's compiled programs
(``bucket_programs()``, the jitted programs of its bucket shapes).  The
port runs eagerly and compiles no program a bucket shape, so that column
has no counterpart and is left out; the bucket sizes and the snapshot
ring's peak are printed as in the reference.

    python -m repro_torch.drivers.async_events --clients 64
    python -m repro_torch.drivers.async_events --clients 128 \\
        --jitter 0.2 --dropout 0.1
    python -m repro_torch.drivers.async_events --device cpu --clients 8
"""
from __future__ import annotations

import argparse
import time
from collections import Counter
from typing import Mapping, Optional

import torch

from repro_torch.configs import CNNS, HeliosConfig, ModelConfig, reduced
from repro_torch.data.federated import partition_noniid_lazy
from repro_torch.data.synthetic import class_gaussian_images
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated import (AsyncFLRun, BernoulliDropout, FLRun,
                                   JitteredArrival, make_fleet,
                                   setup_clients)

ENGINES = (("sequential", FLRun), ("bucketed", AsyncFLRun))


def async_events(cfg: Optional[ModelConfig] = None, clients: int = 64,
                 capable: int = 0, scheme: str = "afo", jitter: float = 0.0,
                 dropout: float = 0.0, device: DeviceLike = None,
                 kernels: Optional[str] = None,
                 init_params: Optional[Mapping] = None) -> dict:
    """Both engines over the same fleet and event budget (``capable``
    capable completions, default one a capable client) on ``cfg`` (reduced
    LeNet by default).  Returns {engine: {"run", "wall_s",
    "events_per_s"}}, the timed pass's numbers."""
    dev = resolve_device(device)
    cfg = cfg or reduced(CNNS["lenet"])
    imgs, labels = class_gaussian_images(
        4096, cfg.image_size, cfg.in_channels, cfg.num_classes, seed=0)
    ti, tl = class_gaussian_images(
        256, cfg.image_size, cfg.in_channels, cfg.num_classes, seed=99)
    n = clients
    capable = capable or n - n // 2
    hcfg = HeliosConfig()
    parts = partition_noniid_lazy(labels, n, shards_per_client=4, seed=0)
    kw = dict(local_steps=1, batch_size=16, lr=0.05, seed=0, kernels=kernels,
              device=dev, init_params=init_params)
    if jitter:
        kw["arrival"] = JitteredArrival(sigma=jitter)
    if dropout:
        kw["dropout"] = BernoulliDropout(p=dropout)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    print(f"== {cfg.name}: N={n} clients (half Table-I stragglers), "
          f"scheme={scheme}, {capable} capable completions ==")
    out = {}
    for name, cls in ENGINES:
        fleet = setup_clients(make_fleet(n - n // 2, n // 2), parts, hcfg,
                              device=dev)
        run = cls(cfg, hcfg, scheme, fleet,
                  {"images": imgs, "labels": labels},
                  {"images": ti, "labels": tl}, **kw)
        # warm-up over the same budget: the event schedule is
        # deterministic, so the timed pass meets the same bucket shapes
        run.run_async(capable, eval_every=0)
        sync()
        t0 = time.perf_counter()
        run.run_async(capable, eval_every=0)
        sync()
        wall = time.perf_counter() - t0
        out[name] = {"run": run, "wall_s": wall,
                     "events_per_s": run.events_processed / wall}
        line = (f"{name:10s} | {run.events_processed} events "
                f"({run.events_dropped} dropped) in {wall:5.1f}s "
                f"= {out[name]['events_per_s']:7.1f} events/s | acc "
                f"{run.evaluate():.3f}")
        if name == "bucketed":
            sizes = Counter(run.bucket_sizes)
            hist = ", ".join(f"{s}x{c}" for s, c in sorted(sizes.items()))
            line += (f"\n{'':10s} | bucket sizes {{{hist}}} | snapshot ring "
                     f"peak {run.snapshot_peak} live anchors")
        print(line)
    rates = [out[name]["events_per_s"] for name, _ in ENGINES]
    print(f"bucketed speedup vs sequential event loop: "
          f"{rates[1] / rates[0]:.2f}x")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="lenet",
                    choices=["lenet", "alexnet", "resnet18"])
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--capable", type=int, default=0,
                    help="capable-client completions to simulate "
                         "(default: one per capable client)")
    ap.add_argument("--scheme", default="afo", choices=["asyn", "afo"])
    ap.add_argument("--jitter", type=float, default=0.0,
                    help="lognormal sigma on completion delays")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-event probability the update is lost")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--kernels", default=None,
                    choices=["reference", "cuda"],
                    help="the soft-training substrate (default: cuda on a "
                         "GPU, reference on the CPU)")
    args = ap.parse_args()
    async_events(reduced(CNNS[args.model]), args.clients,
                 args.capable, args.scheme, args.jitter, args.dropout,
                 args.device, args.kernels)


if __name__ == "__main__":
    main()
