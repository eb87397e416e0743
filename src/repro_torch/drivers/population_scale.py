# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Population-scale federated rounds: partial participation over a
persistent population, on the population engine (``ShardedFLRun``).

A persistent population of N clients (half Table-I stragglers) keeps its
Helios soft-training state server-side while only a sampled cohort of K
trains each round, the regime real FL servers run in.  The cohort is
padded to a multiple of the clients group's training ranks, and each rank
trains its block of slots as one vmapped step a local step, so the same
command scales from one card to one process a card under ``torchrun``:

    python -m repro_torch.drivers.population_scale \\
        --population 1024 --participation 32 --rounds 10
    python -m repro_torch.drivers.population_scale --model alexnet \\
        --widths full --population 1024 --participation 32 --rounds 3
    torchrun --nproc-per-node 4 -m repro_torch.drivers.population_scale \\
        --population 4096 --participation 32 --sampler time_weighted
    python -m repro_torch.drivers.population_scale --device cpu --rounds 2

``--widths reference`` (the default) runs the reference example's reduced
configs; ``full`` takes them unchanged.  It prints the set-up time, the
rounds per second after an untimed warm-up round, the accuracy, and the
clients and distinct cohorts the rounds drew.  The reference's example
also prints its count of compiled round programs (one: the padded cohort
is shape-stable); the port runs eagerly and compiles nothing a round, so
there is no such count to print.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch

from repro_torch.configs import CNNS, HeliosConfig, reduced
from repro_torch.data.federated import partition_iid_lazy
from repro_torch.data.synthetic import class_gaussian_images
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated import ShardedFLRun, make_fleet, setup_clients
from repro_torch.launch.mesh import init_process_group


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def population_scale(model: str = "lenet", population: int = 1024,
                     participation: int = 32, sampler: str = "uniform",
                     rounds: int = 10, widths: str = "reference",
                     device: DeviceLike = None,
                     kernels: Optional[str] = None) -> dict:
    """Run the example's population and return its readings; prints on
    rank 0 only."""
    dev = resolve_device(device)
    if int(os.environ.get("WORLD_SIZE", 1)) > 1 and \
            not torch.distributed.is_initialized():
        dev = init_process_group(dev)
    say = print if int(os.environ.get("RANK", 0)) == 0 else (
        lambda *a, **k: None)
    cfg = reduced(CNNS[model]) if widths == "reference" else CNNS[model]
    imgs, labels = class_gaussian_images(
        8192, cfg.image_size, cfg.in_channels, cfg.num_classes, seed=0)
    ti, tl = class_gaussian_images(
        512, cfg.image_size, cfg.in_channels, cfg.num_classes, seed=99)
    n, k = population, participation
    hcfg = HeliosConfig()
    t0 = time.perf_counter()
    # lazy partition: one shared permutation, no N per-client index arrays
    parts = partition_iid_lazy(len(labels), n, seed=0)
    clients = setup_clients(make_fleet(n - n // 2, n // 2), parts, hcfg,
                            device=dev)
    run = ShardedFLRun(cfg, hcfg, "helios", clients,
                       {"images": imgs, "labels": labels},
                       {"images": ti, "labels": tl},
                       local_steps=1, batch_size=16, lr=0.05,
                       participation=k, sampler=sampler, device=dev,
                       kernels=kernels)
    setup_s = time.perf_counter() - t0
    say(f"== {model} ({widths} widths): N={n} clients, K={k}/round "
        f"({sampler}), {run._group.shards} training rank(s) of "
        f"{run._group.size}, cohort padded to {run._kpad}, "
        f"kernels={run.kernels}, device={dev} ==")
    say(f"set-up {setup_s:.3f} s (fleet, lazy partition, population rows)")

    run.run_sync(1, eval_every=0)          # untimed warm-up round
    _sync(dev)
    t0 = time.perf_counter()
    run.run_sync(rounds, eval_every=0)
    _sync(dev)
    wall = time.perf_counter() - t0
    acc = run.evaluate()
    sampled = {i for cohort in run.cohort_log for i in cohort}
    cohorts = len({tuple(c) for c in run.cohort_log})
    say(f"{rounds} rounds in {wall:.3f} s ({rounds / wall:.2f} rounds/s) | "
        f"acc {acc:.3f}")
    say(f"clients touched: {len(sampled)}/{n} | distinct cohorts: "
        f"{cohorts} of {len(run.cohort_log)} rounds")
    vols = sorted(c.volume for c in run.clients if c.is_straggler
                  and c.volume < 1.0)[:8]
    say(f"adapted straggler volumes (sampled cohorts only): "
        f"{[round(v, 2) for v in vols]}")
    return {"setup_s": setup_s, "wall_s": wall,
            "rounds_per_s": rounds / wall, "acc": acc,
            "touched": len(sampled), "cohorts": cohorts, "run": run}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="lenet",
                    choices=["lenet", "alexnet", "resnet18"])
    ap.add_argument("--population", type=int, default=1024)
    ap.add_argument("--participation", type=int, default=32)
    ap.add_argument("--sampler", default="uniform",
                    choices=["uniform", "time_weighted"])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--widths", default="reference",
                    choices=["reference", "full"],
                    help="reference: the example's reduced configs; full: "
                         "the configs unchanged")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--kernels", default=None,
                    choices=["cuda", "reference"],
                    help="default: cuda on a GPU, reference on the CPU")
    a = ap.parse_args(argv)
    population_scale(a.model, a.population, a.participation, a.sampler,
                     a.rounds, a.widths, a.device, a.kernels)


if __name__ == "__main__":
    main()
