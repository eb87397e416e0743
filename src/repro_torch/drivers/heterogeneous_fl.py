# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""The example's five-scheme table: a 4- or 6-device federated
collaboration with Table-I stragglers, Helios against Syn FL / Asyn FL /
Random [12] / AFO [6] on accuracy and simulated wall time.  The paper's
figure tables (Figs. 5-7, the speedup, the P_s ablation) are
:mod:`repro_torch.drivers.paper_figures`.

    python -m repro_torch.drivers.heterogeneous_fl --devices 4 --rounds 10
    python -m repro_torch.drivers.heterogeneous_fl --device cpu --rounds 2

Population-scale mode: ``--clients N`` (e.g. 64-256) simulates a large
half-straggler fleet (syn and helios only, rounds timed after a warm-up
round); pair it with ``--engine batched`` to run each local step of a
cohort as one vmapped step instead of a per-client loop.  With
``--engine batched`` the async schemes run the bucketed event engine.  The
engines run the CUDA kernels on the GPU and their plain versions on the CPU
unless ``--kernels`` says otherwise.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Mapping, Optional

import torch

from repro_torch.configs import CNNS, HeliosConfig, ModelConfig, reduced
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.drivers.paper_figures import world_data
from repro_torch.federated import (BatchedFLRun, FLRun, make_fleet,
                                   make_scheme, setup_clients)

#: the paper-mode table's schemes, in the reference's order
TABLE_SCHEMES = ("syn", "asyn", "random", "afo", "helios")


def heterogeneous_fl(cfg: ModelConfig, devices: int = 4, rounds: int = 10,
                     engine: str = "sequential", clients: int = 0,
                     device: DeviceLike = None, kernels: Optional[str] = None,
                     init_params: Optional[Mapping] = None, lr: float = 0.1
                     ) -> Dict[str, List[dict]]:
    """Print the comparison on ``cfg`` and return {scheme: history}
    (population mode: {scheme: [{"acc", "wall_s", "rounds"}]}).
    ``init_params`` starts every run from the same params (None draws them
    from the engines' seed).  ``lr`` is the paper-mode table's (the
    reference's 0.1 is set for reduced widths: full-width AlexNet
    diverges at it within two rounds of 5 local steps)."""
    dev = resolve_device(device)
    runner = BatchedFLRun if engine == "batched" else FLRun
    # the class-Gaussian task at the generator's default noise
    n = clients or devices
    train, test, parts = world_data(cfg, n, noniid=not clients, noise=0.7)
    hcfg = HeliosConfig()
    kw = dict(kernels=kernels, device=dev, init_params=init_params)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    if clients:
        nc, ns = n - n // 2, n // 2
        print(f"== {cfg.name}, {nc} capable + {ns} stragglers, "
              f"engine={engine} ==")
        out = {}
        for scheme in ("syn", "helios"):
            run = runner(cfg, hcfg, scheme,
                         setup_clients(make_fleet(nc, ns), parts, hcfg,
                                       device=dev), train, test,
                         local_steps=1, batch_size=16, lr=0.05, **kw)
            run.run_sync(1, eval_every=0)      # untimed warm-up round
            sync()
            t0 = time.perf_counter()
            run.run_sync(rounds, eval_every=0)
            sync()
            wall = time.perf_counter() - t0
            acc = run.evaluate()
            out[scheme] = [{"acc": acc, "wall_s": wall, "rounds": rounds}]
            print(f"{scheme:7s} | final acc {acc:.3f} | "
                  f"wall {wall:6.1f}s ({rounds / wall:.2f} rounds/s)")
        return out

    nc = ns = devices // 2
    print(f"== {cfg.name}, {nc} capable + {ns} stragglers, "
          f"Non-IID=True, engine={engine} ==")
    results = {}
    for scheme in TABLE_SCHEMES:
        run = runner(cfg, hcfg, scheme,
                     setup_clients(make_fleet(nc, ns), parts, hcfg,
                                   device=dev), train, test,
                     local_steps=5, lr=lr, **kw)
        if make_scheme(scheme).async_native:
            hist = run.run_async(rounds)
        else:
            hist = run.run_sync(rounds)
        results[scheme] = hist
        print(f"{scheme:7s} | final acc {hist[-1]['acc']:.3f} | "
              f"sim time {hist[-1]['time']:7.1f} | "
              f"time/cycle {hist[-1]['time'] / max(1, hist[-1]['cycle']):.2f}")

    t_syn = results["syn"][-1]["time"] / max(1, results["syn"][-1]["cycle"])
    t_hel = results["helios"][-1]["time"] / max(
        1, results["helios"][-1]["cycle"])
    print(f"\nHelios cycle speedup vs Syn FL: {t_syn / t_hel:.2f}x "
          f"(paper: up to 2.5x)")
    if ns >= 2:
        vols = results["helios"][-1].get("volumes", [])
        print(f"adapted straggler volumes: "
              f"{[round(v, 2) for v in vols if v < 1.0]}")
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="lenet",
                    choices=["lenet", "alexnet", "resnet18"])
    ap.add_argument("--devices", type=int, default=4, choices=[4, 6])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--engine", default="sequential",
                    choices=["sequential", "batched"])
    ap.add_argument("--clients", type=int, default=0,
                    help="population-scale mode: total client count "
                         "(half stragglers); 0 = paper's 4/6-device setting")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--kernels", default=None,
                    choices=["reference", "cuda"],
                    help="the soft-training substrate (default: cuda on a "
                         "GPU, reference on the CPU)")
    args = ap.parse_args()
    heterogeneous_fl(reduced(CNNS[args.model]), args.devices, args.rounds,
                     args.engine, args.clients, args.device, args.kernels)


if __name__ == "__main__":
    main()
