# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""The scheme gauntlet: every scheme of :data:`SCHEMES` under one
heterogeneous world.

Same non-IID partition, same half-straggler fleet (4 capable + 4 Table-I
stragglers), same seed, 2 local steps at lr 0.02, evaluation every round.
Per scheme: the accuracy trajectory against simulated wall-clock (each
scheme's own round clock: syn waits for stragglers, delayed does not), the
uplink and downlink bytes (scaffold's control deltas ride dense at 2x),
and for the soft-training schemes the Prop. 2 report at the straggler
volumes the run settled on.  Async-native schemes run ``AsyncFLRun``'s
bucket engine for ``rounds`` capable cycles, every other scheme
``BatchedFLRun.run_sync(rounds)``.  The JSON has the reference's keys.
The engines run the CUDA kernels on the GPU and their plain versions on
the CPU unless ``--kernels`` says otherwise.

    python -m repro_torch.drivers.scheme_gauntlet
    python -m repro_torch.drivers.scheme_gauntlet --device cpu --quick
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs import CNNS, HeliosConfig, ModelConfig
from repro_torch.core import theory
from repro_torch.data.federated import partition_iid, partition_noniid
from repro_torch.data.synthetic import class_gaussian_images
from repro_torch.device import DeviceLike
from repro_torch.federated import (SCHEMES, AsyncFLRun, BatchedFLRun,
                                   make_fleet, make_scheme, setup_clients)

#: task difficulty calibrated so convergence takes 10+ rounds (the
#: reference's setting)
_NOISE = {"lenet": 6.0, "alexnet": 3.0, "resnet18": 3.0}
DEFAULT_OUT = os.path.join("chiprun_out", "scheme_gauntlet.json")


def _world(cfg: ModelConfig, n_clients: int, noniid: bool = True,
           seed: int = 0):
    """(train, test, client partitions) of the class-Gaussian task."""
    noise = _NOISE.get(cfg.name, 4.0)
    imgs, labels = class_gaussian_images(
        2000, cfg.image_size, cfg.in_channels, cfg.num_classes, seed=seed,
        noise=noise)
    ti, tl = class_gaussian_images(
        512, cfg.image_size, cfg.in_channels, cfg.num_classes,
        seed=seed + 99, noise=noise)
    if noniid:
        parts = partition_noniid(labels, n_clients, shards_per_client=4,
                                 seed=seed)
    else:
        parts = partition_iid(len(labels), n_clients, seed=seed)
    return {"images": imgs, "labels": labels}, \
        {"images": ti, "labels": tl}, parts


def _sorted_leaves(tree):
    """Leaves in sorted-key order (the reference's tree flattening)."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _prop2_report(straggler) -> dict:
    """Prop. 2 numbers for one straggler's current contribution scores: the
    Wangni sampling distribution at its adapted volume, the Eq. 6 variance
    inflation it pays, and the Eq. 9 expected-sparsity bound."""
    g = torch.cat([torch.as_tensor(v, dtype=torch.float32).reshape(-1)
                   for v in _sorted_leaves(straggler.helios_state["scores"])])
    n = int(g.shape[0])
    v = max(1, int(float(straggler.volume) * n))
    p = theory.wangni_probabilities(g, v)
    lhs, rhs = theory.check_convergence_condition(g, v, rho=0.5)
    return {"score_units": n, "volume": float(straggler.volume),
            "top_v": v,
            "variance_inflation": float(theory.variance_inflation(g, p)),
            "expected_sparsity": float(lhs), "eq9_bound": float(rhs),
            "eq9_holds": bool(float(lhs) <= float(rhs) + 1e-6)}


def scheme_gauntlet(cfg: Optional[ModelConfig] = None, rounds: int = 12,
                    nc: int = 4, ns: int = 4, seed: int = 0,
                    out_path: Optional[str] = DEFAULT_OUT,
                    device: DeviceLike = None, kernels: Optional[str] = None,
                    init_params: Optional[Mapping] = None
                    ) -> Tuple[dict, Dict[str, object], Dict[str, float]]:
    """Run every scheme on ``cfg`` (unreduced LeNet by default) and write the
    table to ``out_path`` (None writes nothing).  ``init_params`` starts
    every run from the same params (None draws them from ``seed``).
    Returns (the table, {scheme: its run}, {scheme: its wall time in s,
    training and evaluation})."""
    cfg = cfg or CNNS["lenet"]
    train, test, parts = _world(cfg, nc + ns, noniid=True, seed=seed)
    results, runs, walls = {}, {}, {}
    for scheme in SCHEMES:
        sch = make_scheme(scheme)
        hcfg = HeliosConfig()
        clients = setup_clients(make_fleet(nc, ns), parts, hcfg,
                                device=device)
        cls = AsyncFLRun if sch.async_native else BatchedFLRun
        run = cls(cfg, hcfg, scheme, clients, train, test, local_steps=2,
                  lr=0.02, seed=seed, kernels=kernels, device=device,
                  init_params=init_params)
        t0 = time.perf_counter()
        # the last history row's evaluation waits for the device
        hist = run.run_async(rounds) if sch.async_native else \
            run.run_sync(rounds)
        walls[scheme] = time.perf_counter() - t0
        rec = {
            "engine": cls.__name__,
            "final_acc": hist[-1]["acc"],
            "sim_time": hist[-1]["time"],
            "uplink_mb": run.uplink_bytes() / 1e6,
            "downlink_mb": run.downlink_bytes() / 1e6,
            "trajectory": [{"time": round(h["time"], 4),
                            "acc": round(h["acc"], 4),
                            "downlink_mb": round(h.get("downlink_mb", 0.0),
                                                 4)} for h in hist],
        }
        if sch.soft_training:
            rec["prop2"] = _prop2_report(
                next(c for c in run.clients if c.is_straggler))
        results[scheme], runs[scheme] = rec, run
        extra = ""
        if "prop2" in rec:
            extra = (f";var_inflation={rec['prop2']['variance_inflation']:.3f}"
                     f";eq9={'ok' if rec['prop2']['eq9_holds'] else 'FAIL'}")
        print(f"scheme_gauntlet/{cfg.name}/{scheme},"
              f"{rec['sim_time'] / max(hist[-1]['cycle'], 1) * 1e6:.1f},"
              f"acc={rec['final_acc']:.3f};simtime={rec['sim_time']:.2f};"
              f"uplink_mb={rec['uplink_mb']:.2f};"
              f"downlink_mb={rec['downlink_mb']:.2f}" + extra, flush=True)
    doc = {"model": cfg.name, "rounds": rounds,
           "fleet": {"capable": nc, "stragglers": ns},
           "partition": "noniid", "seed": seed,
           "local_steps": 2, "lr": 0.02,
           "schemes": results,
           "note": ("one world, every scheme: accuracy is at equal "
                    "ROUNDS; compare at equal sim_time for the "
                    "wall-clock frontier (each scheme's round "
                    "clock differs by design) and against "
                    "uplink_mb for the communication frontier; "
                    "prop2 rows price soft-training's gradient "
                    "variance (Eq. 6/9) at the settled volumes")}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"wrote {out_path}")
    return doc, runs, walls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="3 rounds instead of 12")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--kernels", default=None,
                    choices=["reference", "cuda"],
                    help="the soft-training substrate (default: cuda on a "
                         "GPU, reference on the CPU)")
    args = ap.parse_args()
    scheme_gauntlet(rounds=3 if args.quick else 12, out_path=args.out,
                    device=args.device, kernels=args.kernels)


if __name__ == "__main__":
    main()
