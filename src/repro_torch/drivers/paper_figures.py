# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""The paper's figure tables: Fig. 5 convergence, the speedup against Syn
FL, Fig. 6 aggregation optimisation, Fig. 7 non-IID and the P_s ablation.

One function a table, with the reference harness's names, arguments and
rows.  A row is ``name,us_per_call,derived``: ``us_per_call`` is the
simulated wall time per aggregation cycle (x 1e6), ``derived`` the final
accuracy (or the speedup, or Fig. 6's gain).  Every run is ``FLRun`` on a
class-Gaussian task (2000 training images, 512 test images, non-IID by
sort-and-shard unless Fig. 7 asks for IID), 2 local steps at lr 0.02,
seed 0; an async-native scheme runs ``run_async(rounds)``, every other
``run_sync(rounds)``.

Widths: ``reference`` (the default) runs full LeNet and the reduced
AlexNet and ResNet-18 of the reference (``configs.reduced``), so the CPU
comparison runs like against like; ``full`` takes the three configs
unchanged, for the card.  Every table takes the engine keywords
``device``, ``kernels`` and ``init_params`` (one params tree for every
run of the call, so a call with several models takes none), and returns
its rows.  The engines run the CUDA kernels on the GPU and their
plain versions on the CPU unless ``--kernels`` says otherwise; on the
GPU the CLI turns TF32 off and cuDNN deterministic.

Two quirks of the reference are kept: the speedup table gives helios
three times the rounds of the other schemes, and Fig. 6 divides the sim
time by ``rounds`` where Figs. 5 and 7 divide by the last row's ``cycle``.

    python -m repro_torch.drivers.paper_figures --widths full
    python -m repro_torch.drivers.paper_figures --device cpu --quick
"""
from __future__ import annotations

import argparse
import math
import time
from typing import List, Optional

import torch

from repro_torch.configs import CNNS, HeliosConfig, ModelConfig, reduced
from repro_torch.data.federated import partition_iid, partition_noniid
from repro_torch.data.synthetic import class_gaussian_images
from repro_torch.device import resolve_device
from repro_torch.federated import FLRun, make_fleet, make_scheme, setup_clients

#: task difficulty calibrated so convergence takes 10+ rounds (the
#: reference's setting)
_NOISE = {"lenet": 6.0, "alexnet": 3.0, "resnet18": 3.0}
WIDTHS = ("reference", "full")
#: the tables' learning rate (2 local steps of momentum SGD)
LR = 0.02


def world_data(cfg: ModelConfig, n_clients: int, noniid: bool = True,
               seed: int = 0, noise: Optional[float] = None):
    """(train, test, client partitions) of the class-Gaussian task: 2000
    training images drawn from ``seed``, 512 test images from ``seed + 99``
    at ``noise`` (None: the model's calibrated difficulty), split non-IID
    (4 label shards a client) or IID."""
    noise = _NOISE.get(cfg.name, 4.0) if noise is None else noise
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


def model_config(model: str, widths: str = "reference") -> ModelConfig:
    """The table's config of ``model``: full LeNet, reduced AlexNet and
    ResNet-18 at ``reference`` widths; every config unchanged at ``full``."""
    if widths not in WIDTHS:
        raise ValueError(f"widths must be one of {WIDTHS}, got {widths!r}")
    cfg = CNNS[model]
    return cfg if model == "lenet" or widths == "full" else reduced(cfg)


def _world(model: str, n_clients: int, noniid: bool = True, seed: int = 0,
           widths: str = "reference"):
    cfg = model_config(model, widths)
    return (cfg, *world_data(cfg, n_clients, noniid, seed))


def make_run(world, scheme: str, n_capable: int, n_straggler: int,
             lr: float = LR, hcfg: Optional[HeliosConfig] = None,
             seed: int = 0, device=None, kernels: Optional[str] = None,
             init_params=None) -> FLRun:
    """The tables' run: ``n_capable`` + ``n_straggler`` Table-I devices on
    the world's first partitions, 2 local steps of batch 32."""
    cfg, train, test, parts = world
    hcfg = hcfg or HeliosConfig()
    clients = setup_clients(make_fleet(n_capable, n_straggler), parts, hcfg,
                            device=device)
    return FLRun(cfg, hcfg, scheme, clients, train, test, local_steps=2,
                 lr=lr, seed=seed, kernels=kernels, device=device,
                 init_params=init_params)


def _run_scheme(world, scheme, n_capable, n_straggler, rounds, lr=LR,
                hcfg=None, seed=0, **engine):
    run = make_run(world, scheme, n_capable, n_straggler, lr, hcfg, seed,
                   **engine)
    # the Scheme object is the one authority on sync-vs-event execution
    if make_scheme(scheme).async_native:
        return run.run_async(rounds)
    return run.run_sync(rounds)


def _acc_at_time(hist, t):
    best = 0.0
    for h in hist:
        if h["time"] <= t:
            best = max(best, h["acc"])
    return best


def _time_to_acc(hist, target):
    for h in hist:
        if h["acc"] >= target:
            return h["time"]
    return float("inf")


def emit(name: str, us_per_call: float, derived) -> str:
    """Print one ``name,us_per_call,derived`` row and return it."""
    row = f"{name},{us_per_call:.1f},{derived}"
    print(row, flush=True)
    return row


# ---------------------------------------------------------------------------
# Fig. 5 / §VII.B: convergence accuracy, 4- and 6-device settings
# ---------------------------------------------------------------------------


def table_convergence(models=("lenet", "alexnet", "resnet18"), rounds=14,
                      widths="reference", **engine) -> List[str]:
    if engine.get("init_params") is not None and len(models) != 1:
        raise ValueError("init_params is one params tree: run one model a "
                         "call")
    rows = []
    for model in models:
        for (nc, ns) in ((2, 2), (3, 3)):
            world = _world(model, nc + ns, widths=widths)
            for scheme in ("syn", "asyn", "random", "afo", "helios"):
                hist = _run_scheme(world, scheme, nc, ns, rounds, **engine)
                cyc_t = hist[-1]["time"] / max(hist[-1]["cycle"], 1)
                rows.append(emit(f"fig5/{model}/{nc + ns}dev/{scheme}",
                                 cyc_t * 1e6, f"acc={hist[-1]['acc']:.3f}"))
    return rows


# ---------------------------------------------------------------------------
# §VII.B: speedup vs Syn FL (paper: up to 2.5x)
# ---------------------------------------------------------------------------


def table_speedup(model="lenet", rounds=16, target=0.4, widths="reference",
                  **engine) -> List[str]:
    rows = []
    for (nc, ns) in ((2, 2), (3, 3)):
        world = _world(model, nc + ns, widths=widths)
        base = _run_scheme(world, "syn", nc, ns, rounds, **engine)
        t_syn = _time_to_acc(base, target)
        for scheme in ("helios", "random", "afo"):
            hist = _run_scheme(world, scheme, nc, ns, rounds * 3
                               if scheme == "helios" else rounds, **engine)
            t = _time_to_acc(hist, target)
            sp = t_syn / t if math.isfinite(t) else 0.0
            rows.append(emit(f"speedup/{model}/{nc + ns}dev/{scheme}",
                             (t if math.isfinite(t) else -1) * 1e6,
                             f"speedup_vs_syn={sp:.2f}x"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 6 / §VII.C: aggregation optimization (Helios vs S.T. Only)
# ---------------------------------------------------------------------------


def table_aggregation_opt(model="lenet", rounds=10, widths="reference",
                          **engine) -> List[str]:
    rows = []
    for ns in (1, 2, 3, 4):
        world = _world(model, 2 + ns, widths=widths)
        h_st = _run_scheme(world, "st_only", 2, ns, rounds, **engine)
        h_he = _run_scheme(world, "helios", 2, ns, rounds, **engine)
        gain = h_he[-1]["acc"] - h_st[-1]["acc"]
        rows.append(emit(
            f"fig6/{model}/{ns}stragglers/helios_vs_st_only",
            h_he[-1]["time"] / rounds * 1e6,
            f"acc_st={h_st[-1]['acc']:.3f};acc_helios={h_he[-1]['acc']:.3f};"
            f"gain={gain:+.3f}"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 7 / §VII.D: Non-IID evaluation
# ---------------------------------------------------------------------------


def table_noniid(model="lenet", rounds=12, widths="reference",
                 **engine) -> List[str]:
    rows = []
    for (nc, ns) in ((2, 2), (3, 3)):
        for noniid in (False, True):
            world = _world(model, nc + ns, noniid=noniid, widths=widths)
            for scheme in ("syn", "asyn", "helios"):
                hist = _run_scheme(world, scheme, nc, ns, rounds, **engine)
                tag = "noniid" if noniid else "iid"
                rows.append(emit(
                    f"fig7/{model}/{nc + ns}dev/{tag}/{scheme}",
                    hist[-1]["time"] / max(hist[-1]["cycle"], 1) * 1e6,
                    f"acc={hist[-1]['acc']:.3f}"))
    return rows


# ---------------------------------------------------------------------------
# ablation: P_s (top-contribution fraction, Section VI.A: "0.05 to 0.1")
# ---------------------------------------------------------------------------

#: the ablation's P_s values
P_S = (0.0, 0.05, 0.1, 0.3)


def table_ps_ablation(model="lenet", rounds=10, widths="reference",
                      **engine) -> List[str]:
    """P_s=0 is pure-random rotation (≈ Caldas); large P_s freezes the
    rotation (top units monopolize).  The paper picks 0.05-0.1."""
    world = _world(model, 4, widths=widths)
    rows = []
    for p_s in P_S:
        hist = _run_scheme(world, "helios", 2, 2, rounds,
                           hcfg=HeliosConfig(p_s=p_s), **engine)
        rows.append(emit(f"ablation/p_s={p_s}",
                         hist[-1]["time"] / rounds * 1e6,
                         f"acc={hist[-1]['acc']:.3f}"))
    return rows


TABLES = {
    "fig5": table_convergence,
    "speedup": table_speedup,
    "fig6": table_aggregation_opt,
    "fig7": table_noniid,
    "ablation": table_ps_ablation,
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="Fig. 5 on LeNet only and 6 rounds for Fig. 5, "
                         "the speedup, Fig. 6 and Fig. 7")
    ap.add_argument("--only", default=None,
                    help=f"comma-separated tables of {','.join(TABLES)}")
    ap.add_argument("--widths", default="reference", choices=WIDTHS)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--kernels", default=None,
                    choices=["reference", "cuda"],
                    help="the soft-training substrate (default: cuda on a "
                         "GPU, reference on the CPU)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        # IEEE f32 convolutions and products, as the masked pair computes,
        # and cuDNN's deterministic algorithms: a rerun gives the same rows
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    print(f"# device {torch.cuda.get_device_name(dev) if cuda else 'cpu'}, "
          f"widths {args.widths}, lr {LR}, kernels "
          f"{args.kernels or ('cuda' if cuda else 'reference')}, tf32 off",
          flush=True)
    kw = dict(widths=args.widths, device=dev, kernels=args.kernels)
    only = args.only.split(",") if args.only else list(TABLES)
    for name in only:
        fn = TABLES[name]
        print(f"## {name}", flush=True)
        t0 = time.perf_counter()
        if args.quick and name == "fig5":
            fn(models=("lenet",), rounds=6, **kw)
        elif args.quick and name in ("speedup", "fig6", "fig7"):
            fn(rounds=6, **kw)
        else:
            fn(**kw)
        # every run's last history row evaluates, which waits for the device
        print(f"## {name} wall {time.perf_counter() - t0:.3f} s", flush=True)


if __name__ == "__main__":
    main()
