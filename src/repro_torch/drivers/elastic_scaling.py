# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Elastic collaboration (§VI.C): devices join and leave mid-training.

A new straggler joining is identified (white-box profile), assigned a
soft-training volume, and admitted without interrupting the collaboration;
a leaving device just drops out of the next aggregation.  Helios on a
2 capable + 2 straggler non-IID fleet for 4 rounds, a DeepLens straggler
joins for 4 rounds, then it leaves for 2 (5 local steps at lr 0.1).

    python -m repro_torch.drivers.elastic_scaling
    python -m repro_torch.drivers.elastic_scaling --device cpu
"""
from __future__ import annotations

import argparse
from typing import Mapping, Optional, Tuple

from repro_torch.configs import CNNS, HeliosConfig, ModelConfig, reduced
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.drivers.paper_figures import world_data
from repro_torch.federated import (TABLE_I, Client, FLRun, make_fleet,
                                   setup_clients)


def elastic_scaling(cfg: Optional[ModelConfig] = None,
                    device: DeviceLike = None, kernels: Optional[str] = None,
                    init_params: Optional[Mapping] = None
                    ) -> Tuple[FLRun, Client]:
    """Run the join / leave sequence on ``cfg`` (reduced LeNet by default)
    and return (the run, the newcomer's client)."""
    dev = resolve_device(device)
    cfg = cfg or reduced(CNNS["lenet"])
    # six partitions: four for the first fleet, one for the newcomer
    train, test, parts = world_data(cfg, 6, noise=0.7)
    hcfg = HeliosConfig()
    clients = setup_clients(make_fleet(2, 2), parts[:4], hcfg, device=dev)
    run = FLRun(cfg, hcfg, "helios", clients, train, test, local_steps=5,
                lr=0.1, kernels=kernels, device=dev, init_params=init_params)

    print("phase 1: 2 capable + 2 stragglers")
    run.run_sync(4)
    print(f"  acc={run.history[-1]['acc']:.3f}")

    print("phase 2: a DeepLens straggler JOINS (white-box identification)")
    new = run.add_client(TABLE_I[3], parts[4])
    print(f"  identified straggler={new.is_straggler}, "
          f"assigned P={new.volume:.2f}")
    run.run_sync(4)
    print(f"  acc={run.history[-1]['acc']:.3f} with {len(run.clients)} "
          f"devices")

    print("phase 3: the newcomer LEAVES")
    run.remove_client(new.cid)
    run.run_sync(2)
    print(f"  acc={run.history[-1]['acc']:.3f} with {len(run.clients)} "
          f"devices")
    print("elastic join/leave complete — no restart, no lost state.")
    return run, new


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--kernels", default=None,
                    choices=["reference", "cuda"],
                    help="the soft-training substrate (default: cuda on a "
                         "GPU, reference on the CPU)")
    args = ap.parse_args()
    elastic_scaling(device=args.device, kernels=args.kernels)


if __name__ == "__main__":
    main()
