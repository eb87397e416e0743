# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Quickstart: Helios soft-training on one straggler, end to end.

The public API surface in one walk: the config registry, the model, then
the Helios state machine (identify, volume, select, train, rotate).  Table
I's Jetson Nano (CPU) is the straggler; its soft-training volume P comes
from its modelled cycle time against the capable pace (§IV); then 5
cycles of Eq. 2 selection, 5 masked momentum steps each, Eq. 1 cycle
scores and the C_s rotation (§V).  A training step is one plain torch
function through ``build(cfg)``'s loss; on the card its masked fc layers
run the masked-matmul kernels.

    python -m repro_torch.drivers.quickstart
    python -m repro_torch.drivers.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.configs import CNNS, HeliosConfig, ModelConfig, reduced
from repro_torch.core import soft_train as ST
from repro_torch.core.volume import volume_from_profile
from repro_torch.data.synthetic import class_gaussian_images
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated.adapter import make_adapter
from repro_torch.federated.heterogeneity import CAPABLE, TABLE_I, cycle_time
from repro_torch.kernels.ops import CUDA, REFERENCE, canonical_impl
from repro_torch.models import build
from repro_torch.models import init_params as _init_params
from repro_torch.models.module import tree_map, tree_paths, unflatten
from repro_torch.optim import apply_updates, make_optimizer


def quickstart(cfg: Optional[ModelConfig] = None, device: DeviceLike = None,
               kernels: Optional[str] = None,
               init_params: Optional[Mapping] = None) -> dict:
    """Run the walk on ``cfg`` (reduced LeNet by default) and return
    ``{"params", "state", "volume", "cycles": [(loss, selected)],
    "scores"}``: the final params, the straggler's Helios state, its
    volume, each cycle's last loss and selected fraction, and the last
    cycle's Eq. 1 scores.  ``init_params`` starts from the given params
    (None draws them from seed 0)."""
    dev = resolve_device(device)
    cfg = cfg or reduced(CNNS["lenet"])
    kernels = canonical_impl(kernels or (CUDA if dev.type == "cuda"
                                         else REFERENCE))
    # 1. a model (the paper's LeNet testbed) + its FL adapter
    api = build(cfg)
    # the kernels skip 128-column blocks, the engines' block when
    # HeliosConfig.mask_block is 0
    adapter = make_adapter(cfg, kernels, 128, dev)
    rt = {"kernels": kernels, "mask_block": 128}
    params = _init_params(cfg, 0, dev) if init_params is None else {
        k: torch.as_tensor(np.array(v)).to(dev) for k, v in
        init_params.items()}

    # 2. identify the straggler and its optimization target (§IV)
    straggler = TABLE_I[0]                   # Jetson Nano (CPU) from Table I
    pace = cycle_time(CAPABLE)               # the collaboration pace
    volume = volume_from_profile(cycle_time(straggler), pace)
    print(f"straggler={straggler.name} -> soft-training volume P={volume:.2f}")

    # 3. soft-training cycles (§V): select -> train -> score -> rotate
    hcfg = HeliosConfig(p_s=0.1)
    state = ST.init_state(api.mask_schema, volume=volume, seed=0, device=dev)
    imgs, labels = class_gaussian_images(512, cfg.image_size,
                                         cfg.in_channels, cfg.num_classes)
    opt = make_optimizer("momentum", 0.1)
    opt_state = opt.init(params)

    def train_step(params, opt_state, masks, bi, bl):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = api.loss_fn(leaves, {"images": bi, "labels": bl}, cfg, rt,
                           masks)
        paths = tree_paths(leaves)
        grads = unflatten(dict(zip((k for k, _ in paths), torch.autograd.grad(
            loss, [v for _, v in paths]))))
        updates, opt_state = opt.update(grads, opt_state, params, 0)
        return apply_updates(params, updates), opt_state, loss.detach()

    rng = np.random.default_rng(0)
    log = []
    for cycle in range(5):
        state = ST.begin_cycle(state, hcfg)                  # Eq. 2 selection
        frac = float(np.mean([float(m.mean())
                              for m in state["masks"].values()]))
        prev = params
        for _ in range(5):
            idx = rng.integers(0, len(labels), 32)
            params, opt_state, loss = train_step(
                params, opt_state, state["masks"],
                torch.as_tensor(imgs[idx]).to(dev),
                torch.as_tensor(labels[idx]).to(dev))
        scores = adapter.cycle_scores(params, prev)          # Eq. 1
        state = ST.end_cycle(state, scores, hcfg)            # C_s rotation
        log.append((float(loss), frac))
        print(f"cycle {cycle}: loss={log[-1][0]:.3f} "
              f"selected={frac:.2f} (target P={volume:.2f})")

    print("done — every unit rotates through training while the straggler "
          "computes only a fraction of the model per cycle.")
    return {"params": params, "state": state, "volume": volume,
            "cycles": log, "scores": scores}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--kernels", default=None,
                    choices=["reference", "cuda"],
                    help="the soft-training substrate (default: cuda on a "
                         "GPU, reference on the CPU)")
    args = ap.parse_args()
    quickstart(device=args.device, kernels=args.kernels)


if __name__ == "__main__":
    main()
