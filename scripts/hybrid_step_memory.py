"""Peak device memory of one hybrid training step, three ways, on one GPU.

    python3 scripts/hybrid_step_memory.py [--layers 12]

Zamba2-1.2B at full width with its depth cut to ``--layers`` Mamba2
layers, batch 4 x 512 tokens, ``kernels="cuda"`` (the ``ssd_diag`` kernel
and its recompute backward), full masks, seed-0 params: the peak above
the params of one client's loss and gradients by plain autograd (what
``FLRun``'s local training runs), by ``torch.func.grad``, and of a cohort
of two under ``torch.func.vmap(torch.func.grad(...))`` (what
``BatchedFLRun``'s local training runs).  Prints the card's name and
power limit and one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hybrid_step_memory: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import ZAMBA2_1_2B
    from repro_torch.kernels import build
    from repro_torch.models import (hybrid, init_params, make_full_masks,
                                    transformer)
    from repro_torch.models.module import tree_leaves, tree_paths, unflatten
    build.build(["ssd_scan"])
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(ZAMBA2_1_2B, num_layers=args.layers)
    params = init_params(cfg, 0, "cuda")
    rt = transformer.default_runtime()
    rt["kernels"], rt["mask_block"] = "cuda", 128
    masks = make_full_masks(cfg, "cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, 1024, (2, 4, 512), device="cuda", generator=g)

    def loss(p, b):
        return hybrid.hybrid_loss(p, {"tokens": b}, cfg, rt, masks)

    def autograd_step():
        leaves = dict(tree_paths(params))
        for v in leaves.values():
            v.requires_grad_(True)
        grads = torch.autograd.grad(loss(params, tokens[0]),
                                    list(leaves.values()))
        for v in leaves.values():
            v.requires_grad_(False)
        return unflatten(dict(zip(leaves, grads)))

    steps = {
        "plain autograd, one client": autograd_step,
        "torch.func.grad, one client":
            lambda: torch.func.grad(loss)(params, tokens[0]),
        "torch.func.vmap(grad), a cohort of 2":
            lambda: torch.func.vmap(torch.func.grad(loss),
                                    in_dims=(None, 0))(params, tokens)}
    copy = 4 * sum(v.numel() for v in tree_leaves(params)) / 2 ** 30
    out = {"layers": args.layers, "params_gib": copy}
    for name, step in steps.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = step()
        torch.cuda.synchronize()
        out[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        del grads
        torch.cuda.empty_cache()
        print(f"{name}: step peak above the params {out[name]:.2f} GiB "
              f"(one params copy {copy:.2f} GiB)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
