"""The population engine across the cards of one host: ``ShardedFLRun``
over an NCCL clients group of one rank a card, against the same run at
world 1 on the first card.

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/sharded_ranks_card.py
    # the same on CPU processes over gloo (a dry run of the script)
    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/sharded_ranks_card.py cpu

Full-width AlexNet (``mask_block`` 128), a population of 1024 clients
(half Table-I stragglers, IID), 32 a round (8 slots a rank on 4 cards),
helios, one local step of batch 16, lr 0.05, ``run_sync(2)`` on the CUDA
kernels, under Eq. 10, ``masked_mean`` and ``topk``.  Checks that every
rank ends with the same params, history, population rows and error rows
(digests gathered, after 4 rounds), and that after 2 rounds rank 0's
params are within 1e-4 of the world-1 run's, history identical but
ratios (one float32 ulp) and acc / loss (1/512, 1e-4).  Under ``topk``
an ulp decides (a coordinate at a row's top-k threshold is sent by one
layout and kept by the other), so its params are held at max(1e-4,
twice the drift of a world-1 twin whose initial params are nudged by
2^-23).  Later rounds are not held: a client drawn again selects its
Eq. 2 units from scores that an ulp can reorder.  Prints the round walls
of both layouts (rounds 3 and 4, evaluation off) and exits nonzero when
a check fails.  TF32 off, deterministic cuDNN.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import ALEXNET, HeliosConfig  # noqa: E402
from repro_torch.data.federated import partition_iid_lazy  # noqa: E402
from repro_torch.data.synthetic import class_gaussian_images  # noqa: E402
from repro_torch.federated import (ShardedFLRun, make_fleet,  # noqa: E402
                                   setup_clients)
from repro_torch.launch.mesh import (ClientGroup,  # noqa: E402
                                     init_process_group)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.module import tree_paths  # noqa: E402

N, K = 1024, 32
#: case -> (HeliosConfig overrides, run kwargs)
CASES = {"helios": ({}, {}),
         "masked_mean": ({"aggregation": "masked_mean"}, {}),
         "topk": ({}, {"compression": "topk"})}


def _data():
    imgs, labels = class_gaussian_images(2000, ALEXNET.image_size,
                                         ALEXNET.in_channels,
                                         ALEXNET.num_classes)
    ti, tl = class_gaussian_images(512, ALEXNET.image_size,
                                   ALEXNET.in_channels, ALEXNET.num_classes,
                                   seed=99)
    return {"images": imgs, "labels": labels}, {"images": ti, "labels": tl}


def _run(case: str, dev, data, group=None, nudge: float = 0.0):
    hkw, kw = CASES[case]
    init = {k: v * (1 + nudge) for k, v in
            init_params(ALEXNET, 0, dev).items()}
    hcfg = HeliosConfig(mask_block=128, **hkw)
    train, test = data
    parts = partition_iid_lazy(len(train["labels"]), N, seed=0)
    run = ShardedFLRun(ALEXNET, hcfg, "helios",
                       setup_clients(make_fleet(N // 2, N // 2), parts, hcfg,
                                     device=dev),
                       train, test, local_steps=1, batch_size=16, lr=0.05,
                       participation=K, kernels="cuda", device=dev,
                       group=group, init_params=init, **kw)
    run.run_sync(2)
    held = {k: v.clone() for k, v in run.global_params.items()}
    _sync(dev)
    t0 = time.perf_counter()
    run.run_sync(2, eval_every=0)
    _sync(dev)
    return run, held, (time.perf_counter() - t0) / 2


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _digest(run) -> str:
    h = hashlib.sha256()
    for _, v in tree_paths(run._pop_state):
        h.update(np.ascontiguousarray(v).tobytes())
    for _, v in tree_paths(run.global_params):
        h.update(v.cpu().numpy().tobytes())
    if run.compression != "none":
        for cid in sorted(run._err_store._rows):
            for _, v in tree_paths(run._err_store.row(cid)):
                h.update(v.cpu().numpy().tobytes())
    h.update(json.dumps(run.history, sort_keys=True).encode())
    return h.hexdigest()


def _hold(a, b, pa, pb) -> float:
    """Runs ``a`` and ``b`` over their first 2 rounds: history (ratios to
    one float32 ulp, acc to 1/512, loss to 1e-4), and the params ``pa``,
    ``pb`` they held then: their max |diff|."""
    for x, y in zip(a.history, b.history):
        if any(x[key] != y[key] for key in ("cycle", "time", "volumes")) \
                or not np.allclose(x["ratios"], y["ratios"], rtol=2 ** -23,
                                   atol=0) \
                or abs(x["acc"] - y["acc"]) > 1 / 512 \
                or abs(x["loss"] - y["loss"]) > 1e-4:
            raise AssertionError(f"histories differ: {x} vs {y}")
    return _diff(pa, pb)


def _diff(pa, pb) -> float:
    return max(float((pa[k] - v).abs().max()) for k, v in pb.items())


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = init_process_group(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    data = _data()
    out, ok = {}, True
    for case in CASES:
        run, held, wall = _run(case, dev, data)
        digests = [None] * world
        dist.all_gather_object(digests, _digest(run))
        walls = [None] * world
        dist.all_gather_object(walls, wall)
        same = len(set(digests)) == 1
        rec = {"shards": run._group.shards, "kpad": run._kpad,
               "ranks_identical": same, "round_s": walls}
        if rank == 0:
            alone = ClientGroup(rank=0, size=1, shards=1, device=dev)
            one, held1, wall1 = _run(case, dev, data, alone)
            diff, tol = _hold(run, one, held, held1), 1e-4
            if case == "topk":
                _, twin, _ = _run(case, dev, data, alone, 2.0 ** -23)
                tol = max(tol, 2 * _diff(held1, twin))
            rec.update(world1_round_s=wall1, max_param_diff=diff, tol=tol,
                       acc=[h["acc"] for h in run.history])
            ok = ok and same and diff <= tol and \
                run._group.shards == world
            print(f"{case}: " + json.dumps(rec), flush=True)
        out[case] = rec
        dist.barrier()
    if rank == 0:
        print(json.dumps({"ok": ok, "world": world, "device": (
            torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")}))
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
