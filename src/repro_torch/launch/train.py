# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Training driver: config registry -> model -> Helios soft-training state
-> AdamW -> checkpoints (restart-safe) -> synthetic data.

Helios masks are re-selected every ``--cycle-steps`` steps
(``soft_train.begin_cycle``); the step itself is
:func:`repro_torch.launch.steps.make_train_step`.  Runs on the GPU unless
``--device cpu`` is given; ``--kernels`` defaults to ``cuda`` on the GPU
and ``reference`` on the CPU.

  python -m repro_torch.launch.train --arch xlstm-125m --reduced \\
      --steps 200 --batch 8 --seq 128 --volume 0.5 --ckpt-dir /tmp/run1 \\
      [--device cpu]

A checkpoint holds the whole train state: params, the optimizer's moments,
the step, the Helios state, and in its metadata the Helios key path and
the batch generator's state, so a run resumed from step k draws the same
masks and batches as one that never stopped (the reference restarts its
batch generator from the seed on resume: ROADMAP §3).

The VLM keeps the reference's batch: ``seq - num_image_tokens`` text
columns, a negative slice end below 256, so at the default ``--seq 128``
each row has one text token.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, load, save
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import HeliosConfig, TrainConfig
from repro_torch.core import keys as KY
from repro_torch.core import soft_train as ST
from repro_torch.data.synthetic import markov_tokens
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import CUDA, REFERENCE, canonical_impl
from repro_torch.launch import steps as S
from repro_torch.models import default_runtime
from repro_torch.models.module import tree_leaves


def _saved(state: dict) -> dict:
    """The state without its key path (which goes into the metadata)."""
    return {**state, "helios": {k: v for k, v in state["helios"].items()
                                if k != "rng"}}


def save_state(directory: str, step: int, state: dict,
               data_rng: np.random.Generator, metadata: dict) -> None:
    save(directory, step, _saved(state), metadata={
        **metadata, "helios_rng": [list(p) for p in state["helios"]["rng"].path],
        "data_rng": data_rng.bit_generator.state})


def restore_state(directory: str, state: dict,
                  data_rng: np.random.Generator):
    """(state, step) of the newest checkpoint, ``data_rng`` set to the
    generator state saved with it."""
    tree, step, meta = load(directory, _saved(state))
    tree["helios"]["rng"] = KY.Key(tuple(tuple(p) for p in meta["helios_rng"]))
    data_rng.bit_generator.state = meta["data_rng"]
    return tree, step


def make_batch(cfg, data: np.ndarray, rng: np.random.Generator, batch: int,
               seq: int, device) -> dict:
    """One training batch, drawn as the reference draws it: the row
    indices, then a VLM's stub image embeddings or an encoder-decoder's
    stub frame embeddings ``enc_embeds`` (batch, seq, d_model)."""
    idx = rng.integers(0, len(data), batch)
    if cfg.family == "encdec":
        return {"tokens": torch.as_tensor(data[idx, :seq], device=device),
                "enc_embeds": torch.as_tensor(
                    rng.normal(size=(batch, seq, cfg.d_model)),
                    dtype=torch.float32, device=device)}
    if cfg.family == "vlm":
        n_img = cfg.num_image_tokens
        return {"tokens": torch.as_tensor(data[idx, :seq - n_img],
                                          device=device),
                "image_embeds": torch.as_tensor(
                    rng.normal(size=(batch, n_img, cfg.d_model)),
                    dtype=torch.float32, device=device)}
    return {"tokens": torch.as_tensor(data[idx, :seq], device=device)}


def main(argv=None, report: Optional[dict] = None):
    """Train and return the per-step losses; ``report``, when given,
    receives the config, the final state and the seconds a step."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--volume", type=float, default=1.0,
                    help="Helios soft-training volume P (1.0 = full model)")
    ap.add_argument("--cycle-steps", type=int, default=20,
                    help="soft-training cycle length (mask re-selection)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default=None,
                    choices=("reference", "cuda", "pallas"),
                    help="default: cuda on a GPU, reference on the CPU")
    ap.add_argument("--device", default=None,
                    help="default cuda (raises without a GPU); cpu on ask")
    args = ap.parse_args(argv)

    cfg = get_model_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    hcfg = HeliosConfig(enabled=True, contribution="grad_ema")
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 20))
    rt = default_runtime()
    rt["kernels"] = canonical_impl(args.kernels or (
        CUDA if dev.type == "cuda" else REFERENCE))

    step_fn = S.make_train_step(cfg, hcfg, tcfg, rt)
    state = S.init_train_state(args.seed, cfg, hcfg, tcfg, dev)
    state["helios"] = ST.set_volume(state["helios"], args.volume)
    data = markov_tokens(max(64, args.batch * 8), args.seq + 1,
                         cfg.padded_vocab, seed=args.seed)
    rng = np.random.default_rng(args.seed)

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start = restore_state(args.ckpt_dir, state, rng)
        print(f"resumed from step {start}")

    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M volume="
          f"{args.volume} steps={args.steps} tokens/step="
          f"{args.batch * args.seq} kernels={rt['kernels']} device={dev}")

    losses = []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        if hcfg.enabled and i % args.cycle_steps == 0:
            state["helios"] = ST.begin_cycle(state["helios"], hcfg)
        batch = make_batch(cfg, data, rng, args.batch, args.seq, dev)
        state, metrics = step_fn(state, batch)
        # the loss stays on the device; the host waits only to log or save
        losses.append(metrics["loss"])
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {i:5d} loss {float(losses[-1]):.4f} "
                  f"grad_norm {float(metrics['grad_norm']):.3f} "
                  f"({dt / max(1, len(losses)):.2f}s/step)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_state(args.ckpt_dir, i + 1, state, rng,
                       {"arch": cfg.name, "loss": float(losses[-1])})
    losses = [float(x) for x in losses]
    seconds = time.perf_counter() - t0
    # the final state, unless the loop has just saved this step
    if args.ckpt_dir and latest_step(args.ckpt_dir) != args.steps:
        save_state(args.ckpt_dir, args.steps, state, rng, {"arch": cfg.name})
    if losses:
        first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
        last = np.mean(losses[-5:])
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    if report is not None:
        report.update(cfg=cfg, state=state, rt=rt, start=start,
                      step_s=seconds / max(1, len(losses)))
    return losses


if __name__ == "__main__":
    main()
