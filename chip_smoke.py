"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and ignored):

1. the card's name and power limit; TF32 off for matmuls and convolutions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
   one nvcc per source, all started together;
3. hold each masked-matmul kernel against its plain PyTorch version at the
   AlexNet path's shapes (fc0/fc1 forward, dx and dw at batch 32, P in
   {0.25, 0.5, 1.0}, f32 and bf16) and at ragged shapes; ``masked_dense``
   forward and backward against plain autograd;
4. the AlexNet path: full-width AlexNet, a 2 + 2 Table-I non-IID fleet,
   ``FLRun(..., kernels="cuda").run_sync(2)`` for helios and then syn, with
   the kernels' launch counters zeroed before and read after; the helios
   run is held against a ``kernels="reference"`` run on the card;
5. time each masked kernel, its plain version and ``torch.matmul`` at the
   fc0 shapes with CUDA events, beside the least time the card could take,
   and time whole rounds of the kernel path against the plain path;
3b. hold the flash-attention kernel against its plain version at the LM
   slice's shape (4, 32, 512, 128) causal, at (2, 8, 300, 64) causal and
   ragged and at (2, 4, 256, 16) full, f32 and bf16, and the autograd op
   (kernel forward, recompute backward) against plain autograd;
4b. the LM path: the dense LM at DeepSeek-7B width with its depth cut from
   30 to 2 layers, ``FLRun(..., kernels="cuda").run_sync(2)`` for helios
   and then syn on the same fleet over Markov-topic token streams, with
   the three kernels' counters zeroed before and read after; one training
   step and two rounds of one local step held against the plain path;
5b. time the flash kernel, its plain version and PyTorch's
   ``scaled_dot_product_attention`` at the slice shape, a masked matmul at
   the LM's MLP shape, and one helios LM round under the profiler;
3c. hold the ``ssd_diag`` kernel against its plain version at the hybrid
   slice's shape (B, nc, L, ds, nh, hd) = (4, 2, 256, 64, 64, 64), at the
   ragged (2, 1, 300, 16, 8, 16) and at the reference test's
   (1, 2, 64, 16, 2, 32), f32 and bf16, and at the slice shape with the
   model's own decay (dt ≈ 0.7, A = -1), where the reference's decay
   overflows; the autograd op (kernel forward, recompute backward) against
   plain autograd;
4c. the hybrid path: Zamba2-1.2B at full width with its depth cut from 38
   to 18 Mamba2 layers (three invocations of the shared block),
   ``FLRun(..., kernels="cuda").run_sync(2)`` for helios and then syn on
   the LM's fleet and data, with every kernel's counter zeroed before and
   read after (144 ``ssd_diag`` launches a round, no other kernel); every
   loss and parameter finite; one training step and two rounds of one
   local step held against the plain path;
5c. time the ``ssd_diag`` kernel and its plain version at the slice shape
   beside its bound, and one helios hybrid round, kernel path against
   plain path, then under the profiler.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit, and before that the
``{"kernels": [...]}`` line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s without
#: tensor cores (the kernels run IEEE f32 FMA; no TF32)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
BLOCK = 128
F32_TOL, BF16_TOL = 1e-4, 2e-2
#: fc0 / fc1 of full-width AlexNet at the main path's batch of 32
LAYERS = {"fc0": (4096, 1024), "fc1": (1024, 512)}
BATCH = 32
#: the LM slice: DeepSeek-7B width, depth cut to 2 layers, batch 4 x 512
LM_LAYERS, LM_BATCH, LM_SEQ, LM_VOCAB = 2, 4, 512, 1024
#: the flash kernel's checks: (B, H, S, hd, causal); the first is the slice
FLASH_CASES = ((LM_BATCH, 32, LM_SEQ, 128, True), (2, 8, 300, 64, True),
               (2, 4, 256, 16, False))
#: the hybrid slice: Zamba2-1.2B width, depth cut to 18 Mamba2 layers
HY_LAYERS = 18
#: the ssd_diag kernel's checks: (B, nc, L, ds, nh, hd); the first is the
#: slice (batch 4 x 512 tokens in chunks of 256)
SSD_CASES = ((LM_BATCH, 2, 256, 64, 64, 64), (2, 1, 300, 16, 8, 16),
             (1, 2, 64, 16, 2, 32))


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _alive(nb: int, p: float, g: torch.Generator) -> torch.Tensor:
    """Block flags with round(p·nb) live blocks (at least one)."""
    k = max(1, int(round(p * nb)))
    flags = torch.zeros(nb, device="cuda")
    flags[torch.randperm(nb, generator=g, device="cuda")[:k]] = 1
    return flags


def _case(kind: str, m: int, k: int, n: int, p: float, dtype, g):
    """Operands of one kernel call in the layout the main path hands over:
    'fwd' x @ W, 'dx' dy @ Wᵀ (a transposed view), 'dw' xᵀ (a transposed
    view) @ dy.  Returns (fn, plain, x, w, live, dead columns or None)."""
    from repro_torch.kernels import masked_matmul as K
    from repro_torch.kernels import ref
    if kind == "fwd":
        x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
        w = (torch.randn(k, n, device="cuda", generator=g) / k ** 0.5).to(dtype)
        live_len = n
    elif kind == "dx":                          # (M, N) @ (K, N)ᵀ
        x = torch.randn(m, n, device="cuda", generator=g).to(dtype)
        w = (torch.randn(k, n, device="cuda", generator=g) / n ** 0.5).to(dtype).t()
        live_len = n
    else:                                       # dw: (M, K)ᵀ @ (M, N)
        x = torch.randn(m, k, device="cuda", generator=g).to(dtype).t()
        w = (torch.randn(m, n, device="cuda", generator=g) / m ** 0.5).to(dtype)
        live_len = n
    alive = _alive(-(-live_len // BLOCK), p, g)
    live = K.live_blocks(alive)
    if kind == "dx":
        col = alive.repeat_interleave(BLOCK)[:live_len]
        x = x * col.to(dtype)[None, :]          # dy·mask: dead K entries are 0
        return K.masked_matmul_dk, ref.masked_matmul_dk_ref, x, w, live, None
    dead = alive.repeat_interleave(BLOCK)[:live_len] == 0
    return K.masked_matmul, ref.masked_matmul_ref, x, w, live, dead


def check_kernels() -> dict:
    """Every kernel against its plain version; returns the worst f32 error
    per kernel at the main-path shapes."""
    from repro_torch.kernels import masked_matmul as K
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {"masked_matmul": 0.0, "masked_matmul_dk": 0.0}
    cases = [(kind, BATCH, k, n, p, dt, True)
             for (k, n) in LAYERS.values() for kind in ("fwd", "dx", "dw")
             for p in (0.25, 0.5, 1.0) for dt in (torch.float32, torch.bfloat16)]
    cases += [(kind, m, k, n, p, torch.float32, False)
              for kind in ("fwd", "dx", "dw")
              for (m, k, n, p) in ((5, 37, 300, 0.6), (33, 200, 130, 0.5),
                                   (1, 4096, 1000, 0.3))]
    for kind, m, k, n, p, dt, main in cases:
        fn, plain, x, w, live, dead = _case(kind, m, k, n, p, dt, g)
        y = fn(x, w, live, BLOCK)
        want = plain(x.float(), w.float(), live, BLOCK)
        torch.cuda.synchronize()
        err = float((y.float() - want).abs().max())
        scale = float(want.abs().max())
        tol = (F32_TOL if dt == torch.float32 else BF16_TOL) * scale
        name = "masked_matmul_dk" if kind == "dx" else "masked_matmul"
        zero_ok = dead is None or bool((y[:, dead] == 0).all())
        log(f"check {name:17s} {kind} m={m} k={k} n={n} P={p} "
            f"{str(dt)[6:]:8s} max|err|={err:.3e} tol={tol:.3e} "
            f"dead-zero={zero_ok}")
        if not (err <= tol and zero_ok and math.isfinite(err)):
            raise AssertionError(f"{name} {kind} disagrees with its plain "
                                 f"version: err {err} > tol {tol} or dead "
                                 f"columns not zero ({zero_ok})")
        if main and dt == torch.float32:
            worst[name] = max(worst[name], err)
    # masked_dense forward + backward against plain autograd, fc0 shapes
    for p in (0.25, 0.5, 1.0):
        k, n = LAYERS["fc0"]
        x = torch.randn(BATCH, k, device="cuda", generator=g)
        w = torch.randn(k, n, device="cuda", generator=g) / k ** 0.5
        um = _alive(n // BLOCK, p, g).repeat_interleave(BLOCK)
        gy = torch.randn(BATCH, n, device="cuda", generator=g)
        outs = {}
        for impl in ("cuda", "reference"):
            xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            y = ops.masked_dense(xr, wr, um, impl=impl, block_n=BLOCK)
            dx, dw = torch.autograd.grad(y, (xr, wr), gy)
            outs[impl] = (y, dx, dw)
        for a, b, what in zip(outs["cuda"], outs["reference"], ("y", "dx", "dw")):
            err = float((a.detach() - b.detach()).abs().max())
            tol = F32_TOL * float(b.detach().abs().max())
            log(f"check masked_dense {what:2s} P={p} max|err|={err:.3e} "
                f"tol={tol:.3e}")
            if not err <= tol:
                raise AssertionError(f"masked_dense {what} disagrees: {err}")
        if not bool((outs["cuda"][2][:, um == 0] == 0).all()):
            raise AssertionError("masked_dense: dead dw columns not zero")
    K.reset_launches()
    return worst


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def setting():
    from repro_torch.configs import ALEXNET, HeliosConfig
    from repro_torch.data.federated import partition_noniid
    from repro_torch.data.synthetic import class_gaussian_images
    cfg = ALEXNET
    imgs, labels = class_gaussian_images(2000, cfg.image_size,
                                         cfg.in_channels, cfg.num_classes)
    ti, tl = class_gaussian_images(512, cfg.image_size, cfg.in_channels,
                                   cfg.num_classes, seed=99)
    parts = partition_noniid(labels, 4, shards_per_client=4)
    return cfg, HeliosConfig(mask_block=BLOCK), \
        {"images": imgs, "labels": labels}, {"images": ti, "labels": tl}, parts


def make_run(scheme: str, kernels: str, st, lr: float = 0.05,
             local_steps: int = 5, nudge: float = 0.0):
    """A run on the card; ``nudge`` scales the seed-0 initial weights by
    (1 + nudge) to measure how far rounding noise grows."""
    from repro_torch.federated import FLRun, make_fleet, setup_clients
    from repro_torch.models import init_params
    cfg, hcfg, train, test, parts = st
    clients = setup_clients(make_fleet(2, 2), parts, hcfg, device="cuda")
    init = {k: v * (1 + nudge) for k, v in
            init_params(cfg, 0, "cuda").items()} if nudge else None
    return FLRun(cfg, hcfg, scheme, clients, train, test,
                 local_steps=local_steps, lr=lr, kernels=kernels,
                 device="cuda", init_params=init)


def _param_diff(a, b) -> float:
    return max(float((a.global_params[k] - v).abs().max())
               for k, v in b.global_params.items())


def timed_run(run, rounds: int, eval_every: int = 1):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = run.run_sync(rounds, eval_every=eval_every)
    torch.cuda.synchronize()
    return hist, time.perf_counter() - t0


def check_step(st, run) -> None:
    """One training step of full-width AlexNet, kernel path against plain
    path from the same params and batch: loss and every gradient, with a
    straggler's Eq. 2 masks and with a capable client's full masks."""
    from repro_torch.core import soft_train as ST
    from repro_torch.models import cnn
    cfg, _, train, _, _ = st
    batch = {k: torch.as_tensor(v[:BATCH]).cuda() for k, v in train.items()}
    strag = next(c for c in run.clients if c.is_straggler)
    for who, masks in (("straggler", strag.helios_state["masks"]),
                       ("capable", ST.full_masks(run.adapter.schema, "cuda"))):
        out = {}
        for kernels in ("cuda", "reference"):
            params = {k: v.detach().clone().requires_grad_(True)
                      for k, v in run.global_params.items()}
            loss = cnn.cnn_loss(params, batch, cfg, {"kernels": kernels,
                                                     "mask_block": BLOCK},
                                masks)
            out[kernels] = (loss.detach(), dict(zip(params, torch.autograd.grad(
                loss, list(params.values())))))
        (la, ga), (lb, gb) = out["cuda"], out["reference"]
        worst = max(float((ga[k] - gb[k]).abs().max())
                    / max(float(gb[k].abs().max()), 1e-30) for k in gb)
        log(f"step {who}: loss {float(la):.6f} vs {float(lb):.6f}, worst "
            f"max|grad diff|/max|grad| {worst:.3e}")
        if not (abs(float(la - lb)) <= 1e-5 and worst <= F32_TOL):
            raise AssertionError(f"{who} step: kernel path disagrees with "
                                 f"the plain path ({worst})")


def main_path(st) -> dict:
    from repro_torch.kernels import masked_matmul as K
    K.reset_launches()
    runs = {}
    for scheme in ("helios", "syn"):
        run = make_run(scheme, "cuda", st)
        hist, wall = timed_run(run, 2)
        runs[scheme] = run
        log(f"main path {scheme}: 2 rounds in {wall:.3f} s (first run "
            f"of the process, cuDNN and kernel set-up included)")
        for row in hist:
            log("  history", json.dumps(row))
    launches = dict(K.LAUNCHES)
    log("main path launches", json.dumps(launches))
    for scheme, run in runs.items():
        for k, v in run.global_params.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{scheme}: non-finite {k}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{launches}")
    hel = runs["helios"]
    strag = [r for c, r in zip(hel.clients, hel.history[-1]["ratios"])
             if c.is_straggler]
    if not strag or max(strag) >= 1.0:
        raise AssertionError(f"helios straggler ratios not below 1: {strag}")
    check_step(st, hel)
    # Rounding noise grows fast along this trajectory: at lr 0.05 over ten
    # local steps two correct paths that only sum in another order end
    # ~1e-2 apart.  Print that drift beside the plain path's own drift
    # under a 2^-23 nudge of its initial weights, then hold the two paths
    # to 1e-4 over two rounds of one local step each.
    for steps in (5, 1):
        runs = {name: make_run("helios", kernels, st, local_steps=steps,
                               nudge=nudge)
                for name, kernels, nudge in (("cuda", "cuda", 0.0),
                                             ("plain", "reference", 0.0),
                                             ("nudged", "reference", 2.0 ** -23))}
        for run in runs.values():
            timed_run(run, 2)
        diff = _param_diff(runs["cuda"], runs["plain"])
        log(f"helios 2 rounds x {steps} local steps, lr 0.05: max|param "
            f"diff| kernel vs plain {diff:.3e}, plain vs nudged plain "
            f"{_param_diff(runs['plain'], runs['nudged']):.3e}")
    if not diff <= 1e-4:
        raise AssertionError(f"kernel path drifts from the plain path: {diff}")
    for x, y in zip(runs["cuda"].history, runs["plain"].history):
        for key in ("cycle", "time", "volumes", "ratios"):
            if x[key] != y[key]:
                raise AssertionError(f"history {key} differs: {x[key]} vs "
                                     f"{y[key]}")
        if abs(x["acc"] - y["acc"]) > 1.0 / 512 or \
                abs(x["loss"] - y["loss"]) > 1e-4:
            raise AssertionError(f"history acc/loss differ: {x} vs {y}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def _time_ms(fn, sets, reps: int = 3) -> float:
    """Mean ms per call over rotating operand sets (together larger than
    the 50 MB L2, so every call reads its weights from device memory)."""
    for s in sets[:4]:
        fn(*s)
    torch.cuda.synchronize()
    n = reps * len(sets)
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for s in sets:
            fn(*s)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_kernels(worst: dict, launches: dict, lm_launches: dict) -> list:
    """The masked kernels at the AlexNet fc0 shapes; ``launches`` counts
    both paths' runs (each path's count is in ``launches_by_path``)."""
    from repro_torch.kernels import masked_matmul as K
    from repro_torch.kernels import ref
    k, n = LAYERS["fc0"]
    m, p = BATCH, 0.5
    g = torch.Generator(device="cuda").manual_seed(1)
    out = []
    for name, kind in (("masked_matmul", "fwd"), ("masked_matmul_dk", "dx")):
        sets, dense = [], []
        for _ in range(8):                       # 8 x 16.8 MB of weights
            fn, plain, x, w, live, _ = _case(kind, m, k, n, p,
                                             torch.float32, g)
            sets.append((x, w, live, BLOCK))
            dense.append((x, w))
        n_live = int(live.numel())
        ms = _time_ms(fn, sets)
        plain_ms = _time_ms(plain, sets)
        lib_ms = _time_ms(torch.matmul, dense)
        if kind == "fwd":     # x read whole, live W columns, y written whole
            live_cols = min(n_live * BLOCK, n)
            nbytes = 4 * (m * k + k * live_cols + m * n)
            flops = 2 * m * k * live_cols
        else:                 # live dy columns, live Wᵀ rows, dx written whole
            live_k = min(n_live * BLOCK, n)
            nbytes = 4 * (m * live_k + live_k * k + m * k)
            flops = 2 * m * live_k * k
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/masked_matmul.cu",
               "replaces": "src/repro/kernels/masked_matmul.py:"
                           + ("87" if kind == "fwd" else "103"),
               "launches": launches[name] + lm_launches[name],
               "launches_by_path": {"alexnet": launches[name],
                                    "lm": lm_launches[name]},
               "max_abs_err": worst[name],
               "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_ms}
        log(f"time {name} fc0 {kind} M={m} K={k} N={n} P={p}: {ms:.4f} ms "
            f"(plain {plain_ms:.4f}, torch.matmul P=1 {lib_ms:.4f}, bound "
            f"{row['bound_ms']:.4f} by {row['bound_by']})")
        out.append(row)
    return out


def time_rounds(st) -> None:
    """Whole rounds (no evaluation), kernel path vs plain path, in turns."""
    walls = {"cuda": [], "reference": []}
    for kernels in ("cuda", "reference", "reference", "cuda"):
        run = make_run("helios", kernels, st)
        timed_run(run, 1, eval_every=0)                  # warm-up round
        _, wall = timed_run(run, 2, eval_every=0)
        walls[kernels].append(wall / 2)
    log("round wall s helios (2 rounds after a warm-up round): "
        + json.dumps(walls))
    run = make_run("helios", "cuda", st)
    timed_run(run, 1, eval_every=0)
    profile_round(run, "helios round")


def profile_round(run, label: str) -> None:
    """One round (no evaluation) under the profiler: wall, device busy
    time, idle share and the device time of the heaviest ops."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed_run(run, 1, eval_every=0)
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(_device_us(e) for e in rows) / 1e3
    if busy_ms <= 0:
        raise AssertionError(f"profile {label}: no device time traced")
    log(f"profile one {label}: wall {wall * 1e3:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / (wall * 1e3):.4f}")
    for e in sorted(rows, key=_device_us, reverse=True)[:12]:
        log(f"  device {_device_us(e) / 1e3:9.3f} ms  calls {e.count:5d}  "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 3b: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------


def _qkv(b: int, h: int, s: int, hd: int, dtype, g):
    """q, k, v as the LM hands them over: (B, S, H, hd) buffers seen as
    (B, H, S, hd) views."""
    return [torch.randn(b, s, h, hd, device="cuda", generator=g)
            .to(dtype).transpose(1, 2) for _ in range(3)]


def check_flash() -> float:
    """The flash kernel and the autograd op against their plain versions;
    returns the worst f32 error at the slice shape."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for i, (b, h, s, hd, causal) in enumerate(FLASH_CASES):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(b, h, s, hd, dt, g)
            y = FA.flash_attention(q, k, v, causal)
            want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           causal)
            torch.cuda.synchronize()
            err = float((y.float() - want).abs().max())
            tol = (F32_TOL if dt == torch.float32 else BF16_TOL) * \
                float(want.abs().max())
            log(f"check flash_attention B={b} H={h} S={s} hd={hd} "
                f"causal={causal} {str(dt)[6:]:8s} max|err|={err:.3e} "
                f"tol={tol:.3e}")
            if not (err <= tol and math.isfinite(err)):
                raise AssertionError(f"flash_attention disagrees with its "
                                     f"plain version: {err} > {tol}")
            if i == 0 and dt == torch.float32:
                worst = err
    # the autograd op at the slice shape: kernel forward + recompute
    # backward against plain autograd through the dense attention
    b, h, s, hd, causal = FLASH_CASES[0]
    q, k, v = _qkv(b, h, s, hd, torch.float32, g)
    gy = torch.randn(b, h, s, hd, device="cuda", generator=g)
    outs = {}
    for impl in ("cuda", "reference"):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        y = ops.flash_attention(*leaves, causal=True, impl=impl)
        outs[impl] = (y, *torch.autograd.grad(y, leaves, gy))
    for a, w, what in zip(outs["cuda"], outs["reference"],
                          ("y", "dq", "dk", "dv")):
        err = float((a.detach() - w.detach()).abs().max())
        tol = F32_TOL * float(w.detach().abs().max())
        log(f"check flash op {what:2s} slice shape max|err|={err:.3e} "
            f"tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"flash op {what} disagrees: {err}")
    FA.reset_launches()
    return worst


# ---------------------------------------------------------------------------
# phase 4b: the LM path
# ---------------------------------------------------------------------------


def lm_setting():
    from repro_torch.configs import DEEPSEEK_7B, HeliosConfig
    from repro_torch.data.federated import partition_by_topic
    from repro_torch.data.synthetic import markov_topic_tokens
    from repro_torch.models import init_params
    from repro_torch.models.module import tree_leaves
    cfg = dataclasses.replace(DEEPSEEK_7B, num_layers=LM_LAYERS)
    tokens, topics = markov_topic_tokens(256, LM_SEQ, LM_VOCAB, n_topics=8)
    test_tokens, _ = markov_topic_tokens(16, LM_SEQ, LM_VOCAB, n_topics=8,
                                         seed=9)
    parts = partition_by_topic(topics, 4, topics_per_client=2)
    log(f"LM config: {cfg.name} width (d_model {cfg.d_model}, {cfg.num_heads}"
        f" heads x {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), depth cut from {DEEPSEEK_7B.num_layers} to "
        f"{cfg.num_layers} layers; batch {LM_BATCH} x {LM_SEQ} tokens")
    t0 = time.perf_counter()
    init = init_params(cfg, 0, "cpu")        # host copy, reused by every run
    log(f"LM params {sum(v.numel() for v in tree_leaves(init)) / 1e9:.3f} B, "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, HeliosConfig(mask_block=BLOCK), {"tokens": tokens}, \
        {"tokens": test_tokens}, parts, init


def make_lm_run(scheme: str, kernels: str, st, local_steps: int = 2,
                nudge: float = 0.0):
    from repro_torch.federated import FLRun, make_fleet, setup_clients
    from repro_torch.models.module import tree_map
    cfg, hcfg, train, test, parts, init = st
    clients = setup_clients(make_fleet(2, 2), parts, hcfg, device="cuda")
    if nudge:
        init = tree_map(lambda v: v * (1 + nudge), init)
    return FLRun(cfg, hcfg, scheme, clients, train, test,
                 batch_size=LM_BATCH, local_steps=local_steps, lr=0.05,
                 eval_batch=4, kernels=kernels, device="cuda",
                 init_params=init)


def _host_params(run) -> dict:
    from repro_torch.models.module import tree_paths
    return {k: v.detach().cpu() for k, v in tree_paths(run.global_params)}


def _host_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in b)


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def check_lm_step(st, params, strag_masks) -> None:
    """One full-width LM training step, kernel path against plain path
    from the same params and batch: loss and every gradient, with a
    straggler's Eq. 2 masks and with full masks."""
    from repro_torch.models import make_full_masks, transformer
    from repro_torch.models.module import tree_paths
    cfg, _, train, _, _, _ = st
    batch = {"tokens": torch.as_tensor(train["tokens"][:LM_BATCH]).cuda()}
    for who, masks in (("straggler", strag_masks),
                       ("capable", make_full_masks(cfg, "cuda"))):
        out = {}
        for kernels in ("cuda", "reference"):
            leaves = dict(tree_paths(params))
            for v in leaves.values():
                v.requires_grad_(True)
            rt = transformer.default_runtime()
            rt["kernels"], rt["mask_block"] = kernels, BLOCK
            loss = transformer.lm_loss(params, batch, cfg, rt, masks)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            for v in leaves.values():
                v.requires_grad_(False)
            out[kernels] = (float(loss.detach()), dict(zip(leaves, grads)))
        (la, ga), (lb, gb) = out["cuda"], out["reference"]
        worst, at = max((float((ga[k] - gb[k]).abs().max())
                         / max(float(gb[k].abs().max()), 1e-30), k)
                        for k in gb)
        log(f"LM step {who}: loss {la:.7f} vs {lb:.7f}, worst max|grad "
            f"diff|/max|grad| {worst:.3e} ({at})")
        if not (abs(la - lb) <= F32_TOL * abs(lb) and worst <= F32_TOL):
            raise AssertionError(f"LM {who} step: kernel path disagrees with "
                                 f"the plain path ({worst} at {at})")
        del out, ga, gb
        _free()


def lm_path(st) -> dict:
    """Helios then syn, two rounds each, on the kernel path; the three
    kernels' counters are zeroed before and read after."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import masked_matmul as K
    from repro_torch.models.module import tree_paths
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    FA.reset_launches()
    hel = None
    for scheme in ("helios", "syn"):
        run = make_lm_run(scheme, "cuda", st)
        hist, wall = timed_run(run, 2)
        log(f"LM path {scheme}: 2 rounds in {wall:.3f} s")
        for row in hist:
            log("  history", json.dumps(row))
        for k, v in tree_paths(run.global_params):
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"LM {scheme}: non-finite {k}")
        if scheme == "helios":
            hel = run
        del run
    launches = {**K.LAUNCHES, **FA.LAUNCHES}
    log("LM path launches", json.dumps(launches))
    log(f"LM path peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the LM path: "
                             f"{launches}")
    strag = [r for c, r in zip(hel.clients, hel.history[-1]["ratios"])
             if c.is_straggler]
    if not strag or max(strag) >= 1.0:
        raise AssertionError(f"LM helios straggler ratios not below 1: "
                             f"{strag}")
    strag_masks = next(c for c in hel.clients
                       if c.is_straggler).helios_state["masks"]
    params = hel.global_params
    del hel
    _free()
    check_lm_step(st, params, strag_masks)
    del params
    _free()
    # Two correct paths that sum in another order drift apart along the
    # trajectory: print the drift over two rounds of 2 local steps beside
    # the plain path's own drift under a 2^-23 nudge of its initial
    # weights, and hold the paths to 1e-4 over two rounds of one step.
    for steps in (2, 1):
        host, hists = {}, {}
        for name, kernels, nudge in (("cuda", "cuda", 0.0),
                                     ("plain", "reference", 0.0),
                                     ("nudged", "reference", 2.0 ** -23)):
            run = make_lm_run("helios", kernels, st, local_steps=steps,
                              nudge=nudge)
            hists[name], _ = timed_run(run, 2)
            host[name] = _host_params(run)
            del run
            _free()
        diff = _host_diff(host["cuda"], host["plain"])
        log(f"LM helios 2 rounds x {steps} local steps, lr 0.05: max|param "
            f"diff| kernel vs plain {diff:.3e}, plain vs nudged plain "
            f"{_host_diff(host['plain'], host['nudged']):.3e}")
        del host
    if not diff <= 1e-4:
        raise AssertionError(f"LM kernel path drifts from the plain path: "
                             f"{diff}")
    for x, y in zip(hists["cuda"], hists["plain"]):
        for key in ("cycle", "time", "volumes", "ratios"):
            if x[key] != y[key]:
                raise AssertionError(f"LM history {key} differs: {x[key]} "
                                     f"vs {y[key]}")
        if abs(x["ce"] - y["ce"]) > 1e-4 or abs(x["loss"] - y["loss"]) > 1e-4:
            raise AssertionError(f"LM history ce/loss differ: {x} vs {y}")
    return launches


# ---------------------------------------------------------------------------
# phase 5b: LM timing
# ---------------------------------------------------------------------------


def time_flash(worst: float, launches: int) -> dict:
    """The flash kernel, its plain version and PyTorch's SDPA (a yardstick
    the port never calls) at the slice shape, f32."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    import torch.nn.functional as F
    b, h, s, hd, causal = FLASH_CASES[0]
    g = torch.Generator(device="cuda").manual_seed(3)
    sets = [tuple(_qkv(b, h, s, hd, torch.float32, g)) for _ in range(3)]
    ms = _time_ms(lambda q, k, v: FA.flash_attention(q, k, v, causal), sets)
    plain_ms = _time_ms(lambda q, k, v: ref.flash_attention_ref(q, k, v,
                                                                causal), sets)
    lib_ms = _time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal), sets)
    pairs = s * (s + 1) // 2 if causal else s * s   # (query, key) pairs
    flops = 4 * hd * pairs * b * h                  # q·kᵀ and p·v
    nbytes = 4 * 4 * b * h * s * hd                 # q, k, v read; o written
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:70",
           "launches": launches, "max_abs_err": worst, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms}
    log(f"time flash_attention B={b} H={h} S={s} hd={hd} causal f32: "
        f"{ms:.4f} ms (plain {plain_ms:.4f}, sdpa {lib_ms:.4f}, bound "
        f"{row['bound_ms']:.4f} by {row['bound_by']}; "
        f"{flops / ms / 1e9:.1f} TFLOP/s)")
    return row


def time_lm_mlp() -> None:
    """The masked-matmul pair at the LM's MLP shapes (tokens 2048, d 4096,
    d_ff 11008, P = 0.5), beside the plain version and torch.matmul."""
    m, k, n, p = LM_BATCH * LM_SEQ, 4096, 11008, 0.5
    g = torch.Generator(device="cuda").manual_seed(4)
    for name, kind in (("masked_matmul", "fwd"), ("masked_matmul_dk", "dx")):
        fn, plain, x, w, live, _ = _case(kind, m, k, n, p, torch.float32, g)
        sets = [(x, w, live, BLOCK)]
        ms = _time_ms(fn, sets)
        plain_ms = _time_ms(plain, sets)
        lib_ms = _time_ms(torch.matmul, [(x, w)])
        live_n = min(int(live.numel()) * BLOCK, n)
        flops = 2 * m * k * live_n
        log(f"time {name} LM mlp {kind} M={m} K={k} N={n} P={p}: {ms:.4f} "
            f"ms (plain {plain_ms:.4f}, torch.matmul P=1 {lib_ms:.4f}, bound "
            f"{flops / PEAK_F32 * 1e3:.4f} by operations; "
            f"{flops / ms / 1e9:.1f} TFLOP/s)")
        del x, w


def time_lm_round(st) -> None:
    """One helios LM round (no evaluation), kernel path against plain path
    in turns, then one kernel-path round under the profiler."""
    walls = {"cuda": [], "reference": []}
    for kernels in ("cuda", "reference", "reference", "cuda"):
        run = make_lm_run("helios", kernels, st)
        timed_run(run, 1, eval_every=0)                  # warm-up round
        _, wall = timed_run(run, 1, eval_every=0)
        walls[kernels].append(wall)
        if kernels == "cuda" and len(walls["cuda"]) == 2:
            profile_round(run, "helios LM round")
        del run
        _free()
    log("LM round wall s helios (1 round after a warm-up round): "
        + json.dumps(walls))


# ---------------------------------------------------------------------------
# phase 3c: the ssd_diag kernel against its plain version
# ---------------------------------------------------------------------------


def _ssd_inputs(b, nc, L, ds, nh, hd, dtype, g, model_decay=False):
    """cr, br, dtx ~ N(0, 1) in ``dtype``; a decreasing cumulative
    log-decay in f32: the reference test's (|N| · 0.1 a step) or the
    model's at initialisation (softplus(N) · A with A = -1)."""
    cr, br = (torch.randn(b, nc, L, ds, device="cuda", generator=g)
              .to(dtype) for _ in range(2))
    a = torch.randn(b, nc, L, nh, device="cuda", generator=g)
    a = -torch.nn.functional.softplus(a) if model_decay else -a.abs() * 0.1
    dtx = torch.randn(b, nc, L, nh, hd, device="cuda", generator=g).to(dtype)
    return cr, br, torch.cumsum(a, dim=2), dtx


def check_ssd() -> float:
    """The ssd_diag kernel and the autograd op against their plain
    versions; returns the worst f32 error at the slice shape."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as SS
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    cases = [(c, dt, False) for c in SSD_CASES
             for dt in (torch.float32, torch.bfloat16)]
    cases.append((SSD_CASES[0], torch.float32, True))
    for i, (shape, dt, model_decay) in enumerate(cases):
        cr, br, cum, dtx = _ssd_inputs(*shape, dt, g, model_decay)
        y = SS.ssd_diag(cr, br, cum, dtx)
        want = ref.ssd_diag_ref(cr.float(), br.float(), cum, dtx.float())
        torch.cuda.synchronize()
        err = float((y.float() - want).abs().max())
        tol = (F32_TOL if dt == torch.float32 else BF16_TOL) * \
            max(1.0, float(want.abs().max()))
        log(f"check ssd_diag (B, nc, L, ds, nh, hd)={shape} "
            f"{str(dt)[6:]:8s} {'model decay' if model_decay else ''} "
            f"max|err|={err:.3e} tol={tol:.3e}")
        if not (err <= tol and math.isfinite(err)
                and bool(torch.isfinite(y).all())):
            raise AssertionError(f"ssd_diag disagrees with its plain "
                                 f"version: {err} > {tol}")
        if i == 0:
            worst = err
    # the autograd op at the slice shape, with the model's decay
    cr, br, cum, dtx = _ssd_inputs(*SSD_CASES[0], torch.float32, g, True)
    gy = torch.randn(dtx.shape, device="cuda", generator=g)
    outs = {}
    for impl in ("cuda", "reference"):
        leaves = [t.detach().requires_grad_(True) for t in (cr, br, cum, dtx)]
        y = ops.ssd_diag(*leaves, impl=impl)
        outs[impl] = (y, *torch.autograd.grad(y, leaves, gy))
    for a, w, what in zip(outs["cuda"], outs["reference"],
                          ("y", "dcr", "dbr", "dcum", "ddtx")):
        err = float((a.detach() - w.detach()).abs().max())
        tol = F32_TOL * max(1.0, float(w.detach().abs().max()))
        log(f"check ssd_diag op {what:4s} slice shape max|err|={err:.3e} "
            f"tol={tol:.3e}")
        if not (err <= tol and bool(torch.isfinite(a).all())):
            raise AssertionError(f"ssd_diag op {what} disagrees: {err}")
    SS.reset_launches()
    return worst


# ---------------------------------------------------------------------------
# phase 4c: the hybrid path
# ---------------------------------------------------------------------------


def hybrid_setting():
    """Zamba2-1.2B at full width, 18 Mamba2 layers, on the LM's data."""
    from repro_torch.configs import ZAMBA2_1_2B, HeliosConfig
    from repro_torch.data.federated import partition_by_topic
    from repro_torch.data.synthetic import markov_topic_tokens
    from repro_torch.models import init_params
    from repro_torch.models.module import tree_leaves
    cfg = dataclasses.replace(ZAMBA2_1_2B, num_layers=HY_LAYERS)
    tokens, topics = markov_topic_tokens(256, LM_SEQ, LM_VOCAB, n_topics=8)
    test_tokens, _ = markov_topic_tokens(16, LM_SEQ, LM_VOCAB, n_topics=8,
                                         seed=9)
    parts = partition_by_topic(topics, 4, topics_per_client=2)
    log(f"hybrid config: {cfg.name} width (d_model {cfg.d_model}, "
        f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} SSM heads x "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}; "
        f"shared block {cfg.num_heads} heads, d_ff {cfg.d_ff}, every "
        f"{cfg.attn_every} layers; vocab {cfg.vocab_size}), depth cut from "
        f"{ZAMBA2_1_2B.num_layers} to {cfg.num_layers} Mamba2 layers; batch "
        f"{LM_BATCH} x {LM_SEQ} tokens")
    t0 = time.perf_counter()
    init = init_params(cfg, 0, "cpu")        # host copy, reused by every run
    log(f"hybrid params {sum(v.numel() for v in tree_leaves(init)) / 1e9:.4f}"
        f" B, drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, HeliosConfig(mask_block=BLOCK), {"tokens": tokens}, \
        {"tokens": test_tokens}, parts, init


def _reset_all():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import masked_matmul as K
    from repro_torch.kernels import ssd_scan as SS
    for mod in (K, FA, SS):
        mod.reset_launches()


def _all_launches() -> dict:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import masked_matmul as K
    from repro_torch.kernels import ssd_scan as SS
    return {**K.LAUNCHES, **FA.LAUNCHES, **SS.LAUNCHES}


def check_hybrid_step(st, params, strag_masks) -> None:
    """One full-width hybrid training step, kernel path against plain path
    from the same params and batch: loss and every gradient within 1e-4
    relative, with a straggler's Eq. 2 masks and with full masks."""
    from repro_torch.models import hybrid, make_full_masks, transformer
    from repro_torch.models.module import tree_paths
    cfg, _, train, _, _, _ = st
    batch = {"tokens": torch.as_tensor(train["tokens"][:LM_BATCH]).cuda()}
    for who, masks in (("straggler", strag_masks),
                       ("capable", make_full_masks(cfg, "cuda"))):
        out = {}
        for kernels in ("cuda", "reference"):
            leaves = dict(tree_paths(params))
            for v in leaves.values():
                v.requires_grad_(True)
            rt = transformer.default_runtime()
            rt["kernels"], rt["mask_block"] = kernels, BLOCK
            loss = hybrid.hybrid_loss(params, batch, cfg, rt, masks)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            for v in leaves.values():
                v.requires_grad_(False)
            out[kernels] = (float(loss.detach()), dict(zip(leaves, grads)))
            del grads, loss
        (la, ga), (lb, gb) = out["cuda"], out["reference"]
        finite = all(bool(torch.isfinite(v).all()) for v in ga.values())
        worst, at = max((float((ga[k] - gb[k]).abs().max())
                         / max(float(gb[k].abs().max()), 1e-30), k)
                        for k in gb)
        log(f"hybrid step {who}: loss {la:.7f} vs {lb:.7f}, worst max|grad "
            f"diff|/max|grad| {worst:.3e} ({at}), all finite {finite}")
        if not (finite and abs(la - lb) <= F32_TOL * abs(lb)
                and worst <= F32_TOL):
            raise AssertionError(f"hybrid {who} step: kernel path disagrees "
                                 f"with the plain path ({worst} at {at})")
        del out, ga, gb
        _free()


def hybrid_path(st) -> dict:
    """Helios then syn, two rounds each, on the kernel path; every
    kernel's counter is zeroed before and read after."""
    from repro_torch.models.module import tree_paths
    cfg = st[0]
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    hel = None
    for scheme in ("helios", "syn"):
        run = make_lm_run(scheme, "cuda", st)
        hist, wall = timed_run(run, 2)
        log(f"hybrid path {scheme}: 2 rounds in {wall:.3f} s")
        for row in hist:
            log("  history", json.dumps(row))
            if not (math.isfinite(row["loss"]) and math.isfinite(row["ce"])):
                raise AssertionError(f"hybrid {scheme}: non-finite loss or "
                                     f"ce in {row}")
        for k, v in tree_paths(run.global_params):
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"hybrid {scheme}: non-finite {k}")
        if scheme == "helios":
            hel = run
        del run
    launches = _all_launches()
    log("hybrid path launches", json.dumps(launches))
    log(f"hybrid path peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # each local step of each client runs every Mamba2 layer's kernel once
    per_round = cfg.num_layers * 2 * 4
    want = {"masked_matmul": 0, "masked_matmul_dk": 0, "flash_attention": 0,
            "ssd_diag": 4 * per_round}
    if launches != want:
        raise AssertionError(f"hybrid path launches {launches}, want {want} "
                             f"({per_round} ssd_diag a round; the shared "
                             f"block takes no kernel, as in the reference)")
    strag = [r for c, r in zip(hel.clients, hel.history[-1]["ratios"])
             if c.is_straggler]
    if not strag or max(strag) >= 1.0:
        raise AssertionError(f"hybrid helios straggler ratios not below 1: "
                             f"{strag}")
    strag_masks = next(c for c in hel.clients
                       if c.is_straggler).helios_state["masks"]
    params = hel.global_params
    del hel
    _free()
    check_hybrid_step(st, params, strag_masks)
    del params
    _free()
    # two rounds of one local step, kernel path against plain path, beside
    # the plain path's drift under a 2^-23 nudge of its initial weights
    host, hists = {}, {}
    for name, kernels, nudge in (("cuda", "cuda", 0.0),
                                 ("plain", "reference", 0.0),
                                 ("nudged", "reference", 2.0 ** -23)):
        run = make_lm_run("helios", kernels, st, local_steps=1, nudge=nudge)
        hists[name], _ = timed_run(run, 2)
        host[name] = _host_params(run)
        del run
        _free()
    diff = _host_diff(host["cuda"], host["plain"])
    log(f"hybrid helios 2 rounds x 1 local step, lr 0.05: max|param diff| "
        f"kernel vs plain {diff:.3e}, plain vs nudged plain "
        f"{_host_diff(host['plain'], host['nudged']):.3e}")
    del host
    if not diff <= 1e-4:
        raise AssertionError(f"hybrid kernel path drifts from the plain "
                             f"path: {diff}")
    for x, y in zip(hists["cuda"], hists["plain"]):
        for key in ("cycle", "time", "volumes", "ratios"):
            if x[key] != y[key]:
                raise AssertionError(f"hybrid history {key} differs: "
                                     f"{x[key]} vs {y[key]}")
        if abs(x["ce"] - y["ce"]) > 1e-4 or abs(x["loss"] - y["loss"]) > 1e-4:
            raise AssertionError(f"hybrid history ce/loss differ: {x} vs {y}")
    return launches


# ---------------------------------------------------------------------------
# phase 5c: hybrid timing
# ---------------------------------------------------------------------------


def time_ssd(worst: float, launches: int) -> dict:
    """The ssd_diag kernel and its plain version at the slice shape, f32.
    No single PyTorch call computes this function."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SS
    b, nc, L, ds, nh, hd = SSD_CASES[0]
    g = torch.Generator(device="cuda").manual_seed(6)
    sets = [_ssd_inputs(b, nc, L, ds, nh, hd, torch.float32, g, True)
            for _ in range(3)]               # 3 x 36 MB: more than the L2
    ms = _time_ms(SS.ssd_diag, sets)
    plain_ms = _time_ms(ref.ssd_diag_ref, sets)
    pairs = L * (L + 1) // 2                 # (l, m) pairs with m <= l
    # C·Bᵀ once per (batch, chunk): it has no head axis; the scaled
    # product once per head.  (The kernel recomputes C·Bᵀ for every head:
    # 2·pairs·(ds + hd)·b·nc·nh, the ops-bound 0.064 ms at this shape.)
    flops = 2 * pairs * b * nc * (ds + nh * hd)
    nbytes = 4 * (2 * b * nc * L * ds + b * nc * L * nh
                  + 2 * b * nc * L * nh * hd)   # cr, br, cum, dtx in; y out
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    kernel_flops = 2 * pairs * b * nc * nh * (ds + hd)
    row = {"name": "ssd_diag", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:39",
           "launches": launches, "max_abs_err": worst, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None}
    log(f"time ssd_diag (B, nc, L, ds, nh, hd)={SSD_CASES[0]} f32: {ms:.4f} "
        f"ms (plain {plain_ms:.4f}, bound {row['bound_ms']:.4f} by "
        f"{row['bound_by']}; bytes {t_bytes:.4f} ms, ops {t_ops:.4f} ms; "
        f"{kernel_flops / ms / 1e9:.1f} TFLOP/s as the kernel computes)")
    return row


def time_hybrid_round(st) -> None:
    """One helios hybrid round (no evaluation), kernel path against plain
    path in turns, then one kernel-path round under the profiler."""
    walls = {"cuda": [], "reference": []}
    for kernels in ("cuda", "reference", "reference", "cuda"):
        run = make_lm_run("helios", kernels, st)
        timed_run(run, 1, eval_every=0)                  # warm-up round
        _, wall = timed_run(run, 1, eval_every=0)
        walls[kernels].append(wall)
        if kernels == "cuda" and len(walls["cuda"]) == 2:
            profile_round(run, "helios hybrid round")
        del run
        _free()
    log("hybrid round wall s helios (1 round after a warm-up round): "
        + json.dumps(walls))


def _device_us(e) -> float:
    """Self device time of a profiler row (the attribute was renamed)."""
    t = getattr(e, "self_device_time_total", None)
    return float(t if t is not None else e.self_cuda_time_total)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    line = card_line()
    log("card:", line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    log("allow_tf32 matmul:", torch.backends.cuda.matmul.allow_tf32,
        "cudnn:", torch.backends.cudnn.allow_tf32)
    log("torch", torch.__version__, "cuda", torch.version.cuda)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build(["masked_matmul", "flash_attention", "ssd_scan"])
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for name, text in build.BUILD_LOG.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {name}: {ln.strip()}")

    worst = check_kernels()
    st = setting()
    launches = main_path(st)
    time_rounds(st)
    del st
    _free()

    flash_worst = check_flash()
    lm_st = lm_setting()
    lm_launches = lm_path(lm_st)
    kernels = time_kernels(worst, launches, lm_launches)
    kernels.append(time_flash(flash_worst, lm_launches["flash_attention"]))
    time_lm_mlp()
    time_lm_round(lm_st)
    del lm_st
    _free()

    ssd_worst = check_ssd()
    hy_st = hybrid_setting()
    hy_launches = hybrid_path(hy_st)
    kernels.append(time_ssd(ssd_worst, hy_launches["ssd_diag"]))
    time_hybrid_round(hy_st)

    log(json.dumps({"kernels": kernels}))
    log(line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
