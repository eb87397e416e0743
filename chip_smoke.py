"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and ignored):

1. the card's name and power limit; TF32 off for matmuls and convolutions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version at the main-path
   shapes (AlexNet fc0/fc1 forward, dx and dw at batch 32, P in {0.25, 0.5,
   1.0}, f32 and bf16) and at ragged shapes; ``masked_dense`` forward and
   backward against plain autograd;
4. the main path: full-width AlexNet, a 2 + 2 Table-I non-IID fleet,
   ``FLRun(..., kernels="cuda").run_sync(2)`` for helios and then syn, with
   the kernels' launch counters zeroed before and read after; the helios
   run is held against a ``kernels="reference"`` run on the card;
5. time each kernel, its plain version and ``torch.matmul`` at the fc0
   shapes with CUDA events, beside the least time the card could take, and
   time whole rounds of the kernel path against the plain path.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit, and before that the
``{"kernels": [...]}`` line.
"""
from __future__ import annotations

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


def time_kernels(worst: dict, launches: dict) -> list:
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
               "launches": launches[name], "max_abs_err": worst[name],
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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed_run(run, 1, eval_every=0)
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(_device_us(e) for e in rows) / 1e3
    log(f"profile one helios round: wall {wall * 1e3:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / (wall * 1e3):.4f}")
    for e in sorted(rows, key=_device_us, reverse=True)[:12]:
        log(f"  device {_device_us(e) / 1e3:9.3f} ms  calls {e.count:5d}  "
            f"{e.key[:90]}")


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
    build.build(["masked_matmul"])
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for name, text in build.BUILD_LOG.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {name}: {ln.strip()}")

    worst = check_kernels()
    st = setting()
    launches = main_path(st)
    kernels = time_kernels(worst, launches)
    time_rounds(st)

    log(json.dumps({"kernels": kernels}))
    log(line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
