"""Serving time while a snapshot is written, by the number of deflate
threads of the checkpoint's zlib body, on one GPU.

    python3 scripts/publish_contention.py [--part a|b|ab] [--threads 1,4,8]

The model is ``chip_smoke.py`` phase 4k's serve-while-train cell: Zamba2
width with ``SWT_LAYERS`` Mamba2 layers, random weights from seed 0, a
``GenerationServer`` at batch 4, prompt 128, 8 generated tokens, on
``kernels="cuda"``.

Part a holds the serving thread against a save and nothing else: requests
run back to back on this thread while another thread writes the params
through ``checkpoint.save`` with the deflate on k threads, for each k of
``--threads`` and then in the reverse order, with ten seconds of serving
alone at the start and the end.  Part b runs phase 4k's
``serve_while_train`` whole (2 helios rounds on 2 + 2 clients, a publish
a round, Poisson traffic at ``SWT_RATE_HZ``) with the deflate on one
thread and on the count ``checkpoint.zlib_threads`` picks there (half
the cores: the serving thread is alive), in the order one, picked,
picked, one.  Each condition prints one JSON line: request count, service-time
percentiles (a request alone, on the host's clock, the device
synchronized), how many requests took over 200 ms, and the save or
publish times.  The card's line from ``nvidia-smi`` comes first, and the
last line is a JSON object with every condition.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402
from repro_torch.checkpoint import checkpoint as CK  # noqa: E402

#: a request over this many milliseconds counts as slow
SLOW_MS = 200.0
#: seconds of serving alone before and after part a's saves
IDLE_S = 10.0


def _summary(ms: list) -> dict:
    s = sorted(ms)
    n = len(s)

    def pct(q):
        return s[min((q * n) // 100, n - 1)]

    return {"requests": n, "service_p50_ms": pct(50),
            "service_p90_ms": pct(90), "service_p99_ms": pct(99),
            "service_max_ms": s[-1],
            "slow_requests": sum(1 for x in s if x > SLOW_MS)}


_PICK = CK.zlib_threads


def _threads(k) -> list:
    """Deflate on ``k`` threads from here on, or on the count
    ``zlib_threads`` picks when ``k`` is None (through zlib, whether or not
    ``zstandard`` imports: the deflate threads are what is measured).
    Returns the list each save appends its count to."""
    used = []

    def pick():
        used.append(_PICK() if k is None else k)
        return used[-1]

    CK._zstd = lambda: None
    CK.zlib_threads = pick
    return used


def part_a(threads: list) -> list:
    from repro_torch.configs import ZAMBA2_1_2B
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.launch.serve import GenerationServer, serve_batch
    from repro_torch.models import init_params
    cfg = dataclasses.replace(ZAMBA2_1_2B, num_layers=CS.SWT_LAYERS)
    params = init_params(cfg, 0, "cuda")
    srv = GenerationServer(cfg, 4, 128, gen=8, kernels="cuda",
                           device="cuda")
    req = serve_batch(markov_tokens(4, 128, cfg.padded_vocab, seed=7),
                      "cuda")

    def one() -> float:
        t = time.perf_counter()
        srv(params, req)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    for _ in range(3):                                   # warm-up
        one()
    out = []
    tmp = tempfile.mkdtemp(prefix="contention_")
    try:
        for step, k in enumerate([None, *threads, *threads[::-1], None]):
            ms = []
            if k is None:
                t_end = time.perf_counter() + IDLE_S
                while time.perf_counter() < t_end:
                    ms.append(one())
                row = {"part": "a", "threads": 0, "save_s": None}
            else:
                _threads(k)
                took = []

                def save():
                    t = time.perf_counter()
                    CK.save(tmp, step, params, keep=1)
                    took.append(time.perf_counter() - t)

                th = threading.Thread(target=save)
                th.start()
                while th.is_alive():
                    ms.append(one())
                th.join()
                row = {"part": "a", "threads": k, "save_s": took[0]}
            row.update(_summary(ms))
            print(json.dumps(row), flush=True)
            out.append(row)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params, srv
    CS._free()
    return out


def part_b() -> list:
    from repro_torch.configs import ZAMBA2_1_2B
    from repro_torch.drivers.serve_while_train import serve_while_train
    cfg = dataclasses.replace(ZAMBA2_1_2B, num_layers=CS.SWT_LAYERS)
    out = []
    for k in (1, None, None, 1):
        used = _threads(k)
        res = serve_while_train(cfg, clients=4, rounds=2, local_steps=1,
                                batch_size=4, seq_len=256,
                                rate_hz=CS.SWT_RATE_HZ, batch=4,
                                prompt_len=128, gen=8, tol=0.05,
                                min_requests=10, device="cuda",
                                kernels="cuda")
        svc = res["recorder"].hists["service_ms"]
        row = {"part": "b", "threads": sorted(set(used)),
               "requests_per_sec": res["requests_per_sec"],
               "latency_p50_ms": res["p50_ms"],
               "latency_p99_ms": res["p99_ms"],
               "publish_ms": res["publish_ms"],
               "restore_ms": res["restore_ms"], **_summary(svc)}
        print(json.dumps(row), flush=True)
        out.append(row)
        del res
        CS._free()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", default="ab", choices=("a", "b", "ab"))
    ap.add_argument("--threads", default="1,4,8",
                    help="part a's deflate thread counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("publish_contention: no GPU", file=sys.stderr)
        return 2
    print("card:", CS.card_line())
    print(f"deflate threads a save picks here: {CK.zlib_threads()} alone")
    from repro_torch.kernels import build
    build.build(["masked_matmul", "flash_attention", "ssd_scan"])
    rows = []
    if "a" in args.part:
        rows += part_a([int(k) for k in args.threads.split(",")])
    if "b" in args.part:
        rows += part_b()
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
