"""The paper's five figure tables on one GPU, each beside a nudged twin.

    python3 scripts/figure_spread.py

Runs ``chip_smoke.py`` phase 4m's tables (``repro_torch.drivers.
paper_figures`` at full width and the reference's rounds: Fig. 5 on
LeNet, AlexNet and ResNet-18, the speedup, Fig. 6, Fig. 7 and the P_s
ablation on LeNet) on the kernel path and, for every model, on a plain
twin whose initial weights are scaled by 1 + 2^-23 (AlexNet also on the
plain path), with TF32 off and deterministic cuDNN as in
``chip_smoke.py``: every run's final accuracy on each path and each
table's spread, the largest difference of a run's final accuracy from
the kernel path's.  Rounding noise of one ulp grows along these
trajectories, so the spread says how many of a row's digits are the
model's and how many are noise.  The phase itself keeps no twin, and runs
ResNet-18's Fig. 5 at half the rounds, to stay inside its time limit.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    CS.log("card:", CS.card_line())
    build.build(["masked_matmul"])
    t0 = time.perf_counter()
    CS.repro_figures(twins=("lenet", "alexnet", "resnet18"))
    CS.log(f"figure_spread.py: the tables took "
           f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
