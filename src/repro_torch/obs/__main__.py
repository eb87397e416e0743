# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""CLI: ``python -m repro_torch.obs report|diff``.

``report <run>`` renders one run log (a directory, an ``events.jsonl`` or a
``BENCH_observability.json``).  ``diff <old> <new>`` compares two and exits
nonzero on a regression outside the stated tolerances.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs import report as R


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("report", help="render one run log")
    rp.add_argument("run", help="run dir, events.jsonl, or BENCH json")

    dp = sub.add_parser("diff", help="regression-diff two run logs")
    dp.add_argument("old", help="baseline run log / BENCH json")
    dp.add_argument("new", help="candidate run log / BENCH json")
    dp.add_argument("--tol-scale", type=float, default=1.0,
                    help="multiply every tolerance (default 1.0)")

    args = p.parse_args(argv)
    if args.cmd == "report":
        return R.main_report(args.run)
    return R.main_diff(args.old, args.new, args.tol_scale)


if __name__ == "__main__":
    sys.exit(main())
