"""Compare the masked-matmul kernels of two sources on one GPU.

    python3 scripts/ab_masked_single.py OTHER.cu

``OTHER.cu`` is another version of ``src/repro_torch/kernels/csrc/
masked_matmul.cu`` (for example the parent commit's, unpacked with ``git
archive``).  Both are built with the repo's nvcc flags.  The script prints
each single-client kernel's ptxas report (registers, stack frame, spills)
side by side, then runs AlexNet's six single-client calls at batch 32 and
P = 0.5 (fc0 / fc1 forward, dx and dw, as ``chip_smoke.py`` phase 5b
times them) through the repo's wrapper on each library in turn, and, when
both sources have the client axis, its fc0 forward and dx at C = 2, M = 32
and C = 32, M = 16 (as ``chip_smoke.py`` times them): the outputs must be
bit-identical, and the device time per call is taken in the order other,
this, this, other, twice.  The last line is a JSON object with every
time.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import masked_matmul as K  # noqa: E402

#: ptxas's report of one kernel: its entry line, then the stack and
#: register lines
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
#: template arguments of each kernel without the client axis's flag
_BASE_ARGS = {"void masked_mm_kernel": "TS", "void splitk_reduce": "TS",
              "void masked_mm_tile128": "ABS"}


def compile_so(src: Path, out: Path) -> str:
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{done.stdout}"
                           f"{done.stderr}")
    return done.stdout + done.stderr


def demangle(names):
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def ptxas_report(log: str) -> tuple:
    """Every kernel -> (registers, stack bytes, spill stores, spill loads),
    and the single-client kernels alone keyed by their template arguments
    without a client-axis flag (a source's CLIENTS = false ones)."""
    rows, name = [], None
    for ln in log.splitlines():
        m = _ENTRY.search(ln)
        if m:
            name, stack = m.group(1), None
            continue
        m = _STACK.search(ln)
        if m and name:
            stack = tuple(int(v) for v in m.groups())
            continue
        m = _REGS.search(ln)
        if m and name and stack is not None:
            rows.append((name, int(m.group(1)), *stack))
            name = None
    out, every = {}, {}
    for (_, *nums), full in zip(rows, demangle([r[0] for r in rows])):
        full = full.replace("(anonymous namespace)::", "")
        every[full] = tuple(nums)
        head = full.split("(")[0]
        base, _, args = head.partition("<")
        args = [a.strip() for a in args.rstrip(">").split(",")]
        if len(args) == len(_BASE_ARGS.get(base, args)) + 1:
            if args[-1] != "false":   # a CLIENTS flag as the last argument
                continue
            args = args[:-1]
        out[f"{base}<{', '.join(args)}>"] = tuple(nums)
    return out, every


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other_src = Path(sys.argv[1]).resolve()
    this_src = build.CSRC / f"{K.SOURCE}.cu"
    torch.backends.cuda.matmul.allow_tf32 = False
    line = CS.card_line()
    CS.log("card:", line)
    out_dir = build.build_dir() / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, reports = {}, {}
    for tag, src in (("other", other_src), ("this", this_src)):
        so = out_dir / f"lib{K.SOURCE}-{tag}.so"
        reports[tag], every = ptxas_report(compile_so(src, so))
        libs[tag] = ctypes.CDLL(str(so))
        for name, nums in sorted(every.items()):
            CS.log(f"ptxas {tag} {name}: (regs, stack, spill st, spill ld) "
                   f"{nums}")
    same_ptxas = True
    for key in sorted(set(reports["other"]) | set(reports["this"])):
        a, b = reports["other"].get(key), reports["this"].get(key)
        same_ptxas &= a == b
        CS.log(f"ptxas {key}: other (regs, stack, spill st, spill ld) {a}; "
               f"this {b}; {'same' if a == b else 'DIFFERENT'}")

    def use(tag: str) -> None:
        build._LIBS[K.SOURCE] = libs[tag]

    g = torch.Generator(device="cuda").manual_seed(1)
    times, identical = {}, True
    for layer, (k, n) in CS.LAYERS.items():
        for kind in ("fwd", "dx", "dw"):
            call = CS.LAYER_CALLS[kind](CS.BATCH, k, n)
            per_set = 4 * (CS.BATCH * k + k * n + CS.BATCH * n)
            sets, fn = [], None
            for _ in range(max(8, -(-100_000_000 // per_set))):
                fn, _, x, w, live, _ = CS._operands(*call, 0.5, torch.float32,
                                                    g)
                sets.append((x, w, live, CS.BLOCK))
            ys = {}
            for tag in ("other", "this"):
                use(tag)
                ys[tag] = fn(*sets[0])
            same = torch.equal(ys["other"], ys["this"])
            identical &= same
            label = f"{layer} {kind}"
            t = {"other": [], "this": []}
            for tag in ("other", "this", "this", "other") * 2:
                use(tag)
                t[tag].append(CS._device_ms(fn, sets))
            times[label] = t
            CS.log(f"time {call[0]} {label} M={call[1]} K={call[2]} "
                   f"N={call[3]}: other {['%.5f' % v for v in t['other']]} ms,"
                   f" this {['%.5f' % v for v in t['this']]} ms; outputs "
                   f"bit-identical {same}")
    if all(hasattr(lib, "helios_masked_matmul_clients")
           for lib in libs.values()):
        k, n = CS.LAYERS["fc0"]
        for kind in ("fwd", "dx"):
            for c, m in ((2, CS.BATCH), (32, 16)):
                per_set = 4 * c * (m * k + k * n + m * n)
                sets = []
                for _ in range(max(1, -(-100_000_000 // per_set))):
                    fn, _, x, w, live, counts, _, _ = CS._client_case(
                        kind, c, m, k, n, torch.float32, g, p=0.5)
                    sets.append((x, w, live, counts, CS.BLOCK))
                ys = {}
                for tag in ("other", "this"):
                    use(tag)
                    ys[tag] = fn(*sets[0])
                same = torch.equal(ys["other"], ys["this"])
                identical &= same
                label = f"clients fc0 {kind} C={c} M={m}"
                t = {"other": [], "this": []}
                for tag in ("other", "this", "this", "other") * 2:
                    use(tag)
                    t[tag].append(CS._device_ms(fn, sets))
                times[label] = t
                CS.log(f"time {fn.__name__} {label}: other "
                       f"{['%.5f' % v for v in t['other']]} ms, this "
                       f"{['%.5f' % v for v in t['this']]} ms; outputs "
                       f"bit-identical {same}")
                del sets
    use("this")
    CS.log(line)
    CS.log(json.dumps({"card": line, "ptxas_same": same_ptxas,
                       "outputs_identical": identical, "device_ms": times}))
    return 0 if identical else 1


if __name__ == "__main__":
    sys.exit(main())
