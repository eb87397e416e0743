"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and ignored):

1. the card's name and power limit; TF32 off for matmuls and convolutions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
   one nvcc per source, all started together;
3. hold each masked-matmul kernel against its plain PyTorch version at the
   AlexNet path's shapes (fc0/fc1 forward, dx and dw at batch 32, P in
   {0.25, 0.5, 1.0}, f32 and bf16; the batch-32 calls on split-K), at
   ragged shapes, at the LM's six MLP layouts at full size (P 0.5 and 1.0,
   on tile128) and at mask blocks 16 (general) and 256 (tile128); every
   call twice, bit-identical; ``masked_dense`` forward and backward
   against plain autograd;
4. the AlexNet path: full-width AlexNet, a 2 + 2 Table-I non-IID fleet,
   ``FLRun(..., kernels="cuda").run_sync(2)`` for helios and then syn, with
   the kernels' launch counters (per kernel and per configuration) zeroed
   before and read after; the helios run is held against a
   ``kernels="reference"`` run on the card;
5. time whole rounds of the kernel path against the plain path;
4d. the async baselines on the same model and fleet: ``run_async(8)`` for
   asyn and afo with the masked pair's counters zeroed before and read
   after (6 launches a local step of each processed event: 4 split-K, 2
   tile128); every param finite; at one local step a cycle, every event's
   update held to the plain path's from the same inputs at 1e-4 over
   ``run_async(8)`` and the trajectory over ``run_async(4)`` (cycle, time,
   staleness identical; acc within 1/512, loss and params within 1e-4),
   the eight-cycle and the five-step drift beside a 2^-23-nudged plain
   twin's; a jittered, lossy fleet (lognormal 0.1, dropout 0.2) processing
   and dropping the same events on both paths; ``snapshot_cap=2`` without
   an anchor miss; the wall per processed event on both paths, and one run
   under the profiler;
4e. sampled cohorts and elastic membership: helios ``run_sync(2)`` over
   3 of a 3 + 3 fleet for the uniform and the time-weighted sampler (6
   launches a local step of each cohort member), then the join / leave
   sequence of ``examples/elastic_scaling.py`` held against the plain path
   at one local step, trajectory and every cycle's update;
4f. full-width ResNet-18 (32 px, 100 classes) on a 3 + 3 fleet: helios and
   syn ``run_sync(2)`` on ``kernels="cuda"`` with no masked launch (conv
   filters are its only maskable units), finite params, straggler ratios
   below 1, the round wall, a profiled round and the peak memory;
3d. hold the client-axis masked kernels (one launch for a cohort) against
   their plain versions at fc0 / fc1 forward, dx and dw for cohorts of 1,
   2, 4, 8 and 32 (phase 4g's cohorts and the bucket sizes up to 4) at
   batch 16 and 32, f32 and bf16, each call with the clients'
   P mixed from {0.25, 0.5, 1.0} and one client without a live block,
   then with a weight and a mask shared by the cohort (client stride 0);
   every call twice, bit-identical; dead columns exactly zero;
4g. the batched engine: ``BatchedFLRun(..., kernels="cuda").run_sync(2)``
   for helios and syn on the AlexNet 2 + 2 fleet with the counters zeroed
   before and read after (6 client-axis launches a local step of each
   cohort, none on the single-client entry points); straggler ratios
   below 1, finite params; each cohort's vmapped step against per-client
   plain autograd at 1e-4; two rounds of one local step held at 1e-4
   against ``FLRun``'s plain path (ratios to one float32 ulp) and the
   five-step drift beside a 2^-23-nudged twin's; asyn / afo
   ``run_async(4)`` on the bucket engine against the sequential plain
   loop at 1e-4; the 2 + 2 round walls of both engines on both paths in
   turns and a profiled batched round; a population of 64 clients (half
   stragglers, IID, helios, 1 local step of batch 16): the round wall of
   ``FLRun`` against ``BatchedFLRun`` on both paths, the launches of a
   round, a profiled batched round and its peak memory;
4i. the gauntlet's last schemes and the comparison drivers on the same
   setting: ``run_sync(2)`` of scaffold, fluid and delayed on ``FLRun``
   (120 single-client masked launches a round each) and on
   ``BatchedFLRun`` (30 client-axis launches a round for scaffold and
   delayed, 60 for fluid, none single-client), counters zeroed before
   and read after each run; at one local step, two rounds of both
   engines held at 1e-4 against ``FLRun``'s plain path (history's cycle,
   time, volumes and ratios identical, ratios to one ulp on the batched
   engine), ``run_async(4)`` of scaffold and delayed (the sequential
   fallback) kernel against plain, SCAFFOLD's controls at 1e-4 / (K·lr),
   each beside a 2^-23-nudged plain twin's drift;
   ``repro_torch.drivers.scheme_gauntlet`` at full width (4 + 4 non-IID,
   12 rounds, evaluation every round) on the kernel path and the plain
   path: params finite, engines, sim times, bytes,
   cycles and clocks identical on both paths, scaffold's uplink twice
   helios's, Eq. 9 holding; each scheme's final accuracy and wall per
   history row printed; ``repro_torch.drivers.heterogeneous_fl``'s
   five-scheme table (2 + 2, 5 rounds, lr 0.05) on both engines, every
   loss finite; one SCAFFOLD round under the profiler (the masked pair at
   P = 1); then the client-axis kernels' device time, ``torch.bmm`` at
   P = 1 and the bound;
4j. the uplink codec and the lossy snapshot ring on the same setting: the
   codec on the card against the codec on the CPU, bit for bit, at fc0's
   and conv1's full shapes under a real Eq. 2 draw, single and stacked
   (C = 4), with telescoping to one ulp; ``FLRun`` / ``BatchedFLRun``
   ``run_sync(2)`` of helios and ``AsyncFLRun.run_async(8)`` of asyn and
   afo at one local step under topk / quant / delta with the masked
   pair's launches equal to the uncompressed run's (per kernel, per
   entry) and an error row a client that trained; each engine and mode
   held kernel path against plain path at max(1e-4, twice the plain
   path's drift from a 2^-23-nudged twin) with history identical, quant's
   bytes identical and the others' within 1e-3; the warmup round bit-
   identical to the uncompressed round; topk's uplink >= 10x below
   none's, the lossy rings below fp32's; round walls of each mode on both
   paths in turns and the codec's device time a round (profiled);
3b. hold the flash-attention kernel against its plain version at the LM
   slice's shape (4, 32, 512, 128) causal, at (2, 8, 300, 64) causal and
   ragged and at (2, 4, 256, 16) full, f32 and bf16, on 16-byte copies,
   and at (2, 8, 300, 64) off the 16-byte grid (element copies); every
   call twice, bit-identical; the autograd op (kernel forward, recompute
   backward) against plain autograd;
4b. the LM path: the dense LM at DeepSeek-7B width with its depth cut from
   30 to 2 layers, ``FLRun(..., kernels="cuda").run_sync(2)`` for helios
   and then syn on the same fleet over Markov-topic token streams, with
   the three kernels' counters zeroed before and read after (every flash
   call on 16-byte copies); one training step and two rounds of one local
   step held against the plain path;
5b. time each masked kernel, its plain version and ``torch.matmul`` on the
   same views with CUDA events, beside the least time the card could take:
   the LM's six MLP layouts at P 0.5 and 1.0, AlexNet's fc0 and fc1
   forward, dx and dw at P 0.5; the flash kernel and PyTorch's
   ``scaled_dot_product_attention`` by device time, and its plain version,
   at the slice shape, beside the bounds on the kernel's 3xTF32 route and
   on f32 FMA, and the recompute backward's time; one helios LM round
   against the plain path, and one under the profiler;
3c. hold the ``ssd_diag`` kernel against its plain version at the hybrid
   slice's shape (B, nc, L, ds, nh, hd) = (4, 2, 256, 64, 64, 64), at the
   ragged (2, 1, 300, 16, 8, 16) and at the reference test's
   (1, 2, 64, 16, 2, 32), f32 and bf16, and at the slice shape with the
   model's own decay (dt ≈ 0.7, A = -1), where the reference's decay
   overflows, on 16-byte copies, and the ragged case off the 16-byte grid;
   every call twice, bit-identical; the autograd op (kernel forward,
   recompute backward) against plain autograd;
4c. the hybrid path: Zamba2-1.2B at full width with its depth cut from 38
   to 6 Mamba2 layers (one invocation of the shared block),
   ``FLRun(..., kernels="cuda").run_sync(2)`` for helios and then syn on
   the LM's fleet and data, with every kernel's counter zeroed before and
   read after (48 ``ssd_diag`` launches a round, all on 16-byte copies,
   no other kernel); every loss and parameter finite; one training step
   and two rounds of one local step held against the plain path;
5c. time ``ssd_diag`` by device time and its
   plain version at the slice shape beside both bounds, and the recompute
   backward; one helios hybrid round, kernel path against plain path, then
   under the profiler;
4k. the serving plane: ``repro_torch.launch.serve.main`` at batch 8,
   prompt 512, 32 generated tokens, on the CLI's card default
   ``kernels="cuda"``, on DeepSeek-7B (all 30 layers), Zamba2-1.2B (all
   38: ``ssd_diag`` once a Mamba2 layer a prefill, never in a decode
   step) and Granite-3.0-1B-A400M
   (all 24), counters zeroed before and read after; every logit finite;
   the last decode step's logits held against one prefill over the same
   tokens at max(1e-4, twice a 2^-23-nudged twin's drift) (Granite with
   the capacity-free dense dispatch and its routing flips printed,
   Zamba2 at 542 tokens, a length its chunked SSD takes), Zamba2's
   kernel path against its plain path; prefill ms, decode ms a step
   beside its byte bound, a profiled decode step and the peak memory;
   then serve while training at Zamba2 width with 2 Mamba2 layers
   (``FLRun`` helios on the 2 + 2 fleet, 1 round of one local step,
   publishing every round, ``ServeLoop`` behind ``make_ce_eval``, Poisson
   traffic at 10 Hz): requests, latency and service p50 / p99 and the
   longest queue wait, swaps, publish / restore
   times and rates, the run log flushed and rendered with ``report``;
   ``ssd_diag`` at the serving prefill's shape against its plain
   version and its bound;
4l. the training launch: xLSTM-125M at full size (103.6 M params, all 12
   blocks) through ``repro_torch.launch.train.main`` at batch 8 x 128 for
   4 steps with a checkpoint at step 2, again without checkpoints (the
   card's run-to-run spread), then resumed from step 2: no kernel
   launched, the resumed run's final state within twice the spread of
   the uninterrupted one's (bit for bit when the card repeats itself);
   InternVL2-1B at full width and all 24 layers (batch 8 x 256 stub image
   embeddings + 256 tokens, volume 0.5, block-granular MLP masks) one
   ``make_train_step`` step on ``kernels="cuda"`` held against the plain
   path at 1e-4 (loss, gradient norm, params, AdamW's first moment and
   the scores) with launches equal to 6 masked_matmul, 3
   masked_matmul_dk and 1 flash_attention a layer, step walls in turns,
   and one ``make_fl_round_step`` round of 2 clients x 1 step held the
   same way; Qwen2.5-32B width with the depth cut 64 -> 1 one held
   step, the kernel path's result on the host before
   the plain path runs, and the peak memory; xLSTM-125M and InternVL2-1B
   served through the serve CLI with no kernel launched and the last
   decode step held against a re-prefill at max(1e-4, twice a nudged
   twin's drift); the masked pair and flash at the new shapes against
   their plain versions and timed beside their bounds, ``torch.matmul``
   and SDPA;
4m. the paper's reproduction (``repro_torch.drivers.paper_figures`` and
   the four example drivers) on the card, the masked pair's counters
   zeroed before and read after each run: the pair at LeNet's fc shapes
   (fc0 K 256, N 120; fc1 K 120, N 84: one partial 128-column block
   each) at batch 32 (the tables) and 16 (async_events, observability),
   forward, dx and dw with the block live and dead, and its client-axis
   entries at C = 4, batch 32 and 16 (one client without its live block;
   also the shared weights at batch 16) and at C = 1, batch 16 (a jittered
   bucket, block live and dead), held against their plain versions and
   repeated bit-identical, then timed at batch 32 beside their bounds,
   the plain versions and ``torch.matmul`` / ``torch.bmm``; Fig. 5
   (``table_convergence``, 14 rounds, ResNet-18's cut to 7, lr 0.02) at
   full width on LeNet, AlexNet and ResNet-18, 2 + 2
   and 3 + 3 fleets, five schemes, on the kernel path, AlexNet also on
   the plain path (its nudged twin's spread is
   ``scripts/figure_spread.py``'s): rows, cycles, sim times and volumes
   identical on both paths, every loss finite, masked launches in every
   LeNet and AlexNet run and none in ResNet-18's, each row's final
   accuracy beside the plain one; the speedup
   (16 rounds), Fig. 6 (10), Fig. 7 (12) and the P_s ablation (10) on
   LeNet, each P_s row's first round held against the plain path at
   1e-4; the quickstart walk, the elastic join / leave on both paths (the
   newcomer a straggler, history identical), async_events at 64 clients
   (dropout 0.1, jitter 0.3) with both engines' events/s, and
   observability's armed ``BatchedFLRun`` on both paths (its run log's
   rounds equal the run's, client-axis launches, held as the P_s rows
   are); every plain path launches no masked kernel;
4n. the last two model families, at their published widths: the masked
   pair at DeepSeek-V2's dense first layer (4 x 512 tokens, d_model 5120,
   d_ff 12288; all six layouts at P 0.5 and 1 on ``tile128``) held
   against its plain version and timed beside its bound, the plain
   version and ``torch.matmul``; DeepSeek-V2 through ``FLRun`` with the
   depth cut 60 -> 2 (the dense first layer and one MoE layer) and the
   routed experts 160 -> 8: helios ``run_sync(2)`` at one local step on
   the plain path and then the kernel path, each kernel-path step
   replaying the plain path's expert choices (a flip above a 1e-5 gap
   fails), 48 masked_matmul and 24 masked_matmul_dk launches and no
   other, history identical, params within 1e-4, a timed third round of
   each, the peak, then one step held with a straggler's masks and with
   full masks; ``make_train_step`` at 2 layers and 16 routed experts,
   one held step (plain choices replayed) and step walls in turns;
   serving at 2 layers with all 160 routed experts (batch 8, prompt 512,
   32 generated; the latent cache padded to 544) and SeamlessM4T-large-v2
   at full size through the serve CLI (the self cache padded to 544, the
   cross cache at the encoder's 512), neither launching a kernel, each
   decode held against a re-prefill at max(1e-4, twice a nudged twin's
   drift) (DeepSeek-V2 on the capacity-free dense dispatch, its routing
   flips gated), prefill ms, decode ms a step beside its byte bound, the
   peak; SeamlessM4T's three ``make_train_step`` steps at batch 8 x 512
   with 8 x 512 x 1024 stub frame embeddings in two microbatches (one
   runs out of the card's memory), no kernel, every loss and param
   finite, step walls and the peak;
4o. the batched engines on the dense LM and the hybrid: the kernels at the
   folded cohort shapes (a cohort of 2 folded into the batch axis) held
   against their plain versions and timed beside their bounds: flash at
   (8, 32, 512, 128) beside f32 SDPA, ``ssd_diag`` at (8, 2, 256, 64, 64,
   64), the masked pair's client-axis entries at C = 2, M 2048, K 4096, N
   11008 (forward, dx and dw at P = 0.5 a client, forward and dx on a
   shared weight with every block live; all on tile128) beside
   ``torch.bmm``; ``BatchedFLRun(..., kernels="cuda")`` helios
   ``run_sync(2)`` at one local step on the LM at DeepSeek-7B width (2
   layers) with every counter zeroed before and read after (flash once a
   layer, local step and cohort: 8; the masked MLP on the client-axis
   pair, 48 / 24; nothing else), its peak beside the memory arithmetic, a
   warm round's wall, each cohort's vmapped step against per-client plain
   autograd at 1e-4, a profiled round, then held at 1e-4 against the
   batched plain path and ``FLRun``'s plain path (ratios to one ulp);
   the same on the hybrid at Zamba2 width (6 Mamba2 layers; ``ssd_diag``
   once a Mamba2 layer, local step and cohort: 24), and ``AsyncFLRun``
   asyn ``run_async(4)`` on its kernel path (one ``ssd_diag`` a Mamba2
   layer and bucket) against its plain path and ``FLRun.run_async``'s
   plain path: events equal, params within 1e-4;
4p. the population engine (``ShardedFLRun`` at world 1): the client-axis
   pair at the LeNet cohort's shapes (C = 64, batch 16; fc0 and fc1
   forward, dx and dw) held against its plain versions, fc0's forward and
   dx timed beside their bounds, the plain versions and ``torch.bmm``;
   full-width AlexNet, a population of 1024 clients (half stragglers,
   IID), 32 a round, helios, one local step of batch 16, lr 0.05:
   ``run_sync(2)`` with the uniform sampler on the kernel and the plain
   path and with the time-weighted sampler on the kernel path, counters
   zeroed before and read after (6 client-axis launches a local step and
   rank block, none single-client), the rows of undrawn clients bit for
   bit as they were and the drawn stragglers' cycles equal to their
   draws, the kernel path held to the plain path at 1e-4 (ratios to one
   ulp), the host bytes of the population rows, round walls of both paths
   in turns, a profiled round and its peak; 64 clients at full
   participation on ``FLRun``, ``BatchedFLRun`` and ``ShardedFLRun``, held
   together at 1e-4 (the three-way wall); full-width LeNet, a population
   of 10^5 clients (an 8-device template fleet over one shared index
   array, as the reference's million-client worker builds it), 64 a round
   under ``topk``: set-up time, a warm-up round, 2 rounds with exact
   launches, finite params, undrawn rows at their initial values, an
   error row for each drawn client only, the round wall, host bytes and
   the peak.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit, and before that the
``{"kernels": [...]}`` line.
"""
from __future__ import annotations

import collections
import contextlib
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

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s on the CUDA
#: cores (the masked pair runs IEEE f32 FMA) and dense TF32 FLOP/s on the
#: tensor cores (flash_attention and ssd_diag run three TF32 products per
#: f32 product, the 3xTF32 split)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
BLOCK = 128
F32_TOL, BF16_TOL = 1e-4, 2e-2
#: fc0 / fc1 of full-width AlexNet at the main path's batch of 32
LAYERS = {"fc0": (4096, 1024), "fc1": (1024, 512)}
BATCH = 32
#: the LM slice: DeepSeek-7B width, depth cut to 2 layers, batch 4 x 512
LM_LAYERS, LM_BATCH, LM_SEQ, LM_VOCAB = 2, 4, 512, 1024
#: the LM's masked MLP calls per layer-step, as products (M, K) @ (K, N):
#: (label, kernel, M, K, N, x layout, w layout), "col" a transposed view;
#: tokens 2048, d_model 4096, d_ff 11008
LM_TOKENS, LM_D, LM_FF = LM_BATCH * LM_SEQ, 4096, 11008


def mlp_calls(tokens: int, d: int, ff: int) -> tuple:
    """A gated MLP's six masked products at ``tokens`` rows, d_model
    ``d`` and width ``ff``, in the layouts the main path hands over."""
    return (("wi/wg fwd", "masked_matmul", tokens, d, ff, "row", "row"),
            ("wi/wg dw", "masked_matmul", d, tokens, ff, "col", "row"),
            ("wo dh", "masked_matmul", tokens, d, ff, "row", "col"),
            ("wo dwT", "masked_matmul", d, tokens, ff, "col", "row"),
            ("wo fwd", "masked_matmul_dk", tokens, ff, d, "row", "row"),
            ("wi/wg dx", "masked_matmul_dk", tokens, ff, d, "row", "col"))


LM_MLP = mlp_calls(LM_TOKENS, LM_D, LM_FF)
#: the flash kernel's checks: (B, H, S, hd, causal); the first is the slice
FLASH_CASES = ((LM_BATCH, 32, LM_SEQ, 128, True), (2, 8, 300, 64, True),
               (2, 4, 256, 16, False))
#: the hybrid slice: Zamba2-1.2B width, depth cut to 6 Mamba2 layers (the
#: whole script's time limit)
HY_LAYERS = 6
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
    """Block flags with round(p·nb) live blocks (at least one; none at
    p = 0)."""
    k = max(1, int(round(p * nb))) if p > 0 else 0
    flags = torch.zeros(nb, device="cuda")
    flags[torch.randperm(nb, generator=g, device="cuda")[:k]] = 1
    return flags


def _operands(kernel: str, m: int, k: int, n: int, xl: str, wl: str,
              p: float, dtype, g, block: int = BLOCK):
    """Operands of one product y = (M, K) @ (K, N) in the layouts the main
    path hands over ("col": a transposed view), w scaled by K^-1/2, with
    round(p·blocks) live mask blocks over N (column kernel) or over K (dk;
    x's dead columns are zero, as in dy·mask).  Returns (fn, plain, x, w,
    live, dead columns or None)."""
    from repro_torch.kernels import masked_matmul as K
    from repro_torch.kernels import ref

    def mat(rows, cols, layout, div=None):
        shape = (rows, cols) if layout == "row" else (cols, rows)
        t = torch.randn(*shape, device="cuda", generator=g)
        t = (t if div is None else t / div).to(dtype)
        return t if layout == "row" else t.t()

    x = mat(m, k, xl)
    w = mat(k, n, wl, k ** 0.5)
    dk = kernel == "masked_matmul_dk"
    length = k if dk else n
    alive = _alive(-(-length // block), p, g)
    live = K.live_blocks(alive)
    col = alive.repeat_interleave(block)[:length]
    if dk:
        x = x * col.to(dtype)[None, :]          # dy·mask: dead K entries are 0
        return K.masked_matmul_dk, ref.masked_matmul_dk_ref, x, w, live, None
    return K.masked_matmul, ref.masked_matmul_ref, x, w, live, col == 0


#: a layer's calls as products: 'fwd' x @ W, 'dx' dy @ Wᵀ (a transposed
#: view; the dk kernel), 'dw' xᵀ (a transposed view) @ dy
LAYER_CALLS = {"fwd": lambda m, k, n: ("masked_matmul", m, k, n, "row", "row"),
               "dx": lambda m, k, n: ("masked_matmul_dk", m, n, k, "row", "col"),
               "dw": lambda m, k, n: ("masked_matmul", k, m, n, "col", "row")}


def _case(kind: str, m: int, k: int, n: int, p: float, dtype, g,
          block: int = BLOCK):
    """One call of a layer (M, K) -> (M, N) in the layout the main path
    hands over: 'fwd', 'dx' or 'dw' (LAYER_CALLS)."""
    return _operands(*LAYER_CALLS[kind](m, k, n), p, dtype, g, block)


def _check_call(label: str, fn, plain, x, w, live, dead, block: int,
                dt) -> tuple:
    """One kernel call against its plain version: max abs error within
    1e-4 (f32) or 2e-2 (bf16) of the output's scale, dead columns exactly
    zero, and a second call bit-identical to the first.  Returns (error,
    the configuration the wrapper's plan picked)."""
    from repro_torch.kernels import masked_matmul as K
    name = fn.__name__
    # with no live block the wrapper returns zeros and launches nothing
    p = K.plan(name, x.shape[0], w.shape[1], x.shape[1], live.numel(), block,
               x, w) if live.numel() else None
    y = fn(x, w, live, block)
    again = fn(x, w, live, block)
    want = plain(x.float(), w.float(), live, block)
    torch.cuda.synchronize()
    err = float((y.float() - want).abs().max())
    tol = (F32_TOL if dt == torch.float32 else BF16_TOL) * \
        max(float(want.abs().max()), 1e-30)
    zero_ok = dead is None or bool((y[:, dead] == 0).all())
    same = torch.equal(y, again)
    how = "no live block, no launch" if p is None else \
        f"{p.config} S={p.splits} grid={p.grid}"
    log(f"check {name:17s} {label} {str(dt)[6:]:8s} [{how}] "
        f"max|err|={err:.3e} tol={tol:.3e} "
        f"dead-zero={zero_ok} repeat-identical={same}")
    if not (err <= tol and zero_ok and same and math.isfinite(err)):
        raise AssertionError(f"{name} {label} disagrees with its plain "
                             f"version: err {err} > tol {tol}, dead columns "
                             f"not zero ({zero_ok}) or a repeat differs "
                             f"({same})")
    return err, None if p is None else p.config


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
        err, config = _check_call(f"{kind} m={m} k={k} n={n} P={p}", fn,
                                  plain, x, w, live, dead, BLOCK, dt)
        if main and kind != "dw" and config != "splitk":
            raise AssertionError(f"{kind} at batch {m} took {config}, not "
                                 f"splitk")
        if main and dt == torch.float32:
            worst[fn.__name__] = max(worst[fn.__name__], err)
    # the LM's MLP calls at full size (tile128), then mask blocks of 16
    # (general) and 256 (tile128) at a mid shape
    for label, kernel, m, k, n, xl, wl in LM_MLP:
        for p in (0.5, 1.0):
            fn, plain, x, w, live, dead = _operands(kernel, m, k, n, xl, wl,
                                                    p, torch.float32, g)
            err, config = _check_call(f"LM {label} M={m} K={k} N={n} P={p}",
                                      fn, plain, x, w, live, dead, BLOCK,
                                      torch.float32)
            if config != "tile128":
                raise AssertionError(f"LM {label} took {config}, not tile128")
            worst[kernel] = max(worst[kernel], err)
            del x, w, dead
    for block, want in ((16, "general"), (256, "tile128")):
        for kind in ("fwd", "dx", "dw"):
            fn, plain, x, w, live, dead = _case(kind, 512, 1024, 1536, 0.5,
                                                torch.float32, g, block)
            _, config = _check_call(f"{kind} m=512 k=1024 n=1536 P=0.5 "
                                    f"block={block}", fn, plain, x, w, live,
                                    dead, block, torch.float32)
            if config != want:
                raise AssertionError(f"block {block} {kind} took {config}, "
                                     f"not {want}")
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
             local_steps: int = 5, nudge: float = 0.0, fleet=(2, 2),
             engine=None, **kw):
    """A run on the card over ``fleet`` (capable, stragglers) and the first
    clients' partitions of ``st``; ``nudge`` scales the seed-0 initial
    weights by (1 + nudge) to measure how far rounding noise grows;
    ``engine`` is ``FLRun`` unless given; ``kw`` goes to the engine
    (participation, sampler, arrival, dropout, batch_size)."""
    from repro_torch.federated import FLRun, make_fleet, setup_clients
    from repro_torch.models import init_params
    cfg, hcfg, train, test, parts = st
    clients = setup_clients(make_fleet(*fleet), parts[:sum(fleet)], hcfg,
                            device="cuda")
    init = {k: v * (1 + nudge) for k, v in
            init_params(cfg, 0, "cuda").items()} if nudge else None
    return (engine or FLRun)(cfg, hcfg, scheme, clients, train, test,
                             local_steps=local_steps, lr=lr, kernels=kernels,
                             device="cuda", init_params=init, **kw)


def _param_diff(a, b) -> float:
    return max(float((a.global_params[k] - v).abs().max())
               for k, v in b.global_params.items())


def timed_run(run, rounds: int, eval_every: int = 1):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = run.run_sync(rounds, eval_every=eval_every)
    torch.cuda.synchronize()
    return hist, time.perf_counter() - t0


def timed_async(run, cycles: int, eval_every: int = 1, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = run.run_async(cycles, eval_every=eval_every, **kw)
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
    # per local step: the fc0 and fc1 forwards and dx at batch 32 (split-K)
    # and the two dw products, M = 4096 and 1024 (tile128)
    configs = dict(K.CONFIG_LAUNCHES)
    log("main path launches by configuration", json.dumps(configs))
    dw = launches["masked_matmul"] // 2
    want = {"general": 0, "tile128": dw,
            "splitk": launches["masked_matmul"] - dw
            + launches["masked_matmul_dk"]}
    if configs != want:
        raise AssertionError(f"AlexNet configurations {configs}, want {want}")
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


def _bound(kernel: str, m: int, k: int, n: int, live_len: int) -> tuple:
    """(bound ms, "bytes" or "operations", FLOP) of one f32 product with
    ``live_len`` live columns (column kernel: x read whole, the live w
    columns, y written whole) or live contraction rows (dk: the live x
    columns and w rows, y written whole)."""
    if kernel == "masked_matmul":
        nbytes = 4 * (m * k + k * live_len + m * n)
        flops = 2 * m * k * live_len
    else:
        nbytes = 4 * (m * live_len + live_len * n + m * n)
        flops = 2 * m * live_len * n
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), flops


def _bounds(flops: float, nbytes: float) -> dict:
    """The least time of a function run as 3xTF32 products on the tensor
    cores (three TF32 products per f32 product; the kernels' route) and
    as f32 FMA on the CUDA cores, each the larger of its operations and
    the bytes: ``bound_ms`` / ``bound_by`` for the route, ``bound_f32_ms``
    beside it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_tf32, t_f32 = 3 * flops / PEAK_TF32 * 1e3, flops / PEAK_F32 * 1e3
    return {"bound_ms": max(t_bytes, t_tf32),
            "bound_by": "bytes" if t_bytes >= t_tf32 else "operations",
            "bound_f32_ms": max(t_bytes, t_f32), "bytes_ms": t_bytes,
            "tf32x3_ops_ms": t_tf32, "f32_ops_ms": t_f32}


def _device_ms(fn, sets, reps: int = 3) -> float:
    """Device time per call without the host's share (at batch 32 the
    Python wrappers take longer to enqueue a call than the card to run it):
    the card first sleeps while the host enqueues every call, then CUDA
    events time the calls back to back.  The sleep doubles until it
    outlasts the enqueueing (a call that waits for the device never lets
    it: that fails)."""
    for s in sets[:4]:
        fn(*s)
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            for s in sets:
                fn(*s)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if enqueue_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / (reps * len(sets))
        cycles *= 2
    raise AssertionError(f"{getattr(fn, '__name__', fn)}: enqueueing "
                         f"{reps * len(sets)} calls took {enqueue_ms:.1f} ms,"
                         f" longer than the device's sleep")


def _time_call(label: str, kernel: str, m: int, k: int, n: int, xl: str,
               wl: str, p: float, g, n_sets: int) -> dict:
    """The kernel, its plain version and ``torch.matmul`` on the same views
    (the dense product, P = 1) over ``n_sets`` rotating operand sets: device
    time per call (``ms``, ``library_ms``) and CUDA-event time over calls as
    the host issues them, its enqueueing included (``wall_ms``,
    ``library_wall_ms``, ``plain_ms``)."""
    sets, dense = [], []
    for _ in range(n_sets):
        fn, plain, x, w, live, _ = _operands(kernel, m, k, n, xl, wl, p,
                                             torch.float32, g)
        sets.append((x, w, live, BLOCK))
        dense.append((x, w))
    # the plain version waits for the device (its mask's repeat_interleave
    # reads a size back), so only its event time is taken
    t = {"ms": _device_ms(fn, sets), "wall_ms": _time_ms(fn, sets),
         "plain_ms": _time_ms(plain, sets),
         "library_ms": _device_ms(torch.matmul, dense),
         "library_wall_ms": _time_ms(torch.matmul, dense)}
    length = k if kernel == "masked_matmul_dk" else n
    bound_ms, by, flops = _bound(kernel, m, k, n,
                                 min(int(live.numel()) * BLOCK, length))
    log(f"time {kernel} {label} M={m} K={k} N={n} x {xl} w {wl} P={p}: "
        f"device {t['ms']:.4f} ms (torch.matmul P=1 same views "
        f"{t['library_ms']:.4f}); as issued {t['wall_ms']:.4f} (torch.matmul "
        f"{t['library_wall_ms']:.4f}, plain {t['plain_ms']:.4f}); bound "
        f"{bound_ms:.4f} by {by}; "
        f"{flops / t['ms'] / 1e9:.1f} TFLOP/s; faster than torch.matmul: "
        f"device {'yes' if t['ms'] < t['library_ms'] else 'no'}, wall "
        f"{'yes' if t['wall_ms'] < t['library_wall_ms'] else 'no'}")
    return {**t, "bound_ms": bound_ms, "bound_by": by}


def time_kernels(worst: dict, paths: dict, lm_times: dict) -> list:
    """The masked kernels at AlexNet's fc0 and fc1 shapes, P = 0.5 (fc0
    forward and dx are the rows' own numbers), beside the LM's MLP times;
    ``paths`` holds each main path's launch counts (path -> kernel ->
    launches), ``launches`` their sum (each path's count is in
    ``launches_by_path``)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    times = {"masked_matmul": {}, "masked_matmul_dk": {}}
    for layer, (k, n) in LAYERS.items():
        for kind in ("fwd", "dx", "dw"):
            call = LAYER_CALLS[kind](BATCH, k, n)
            # rotating sets that together pass the 50 MB L2, so each call
            # reads its operands from device memory
            per_set = 4 * (BATCH * k + k * n + BATCH * n)
            times[call[0]][f"{layer} {kind}"] = _time_call(
                f"{layer} {kind}", *call, 0.5, g,
                max(8, -(-100_000_000 // per_set)))
    out = []
    for name, main in (("masked_matmul", "fc0 fwd"),
                       ("masked_matmul_dk", "fc0 dx")):
        t = times[name][main]
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/masked_matmul.cu",
                    "replaces": "src/repro/kernels/masked_matmul.py:"
                                + ("87" if name == "masked_matmul" else "103"),
                    "launches": sum(p[name] for p in paths.values()),
                    "launches_by_path": {path: p[name]
                                         for path, p in paths.items()},
                    "max_abs_err": worst[name],
                    "ms": t["ms"], "plain_ms": t["plain_ms"],
                    "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                    "bound_f32_ms": t["bound_ms"],
                    "library_ms": t["library_ms"], "wall_ms": t["wall_ms"],
                    "library_wall_ms": t["library_wall_ms"],
                    "alexnet": times[name], "lm": lm_times[name]})
    return out


def _client_bound(kernel: str, m: int, k: int, n: int, cols) -> tuple:
    """(bound ms, "bytes" or "operations") of a client-axis call: per
    client, x read whole, its live w columns (dk: its live x columns and w
    rows) and y written whole, summed over the clients; f32."""
    nbytes = flops = 0
    for live in cols:
        if kernel == "masked_matmul":
            nbytes += 4 * (m * k + k * live + m * n)
            flops += 2 * m * k * live
        else:
            nbytes += 4 * (m * live + live * n + m * n)
            flops += 2 * m * live * n
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _time_client_call(layer: str, kind: str, c: int, m: int, k: int,
                      n: int, p: float, g, n_sets: int = 0) -> dict:
    """One client-axis call of a layer, every client at P = ``p``, over
    ``n_sets`` operand sets (0: as many as together pass the 50 MB L2):
    device time, the plain version's (a loop over the clients) event time
    as issued, ``torch.bmm`` at P = 1 on the same views by device time,
    and the bound summed over the clients."""
    per_set = 4 * c * (m * k + k * n + m * n)
    sets, dense = [], []
    for _ in range(n_sets or max(1, -(-100_000_000 // per_set))):
        fn, plain, x, w, live, counts, _, cols = _client_case(
            kind, c, m, k, n, torch.float32, g, p=p)
        sets.append((x, w, live, counts, BLOCK))
        dense.append((x, w))
    name = fn.__name__
    bound, by = _client_bound(name.replace("_clients", ""), x.shape[1],
                              x.shape[2], w.shape[2], cols)
    t = {"ms": _device_ms(fn, sets), "plain_ms": _time_ms(plain, sets),
         "library_ms": _device_ms(torch.bmm, dense), "bound_ms": bound,
         "bound_by": by}
    log(f"time {name} {layer} {kind} C={c} M={m} K={k} N={n} P={p}: device "
        f"{t['ms']:.4f} ms (torch.bmm P=1 same views {t['library_ms']:.4f}), "
        f"plain {t['plain_ms']:.4f} as issued; bound {bound:.4f} by {by}")
    return t


def time_client_kernels(worst: dict, launches: dict) -> list:
    """The client-axis pair at fc0 forward and dx, every client at P = 0.5:
    the 2 + 2 fleet's cohort of 2 at batch 32 (the rows' own numbers) and
    the 64-client population's cohort of 32 at batch 16.  Device time, the
    plain version's (a loop over the clients) event time as issued,
    ``torch.bmm`` at P = 1 on the same views by device time, and the bound
    summed over the clients."""
    g = torch.Generator(device="cuda").manual_seed(3)
    k, n = LAYERS["fc0"]
    out = []
    for kind, name in (("fwd", "masked_matmul"), ("dx", "masked_matmul_dk")):
        rows = {f"C={c} M={m}": _time_client_call("fc0", kind, c, m, k, n,
                                                  0.5, g)
                for c, m in ((2, BATCH), (32, 16))}
        main = rows[f"C=2 M={BATCH}"]
        out.append({"name": f"{name}_clients", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/masked_matmul.cu",
                    "replaces": "src/repro/kernels/masked_matmul.py:"
                                + ("87" if name == "masked_matmul" else "103"),
                    "launches": sum(p[name] for p in launches.values()),
                    "launches_by_path": {path: p[name]
                                         for path, p in launches.items()},
                    "max_abs_err": worst[f"{name}_clients"],
                    **main, "cohorts": rows})
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


def profile_round(run, label: str, drive=None, host_top: int = 0,
                  groups: tuple = (), ranges: tuple = ()) -> dict:
    """One round (no evaluation), or what ``drive`` runs (it returns its
    wall in seconds), under the profiler: wall, device busy time, idle
    share and the device time of the heaviest ops (and the ``host_top``
    heaviest by host self time); ``groups`` adds (label, name parts)
    groups of device ops to the kernels' own; ``ranges`` names
    ``record_function`` ranges whose kernels' device time is summed.
    Returns the wall, the busy time and the masked kernels' device time in
    ms, and each group's and range's device time under its label."""
    from torch.profiler import ProfilerActivity, profile
    drive = drive or (lambda: timed_run(run, 1, eval_every=0)[1])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = drive()
    # a record_function range also shows as a device row spanning its
    # kernels: only the kernels count as busy time
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.key not in ranges]
    busy_ms = sum(_device_us(e) for e in rows) / 1e3
    if busy_ms <= 0:
        raise AssertionError(f"profile {label}: no device time traced")
    log(f"profile one {label}: wall {wall * 1e3:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / (wall * 1e3):.4f}")
    out = {"wall_ms": wall * 1e3, "busy_ms": busy_ms, "masked_ms": 0.0}
    for what, names in (("masked kernels", ("masked_mm", "splitk_reduce")),
                        ("flash_attention kernel", ("flash_fwd_kernel",)),
                        ("ssd_diag kernels", ("ssd_cb_kernel",
                                              "ssd_diag_kernel"))) + groups:
        mine = [e for e in rows if any(n in e.key for n in names)]
        if mine:
            ms = sum(map(_device_us, mine)) / 1e3
            if what == "masked kernels":
                out["masked_ms"] = ms
            out[what] = ms
            log(f"  {what}: device {ms:.3f} ms ({ms / busy_ms:.4f} of busy) "
                f"over {sum(e.count for e in mine)} kernel calls")
    for e in sorted(rows, key=_device_us, reverse=True)[:12]:
        log(f"  device {_device_us(e) / 1e3:9.3f} ms  calls {e.count:5d}  "
            f"{e.key[:90]}")
    host = [e for e in prof.key_averages()
            if not str(e.device_type).endswith("CUDA")]
    for name in ranges:
        mine = [e for e in host if e.key == name]
        t = sum(getattr(e, "device_time_total", None)
                if getattr(e, "device_time_total", None) is not None
                else e.cuda_time_total for e in mine) / 1e3
        out[name] = t
        log(f"  range {name}: device {t:.3f} ms ({t / busy_ms:.4f} of busy)"
            f" over {sum(e.count for e in mine)} ranges")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:host_top]:
        log(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms  calls "
            f"{e.count:5d}  {e.key[:90]}")
    return out


# ---------------------------------------------------------------------------
# phase 4d: the async baselines
# ---------------------------------------------------------------------------

#: masked calls per local step of full-width AlexNet: the fc0 and fc1
#: forwards and dx at batch 32 (split-K), their two dw products (tile128)
CALLS_PER_STEP = {"masked_matmul": 4, "masked_matmul_dk": 2}
CONFIGS_PER_STEP = {"general": 0, "tile128": 2, "splitk": 4}


def _expect_launches(what: str, steps: int) -> dict:
    """Check the masked pair's counters against ``steps`` local steps of
    AlexNet (per kernel and per configuration) and return the counts."""
    from repro_torch.kernels import masked_matmul as K
    launches, configs = dict(K.LAUNCHES), dict(K.CONFIG_LAUNCHES)
    log(f"{what} launches {json.dumps(launches)} by configuration "
        f"{json.dumps(configs)} over {steps} local steps")
    want = {k: v * steps for k, v in CALLS_PER_STEP.items()}
    want_cfg = {k: v * steps for k, v in CONFIGS_PER_STEP.items()}
    if launches != want or configs != want_cfg:
        raise AssertionError(f"{what}: launches {launches} / {configs}, want "
                             f"{want} / {want_cfg} (6 a local step)")
    return launches


def _finite(run, what: str) -> None:
    for k, v in run.global_params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: non-finite {k}")


def _hold_paths(what: str, a, b, keys) -> float:
    """Kernel path ``a`` against plain path ``b`` after the same rounds or
    events: the history's ``keys`` identical, acc within 1/512, loss within
    1e-4, params within 1e-4.  Returns the params' max |diff|."""
    if len(a.history) != len(b.history):
        raise AssertionError(f"{what}: history lengths differ")
    for x, y in zip(a.history, b.history):
        for key in keys:
            if x[key] != y[key]:
                raise AssertionError(f"{what}: history {key} differs: "
                                     f"{x[key]} vs {y[key]}")
        if abs(x["acc"] - y["acc"]) > 1.0 / 512 or \
                abs(x["loss"] - y["loss"]) > 1e-4:
            raise AssertionError(f"{what}: history acc/loss differ: {x} "
                                 f"vs {y}")
    diff = _param_diff(a, b)
    if not diff <= 1e-4:
        raise AssertionError(f"{what}: kernel path drifts from the plain "
                             f"path: {diff}")
    return diff


def _shadow_plain(run) -> list:
    """Make every local-training call of ``run`` also run the plain path
    on the same params, batches and masks; returns the list that collects
    each call's max |param diff| (its own launches are the kernel path's:
    the plain path launches nothing)."""
    from repro_torch.federated.adapter import make_adapter
    from repro_torch.federated.runtime import _make_local_train
    plain = _make_local_train(make_adapter(run.cfg, "reference",
                                           run.mask_block, run.device),
                              run.opt)
    kernel = run._local_train
    diffs = []

    def both(params, batches, masks):
        out = kernel(params, batches, masks)
        ref, _ = plain(params, batches, masks)
        diffs.append(max(float((out[0][k] - v).abs().max())
                         for k, v in ref.items()))
        return out

    run._local_train = both
    return diffs


def async_path(st) -> dict:
    """asyn and afo, ``run_async(8)`` on the kernel path with the masked
    pair's counters zeroed before and read after: 6 launches a local step
    of each processed event.  Then parity with the plain path, a jittered
    and lossy fleet, a small snapshot cap, and the wall per event."""
    from repro_torch.federated import BernoulliDropout, JitteredArrival
    from repro_torch.kernels import masked_matmul as K
    steps = 5
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    events = 0
    for scheme in ("asyn", "afo"):
        run = make_run(scheme, "cuda", st, local_steps=steps)
        hist, wall = timed_async(run, 8)
        events += run.events_processed
        log(f"async path {scheme}: run_async(8) in {wall:.3f} s, "
            f"{run.events_processed} events, staleness "
            f"{[r['staleness'] for r in hist]}, snapshot peak "
            f"{run.snapshot_peak}, queue peak {run.rec.count('queue_peak')}")
        for row in hist:
            log("  history", json.dumps(row))
        _finite(run, f"async {scheme}")
    launches = _expect_launches("async path", steps * events)
    log(f"async path peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
        f"(snapshot cap 64)")
    # One local step a cycle.  Every event's update is held to the plain
    # path's from the same params, batch and masks; the trajectory is
    # held to the plain path over 4 capable cycles.  Over 8 (10 events
    # in a chain) rounding noise grows to the order of 1e-4, so that
    # drift is printed beside a 2^-23-nudged plain twin's.
    for scheme in ("asyn", "afo"):
        runs = {name: make_run(scheme, kernels, st, local_steps=1,
                               nudge=nudge)
                for name, kernels, nudge in (
                    ("cuda", "cuda", 0.0), ("plain", "reference", 0.0),
                    ("nudged", "reference", 2.0 ** -23))}
        per_event = _shadow_plain(runs["cuda"])
        for run in runs.values():
            timed_async(run, 8)
        log(f"async {scheme} run_async(8) x 1 local step: every event's "
            f"update kernel vs plain from the same inputs, worst "
            f"{max(per_event):.3e} over {len(per_event)} events; trajectory "
            f"max|param diff| kernel vs plain "
            f"{_param_diff(runs['cuda'], runs['plain']):.3e}, plain vs "
            f"nudged plain {_param_diff(runs['plain'], runs['nudged']):.3e}")
        if not max(per_event) <= 1e-4:
            raise AssertionError(f"async {scheme}: an event's update "
                                 f"disagrees with the plain path: "
                                 f"{per_event}")
        a, b = (make_run(scheme, k, st, local_steps=1)
                for k in ("cuda", "reference"))
        for run in (a, b):
            timed_async(run, 4)
        diff = _hold_paths(f"async {scheme}", a, b,
                           ("cycle", "time", "staleness"))
        log(f"async {scheme} run_async(4) x 1 local step: max|param diff| "
            f"kernel vs plain {diff:.3e}")
    # a jittered, lossy fleet draws the same events on both paths
    lossy = [make_run("asyn", k, st, local_steps=1,
                      arrival=JitteredArrival(0.1),
                      dropout=BernoulliDropout(0.2))
             for k in ("cuda", "reference")]
    for run in lossy:
        timed_async(run, 8)
    counts = [(r.events_processed, r.events_dropped) for r in lossy]
    log(f"asyn jitter 0.1 + dropout 0.2: (processed, dropped) kernel "
        f"{counts[0]}, plain {counts[1]}; times "
        f"{[r['time'] for r in lossy[0].history]}; max|param diff| "
        f"{_param_diff(*lossy):.3e}")
    if counts[0] != counts[1]:
        raise AssertionError(f"jittered lossy fleet: event counts differ "
                             f"{counts}")
    # a small snapshot cap evicts, never a live anchor
    run = make_run("afo", "cuda", st)
    timed_async(run, 8, eval_every=0, snapshot_cap=2)
    bound = 2 + len(run.clients) + 1
    log(f"afo snapshot_cap 2: peak {run.snapshot_peak} (bound {bound}), "
        f"anchor misses {run.snapshot_anchor_misses}")
    if run.snapshot_anchor_misses or run.snapshot_peak > bound:
        raise AssertionError("snapshot cap 2: an anchor was evicted or the "
                             "snapshot dict outgrew its bound")
    time_async(st)
    return launches


def time_async(st) -> None:
    """Wall per processed event of asyn (no evaluation), kernel path
    against plain path in turns, then one kernel-path run under the
    profiler: idle share and the masked kernels' device time an event."""
    per_event = {"cuda": [], "reference": []}
    for kernels in ("cuda", "reference", "reference", "cuda"):
        run = make_run("asyn", kernels, st)
        _, wall = timed_async(run, 8, eval_every=0)
        per_event[kernels].append(wall * 1e3 / run.events_processed)
    log("async wall ms per processed event, asyn run_async(8): "
        + json.dumps(per_event))
    run = make_run("asyn", "cuda", st)
    prof = profile_round(run, "asyn run_async(8)",
                         lambda: timed_async(run, 8, eval_every=0)[1])
    log(f"async masked kernels' device time per event "
        f"{prof['masked_ms'] / run.events_processed:.4f} ms, wall per event "
        f"{prof['wall_ms'] / run.events_processed:.3f} ms")


# ---------------------------------------------------------------------------
# phase 4e: sampled cohorts and elastic membership
# ---------------------------------------------------------------------------


def six_client_setting(st):
    """The AlexNet setting's data split over six clients."""
    from repro_torch.data.federated import partition_noniid
    cfg, hcfg, train, test, _ = st
    return cfg, hcfg, train, test, partition_noniid(train["labels"], 6,
                                                    shards_per_client=4)


def cohort_path(st6) -> dict:
    """helios ``run_sync(2)`` over 3 of a 3 + 3 fleet, uniform and
    time-weighted, then the elastic join / leave sequence; the masked
    pair's counters are zeroed before and read after each kernel-path run
    (6 launches a local step of each cohort member)."""
    from repro_torch.federated import TABLE_I
    from repro_torch.kernels import masked_matmul as K
    steps = 5
    total = {k: 0 for k in CALLS_PER_STEP}
    for sampler in ("uniform", "time_weighted"):
        run = make_run("helios", "cuda", st6, local_steps=steps,
                       fleet=(3, 3), participation=3, sampler=sampler)
        K.reset_launches()
        hist, wall = timed_run(run, 2)
        got = _expect_launches(
            f"cohort path {sampler}",
            steps * sum(len(c) for c in run.cohort_log))
        total = {k: total[k] + got[k] for k in total}
        log(f"cohort path {sampler}: 2 rounds in {wall:.3f} s, cohorts "
            f"{run.cohort_log}")
        for row in hist:
            log("  history", json.dumps(row))
        _finite(run, f"cohort {sampler}")
    # examples/elastic_scaling.py's sequence, one local step a cycle; each
    # kernel-path cycle also checked against the plain path on its inputs
    runs = {}
    for kernels in ("cuda", "reference"):
        run = make_run("helios", kernels, st6, local_steps=1)
        if kernels == "cuda":
            per_cycle = _shadow_plain(run)
        K.reset_launches()
        timed_run(run, 2)
        new = run.add_client(TABLE_I[3], st6[4][4])
        timed_run(run, 1)
        run.remove_client(new.cid)
        timed_run(run, 1)
        if kernels == "cuda":
            got = _expect_launches("elastic join / leave", sum(
                len(c) for c in run.cohort_log))
            total = {k: total[k] + got[k] for k in total}
        log(f"elastic {kernels}: joined cid {new.cid} straggler "
            f"{new.is_straggler} volume {new.volume:.4f}; cohorts "
            f"{[len(c) for c in run.cohort_log]}")
        runs[kernels] = run
    diff = _hold_paths("elastic", runs["cuda"], runs["reference"],
                       ("cycle", "time", "volumes", "ratios"))
    log(f"elastic join / leave x 1 local step: max|param diff| kernel vs "
        f"plain {diff:.3e}; each cycle's update from the same inputs, "
        f"worst {max(per_cycle):.3e} over {len(per_cycle)} cycles")
    if not max(per_cycle) <= 1e-4:
        raise AssertionError(f"elastic: a cycle's update disagrees with the "
                             f"plain path: {per_cycle}")
    return total


# ---------------------------------------------------------------------------
# phase 4f: ResNet-18
# ---------------------------------------------------------------------------


def resnet_path() -> None:
    """Full-width ResNet-18 (32 px, 100 classes) on a 3 + 3 fleet: helios
    and syn ``run_sync(2)`` with ``kernels="cuda"``.  Its maskable units
    are conv filters, so no masked kernel launches (no call site, as in the
    reference)."""
    from repro_torch.configs import RESNET18, HeliosConfig
    from repro_torch.data.federated import partition_noniid
    from repro_torch.data.synthetic import class_gaussian_images
    from repro_torch.kernels import masked_matmul as K
    cfg = RESNET18
    imgs, labels = class_gaussian_images(2000, cfg.image_size,
                                         cfg.in_channels, cfg.num_classes)
    ti, tl = class_gaussian_images(512, cfg.image_size, cfg.in_channels,
                                   cfg.num_classes, seed=99)
    st = (cfg, HeliosConfig(mask_block=BLOCK),
          {"images": imgs, "labels": labels}, {"images": ti, "labels": tl},
          partition_noniid(labels, 6, shards_per_client=4))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    for scheme in ("helios", "syn"):
        run = make_run(scheme, "cuda", st, fleet=(3, 3))
        n = sum(v.numel() for v in run.global_params.values())
        hist, wall = timed_run(run, 2)
        log(f"resnet18 {scheme} ({n / 1e6:.3f} M params): 2 rounds in "
            f"{wall:.3f} s (first runs, cuDNN set-up included)")
        for row in hist:
            log("  history", json.dumps(row))
        _finite(run, f"resnet18 {scheme}")
        if scheme == "helios":
            strag = [r for c, r in zip(run.clients, hist[-1]["ratios"])
                     if c.is_straggler]
            if not strag or max(strag) >= 1.0:
                raise AssertionError(f"resnet18 helios straggler ratios not "
                                     f"below 1: {strag}")
    launches = dict(K.LAUNCHES)
    log(f"resnet18 masked launches {json.dumps(launches)} (no call site)")
    if any(launches.values()):
        raise AssertionError(f"resnet18 launched masked kernels: {launches}")
    walls = []
    for _ in range(2):
        _, wall = timed_run(run, 1, eval_every=0)
        walls.append(wall)
    log(f"resnet18 syn round wall s (no evaluation): {json.dumps(walls)}")
    run = make_run("helios", "cuda", st, fleet=(3, 3))
    timed_run(run, 1, eval_every=0)
    profile_round(run, "helios resnet18 round")
    log(f"resnet18 path peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")


# ---------------------------------------------------------------------------
# phase 3d: the client-axis kernels against their plain versions
# ---------------------------------------------------------------------------

#: cohort sizes and batches of the client-axis checks: the cohorts of
#: phase 4g (2, 8 and 32) and the bucket engine's padded sizes up to 4 (a
#: bucket of 1, of 2, of 3 padded to 4), whose split counts differ
CLIENT_COUNTS, CLIENT_BATCHES = (1, 2, 4, 8, 32), (16, 32)


def _client_case(kind: str, c: int, m: int, k: int, n: int, dtype, g,
                 shared: bool = False, p=None):
    """One client-axis call of a layer (M, K) -> (M, N) in the layout the
    vmap rules hand over: 'fwd' x (C, M, K) @ W (C, K, N); 'dx' dy·mask
    (C, M, N) @ Wᵀ (a transposed view; the dk kernel); 'dw' xᵀ (a
    transposed view) @ dy·mask.  Client i keeps P = (0.25, 0.5, 1.0)[i % 3]
    of its mask blocks and client 0 none (a cohort of one: P = 0.5; every
    client P = ``p`` when it is given); ``shared`` gives W and the mask a
    client stride of 0 with every block live (a capable cohort's first
    step: the global weights, full masks).  Returns (fn, plain, x, w, live,
    counts, dead (C, N) or None, live columns per client)."""
    from repro_torch.kernels import masked_matmul as K
    from repro_torch.kernels import ref
    nb = -(-n // BLOCK)
    if shared:
        flags = torch.ones(nb, device="cuda").expand(c, nb)
    elif p is not None or c == 1:
        flags = torch.stack([_alive(nb, 0.5 if p is None else p, g)
                             for _ in range(c)])
    else:
        flags = torch.stack([torch.zeros(nb, device="cuda")] + [
            _alive(nb, (0.25, 0.5, 1.0)[i % 3], g) for i in range(1, c)])
    live, counts = K.live_table(flags)
    mask = flags.repeat_interleave(BLOCK, dim=1)[:, :n]
    if shared:
        w = (torch.randn(k, n, device="cuda", generator=g) / k ** 0.5) \
            .to(dtype).expand(c, k, n)
    else:
        w = (torch.randn(c, k, n, device="cuda", generator=g) / k ** 0.5) \
            .to(dtype)
    x = torch.randn(c, m, k, device="cuda", generator=g).to(dtype)
    dy = (torch.randn(c, m, n, device="cuda", generator=g)
          * mask[:, None, :]).to(dtype)
    cols = [min(int(v) * BLOCK, n) for v in counts.tolist()]
    if kind == "fwd":
        return (K.masked_matmul_clients, ref.masked_matmul_clients_ref, x, w,
                live, counts, mask == 0, cols)
    if kind == "dx":
        return (K.masked_matmul_dk_clients, ref.masked_matmul_dk_clients_ref,
                dy, w.transpose(1, 2), live, counts, None, cols)
    return (K.masked_matmul_clients, ref.masked_matmul_clients_ref,
            x.transpose(1, 2), dy, live, counts, mask == 0, cols)


def _check_client_call(label: str, fn, plain, x, w, live, counts, dead,
                       dt) -> tuple:
    """One client-axis call against its plain version (a loop over the
    clients): max abs error within 1e-4 (f32) or 2e-2 (bf16) of the
    output's scale, dead columns exactly zero, a second call bit-identical.
    Returns (error, the configuration the plan picked)."""
    from repro_torch.kernels import masked_matmul as K
    name = fn.__name__
    c, m, k = x.shape
    p = K.plan(name.replace("_clients", ""), m, w.shape[2], k, live.shape[1],
               BLOCK, x, w, clients=c)
    y = fn(x, w, live, counts, BLOCK)
    again = fn(x, w, live, counts, BLOCK)
    want = plain(x.float(), w.float(), live, counts, BLOCK)
    torch.cuda.synchronize()
    err = float((y.float() - want).abs().max())
    tol = (F32_TOL if dt == torch.float32 else BF16_TOL) * \
        max(float(want.abs().max()), 1e-30)
    zero_ok = dead is None or bool((y.float() * dead[:, None, :]).eq(0).all())
    same = torch.equal(y, again)
    log(f"check {name:24s} {label} {str(dt)[6:]:8s} [{p.config} S={p.splits}"
        f" grid={p.grid}] max|err|={err:.3e} tol={tol:.3e} "
        f"dead-zero={zero_ok} repeat-identical={same}")
    if not (err <= tol and zero_ok and same and math.isfinite(err)):
        raise AssertionError(f"{name} {label} disagrees with its plain "
                             f"version: err {err} > tol {tol}, dead columns "
                             f"not zero ({zero_ok}) or a repeat differs "
                             f"({same})")
    return err, p.config


def check_client_kernels() -> dict:
    """The client-axis pair against its plain versions at fc0 / fc1
    forward, dx and dw for C in CLIENT_COUNTS at batch 16 and 32, f32 and
    bf16, the clients' P mixed in each call with one client that has no
    live block; then a shared (stride-0) weight and mask.  Returns the
    worst f32 error per kernel."""
    from repro_torch.kernels import masked_matmul as K
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = {"masked_matmul_clients": 0.0, "masked_matmul_dk_clients": 0.0}
    cases = [(kind, c, m, k, n, dt, False)
             for (k, n) in LAYERS.values() for kind in ("fwd", "dx", "dw")
             for c in CLIENT_COUNTS for m in CLIENT_BATCHES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(kind, c, BATCH, k, n, torch.float32, True)
              for (k, n) in LAYERS.values() for kind in ("fwd", "dx")
              for c in (2, 32)]
    for kind, c, m, k, n, dt, shared in cases:
        fn, plain, x, w, live, counts, dead, _ = _client_case(kind, c, m, k, n,
                                                              dt, g, shared)
        err, config = _check_client_call(
            f"{kind} C={c} m={m} k={k} n={n}{' shared' if shared else ''}",
            fn, plain, x, w, live, counts, dead, dt)
        want = "splitk" if kind != "dw" else \
            "tile128" if dt == torch.float32 else "general"
        if config != want:
            raise AssertionError(f"client {kind} C={c} m={m} {dt} took "
                                 f"{config}, not {want}")
        if dt == torch.float32:
            worst[fn.__name__] = max(worst[fn.__name__], err)
        del x, w, dead
    K.reset_launches()
    return worst


# ---------------------------------------------------------------------------
# phase 4g: the batched engine
# ---------------------------------------------------------------------------

#: client-axis calls per local step of a cohort (the kernels run one launch
#: per call for the whole cohort): fc0 / fc1 forward and dw, and dx
CLIENT_CALLS_PER_STEP = {"masked_matmul": 4, "masked_matmul_dk": 2}


def _expect_client_launches(what: str, cohort_steps: int,
                            configs: dict) -> dict:
    """The client-axis counters against ``cohort_steps`` (cohorts × local
    steps) vmapped steps, none on the single-client entry points."""
    from repro_torch.kernels import masked_matmul as K
    launches = dict(K.CLIENT_LAUNCHES)
    got_cfg = {k: v for k, v in K.CLIENT_CONFIG_LAUNCHES.items() if v}
    log(f"{what} client-axis launches {json.dumps(launches)} by "
        f"configuration {json.dumps(got_cfg)}, single-client "
        f"{json.dumps(K.LAUNCHES)}, over {cohort_steps} cohort steps")
    want = {k: v * cohort_steps for k, v in CLIENT_CALLS_PER_STEP.items()}
    want_cfg = {k: v * cohort_steps for k, v in configs.items()}
    if launches != want or got_cfg != want_cfg or any(K.LAUNCHES.values()):
        raise AssertionError(f"{what}: client-axis launches {launches} / "
                             f"{got_cfg} (want {want} / {want_cfg}), "
                             f"single-client {K.LAUNCHES} (want none)")
    return launches


def check_batched_step(st, run) -> None:
    """One vmapped training step of each cohort (the kernel path, from the
    global params as the round's first step takes them) against plain
    autograd client by client: loss and every gradient within 1e-4
    relative."""
    from repro_torch.core import soft_train as ST
    from repro_torch.models import cnn
    cfg, _, train, _, _ = st
    batch = {k: torch.as_tensor(v[:2 * BATCH]).cuda()
             .reshape((2, BATCH) + v.shape[1:]) for k, v in train.items()}
    strag = [c.helios_state for c in run.clients if c.is_straggler]
    step = torch.func.grad_and_value(run.adapter.loss_fn)
    for who, masks, m_dim in (
            ("straggler cohort", ST.stack_states(strag)["masks"], 0),
            ("capable cohort", run._ones, None)):
        grads, loss = torch.func.vmap(step, in_dims=(None, 0, m_dim))(
            run.global_params, batch, masks)
        worst = 0.0
        for i in range(2):
            params = {k: v.detach().clone().requires_grad_(True)
                      for k, v in run.global_params.items()}
            mi = masks if m_dim is None else {k: v[i] for k, v in
                                              masks.items()}
            li = cnn.cnn_loss(params, {k: v[i] for k, v in batch.items()},
                              cfg, {"kernels": "reference",
                                    "mask_block": BLOCK}, mi)
            gi = dict(zip(params, torch.autograd.grad(
                li, list(params.values()))))
            li = li.detach()
            if not abs(float(loss[i] - li)) <= F32_TOL * abs(float(li)):
                raise AssertionError(f"{who}: loss {float(loss[i])} vs "
                                     f"{float(li)}")
            worst = max([worst] + [float((grads[k][i] - gi[k]).abs().max())
                                   / max(float(gi[k].abs().max()), 1e-30)
                                   for k in gi])
        log(f"batched step {who}: losses {[float(v) for v in loss]}, worst "
            f"max|grad diff|/max|grad| against per-client plain autograd "
            f"{worst:.3e}")
        if not worst <= F32_TOL:
            raise AssertionError(f"{who}: vmapped step disagrees with plain "
                                 f"autograd ({worst})")


def _hold_batched(what: str, a, b) -> float:
    """Batched run ``a`` against sequential run ``b``: cycle, time and
    volumes identical, ratios within one float32 ulp (the reference's own
    batched program computes them as count × 1/total), acc within 1/512,
    loss and params within 1e-4.  Returns the params' max |diff|."""
    import numpy as np
    for x, y in zip(a.history, b.history):
        if (x["ratios"] != y["ratios"] and not np.allclose(
                x["ratios"], y["ratios"], rtol=2 ** -23, atol=0)):
            raise AssertionError(f"{what}: ratios differ: {x['ratios']} vs "
                                 f"{y['ratios']}")
    return _hold_paths(what, a, b, ("cycle", "time", "volumes"))


def batched_path(st) -> dict:
    """``BatchedFLRun(kernels="cuda").run_sync(2)`` for helios and syn on
    the 2 + 2 fleet with the masked counters zeroed before and read after
    each (6 client-axis launches a local step of each cohort, none on the
    single-client entry), the vmapped step against plain autograd, parity
    with the sequential plain path, and asyn / afo on the bucket engine."""
    from repro_torch.federated import BatchedFLRun
    from repro_torch.kernels import masked_matmul as K
    steps = 5
    total = {k: 0 for k in CLIENT_CALLS_PER_STEP}
    runs = {}
    for scheme, cohorts in (("helios", 2), ("syn", 1)):
        K.reset_launches()
        run = make_run(scheme, "cuda", st, engine=BatchedFLRun)
        hist, wall = timed_run(run, 2)
        got = _expect_client_launches(
            f"batched {scheme}", 2 * steps * cohorts,
            {"splitk": 4, "tile128": 2})
        total = {k: total[k] + got[k] for k in total}
        log(f"batched path {scheme}: 2 rounds in {wall:.3f} s (first run of "
            f"the engine, vmap set-up included)")
        for row in hist:
            log("  history", json.dumps(row))
        _finite(run, f"batched {scheme}")
        runs[scheme] = run
    strag = [r for c, r in zip(runs["helios"].clients,
                               runs["helios"].history[-1]["ratios"])
             if c.is_straggler]
    if not strag or max(strag) >= 1.0:
        raise AssertionError(f"batched helios straggler ratios not below 1: "
                             f"{strag}")
    check_batched_step(st, runs["helios"])
    # the batched kernel path against the sequential plain path: the
    # five-step drift beside the plain path's under a 2^-23 nudge, then two
    # rounds of one local step held at 1e-4
    for steps in (5, 1):
        b = make_run("helios", "cuda", st, local_steps=steps,
                     engine=BatchedFLRun)
        plain, nudged = (make_run("helios", "reference", st,
                                  local_steps=steps, nudge=nudge)
                         for nudge in (0.0, 2.0 ** -23))
        for run in (b, plain, nudged):
            timed_run(run, 2)
        log(f"batched helios 2 rounds x {steps} local steps: max|param diff|"
            f" batched kernel vs sequential plain {_param_diff(b, plain):.3e},"
            f" plain vs nudged plain {_param_diff(plain, nudged):.3e}")
    diff = _hold_batched("batched helios", b, plain)
    log(f"batched helios run_sync(2) x 1 local step held: {diff:.3e}")
    # asyn / afo on the bucket engine against the sequential plain loop
    for scheme in ("asyn", "afo"):
        K.reset_launches()
        a = make_run(scheme, "cuda", st, local_steps=1, engine=BatchedFLRun)
        timed_async(a, 4)
        got = _expect_client_launches(f"bucket engine {scheme}",
                                      len(a.bucket_sizes),
                                      {"splitk": 4, "tile128": 2})
        total = {k: total[k] + got[k] for k in total}
        s = make_run(scheme, "reference", st, local_steps=1)
        timed_async(s, 4)
        diff = _param_diff(a, s)
        trained = sum(1 << (b - 1).bit_length() for b in a.bucket_sizes)
        log(f"bucket engine {scheme} run_async(4) x 1 local step: buckets "
            f"{a.bucket_sizes}, events {a.events_processed} (sequential "
            f"{s.events_processed}; {trained} trained with the padding), "
            f"max|param diff| vs the sequential plain loop {diff:.3e}; "
            f"history {[r['cycle'] for r in a.history]}")
        if a.events_processed != s.events_processed or not diff <= 1e-4:
            raise AssertionError(f"bucket engine {scheme} drifts from the "
                                 f"sequential loop: {diff}")
    return total


def time_batched_rounds(st) -> None:
    """Whole helios rounds of the 2 + 2 fleet (5 local steps, no
    evaluation) on ``FLRun`` and ``BatchedFLRun``, kernel and plain path,
    in turns after a warm-up round; then one batched kernel-path round
    under the profiler."""
    from repro_torch.federated import BatchedFLRun, FLRun
    walls = {}
    for engine, kernels in ((FLRun, "cuda"), (BatchedFLRun, "cuda"),
                            (BatchedFLRun, "reference"), (FLRun, "reference"),
                            (FLRun, "reference"), (BatchedFLRun, "reference"),
                            (BatchedFLRun, "cuda"), (FLRun, "cuda")):
        run = make_run("helios", kernels, st, engine=engine)
        timed_run(run, 1, eval_every=0)
        _, wall = timed_run(run, 2, eval_every=0)
        walls.setdefault(f"{engine.__name__} {kernels}", []).append(wall / 2)
    log("round wall s helios 2 + 2 (2 rounds after a warm-up round): "
        + json.dumps(walls))
    run = make_run("helios", "cuda", st, engine=BatchedFLRun)
    timed_run(run, 1, eval_every=0)
    profile_round(run, "batched helios round (2 + 2)", host_top=10)


def population_path(st) -> dict:
    """A full-width AlexNet population of 64 clients (half stragglers, IID,
    helios, 1 local step of batch 16, lr 0.05): the round wall of
    ``FLRun`` against ``BatchedFLRun`` on the kernel path and the plain
    path after a warm-up round, the launches of a round, one profiled
    batched round and its peak memory.  Larger populations run on the
    population engine (phase 4p)."""
    from repro_torch.data.federated import partition_iid
    from repro_torch.federated import BatchedFLRun, FLRun
    from repro_torch.kernels import masked_matmul as K
    cfg, hcfg, train, test, _ = st
    out = {}
    launched = {k: 0 for k in CLIENT_CALLS_PER_STEP}
    for n in (64,):
        pop = (cfg, hcfg, train, test,
               partition_iid(len(train["labels"]), n))
        kw = dict(fleet=(n - n // 2, n // 2), local_steps=1, batch_size=16)
        walls = {}
        for engine, kernels in ((FLRun, "cuda"), (BatchedFLRun, "cuda"),
                                (BatchedFLRun, "reference"),
                                (FLRun, "reference")):
            run = make_run("helios", kernels, pop, engine=engine, **kw)
            timed_run(run, 1, eval_every=0)               # warm-up round
            K.reset_launches()
            _, wall = timed_run(run, 1, eval_every=0)
            name = f"{engine.__name__} {kernels}"
            walls[name] = wall
            single, client = sum(K.LAUNCHES.values()), \
                sum(K.CLIENT_LAUNCHES.values())
            log(f"population {n}: {name} round wall {wall:.4f} s, masked "
                f"launches single-client {single}, client-axis {client}")
            want = (0, 0) if kernels == "reference" else \
                (6 * n, 0) if engine is FLRun else (0, 12)
            if (single, client) != want:
                raise AssertionError(f"population {n} {name}: launches "
                                     f"{(single, client)}, want {want}")
            launched = {k: launched[k] + v
                        for k, v in K.CLIENT_LAUNCHES.items()}
            _finite(run, f"population {n} {name}")
        log(f"population {n} round walls s: {json.dumps(walls)}")
        run = make_run("helios", "cuda", pop, engine=BatchedFLRun, **kw)
        timed_run(run, 1, eval_every=0)
        _free()
        torch.cuda.reset_peak_memory_stats()
        prof = profile_round(run, f"batched helios round of {n} clients",
                             host_top=10)
        log(f"population {n} batched round peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        out[n] = {"walls": walls, **prof}
        del run
        _free()
    out["launches"] = launched
    return out


# ---------------------------------------------------------------------------
# phase 4i: SCAFFOLD, FLuID, delayed-gradient and the comparison drivers
# ---------------------------------------------------------------------------

NEW_SCHEMES = ("scaffold", "fluid", "delayed")
#: cohorts of a batched round on the 2 + 2 fleet: fluid soft-trains its
#: stragglers as a second cohort, scaffold and delayed train one full-model
#: cohort of 4
NEW_COHORTS = {"scaffold": 1, "fluid": 2, "delayed": 1}


def _counts() -> tuple:
    """(single-client, client-axis) launch counters of the masked pair."""
    from repro_torch.kernels import masked_matmul as K
    return dict(K.LAUNCHES), dict(K.CLIENT_LAUNCHES)


def _add(total: dict, got: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in got.items()}


def _hold_controls(what: str, a, b, tol: float = math.inf) -> float:
    """SCAFFOLD's ``c_global`` and every client's control row, run ``a``
    against run ``b``, within ``tol``; returns the worst |diff|."""
    if sorted(a._ctrl_store._rows) != sorted(b._ctrl_store._rows):
        raise AssertionError(f"{what}: control rows of other clients")
    pairs = [(a._c_global, b._c_global)] + [
        (a._ctrl_store.row(c), b._ctrl_store.row(c))
        for c in b._ctrl_store._rows]
    worst = max(float((x[k] - v).abs().max()) for x, y in pairs
                for k, v in y.items())
    if not worst <= tol:
        raise AssertionError(f"{what}: controls differ by {worst} (tol "
                             f"{tol})")
    return worst


def schemes_path(st) -> dict:
    """Phase 4i on the AlexNet 2 + 2 setting: scaffold, fluid and delayed on
    ``FLRun`` and ``BatchedFLRun`` with exact launch counts, their holds
    against the plain path at one local step, the scheme gauntlet at full
    width on both paths, the five-scheme table on both engines, and a
    profiled SCAFFOLD round.  Returns the launches by path, single-client
    and client-axis."""
    from repro_torch.configs import ALEXNET
    from repro_torch.drivers.heterogeneous_fl import heterogeneous_fl
    from repro_torch.drivers.scheme_gauntlet import scheme_gauntlet
    from repro_torch.federated import BatchedFLRun
    from repro_torch.kernels import masked_matmul as K
    t0 = time.perf_counter()
    steps = 5
    single, client = {}, {}
    # 1. exact launches: FLRun 6 single-client calls a local step a client
    # (120 a round), BatchedFLRun 6 client-axis calls a local step a cohort
    for scheme in NEW_SCHEMES:
        K.reset_launches()
        run = make_run(scheme, "cuda", st, local_steps=steps)
        hist, wall = timed_run(run, 2)
        single = _add(single, _expect_launches(f"FLRun {scheme}",
                                               2 * 4 * steps))
        if any(K.CLIENT_LAUNCHES.values()):
            raise AssertionError(f"FLRun {scheme}: client-axis launches "
                                 f"{K.CLIENT_LAUNCHES}")
        log(f"FLRun {scheme}: 2 rounds in {wall:.3f} s; history "
            + json.dumps([{k: r[k] for k in ("cycle", "time", "acc",
                                              "ratios")} for r in hist]))
        _finite(run, f"FLRun {scheme}")
        K.reset_launches()
        run = make_run(scheme, "cuda", st, local_steps=steps,
                       engine=BatchedFLRun)
        hist, wall = timed_run(run, 2)
        client = _add(client, _expect_client_launches(
            f"BatchedFLRun {scheme}", 2 * steps * NEW_COHORTS[scheme],
            {"splitk": 4, "tile128": 2}))
        log(f"BatchedFLRun {scheme}: 2 rounds in {wall:.3f} s")
        _finite(run, f"BatchedFLRun {scheme}")
        strag = [r for c, r in zip(run.clients, hist[-1]["ratios"])
                 if c.is_straggler]
        if (max(strag) < 1.0) != (scheme == "fluid"):
            raise AssertionError(f"{scheme}: straggler ratios {strag}")
    # 2. holds at one local step: FLRun and BatchedFLRun against FLRun's
    # plain path over two rounds, run_async(4) (the sequential fallback)
    # kernel against plain; SCAFFOLD's controls at 1e-4 / (K * lr), each
    # engine's kernel path against its own plain path (a client's control
    # row is its own update times 1/(K * lr), not averaged over the cohort
    # as the global params are, so a fork at an AlexNet max-pool near-tie
    # between the engines' roundings shows there 4x larger: printed
    # beside the nudged twin's); each beside the plain path's drift from a
    # 2^-23-nudged plain twin
    ctrl_tol = 1e-4 / (1 * 0.05)
    for scheme in NEW_SCHEMES:
        runs = {name: make_run(scheme, kernels, st, local_steps=1,
                               nudge=nudge, engine=engine)
                for name, kernels, nudge, engine in (
                    ("cuda", "cuda", 0.0, None),
                    ("plain", "reference", 0.0, None),
                    ("nudged", "reference", 2.0 ** -23, None),
                    ("batched", "cuda", 0.0, BatchedFLRun),
                    ("batched plain", "reference", 0.0, BatchedFLRun))}
        for run in runs.values():
            timed_run(run, 2)
        d_seq = _hold_paths(f"FLRun {scheme}", runs["cuda"], runs["plain"],
                            ("cycle", "time", "volumes", "ratios"))
        d_bat = _hold_batched(f"BatchedFLRun {scheme}", runs["batched"],
                              runs["plain"])
        log(f"{scheme} run_sync(2) x 1 local step, max|param diff| against "
            f"FLRun's plain path: FLRun kernel {d_seq:.3e}, BatchedFLRun "
            f"kernel {d_bat:.3e} (against BatchedFLRun's plain path "
            f"{_param_diff(runs['batched'], runs['batched plain']):.3e}); "
            f"plain vs nudged plain "
            f"{_param_diff(runs['plain'], runs['nudged']):.3e}")
        if scheme == "scaffold":
            held = [_hold_controls(f"{what} scaffold", runs[a], runs[b],
                                   ctrl_tol)
                    for what, a, b in (("FLRun", "cuda", "plain"),
                                       ("BatchedFLRun", "batched",
                                        "batched plain"))]
            cross = _hold_controls("cross", runs["batched"], runs["plain"])
            noise = _hold_controls("nudged", runs["nudged"], runs["plain"])
            log(f"scaffold controls, max|diff| kernel vs plain (tol "
                f"{ctrl_tol:.1e}): FLRun {held[0]:.3e}, BatchedFLRun "
                f"{held[1]:.3e}; ungated: BatchedFLRun kernel vs FLRun plain"
                f" {cross:.3e}, FLRun plain vs nudged plain {noise:.3e}")
    for scheme in ("scaffold", "delayed"):
        runs = {name: make_run(scheme, kernels, st, local_steps=1,
                               nudge=nudge, engine=BatchedFLRun)
                for name, kernels, nudge in (
                    ("cuda", "cuda", 0.0), ("plain", "reference", 0.0),
                    ("nudged", "reference", 2.0 ** -23))}
        for run in runs.values():
            timed_async(run, 4)
        diff = _hold_paths(f"{scheme} run_async", runs["cuda"], runs["plain"],
                           ("cycle", "time", "staleness"))
        extra = ""
        if scheme == "scaffold":
            held = _hold_controls("async scaffold", runs["cuda"],
                                  runs["plain"], ctrl_tol)
            noise = _hold_controls("async nudged", runs["nudged"],
                                   runs["plain"])
            extra = f"; controls {held:.3e} (nudged {noise:.3e})"
        log(f"{scheme} run_async(4) x 1 local step (sequential fallback), "
            f"{runs['cuda'].events_processed} events: max|param diff| kernel "
            f"vs plain {diff:.3e}, plain vs nudged plain "
            f"{_param_diff(runs['plain'], runs['nudged']):.3e}{extra}")
    # 3. the scheme gauntlet at full width, kernel path and plain path
    g = {}
    for name, kernels in (("cuda", "cuda"), ("plain", "reference")):
        K.reset_launches()
        doc, runs, walls = scheme_gauntlet(
            ALEXNET, rounds=12, device="cuda", kernels=kernels,
            out_path=str(ROOT / "chiprun_out"
                         / f"scheme_gauntlet_{name}.json"))
        g[name] = doc["schemes"], runs, walls, _counts()
        for scheme, run in runs.items():
            _finite(run, f"gauntlet {name} {scheme}")
    (cs, cr, cw, (g_single, g_client)), (ps, pr, pw, _) = \
        g["cuda"], g["plain"]
    for scheme in cs:
        for key in ("engine", "sim_time", "uplink_mb", "downlink_mb"):
            if cs[scheme][key] != ps[scheme][key]:
                raise AssertionError(f"gauntlet {scheme}: {key} "
                                     f"{cs[scheme][key]} vs {ps[scheme][key]}")
        if [h["cycle"] for h in cr[scheme].history] != \
                [h["cycle"] for h in pr[scheme].history] or \
                [t["time"] for t in cs[scheme]["trajectory"]] != \
                [t["time"] for t in ps[scheme]["trajectory"]]:
            raise AssertionError(f"gauntlet {scheme}: cycles or clocks "
                                 f"differ between the paths")
        for side in (cs, ps):
            if "prop2" in side[scheme] and \
                    not side[scheme]["prop2"]["eq9_holds"]:
                raise AssertionError(f"gauntlet {scheme}: Eq. 9 fails "
                                     f"{side[scheme]['prop2']}")
        rounds = max(len(cr[scheme].history), 1)
        c = cs[scheme]
        prop2 = f"; var_inflation {c['prop2']['variance_inflation']:.4f}" \
            if "prop2" in c else ""
        log(f"gauntlet {scheme:8s} {c['engine']:12s}: final acc kernel "
            f"{c['final_acc']:.4f} plain {ps[scheme]['final_acc']:.4f}; "
            f"max|param diff| kernel vs plain "
            f"{_param_diff(cr[scheme], pr[scheme]):.3e}; sim_time {c['sim_time']:.2f}, uplink {c['uplink_mb']:.2f} MB, "
            f"downlink {c['downlink_mb']:.2f} MB; wall per history row "
            f"kernel {cw[scheme] / rounds:.4f} s, plain "
            f"{pw[scheme] / rounds:.4f} s{prop2}")
    if cs["scaffold"]["uplink_mb"] != 2 * cs["helios"]["uplink_mb"]:
        raise AssertionError("gauntlet: scaffold's uplink is not twice "
                             "helios's")
    log(f"gauntlet masked launches (kernel path, 9 schemes): single-client "
        f"{json.dumps(g_single)}, client-axis {json.dumps(g_client)}")
    if min(g_client.values()) <= 0:
        raise AssertionError(f"gauntlet: a client-axis kernel never "
                             f"launched {g_client}")
    # 4. the five-scheme table, both engines, kernel path, at lr 0.05: the
    # driver's 0.1 (the reference's, for reduced widths) takes full-width
    # AlexNet's loss to NaN within two rounds
    t_single, t_client = {}, {}
    for engine in ("sequential", "batched"):
        K.reset_launches()
        res = heterogeneous_fl(ALEXNET, devices=4, rounds=5, engine=engine,
                               device="cuda", kernels="cuda", lr=0.05)
        s1, c1 = _counts()
        t_single, t_client = _add(t_single, s1), _add(t_client, c1)
        log(f"five-scheme table ({engine}) masked launches: single-client "
            f"{json.dumps(s1)}, client-axis {json.dumps(c1)}; rows "
            + json.dumps({k: [h["cycle"], h["time"], h["acc"]]
                          for k, h in ((k, v[-1]) for k, v in res.items())}))
        if min((s1 if engine == "sequential" else c1).values()) <= 0 or \
                not all(math.isfinite(r["loss"]) for v in res.values()
                        for r in v):
            raise AssertionError(f"five-scheme table ({engine}): {s1} {c1}")
    # 5. a SCAFFOLD round under the profiler: every client at P = 1
    run = make_run("scaffold", "cuda", st)
    timed_run(run, 1, eval_every=0)
    prof = profile_round(run, "scaffold round (FLRun 2 + 2, P = 1)")
    log(f"scaffold round: the masked pair at P = 1 {prof['masked_ms']:.3f} ms,"
        f" {prof['masked_ms'] / prof['wall_ms']:.4f} of the wall, "
        f"{prof['masked_ms'] / prof['busy_ms']:.4f} of device busy time")
    log(f"phase 4i took {time.perf_counter() - t0:.1f} s")
    return {"single": {"schemes": single, "gauntlet": g_single,
                       "table": t_single},
            "client": {"schemes": client, "gauntlet": g_client,
                       "table": t_client}}


# ---------------------------------------------------------------------------
# phase 4j: the uplink codec and the lossy snapshot ring
# ---------------------------------------------------------------------------

LOSSY = ("topk", "quant", "delta")
#: the engines phase 4j drives: (label, engine, scheme, drive for the
#: launch check, drive for the holds, the history keys held identical)
COMP_CASES = (
    ("FLRun", None, "helios", lambda r: timed_run(r, 2),
     lambda r: timed_run(r, 2), ("cycle", "time", "volumes", "ratios")),
    ("BatchedFLRun", "BatchedFLRun", "helios", lambda r: timed_run(r, 2),
     lambda r: timed_run(r, 2), ("cycle", "time", "volumes", "ratios")),
    ("AsyncFLRun asyn", "AsyncFLRun", "asyn", lambda r: timed_async(r, 8),
     lambda r: timed_async(r, 4), ("cycle", "time", "staleness")),
    ("AsyncFLRun afo", "AsyncFLRun", "afo", lambda r: timed_async(r, 8),
     lambda r: timed_async(r, 4), ("cycle", "time", "staleness")))
#: kernel-name parts of the codec's device work in a profiled round
CODEC_OPS = (("codec: top-k (select / sort)", ("topk", "Topk", "TopK",
                                                "radix", "sort", "Sort")),
             ("codec: round", ("round",)))


class CodecTap:
    """While active, keeps the inputs and the ``sent`` tree of every codec
    call, each inside a ``codec`` profiler range: every engine reaches the
    codec through ``compress_update_stacked`` (the single-update form is
    its one-row case), looked up on the module at each call."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.optim import compression as CP
        self._cp, self._saved = CP, CP.compress_update_stacked

        def tapped(delta, error, mode, frac=0.05, bits=8, masks=None):
            with torch.profiler.record_function("codec"):
                out = self._saved(delta, error, mode, frac, bits, masks)
            self.calls.append({"delta": delta, "error": error,
                               "masks": masks, "sent": out[0]})
            return out

        CP.compress_update_stacked = tapped
        return self

    def __exit__(self, *exc):
        self._cp.compress_update_stacked = self._saved


def _sent_differences(a: dict, b: dict, mode: str, bits: int = 8) -> int:
    """Coordinates of two ``sent`` trees that were decided differently: in
    or out of the sent set (topk, delta), or a code step apart (quant,
    delta; a step is the leaf's max |value| / (2^(bits-1) - 1))."""
    n = 0
    for k, x in a.items():
        y = b[k]
        n += int(((x != 0) ^ (y != 0)).sum())
        if mode != "topk":
            step = x.abs().amax() / (2 ** (bits - 1) - 1)
            n += int(((x - y).abs() > 0.5 * step).sum())
    return n


def _ulp_ok(lhs: torch.Tensor, rhs: torch.Tensor) -> bool:
    """|lhs - rhs| within one f32 ulp of |rhs|."""
    big = torch.full_like(rhs, math.inf)
    ulp = torch.nextafter(rhs.abs(), big) - rhs.abs()
    return bool(((lhs - rhs).abs() <= ulp).all())


def check_codec(st) -> None:
    """The codec on the card against the codec on the CPU, bit for bit
    (``sent``, the new error rows, the coordinate counts), single and
    stacked (C = 4), each mode: seeded deltas and error rows at fc0's
    (4096, 1024) and conv1's full shapes, a sixteenth of the fc0 delta's
    values tied at 3 sigma (k is a twentieth: every tie is kept, so a full
    row sends more than k); masks from a real Eq. 2 draw of
    both stragglers (ones for the two capable rows).  Telescoping
    ``sent + new_error == delta + error`` within one ulp on unmasked
    coordinates."""
    import numpy as np
    from repro_torch.core import soft_train as ST
    from repro_torch.optim import compression as CP
    run = make_run("helios", "reference", st, local_steps=1)
    hcfg = run._scheme.effective_hcfg(run.hcfg)
    keys = ("fc0_w", "conv1_w")
    shapes = {k: tuple(run.global_params[k].shape) for k in keys}
    masks = []
    for c in run.clients:
        if c.is_straggler:
            um = ST.begin_cycle(c.helios_state, hcfg)["masks"]
            pm = run.adapter.expand_masks(um, run.global_params)
            masks.append({k: pm[k].cpu() for k in keys})
        else:
            masks.append({k: torch.ones(shapes[k]) for k in keys})
    live = [float(m["fc0_w"].mean()) for m in masks]
    rng = np.random.default_rng(41)
    # more ties than fc0's k, so its threshold is a tie; the error rows are
    # zero there, so that delta + error keeps them tied
    n_fc0 = math.prod(shapes["fc0_w"])
    tied = torch.from_numpy(rng.permutation(n_fc0)[:n_fc0 // 16])

    def tree(scale, tie_value):
        out = {k: torch.from_numpy((scale * rng.standard_normal(s))
                                   .astype(np.float32)) for k, s in
               shapes.items()}
        out["fc0_w"].view(-1)[tied] = tie_value
        return out

    rows = [(tree(1e-3, 3e-3), tree(1e-4, 0.0)) for _ in range(4)]
    mism = []

    def compare(what, cpu, dev):
        for j, name in ((0, "sent"), (1, "new_error")):
            for k in keys:
                bad = (cpu[j][k] != dev[j][k].cpu()).view(-1)
                if bad.any():
                    at = bad.nonzero()[:3, 0]
                    mism.append(
                        f"{what} {name} {k}: {int(bad.sum())} at "
                        f"{at.tolist()}, CPU {cpu[j][k].view(-1)[at].tolist()}"
                        f" card {dev[j][k].cpu().view(-1)[at].tolist()}")
        if not torch.equal(cpu[2], dev[2].cpu()):
            mism.append(f"{what} coords {cpu[2].tolist()} vs "
                        f"{dev[2].tolist()}")

    def cuda(t):
        return {k: v.cuda() for k, v in t.items()}

    for mode in LOSSY:
        for i, (d, e) in enumerate(rows):
            m = masks[i]
            dev = CP.compress_update(cuda(d), cuda(e), mode, 0.05, 8,
                                     cuda(m))
            compare(f"{mode} row {i}", CP.compress_update(d, e, mode, 0.05,
                                                          8, m), dev)
            for k in keys:
                keep = m[k].cuda() > 0
                if not _ulp_ok((dev[0][k] + dev[1][k])[keep],
                               (d[k] + e[k]).cuda()[keep]):
                    raise AssertionError(f"codec {mode} {k}: sent + "
                                         f"new_error != delta + error")
        stack = [{k: torch.stack([r[j][k] for r in rows]) for k in keys}
                 for j in (0, 1)]
        sm = {k: torch.stack([m[k] for m in masks]) for k in keys}
        dev = CP.compress_update_stacked(cuda(stack[0]), cuda(stack[1]),
                                         mode, 0.05, 8, cuda(sm))
        compare(f"{mode} stacked", CP.compress_update_stacked(
            stack[0], stack[1], mode, 0.05, 8, sm), dev)
        sent_fc0 = [int((dev[0]["fc0_w"][i] != 0).sum()) for i in range(4)]
        log(f"codec {mode} card vs CPU (fc0 {shapes['fc0_w']}, conv1 "
            f"{shapes['conv1_w']}; rows' live fc0 share {live}): coords "
            f"{[float(x) for x in dev[2]]}, fc0 sent per row {sent_fc0} "
            f"(leaf_k {CP.leaf_k(n_fc0, 0.05)})")
    log(f"codec card vs CPU: {len(mism)} mismatching tensors over 3 modes "
        f"x (4 single + 1 stacked) calls {mism}")
    if mism:
        raise AssertionError(f"codec: the card and the CPU disagree: "
                             f"{mism}")


def _hold_comp(what: str, a, b, keys, tol: float) -> float:
    """Run ``a`` against run ``b`` under compression: the history's
    ``keys`` identical, params within ``tol``, quant's bytes identical and
    the others' within 1e-3 relative.  Returns the params' max |diff|."""
    for x, y in zip(a.history, b.history):
        for key in keys:
            if x[key] != y[key]:
                raise AssertionError(f"{what}: history {key} differs: "
                                     f"{x[key]} vs {y[key]}")
    if len(a.history) != len(b.history):
        raise AssertionError(f"{what}: history lengths differ")
    diff = _param_diff(a, b)
    if not diff <= tol:
        raise AssertionError(f"{what}: params differ by {diff} (tol {tol})")
    ba, bb = a.uplink_bytes(), b.uplink_bytes()
    if (ba != bb) if a.compression == "quant" else \
            abs(ba - bb) > 1e-3 * bb:
        raise AssertionError(f"{what}: uplink bytes {ba} vs {bb}")
    return diff


def compression_path(st) -> dict:
    """Phase 4j on the AlexNet 2 + 2 setting: the codec on the card against
    the CPU; ``FLRun`` / ``BatchedFLRun`` ``run_sync(2)`` of helios and
    ``AsyncFLRun.run_async(8)`` of asyn and afo at one local step under
    each lossy mode with the masked pair's launches equal to the
    uncompressed run's; the kernel path held to the plain path per engine
    and mode; the warmup round; bytes, ring bytes, error rows and memory;
    round walls of each mode in turns and the codec's device time.
    Returns the launches of the lossy runs, single-client and
    client-axis."""
    from repro_torch.core import aggregation as AG
    from repro_torch.federated import AsyncFLRun, BatchedFLRun
    from repro_torch.kernels import masked_matmul as K
    from repro_torch.optim import compression as CP
    t0 = time.perf_counter()
    check_codec(st)
    engines = {None: None, "BatchedFLRun": BatchedFLRun,
               "AsyncFLRun": AsyncFLRun}
    # 1. launches: each lossy mode's masked launches are the uncompressed
    # run's, per kernel and per entry (the codec launches no hand kernel)
    single, client, per_round, peak = {}, {}, {}, {}
    for label, eng, scheme, drive, _, _ in COMP_CASES:
        got = {}
        for mode in ("none",) + LOSSY:
            K.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            run = make_run(scheme, "cuda", st, local_steps=1,
                           engine=engines[eng], compression=mode)
            _, wall = drive(run)
            got[mode] = _counts()
            _finite(run, f"{label} {mode}")
            if label == "FLRun":
                per_round[mode] = run.uplink_bytes() / 2
                peak[mode] = torch.cuda.max_memory_allocated() / 2 ** 30
            if mode != "none":
                single = _add(single, got[mode][0])
                client = _add(client, got[mode][1])
                touched = sum(c.staleness_anchor > 0 for c in run.clients) \
                    if scheme in ("asyn", "afo") else len(run.clients)
                if run._err_store.touched() != touched:
                    raise AssertionError(
                        f"{label} {mode}: {run._err_store.touched()} error "
                        f"rows for {touched} clients that trained")
            log(f"{label} {mode}: {wall:.3f} s, {run.uplink_updates} "
                f"updates, uplink {run.uplink_bytes():.0f} B, "
                f"masked launches single {json.dumps(got[mode][0])} "
                f"client-axis {json.dumps(got[mode][1])}")
        for mode in LOSSY:
            if got[mode] != got["none"] or \
                    not any(v for d in got[mode] for v in d.values()):
                raise AssertionError(f"{label} {mode}: masked launches "
                                     f"{got[mode]}, uncompressed "
                                     f"{got['none']}")
    # 2. bytes a round, the rings, peak memory
    log("FLRun uplink bytes a round (2 + 2, helios): " + json.dumps(
        per_round) + "; peak device memory GiB " + json.dumps(
            {k: round(v, 3) for k, v in peak.items()}))
    ratio = per_round["none"] / per_round["topk"]
    if not ratio >= 10.0:
        raise AssertionError(f"topk uplink only {ratio:.2f}x below none")
    g = make_run("afo", "reference", st).global_params
    rings = {mode: AG.SnapshotRing(g, 16, 4, mode=mode, fresh_window=2)
             .nbytes() for mode in ("fp32", "quant", "delta")}
    log(f"topk uplink {ratio:.2f}x below none; snapshot ring bytes at "
        f"snapshot_cap 16, comp_fresh 2, 4 anchors: {json.dumps(rings)}")
    if not max(rings["quant"], rings["delta"]) < rings["fp32"]:
        raise AssertionError(f"lossy ring not smaller than fp32: {rings}")
    # 3. holds at one local step, kernel path against plain path, beside
    # the plain path's drift from its 2^-23-nudged twin under the mode
    for label, eng, scheme, _, drive, keys in COMP_CASES:
        for mode in LOSSY:
            runs, sent = {}, {}
            for name, kernels, nudge in (("cuda", "cuda", 0.0),
                                         ("plain", "reference", 0.0),
                                         ("nudged", "reference", 2.0 ** -23)):
                runs[name] = make_run(scheme, kernels, st, local_steps=1,
                                      nudge=nudge, engine=engines[eng],
                                      compression=mode)
                with CodecTap() as tap:
                    drive(runs[name])
                sent[name] = tap.calls[-1]["sent"]
            drift = _param_diff(runs["plain"], runs["nudged"])
            tol = max(1e-4, 2 * drift)
            diff = _hold_comp(f"{label} {mode}", runs["cuda"], runs["plain"],
                              keys, tol)
            log(f"{label} {mode} hold kernel vs plain {diff:.3e} (tol "
                f"{tol:.1e}, {'2x twin drift' if tol > 1e-4 else '1e-4'}); "
                f"plain vs nudged plain {drift:.3e}; decisions apart at the "
                f"last update: kernel vs plain "
                f"{_sent_differences(sent['cuda'], sent['plain'], mode)}, "
                f"plain vs nudged "
                f"{_sent_differences(sent['plain'], sent['nudged'], mode)}; "
                f"bytes {runs['cuda'].uplink_bytes():.0f} / "
                f"{runs['plain'].uplink_bytes():.0f}")
    # 4. a warmup round is the uncompressed round, bit for bit
    for eng in (None, "BatchedFLRun"):
        warm, dense = (make_run("helios", "cuda", st, local_steps=1,
                                engine=engines[eng], **kw)
                       for kw in (dict(compression="topk", comp_warmup=1),
                                  dict()))
        for run in (warm, dense):
            timed_run(run, 1)
        same = all(torch.equal(warm.global_params[k], v)
                   for k, v in dense.global_params.items())
        log(f"{eng or 'FLRun'} comp_warmup=1: round 0 bit-identical to "
            f"the uncompressed round: {same}; dense updates "
            f"{warm.uplink_dense_updates}")
        if not same or warm.uplink_dense_updates != 4:
            raise AssertionError(f"{eng or 'FLRun'}: the warmup round is "
                                 f"not the uncompressed round")
    # 5. where the time goes: round walls (5 local steps, evaluation off)
    # of each mode on both paths in turns, the codec's device time on a
    # round's own inputs, and a profiled round a mode
    walls = {}
    for mode in ("none",) + LOSSY:
        walls[mode] = {"cuda": [], "reference": []}
        for kernels in ("cuda", "reference", "reference", "cuda"):
            run = make_run("helios", kernels, st, compression=mode)
            timed_run(run, 1, eval_every=0)
            _, wall = timed_run(run, 2, eval_every=0)
            walls[mode][kernels].append(wall / 2)
    log("round wall s helios FLRun 2 + 2 by mode (2 rounds after a warm-up "
        "round): " + json.dumps(walls))
    for mode in LOSSY:
        run = make_run("helios", "cuda", st, compression=mode)
        timed_run(run, 1, eval_every=0)
        with CodecTap() as tap:
            prof = profile_round(run, f"helios round under {mode}",
                                 groups=CODEC_OPS, ranges=("codec",))
        sets = [(c["delta"], c["error"], c["masks"]) for c in tap.calls]
        avail = [{k: (d[k] + e[k]) * m[k] for k in d} for d, e, m in sets]
        parts = {"codec: topk": lambda v: CP._rows_topk(v, 0.05),
                 "codec: quantize passes":
                     lambda v: CP._rows_roundtrip_quant(v, 8),
                 "codec: fp16 round trip": CP._roundtrip_f16}
        need = {"topk": ("codec: topk", "codec: fp16 round trip"),
                "quant": ("codec: quantize passes",),
                "delta": ("codec: topk", "codec: quantize passes")}[mode]

        def replay():
            torch.cuda.synchronize()
            t = time.perf_counter()
            for part in need:
                with torch.profiler.record_function(part):
                    for a in avail:
                        for v in a.values():
                            parts[part](v)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        replay()
        split = profile_round(run, f"codec parts under {mode} (the round's "
                              f"{len(avail)} updates replayed)", replay,
                              ranges=need)
        log(f"codec {mode}: device time a round {prof['codec']:.3f} ms "
            f"(the profiled round's 'codec' ranges, {len(sets)} updates), "
            f"{prof['codec'] / prof['busy_ms']:.4f} of its busy time, "
            f"{prof['codec'] / prof['wall_ms']:.4f} of its wall; parts "
            + ", ".join(f"{p[7:]} {split[p]:.3f} ms" for p in need))
    log(f"phase 4j took {time.perf_counter() - t0:.1f} s")
    return {"single": single, "client": client}


# ---------------------------------------------------------------------------
# phase 3b: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------


def _qkv(b: int, h: int, s: int, hd: int, dtype, g, pad: int = 0):
    """q, k, v as the LM hands them over: (B, S, H, hd) buffers seen as
    (B, H, S, hd) views; ``pad`` widens each buffer's last dim (hd + 1 puts
    every row off the 16-byte grid: the kernel's unaligned variant)."""
    return [torch.randn(b, s, h, hd + pad, device="cuda", generator=g)
            .to(dtype)[..., :hd].transpose(1, 2) for _ in range(3)]


def _check_flash_case(b: int, h: int, s: int, hd: int, causal: bool, dt,
                      gen, pad: int = 0) -> float:
    """One flash call, twice, against its plain version: within tolerance,
    bit-identical on repeat, on the copy variant ``pad`` selects; returns
    the max abs error."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    q, k, v = _qkv(b, h, s, hd, dt, gen, pad)
    before = dict(FA.CONFIG_LAUNCHES)
    y = FA.flash_attention(q, k, v, causal)
    again = FA.flash_attention(q, k, v, causal)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal)
    torch.cuda.synchronize()
    err = float((y.float() - want).abs().max())
    tol = (F32_TOL if dt == torch.float32 else BF16_TOL) * \
        float(want.abs().max())
    variant = "unaligned" if pad else "aligned"
    took = FA.CONFIG_LAUNCHES[variant] - before[variant]
    same = torch.equal(y, again)
    log(f"check flash_attention B={b} H={h} S={s} hd={hd} "
        f"causal={causal} {str(dt)[6:]:8s} [{variant}] "
        f"max|err|={err:.3e} tol={tol:.3e} repeat-identical={same}")
    if not (err <= tol and math.isfinite(err) and same and took == 2):
        raise AssertionError(f"flash_attention disagrees with its "
                             f"plain version: {err} > {tol}, a "
                             f"repeat differs ({same}) or the calls "
                             f"did not take {variant} ({took} of 2)")
    return err


def _check_flash_op(b: int, h: int, s: int, hd: int, g) -> None:
    """The causal autograd op (kernel forward + recompute backward) against
    plain autograd through the dense attention."""
    from repro_torch.kernels import ops
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
        log(f"check flash op {what:2s} ({b}, {h}, {s}, {hd}) max|err|="
            f"{err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"flash op {what} disagrees: {err}")


def check_flash() -> float:
    """The flash kernel and the autograd op against their plain versions;
    returns the worst f32 error at the slice shape."""
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    # every case on 16-byte copies, then the second case off the 16-byte
    # grid (element copies), drawn from a generator of its own
    cases = [(c, 0, g) for c in FLASH_CASES] + [
        (FLASH_CASES[1], 1, torch.Generator(device="cuda").manual_seed(12))]
    for i, (case, pad, gen) in enumerate(cases):
        for dt in (torch.float32, torch.bfloat16):
            err = _check_flash_case(*case, dt, gen, pad)
            if i == 0 and dt == torch.float32:
                worst = err
    # the autograd op at the slice shape
    _check_flash_op(*FLASH_CASES[0][:4], g)
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
                nudge: float = 0.0, engine=None):
    """A token-LM run on the card (``engine`` ``FLRun`` unless given) over
    the 2 + 2 fleet of ``st``, from its host params."""
    from repro_torch.federated import FLRun, make_fleet, setup_clients
    from repro_torch.models.module import tree_map
    cfg, hcfg, train, test, parts, init = st
    clients = setup_clients(make_fleet(2, 2), parts, hcfg, device="cuda")
    if nudge:
        init = tree_map(lambda v: v * (1 + nudge), init)
    return (engine or FLRun)(cfg, hcfg, scheme, clients, train, test,
                             batch_size=LM_BATCH, local_steps=local_steps,
                             lr=0.05, eval_batch=4, kernels=kernels,
                             device="cuda", init_params=init)


def _host_params(run) -> dict:
    from repro_torch.models.module import tree_paths
    return {k: v.detach().cpu() for k, v in tree_paths(run.global_params)}


def _host_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in b)


def _hold_lm(what: str, a_hist, a_host, b_hist, b_host, ulp: bool) -> float:
    """Run ``a`` against run ``b`` (histories and host params): cycle,
    time and volumes identical, ratios identical (``ulp``: within one
    float32 ulp, the batched engine's count × 1/total against FLRun's
    count / total), ce and loss within 1e-4, params within 1e-4."""
    import numpy as np
    if len(a_hist) != len(b_hist):
        raise AssertionError(f"{what}: history lengths differ")
    for x, y in zip(a_hist, b_hist):
        for key in ("cycle", "time", "volumes") + (() if ulp else
                                                    ("ratios",)):
            if x[key] != y[key]:
                raise AssertionError(f"{what}: history {key} differs: "
                                     f"{x[key]} vs {y[key]}")
        if ulp and not np.allclose(x["ratios"], y["ratios"], rtol=2 ** -23,
                                   atol=0):
            raise AssertionError(f"{what}: ratios differ: {x['ratios']} vs "
                                 f"{y['ratios']}")
        if abs(x["ce"] - y["ce"]) > 1e-4 or abs(x["loss"] - y["loss"]) > 1e-4:
            raise AssertionError(f"{what}: ce / loss differ: {x} vs {y}")
    diff = _host_diff(a_host, b_host)
    if not diff <= 1e-4:
        raise AssertionError(f"{what}: params differ by {diff}")
    return diff


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
    configs = dict(K.CONFIG_LAUNCHES)
    log("LM path launches by configuration", json.dumps(configs))
    masked = K.LAUNCHES["masked_matmul"] + K.LAUNCHES["masked_matmul_dk"]
    if configs != {"general": 0, "tile128": masked, "splitk": 0}:
        raise AssertionError(f"LM masked calls not all on tile128: {configs}")
    flash = dict(FA.CONFIG_LAUNCHES)
    log("LM path flash_attention launches by copy variant", json.dumps(flash))
    if flash != {"aligned": FA.LAUNCHES["flash_attention"], "unaligned": 0}:
        raise AssertionError(f"LM flash calls not all on 16-byte copies: "
                             f"{flash}")
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
    # trajectory: hold them to 1e-4 over two rounds of one step.
    host, hists = {}, {}
    for name, kernels in (("cuda", "cuda"), ("plain", "reference")):
        run = make_lm_run("helios", kernels, st, local_steps=1)
        hists[name], _ = timed_run(run, 2)
        host[name] = _host_params(run)
        del run
        _free()
    diff = _host_diff(host["cuda"], host["plain"])
    log(f"LM helios 2 rounds x 1 local step, lr 0.05: max|param diff| "
        f"kernel vs plain {diff:.3e}")
    _hold_lm("LM kernel vs plain", hists["cuda"], host["cuda"],
             hists["plain"], host["plain"], False)
    del host
    return launches


# ---------------------------------------------------------------------------
# phase 5b: LM timing
# ---------------------------------------------------------------------------


def _bwd_ms(op, sets, n_out_args: int) -> float:
    """Event time of the autograd op's forward and recompute backward over
    rotating operand sets, less the forward alone: the backward's share of
    a call as the host issues it."""
    g = torch.Generator(device="cuda").manual_seed(7)
    grads = [torch.randn(op(*s).shape, device="cuda", generator=g)
             for s in sets]

    def step(*args):
        leaves = [t.detach().requires_grad_(True) for t in args[:n_out_args]]
        y = op(*leaves)
        torch.autograd.grad(y, leaves, grads[args[-1]])

    indexed = [(*s, i) for i, s in enumerate(sets)]
    both = _time_ms(step, indexed)
    fwd = _time_ms(lambda *a: op(*a[:n_out_args]), indexed)
    return both - fwd


def _flash_times(b: int, h: int, s: int, hd: int, causal: bool,
                 seed: int) -> tuple:
    """The flash kernel, its plain version and PyTorch's SDPA (a yardstick
    the port never calls) at one shape, f32: device time (calls enqueued
    while the card sleeps), event time as issued, the recompute backward's
    event time, and the bounds.  Returns (times, bounds, FLOP)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = [tuple(_qkv(b, h, s, hd, torch.float32, g)) for _ in range(3)]
    kern = lambda q, k, v: FA.flash_attention(q, k, v, causal)
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=causal)
    t = {"ms": _device_ms(kern, sets), "wall_ms": _time_ms(kern, sets),
         "library_ms": _device_ms(sdpa, sets),
         "library_wall_ms": _time_ms(sdpa, sets),
         "plain_ms": _time_ms(lambda q, k, v: ref.flash_attention_ref(
             q, k, v, causal), sets)}
    t["recompute_bwd_ms"] = _bwd_ms(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=causal), sets, 3)
    pairs = s * (s + 1) // 2 if causal else s * s   # (query, key) pairs
    flops = 4 * hd * pairs * b * h                  # q·kᵀ and p·v
    bd = _bounds(flops, 4 * 4 * b * h * s * hd)     # q, k, v read; o written
    return t, bd, flops


def _flash_line(shape: tuple, t: dict, bd: dict, flops: float,
                per_round: int) -> None:
    b, h, s, hd, _ = shape
    bwd = t["recompute_bwd_ms"]
    log(f"time flash_attention B={b} H={h} S={s} hd={hd} causal f32: "
        f"device {t['ms']:.4f} ms (sdpa {t['library_ms']:.4f}); as issued "
        f"{t['wall_ms']:.4f} (sdpa {t['library_wall_ms']:.4f}, plain "
        f"{t['plain_ms']:.4f}); bound {bd['bound_ms']:.4f} by "
        f"{bd['bound_by']} on the 3xTF32 route (bytes {bd['bytes_ms']:.4f}, "
        f"ops {bd['tf32x3_ops_ms']:.4f}), {bd['bound_f32_ms']:.4f} on f32 "
        f"FMA; {flops / t['ms'] / 1e9:.1f} TFLOP/s; faster than sdpa: "
        f"{'yes' if t['ms'] < t['library_ms'] else 'no'}; recompute "
        f"backward {bwd:.4f} ms a call, {bwd * per_round:.3f} ms a round "
        f"({per_round} calls)")


def time_flash(worst: float, launches: int, per_round: int) -> dict:
    """The flash kernel against its plain version and SDPA at the LM
    slice's shape, and the recompute backward, a call and a round."""
    t, bd, flops = _flash_times(*FLASH_CASES[0], seed=3)
    _flash_line(FLASH_CASES[0], t, bd, flops, per_round)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:70",
            "launches": launches, "max_abs_err": worst, **t,
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "bound_f32_ms": bd["bound_f32_ms"],
            "recompute_bwd_ms_per_round": t["recompute_bwd_ms"] * per_round}


def time_lm_mlp() -> dict:
    """The masked-matmul pair in each of the LM MLP's six layouts at P 0.5
    and 1.0, f32; returns the P = 0.5 times per kernel and layout."""
    g = torch.Generator(device="cuda").manual_seed(4)
    out = {"masked_matmul": {}, "masked_matmul_dk": {}}
    for label, kernel, m, k, n, xl, wl in LM_MLP:
        for p in (0.5, 1.0):
            t = _time_call(f"LM {label}", kernel, m, k, n, xl, wl, p, g, 1)
            if p == 0.5:
                out[kernel][label] = t
            _free()
    return out


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


def _ssd_inputs(b, nc, L, ds, nh, hd, dtype, g, model_decay=False,
                pad=0):
    """cr, br, dtx ~ N(0, 1) in ``dtype``; a decreasing cumulative
    log-decay in f32: the reference test's (|N| · 0.1 a step) or the
    model's at initialisation (softplus(N) · A with A = -1).  ``pad``
    widens the last dim of each buffer (1 puts br's and dtx's rows off the
    16-byte grid: the kernel's unaligned variant)."""
    cr, br = (torch.randn(b, nc, L, ds + pad, device="cuda", generator=g)
              .to(dtype)[..., :ds] for _ in range(2))
    a = torch.randn(b, nc, L, nh, device="cuda", generator=g)
    a = -torch.nn.functional.softplus(a) if model_decay else -a.abs() * 0.1
    dtx = torch.randn(b, nc, L, nh, hd + pad, device="cuda",
                      generator=g).to(dtype)[..., :hd]
    return cr, br, torch.cumsum(a, dim=2), dtx


def _check_ssd_case(shape: tuple, dt, model_decay: bool, pad: int,
                    gen) -> float:
    """One ssd_diag call, twice, against its plain version: within
    tolerance, finite, bit-identical on repeat, on the copy variant ``pad``
    selects; returns the max abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SS
    cr, br, cum, dtx = _ssd_inputs(*shape, dt, gen, model_decay, pad)
    before = dict(SS.CONFIG_LAUNCHES)
    y = SS.ssd_diag(cr, br, cum, dtx)
    again = SS.ssd_diag(cr, br, cum, dtx)
    want = ref.ssd_diag_ref(cr.float(), br.float(), cum, dtx.float())
    torch.cuda.synchronize()
    err = float((y.float() - want).abs().max())
    tol = (F32_TOL if dt == torch.float32 else BF16_TOL) * \
        max(1.0, float(want.abs().max()))
    variant = "unaligned" if pad else "aligned"
    took = SS.CONFIG_LAUNCHES[variant] - before[variant]
    same = torch.equal(y, again)
    log(f"check ssd_diag (B, nc, L, ds, nh, hd)={shape} "
        f"{str(dt)[6:]:8s} {'model decay' if model_decay else ''} "
        f"[{variant}] max|err|={err:.3e} tol={tol:.3e} "
        f"repeat-identical={same}")
    if not (err <= tol and math.isfinite(err) and same and took == 2
            and bool(torch.isfinite(y).all())):
        raise AssertionError(f"ssd_diag disagrees with its plain "
                             f"version: {err} > {tol}, a repeat differs "
                             f"({same}) or the calls did not take "
                             f"{variant} ({took} of 2)")
    return err


def check_ssd() -> float:
    """The ssd_diag kernel and the autograd op against their plain
    versions; returns the worst f32 error at the slice shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SS
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    cases = [(c, dt, False, 0, g) for c in SSD_CASES
             for dt in (torch.float32, torch.bfloat16)]
    cases.append((SSD_CASES[0], torch.float32, True, 0, g))
    # the ragged case off the 16-byte grid (element copies), drawn from a
    # generator of its own
    g_pad = torch.Generator(device="cuda").manual_seed(15)
    cases += [(SSD_CASES[1], dt, False, 1, g_pad)
              for dt in (torch.float32, torch.bfloat16)]
    for i, (shape, dt, model_decay, pad, gen) in enumerate(cases):
        err = _check_ssd_case(shape, dt, model_decay, pad, gen)
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
    """Zamba2-1.2B at full width, ``HY_LAYERS`` Mamba2 layers, on the LM's
    data."""
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
    from repro_torch.kernels import ssd_scan as SS
    variants = dict(SS.CONFIG_LAUNCHES)
    log("hybrid path ssd_diag launches by copy variant", json.dumps(variants))
    if variants != {"aligned": want["ssd_diag"], "unaligned": 0}:
        raise AssertionError(f"hybrid ssd_diag calls not all on 16-byte "
                             f"copies: {variants}")
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
    # two rounds of one local step, kernel path against plain path
    host, hists = {}, {}
    for name, kernels in (("cuda", "cuda"), ("plain", "reference")):
        run = make_lm_run("helios", kernels, st, local_steps=1)
        hists[name], _ = timed_run(run, 2)
        host[name] = _host_params(run)
        del run
        _free()
    diff = _host_diff(host["cuda"], host["plain"])
    log(f"hybrid helios 2 rounds x 1 local step, lr 0.05: max|param diff| "
        f"kernel vs plain {diff:.3e}")
    _hold_lm("hybrid kernel vs plain", hists["cuda"], host["cuda"],
             hists["plain"], host["plain"], False)
    del host
    return launches


# ---------------------------------------------------------------------------
# phase 5c: hybrid timing
# ---------------------------------------------------------------------------


def time_ssd(worst: float, launches: int, per_round: int,
             shape: tuple = SSD_CASES[0], name: str = "ssd_diag",
             seed: int = 6) -> dict:
    """The ssd_diag kernel and its plain version at ``shape`` (the slice's
    unless given), f32: device time (calls enqueued while the card sleeps),
    event time as issued, and the recompute backward of the autograd op.
    No single PyTorch call computes this function."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as SS
    b, nc, L, ds, nh, hd = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = [_ssd_inputs(b, nc, L, ds, nh, hd, torch.float32, g, True)
            for _ in range(3)]               # 3 x 36 MB: more than the L2
    t = {"ms": _device_ms(SS.ssd_diag, sets),
         "wall_ms": _time_ms(SS.ssd_diag, sets),
         "plain_ms": _time_ms(ref.ssd_diag_ref, sets)}
    bwd = _bwd_ms(lambda *a: ops.ssd_diag(*a), sets, 4)
    pairs = L * (L + 1) // 2                 # (l, m) pairs with m <= l
    # the least work: C·Bᵀ once per (batch, chunk), it has no head axis
    # (the kernel does so), the decayed product once per head
    flops = 2 * pairs * b * nc * (ds + nh * hd)
    bd = _bounds(flops, 4 * (2 * b * nc * L * ds + b * nc * L * nh
                             + 2 * b * nc * L * nh * hd))  # in; y out
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:39",
           "launches": launches, "max_abs_err": worst, **t,
           "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
           "bound_f32_ms": bd["bound_f32_ms"], "library_ms": None,
           "recompute_bwd_ms": bwd, "recompute_bwd_ms_per_round":
               bwd * per_round}
    log(f"time ssd_diag (B, nc, L, ds, nh, hd)={shape} f32: device "
        f"{t['ms']:.4f} ms; as issued {t['wall_ms']:.4f} (plain {t['plain_ms']:.4f}); "
        f"bound {bd['bound_ms']:.4f} by {bd['bound_by']} on the 3xTF32 "
        f"route (bytes {bd['bytes_ms']:.4f}, ops {bd['tf32x3_ops_ms']:.4f})"
        f", {bd['bound_f32_ms']:.4f} on f32 FMA; {flops / t['ms'] / 1e9:.1f}"
        f" TFLOP/s of least work; recompute backward {bwd:.4f} ms a call, "
        f"{bwd * per_round:.3f} ms a round ({per_round} calls)")
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


# ---------------------------------------------------------------------------
# phases 3e, 4h and 5d: the MoE path (Granite-3.0-1B-A400M)
# ---------------------------------------------------------------------------

#: the MoE slice's flash calls, (B, H, S, hd, causal): Granite's 8 KV heads
#: are repeated onto its 16 query heads before the kernel
GR_FLASH = (LM_BATCH, 16, LM_SEQ, 64, True)
#: device memory the MoE path may hold before its depth must be cut
GR_PEAK_GIB = 76.0
#: the MoE slice: Granite-3.0-1B-A400M width, depth cut 24 -> 6 (the whole
#: script's time limit: at 24 layers the phase took ~126 s)
GR_LAYERS = 6
#: the largest k-th / (k+1)-th router probability gap at which the kernel
#: path and the plain path may choose different experts for a token
FLIP_GAP = 1e-5
#: device ops of the router's top-k and the grouped dispatch (the
#: embedding's gather and backward and the loss's gather match too)
DISPATCH_OPS = (("routing + dispatch (sort / index / scatter / gather)",
                 ("sort", "Sort", "index", "Index", "scatter", "gather")),)


def check_granite_flash() -> float:
    """The flash kernel at the MoE path's shape, f32 and bf16, against its
    plain version, and the autograd op; returns the f32 error."""
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator(device="cuda").manual_seed(21)
    worst = _check_flash_case(*GR_FLASH, torch.float32, g)
    _check_flash_case(*GR_FLASH, torch.bfloat16, g)
    _check_flash_op(*GR_FLASH[:4], g)
    FA.reset_launches()
    return worst


def granite_setting():
    """Granite-3.0-1B-A400M at full width, ``GR_LAYERS`` layers, on the
    LM's data."""
    from repro_torch.configs import GRANITE_MOE_1B_A400M, HeliosConfig
    from repro_torch.data.federated import partition_by_topic
    from repro_torch.data.synthetic import markov_topic_tokens
    from repro_torch.models import init_params
    from repro_torch.models.module import tree_leaves
    cfg = dataclasses.replace(GRANITE_MOE_1B_A400M, num_layers=GR_LAYERS)
    tokens, topics = markov_topic_tokens(256, LM_SEQ, LM_VOCAB, n_topics=8)
    test_tokens, _ = markov_topic_tokens(16, LM_SEQ, LM_VOCAB, n_topics=8,
                                         seed=9)
    parts = partition_by_topic(topics, 4, topics_per_client=2)
    log(f"Granite config: {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads x {cfg.resolved_head_dim} over "
        f"{cfg.num_kv_heads} KV heads, {cfg.num_experts} experts of "
        f"{cfg.moe_d_ff} hidden units, top-{cfg.num_experts_per_tok}, tied "
        f"embeddings, vocab {cfg.vocab_size} padded to {cfg.padded_vocab}), "
        f"depth cut from {GRANITE_MOE_1B_A400M.num_layers} to "
        f"{cfg.num_layers} layers; batch {LM_BATCH} x {LM_SEQ} tokens over a "
        f"data vocab of "
        f"{LM_VOCAB}; a 2 + 2 Table-I fleet, 2 local steps, lr 0.05")
    t0 = time.perf_counter()
    init = init_params(cfg, 0, "cpu")        # host copy, reused by every run
    log(f"Granite params {sum(v.numel() for v in tree_leaves(init)) / 1e9:.4f}"
        f" B, drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, HeliosConfig(mask_block=BLOCK), {"tokens": tokens}, \
        {"tokens": test_tokens}, parts, init


class RouteTap:
    """A script-side instrument on the port's top-k routing
    (``repro_torch.models.moe.top_k``), patched in for one ``use`` block.

    ``record`` queues each call's router probabilities and choices.
    ``replay`` hands each call the oldest queued choices instead of its
    own, gathering its own probabilities there; ``compare`` leaves the
    call's own choices in place.  Both keep, for each call, the tokens
    whose own top-k set differs from the queued one (routing flips), the
    queued and the own k-th / (k+1)-th probability gaps, and each token's
    largest probability change."""

    def __init__(self):
        self.queue = collections.deque()
        self.seen = []

    @contextlib.contextmanager
    def use(self, mode: str):
        from repro_torch.models import moe
        orig = moe.top_k

        def gap(p, k):
            v = torch.sort(p.detach(), dim=-1, descending=True).values
            return v[:, k - 1] - v[:, k]

        def tap(probs, k):
            w, idx = orig(probs, k)
            if mode == "record":
                self.queue.append((probs.detach(), idx))
                return w, idx
            rp, ridx = self.queue.popleft()
            differs = (torch.sort(idx, dim=-1).values
                       != torch.sort(ridx, dim=-1).values).any(dim=-1)
            self.seen.append((differs, gap(rp, k), gap(probs, k),
                              (probs.detach() - rp).abs().amax(dim=-1)))
            if mode == "compare":
                return w, idx
            return probs.gather(-1, ridx), ridx

        moe.top_k = tap
        try:
            yield self
        finally:
            moe.top_k = orig

    def report(self, label: str, layers: int, k: int, gate: bool) -> None:
        """Print the flips; with ``gate``, fail on one at a gap above
        ``FLIP_GAP``."""
        if self.queue:
            raise AssertionError(f"{label}: {len(self.queue)} recorded "
                                 f"routings were not replayed")
        decisions = sum(int(f[0].shape[0]) for f in self.seen)
        found = []
        for at, (differs, gp, gk, _) in enumerate(self.seen):
            for t in differs.nonzero().flatten().tolist():
                found.append((at, t, float(gp[t]), float(gk[t])))
        # a token's k-th / (k+1)-th gap moves by at most twice its largest
        # probability change, so only tokens moved by more than half the
        # gate can flip above it
        dp, at_dp = max((float(f[3].max()), at)
                        for at, f in enumerate(self.seen))
        moved = sum(int((f[3] > FLIP_GAP / 2).sum()) for f in self.seen)
        log(f"{label}: {decisions} top-{k} routing decisions over "
            f"{len(self.seen)} router calls; max|router prob diff| "
            f"{dp:.3e} (router call {at_dp}, layer {at_dp % layers}); "
            f"tokens moved by more than {FLIP_GAP / 2:g}: {moved}; flips "
            f"(the top-{k} sets differ): {len(found)}")
        for at, t, gp, gk in found:
            log(f"  flip: router call {at} (layer {at % layers}), token {t}: "
                f"k-th/(k+1)-th probability gap {gp:.3e} on the recorded "
                f"path, {gk:.3e} on the other")
        worst = max((gp for _, _, gp, _ in found), default=0.0)
        if gate and worst > FLIP_GAP:
            raise AssertionError(f"{label}: a routing flip at a gap of "
                                 f"{worst} > {FLIP_GAP}")


def shadow_plain_routing(run, tap: RouteTap, cross: RouteTap) -> None:
    """Make each local step of ``run`` (the kernel path) take the plain
    path's expert choices from the same params and batch: a plain forward
    without grad records them (``cross`` compares them with another run's
    recorded choices, in step order), then the kernel forward replays
    them."""
    ad = run.adapter
    plain_rt = {**ad.rt, "kernels": "reference"}
    kernel_loss = ad.loss_fn

    def loss_fn(params, batch, masks):
        with torch.no_grad(), tap.use("record"), cross.use("compare"):
            ad.api.loss_fn(params, batch, ad.cfg, plain_rt, masks)
        with tap.use("replay"):
            return kernel_loss(params, batch, masks)

    ad.loss_fn = loss_fn


def record_routing(run, tap: RouteTap) -> None:
    """Record the expert choices of each local step of ``run``."""
    ad = run.adapter
    loss = ad.loss_fn

    def loss_fn(params, batch, masks):
        with tap.use("record"):
            return loss(params, batch, masks)

    ad.loss_fn = loss_fn


def check_moe_step(st, params, strag_masks, label: str) -> None:
    """One full-size MoE training step, kernel path against plain path
    from the same params and batch, the plain path's expert choices
    replayed into the kernel path: loss and every gradient within 1e-4
    relative, with a straggler's Eq. 2 masks and with full masks."""
    from repro_torch.models import make_full_masks, transformer
    from repro_torch.models.module import tree_paths
    cfg, _, train, _, _, _ = st
    moe_layers = cfg.num_layers - cfg.first_k_dense
    batch = {"tokens": torch.as_tensor(train["tokens"][:LM_BATCH]).cuda()}
    for who, masks in (("straggler", strag_masks),
                       ("capable", make_full_masks(cfg, "cuda"))):
        out, tap = {}, RouteTap()
        for kernels, mode in (("reference", "record"), ("cuda", "replay")):
            leaves = dict(tree_paths(params))
            for v in leaves.values():
                v.requires_grad_(True)
            rt = transformer.default_runtime()
            rt["kernels"], rt["mask_block"] = kernels, BLOCK
            with tap.use(mode):
                loss = transformer.lm_loss(params, batch, cfg, rt, masks)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            for v in leaves.values():
                v.requires_grad_(False)
            out[kernels] = (float(loss.detach()), dict(zip(leaves, grads)))
            del grads, loss
        tap.report(f"{label} step {who}, plain choices replayed",
                   moe_layers, cfg.num_experts_per_tok, gate=True)
        (la, ga), (lb, gb) = out["cuda"], out["reference"]
        finite = all(bool(torch.isfinite(v).all()) for v in ga.values())
        worst, at = max((float((ga[k] - gb[k]).abs().max())
                         / max(float(gb[k].abs().max()), 1e-30), k)
                        for k in gb)
        log(f"{label} step {who}: loss {la:.7f} vs {lb:.7f}, worst max|grad "
            f"diff|/max|grad| {worst:.3e} ({at}), all finite {finite}")
        if not (finite and abs(la - lb) <= F32_TOL * abs(lb)
                and worst <= F32_TOL):
            raise AssertionError(f"{label} {who} step: kernel path disagrees "
                                 f"with the plain path ({worst} at {at})")
        del out, ga, gb, tap
        _free()


def check_granite_dispatch(st, params, strag_masks) -> None:
    """``moe_fwd`` grouped against dense on the middle layer's activations
    at full width, at a capacity factor of E / k (every expert has a slot
    for every token, so nothing overflows), without a mask and with a
    straggler's expert mask; and how many choices the default capacity
    factor of 1.25 drops there."""
    from repro_torch.models import moe, transformer
    cfg, _, train, _, _, _ = st
    layer = cfg.num_layers // 2
    batch = {"tokens": torch.as_tensor(train["tokens"][:LM_BATCH]).cuda()}
    seen, orig = [], moe.moe_fwd

    def grab(p, x, c, **kw):
        seen.append((p, x))
        return orig(p, x, c, **kw)

    moe.moe_fwd = grab
    try:
        with torch.no_grad():
            transformer.lm_loss(params, batch, cfg,
                                transformer.default_runtime(), None)
    finally:
        moe.moe_fwd = orig
    p, h = seen[layer]
    del seen
    cf = cfg.num_experts / cfg.num_experts_per_tok
    t = h.shape[0] * h.shape[1]
    for who, em in (("no mask", None),
                    ("straggler mask", strag_masks["experts"][layer])):
        with torch.no_grad():
            got = moe.moe_fwd(p, h, cfg, expert_mask=em, impl="grouped",
                              capacity_factor=cf)
            want = moe.moe_fwd(p, h, cfg, expert_mask=em, impl="dense")
            _, idx = moe._route(p, h.reshape(t, -1), cfg, em)
        err = float((got - want).abs().max())
        tol = F32_TOL * float(want.abs().max())
        counts = torch.zeros(cfg.num_experts, dtype=torch.long,
                             device="cuda").index_add_(
            0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
        cap = moe.capacity(t, cfg, 1.25)
        over = int((counts - cap).clamp(min=0).sum())
        log(f"check moe_fwd grouped (capacity factor {cf:g}, {t} slots an "
            f"expert) against dense, layer {layer}, {who}: max|err|="
            f"{err:.3e} tol={tol:.3e}; at capacity factor 1.25 ({cap} "
            f"slots) {over} of {t * cfg.num_experts_per_tok} choices "
            f"overflow")
        if not (err <= tol and math.isfinite(err)):
            raise AssertionError(f"grouped dispatch disagrees with dense "
                                 f"({who}): {err} > {tol}")
        del got, want
    _free()


def granite_path(st) -> dict:
    """Helios then syn, two rounds each, on the kernel path with every
    kernel's counter zeroed before and read after; then the one-step and
    two-round holds against the plain path, the plain path's expert
    choices replayed into the kernel path."""
    from repro_torch.models.module import tree_paths
    cfg = st[0]
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    hel = None
    for scheme in ("helios", "syn"):
        run = make_lm_run(scheme, "cuda", st)
        hist, wall = timed_run(run, 2)
        log(f"Granite path {scheme}: 2 rounds in {wall:.3f} s")
        for row in hist:
            log("  history", json.dumps(row))
            if not (math.isfinite(row["loss"]) and math.isfinite(row["ce"])):
                raise AssertionError(f"Granite {scheme}: non-finite loss or "
                                     f"ce in {row}")
        for k, v in tree_paths(run.global_params):
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"Granite {scheme}: non-finite {k}")
        if scheme == "helios":
            hel = run
        del run
    launches = _all_launches()
    log("Granite path launches", json.dumps(launches))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"Granite path peak device memory {peak:.2f} GiB "
        f"({cfg.num_layers} layers)")
    # each local step of each client runs every layer's attention once
    per_round = cfg.num_layers * 2 * 4
    want = {"masked_matmul": 0, "masked_matmul_dk": 0,
            "flash_attention": 4 * per_round, "ssd_diag": 0}
    if launches != want:
        raise AssertionError(f"Granite path launches {launches}, want {want}"
                             f" ({per_round} flash a round; the MoE block "
                             f"takes no kernel, as in the reference)")
    from repro_torch.kernels import flash_attention as FA
    flash = dict(FA.CONFIG_LAUNCHES)
    log("Granite path flash_attention launches by copy variant",
        json.dumps(flash))
    if flash != {"aligned": want["flash_attention"], "unaligned": 0}:
        raise AssertionError(f"Granite flash calls not all on 16-byte "
                             f"copies: {flash}")
    if peak > GR_PEAK_GIB:
        raise AssertionError(f"Granite path peak {peak:.2f} GiB passes "
                             f"{GR_PEAK_GIB} GiB: cut its depth")
    strag = [r for c, r in zip(hel.clients, hel.history[-1]["ratios"])
             if c.is_straggler]
    if not strag or max(strag) >= 1.0:
        raise AssertionError(f"Granite helios straggler ratios not below 1: "
                             f"{strag}")
    strag_masks = next(c for c in hel.clients
                       if c.is_straggler).helios_state["masks"]
    params = hel.global_params
    del hel
    _free()
    check_moe_step(st, params, strag_masks, "Granite")
    check_granite_dispatch(st, params, strag_masks)
    del params
    _free()
    # Two rounds of one local step.  After the first aggregation the two
    # runs' params differ by rounding too, and the router amplifies that
    # (its weights move along the hidden states it multiplies), so each
    # kernel-path step replays the plain path's choices from the same
    # params and batch; those are also compared, ungated, with the plain
    # run's own choices.
    host, hists, tap, cross = {}, {}, RouteTap(), RouteTap()
    for name, kernels in (("plain", "reference"), ("cuda", "cuda")):
        run = make_lm_run("helios", kernels, st, local_steps=1)
        if name == "plain":
            record_routing(run, cross)
        else:
            shadow_plain_routing(run, tap, cross)
        hists[name], _ = timed_run(run, 2)
        host[name] = _host_params(run)
        del run
        _free()
    k = cfg.num_experts_per_tok
    tap.report("Granite helios 2 rounds x 1 local step, each step's plain "
               "choices from the same params replayed into the kernel "
               "path", cfg.num_layers, k, gate=True)
    cross.report("Granite helios 2 rounds x 1 local step, the plain run's "
                 "choices against the plain path's on the kernel run's "
                 "params (ungated)", cfg.num_layers, k, gate=False)
    diff = _host_diff(host["cuda"], host["plain"])
    log(f"Granite helios 2 rounds x 1 local step, lr 0.05, plain choices "
        f"replayed: max|param diff| kernel vs plain {diff:.3e}")
    del host, tap, cross
    _free()
    if not diff <= 1e-4:
        raise AssertionError(f"Granite kernel path drifts from the plain "
                             f"path: {diff}")
    for x, y in zip(hists["cuda"], hists["plain"]):
        for key in ("cycle", "time", "volumes", "ratios"):
            if x[key] != y[key]:
                raise AssertionError(f"Granite history {key} differs: "
                                     f"{x[key]} vs {y[key]}")
        if abs(x["ce"] - y["ce"]) > 1e-4 or abs(x["loss"] - y["loss"]) > 1e-4:
            raise AssertionError(f"Granite history ce/loss differ: {x} vs "
                                 f"{y}")
    log(f"Granite phase peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return launches


def time_granite_flash(worst: float, launches: int, per_round: int) -> dict:
    """The flash kernel against its plain version and SDPA at the MoE
    path's shape, beside the bounds, and the recompute backward."""
    t, bd, flops = _flash_times(*GR_FLASH, seed=23)
    _flash_line(GR_FLASH, t, bd, flops, per_round)
    return {"shape": list(GR_FLASH[:4]), "launches": launches,
            "max_abs_err": worst, **t, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "bound_f32_ms": bd["bound_f32_ms"],
            "recompute_bwd_ms_per_round": t["recompute_bwd_ms"] * per_round}


def time_granite_round(st) -> None:
    """One helios Granite round (no evaluation), kernel path against plain
    path in turns, then one kernel-path round under the profiler."""
    walls = {"cuda": [], "reference": []}
    for kernels in ("cuda", "reference", "reference", "cuda"):
        run = make_lm_run("helios", kernels, st)
        timed_run(run, 1, eval_every=0)                  # warm-up round
        _, wall = timed_run(run, 1, eval_every=0)
        walls[kernels].append(wall)
        if kernels == "cuda" and len(walls["cuda"]) == 2:
            profile_round(run, "helios Granite round", host_top=8,
                          groups=DISPATCH_OPS)
        del run
        _free()
    log("Granite round wall s helios (1 round after a warm-up round): "
        + json.dumps(walls))


def granite_phase(kernels: list) -> None:
    """Phases 3e, 4h and 5d; adds the MoE path's flash launches and its
    shape's times to the flash row of ``kernels``."""
    t0 = time.perf_counter()
    worst = check_granite_flash()
    st = granite_setting()
    launches = granite_path(st)
    per_round = launches["flash_attention"] // 4
    gr = time_granite_flash(worst, launches["flash_attention"], per_round)
    time_granite_round(st)
    row = next(k for k in kernels if k["name"] == "flash_attention")
    row["launches_by_path"] = {"lm": row["launches"],
                               "granite": launches["flash_attention"]}
    row["launches"] += launches["flash_attention"]
    row["granite"] = gr
    log(f"Granite phase took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 4k: the serving plane
# ---------------------------------------------------------------------------

#: the standalone generation cell: batch, prompt, generated tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 32
SERVE_MODELS = ("deepseek-7b", "zamba2-1.2b", "granite-moe-1b-a400m")
#: serve while training: Zamba2 width cut to this many Mamba2 layers (the
#: publish through zlib, ~17 MB/s on a host core, sets the phase's time)
SWT_LAYERS = 2
#: its rounds: a publish each and the initial one
SWT_ROUNDS = 1
#: the offered rate: a request takes ~35 ms on the card while training
#: runs, so 10 Hz loads the serving thread to about a third between
#: restores; requests that arrive during a restore (seconds, on the same
#: thread) still queue, which the latency percentiles show and the
#: service percentiles do not
SWT_RATE_HZ = 10.0


def _serve_cli(arch: str, kernels: str) -> dict:
    """``repro_torch.launch.serve.main`` at the serving cell, with every
    kernel counter zeroed before and read after."""
    from repro_torch.launch import serve as SV
    report = {}
    _reset_all()
    SV.main(["--arch", arch, "--batch", str(SERVE_BATCH), "--prompt-len",
             str(SERVE_PROMPT), "--gen", str(SERVE_GEN), "--kernels",
             kernels], report=report)
    report["launches"] = _all_launches()
    return report


def _forced(srv, params, batch, toks, steps: int) -> tuple:
    """Prefill the prompt, then decode the generated tokens ``toks[:, :steps]``
    one at a time: (prefill logits, [each step's logits])."""
    from repro_torch.launch import serve as SV
    logits, cache = srv.prefill(params, batch)
    cache = SV.pad_cache(cache, cache["pos"] + SERVE_GEN)
    out = []
    for i in range(steps):
        lg, cache = srv.decode(params, toks[:, i:i + 1], cache)
        out.append(lg)
    del cache
    return logits, out


def _full_prefill(srv, params, batch, toks, steps: int) -> torch.Tensor:
    """Last-position logits of one prefill over the prompt (after a VLM's
    image prefix) and the first ``steps`` generated tokens."""
    seq = torch.cat([batch["tokens"], toks[:, :steps]], dim=1)
    return srv.prefill(params, {**batch, "tokens": seq})[0]


def _nudge(params, factor: float) -> None:
    from repro_torch.models.module import tree_leaves
    with torch.no_grad():
        for v in tree_leaves(params):
            v.mul_(factor)


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


class _RouterLog:
    """Records each call of the port's top-k routing (probabilities and
    choices) inside ``use()``."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def use(self):
        from repro_torch.models import moe
        orig = moe.top_k

        def tap(probs, k):
            w, idx = orig(probs, k)
            self.calls.append((probs.detach(), idx))
            return w, idx

        moe.top_k = tap
        try:
            yield self
        finally:
            moe.top_k = orig


def _routing_flips(dec: _RouterLog, full: _RouterLog, layers: int, k: int,
                   positions: int) -> None:
    """Hold the routing of prefill + decode steps against one prefill over
    the same tokens, position by position: flips (the top-k sets differ)
    at a probability gap above ``FLIP_GAP`` fail."""
    b = SERVE_BATCH
    flips, worst_gap, dp = [], 0.0, 0.0
    for layer in range(layers):
        own = [dec.calls[layer]] + [dec.calls[layers * (1 + s) + layer]
                                    for s in range(positions - SERVE_PROMPT)]
        probs = torch.cat([p.reshape(b, -1, p.shape[-1]) for p, _ in own], 1)
        idx = torch.cat([i.reshape(b, -1, k) for _, i in own], 1)
        rp, ri = full.calls[layer]
        rp = rp.reshape(b, -1, rp.shape[-1])[:, :positions]
        ri = ri.reshape(b, -1, k)[:, :positions]
        differs = (torch.sort(idx, -1).values
                   != torch.sort(ri, -1).values).any(-1)
        srt = torch.sort(rp, -1, descending=True).values
        gap = srt[..., k - 1] - srt[..., k]
        dp = max(dp, _max_diff(probs, rp))
        for bi, pi in differs.nonzero().tolist():
            flips.append((layer, bi, pi, float(gap[bi, pi])))
    log(f"  routing, prefill + decode against one prefill over the same "
        f"{positions} positions ({layers} layers, top-{k}): max|router prob "
        f"diff| {dp:.3e}, flips {len(flips)}")
    for layer, bi, pi, g in flips[:20]:
        log(f"    flip: layer {layer}, row {bi}, position {pi}, k-th/(k+1)-th"
            f" gap {g:.3e}")
    worst_gap = max((f[3] for f in flips), default=0.0)
    if worst_gap > FLIP_GAP:
        raise AssertionError(f"serving routing flip at a gap of {worst_gap} "
                             f"> {FLIP_GAP}")


def _serve_readings(srv, params, batch, toks) -> dict:
    """Prefill ms and decode ms a token by CUDA events after a warm-up,
    beside the decode step's byte bound: the params and the live cache
    (attention K / V up to the step's position, the SSM states) read once
    a token."""
    from repro_torch.launch import serve as SV
    from repro_torch.models.module import tree_leaves
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    srv.prefill(params, batch)                        # warm-up
    ev[0].record()
    logits, cache = srv.prefill(params, batch)
    ev[1].record()
    p0 = cache["pos"]                 # the prompt, after a VLM's prefix
    cache = SV.pad_cache(cache, p0 + SERVE_GEN)
    steps = SERVE_GEN - 1
    ev[2].record()
    for i in range(steps):
        _, cache = srv.decode(params, toks[:, i:i + 1], cache)
    ev[3].record()
    ev[3].synchronize()
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = ev[2].elapsed_time(ev[3]) / steps
    p_bytes = sum(v.numel() * v.element_size() for v in tree_leaves(params))

    def cache_bytes(node, pos):
        """What a step at ``pos`` reads: the self-attention leaves (K / V,
        MLA's latent and RoPE key) up to ``pos``, the rest whole (the SSM
        states, an encoder-decoder's cross K / V, passed with ``pos``
        None)."""
        if isinstance(node, dict):
            total = 0
            for k, v in node.items():
                if k == "pos":
                    continue
                if pos is not None and k in SV.CACHE_SEQ_AXIS:
                    ax = SV.CACHE_SEQ_AXIS[k]
                    total += v.element_size() * v.numel() // v.shape[ax] \
                        * (pos + 1)
                else:
                    total += cache_bytes(v, None if k == "cross" else pos)
            return total
        if isinstance(node, (list, tuple)):
            return sum(cache_bytes(v, pos) for v in node)
        return node.numel() * node.element_size()

    live = [cache_bytes(cache, p0 + i) for i in range(steps)]
    bound_ms = (p_bytes + sum(live) / steps) / PEAK_BYTES * 1e3
    # four decode steps under the profiler: device busy time, idle share
    # and the kernels a step launches
    from torch.profiler import ProfilerActivity, profile
    cache["pos"] = p0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(4):
            _, cache = srv.decode(params, toks[:, i:i + 1], cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(_device_us(e) for e in rows) / 1e3
    del cache, logits
    return {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "decode_bound_ms": bound_ms, "param_gb": p_bytes / 1e9,
            "live_cache_gb_last": live[-1] / 1e9,
            "decode_tok_s": SERVE_BATCH / decode_ms * 1e3,
            "profiled_decode_step_ms": wall_ms / 4,
            "decode_idle_share": 1 - busy_ms / wall_ms,
            "decode_kernels_per_step": sum(e.count for e in rows) / 4}


def serve_model(arch: str) -> dict:
    """One model at full width and depth: generation through the CLI, the
    cache-consistency hold beside a nudged twin, (Zamba2) the kernel path
    against the plain path and the ``ssd_diag`` counts, the readings."""
    from repro_torch.launch import serve as SV
    from repro_torch.models.module import tree_leaves
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    hybrid = arch.startswith("zamba2")
    moe_model = arch.startswith("granite")
    rep = _serve_cli(arch, "cuda")
    cfg, params, batch = rep["cfg"], rep["params"], rep["batch"]
    toks, srv = rep["tokens"], rep["server"]
    n_params = sum(v.numel() for v in tree_leaves(params))
    log(f"serve {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.4f} B params; CLI prefill {rep['prefill_s']:.3f} s"
        f", decode {rep['decode_s']:.3f} s for {SERVE_GEN - 1} steps; "
        f"launches {json.dumps(rep['launches'])}; tokens[0][:8] "
        f"{toks[0, :8].tolist()}")
    want = {"masked_matmul": 0, "masked_matmul_dk": 0, "flash_attention": 0,
            "ssd_diag": cfg.num_layers if hybrid else 0}
    if rep["launches"] != want:
        raise AssertionError(f"serve {arch} launches {rep['launches']}, "
                             f"want {want} (ssd_diag once a Mamba2 layer "
                             f"in the prefill, never in a decode step)")
    if not bool(torch.isfinite(rep["prefill_logits"]).all()):
        raise AssertionError(f"serve {arch}: non-finite prefill logits")
    out = {"arch": arch, "layers": cfg.num_layers, "params_b": n_params / 1e9,
           "launches": rep["launches"]}
    del rep
    if hybrid:
        # the counts a prefill and a decode step make apart
        _reset_all()
        _, cache = srv.prefill(params, batch)
        n_pre = _all_launches()["ssd_diag"]
        _reset_all()
        srv.decode(params, toks[:, :1],
                   SV.pad_cache(cache, SERVE_PROMPT + SERVE_GEN))
        n_dec = _all_launches()["ssd_diag"]
        del cache
        log(f"serve {arch}: ssd_diag launches a prefill {n_pre}, a decode "
            f"step {n_dec}")
        if (n_pre, n_dec) != (cfg.num_layers, 0):
            raise AssertionError(f"serve {arch}: ssd_diag launches "
                                 f"{n_pre} / {n_dec} a prefill / decode "
                                 f"step, want {cfg.num_layers} / 0")
    hold = srv
    if moe_model:
        # expert capacity counts the call's tokens: only the capacity-free
        # dense dispatch computes the same function in both forms
        hold = SV.GenerationServer(cfg, SERVE_BATCH, SERVE_PROMPT,
                                   gen=SERVE_GEN, kernels="cuda")
        hold.rt["moe_impl"] = "dense"
    # ssd_chunked takes lengths its chunk count divides: 542, not 543
    steps = SERVE_GEN - 2 if hybrid else SERVE_GEN - 1
    dec_log, full_log = _RouterLog(), _RouterLog()
    with dec_log.use():
        _, dec = _forced(hold, params, batch, toks, steps)
    with full_log.use():
        full = _full_prefill(hold, params, batch, toks, steps)
    if not all(bool(torch.isfinite(x).all()) for x in dec + [full]):
        raise AssertionError(f"serve {arch}: non-finite decode logits")
    consistency = _max_diff(dec[-1], full)
    if moe_model:
        _routing_flips(dec_log, full_log, cfg.num_layers,
                       cfg.num_experts_per_tok, SERVE_PROMPT + steps)
    del dec_log, full_log
    out.update(consistency=consistency, positions=SERVE_PROMPT + steps)
    if hybrid:
        plain = SV.GenerationServer(cfg, SERVE_BATCH, SERVE_PROMPT,
                                    gen=SERVE_GEN, kernels="reference")
        p_pre, p_dec = _forced(plain, params, batch, toks, steps)
        k_pre = srv.prefill(params, batch)[0]
        out["kernel_vs_plain"] = max(
            _max_diff(k_pre, p_pre),
            max(_max_diff(a, b) for a, b in zip(dec, p_dec)))
        out["plain_tokens_equal"] = bool(torch.equal(plain(params, batch),
                                                     toks))
        del plain, p_pre, p_dec, k_pre
    del dec
    readings = _serve_readings(srv, params, batch, toks)
    # the twin: the same prefill over prompt + generated tokens with every
    # weight nudged by 2^-23 (in place; nothing reads the params after)
    _nudge(params, 1.0 + 2.0 ** -23)
    drift = _max_diff(_full_prefill(hold, params, batch, toks, steps), full)
    gate = max(F32_TOL, 2 * drift)
    out.update(drift=drift, gate=gate, **readings,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               seconds=time.perf_counter() - t0)
    log(f"serve {arch}: last decode step's logits against one prefill over "
        f"the same {SERVE_PROMPT + steps} tokens {consistency:.3e}; the "
        f"prefill's drift under a 2^-23 nudge {drift:.3e}; gate {gate:.3e}"
        + (f"; kernel path against plain path {out['kernel_vs_plain']:.3e},"
           f" greedy tokens equal {out['plain_tokens_equal']}"
           if hybrid else "")
        + (" (moe_impl dense)" if moe_model else ""))
    log(f"serve {arch}: prefill {readings['prefill_ms']:.3f} ms for "
        f"{SERVE_BATCH} x {SERVE_PROMPT}; decode "
        f"{readings['decode_ms_per_token']:.4f} ms a token step "
        f"({readings['decode_tok_s']:.1f} tok/s) against a byte bound of "
        f"{readings['decode_bound_ms']:.4f} ms (params "
        f"{readings['param_gb']:.3f} GB + live cache, "
        f"{readings['live_cache_gb_last']:.3f} GB at the last step, at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s); peak {out['peak_gib']:.2f} GiB; "
        f"{out['seconds']:.1f} s")
    log(f"serve {arch}: profiled decode step "
        f"{readings['profiled_decode_step_ms']:.3f} ms, device idle share "
        f"{readings['decode_idle_share']:.4f}, "
        f"{readings['decode_kernels_per_step']:.0f} kernels a step")
    if consistency > gate:
        raise AssertionError(f"serve {arch}: decode disagrees with prefill "
                             f"over the same tokens: {consistency} > {gate}")
    if hybrid and out["kernel_vs_plain"] > gate:
        raise AssertionError(f"serve {arch}: kernel path disagrees with the "
                             f"plain path: {out['kernel_vs_plain']} > {gate}")
    del params, srv, hold, full
    return out


def serve_while_train_path() -> dict:
    """Serve while training at Zamba2 width, depth cut to ``SWT_LAYERS``:
    ``FLRun`` helios on a 2 + 2 fleet, ``SWT_ROUNDS`` rounds of one local
    step, publishing every round, behind ``make_ce_eval``; the run log
    rendered with the port's report."""
    from repro_torch.configs import ZAMBA2_1_2B
    from repro_torch.drivers.serve_while_train import serve_while_train
    from repro_torch.obs import report as OBR
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(ZAMBA2_1_2B, num_layers=SWT_LAYERS)
    out_dir = str(ROOT / "chiprun_out" / "serve_obs")
    _reset_all()
    res = serve_while_train(cfg, clients=4, rounds=SWT_ROUNDS,
                            local_steps=1, batch_size=4, seq_len=256,
                            rate_hz=SWT_RATE_HZ, batch=4, prompt_len=128,
                            gen=8, tol=0.05, min_requests=10, device="cuda",
                            kernels="cuda", out=out_dir)
    launches = _all_launches()
    rec = res.pop("recorder")
    res.pop("history")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log("serve while training (Zamba2 width, "
        f"{SWT_LAYERS} Mamba2 layers): " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in res.items()}))
    report = OBR.render(OBR.load_events(out_dir))
    for ln in report.splitlines()[:60]:
        log("  | " + ln)
    swapped = [e for e in rec.events if e["kind"] == "swap"
               and e["round"] >= 1]
    if not swapped:
        raise AssertionError("serve while training: no swap to a trained "
                             "round")
    return res


def serve_phase(kernels: list) -> None:
    """Phase 4k; adds the serving launches of ``ssd_diag`` and its time at
    the serving shape to its row of ``kernels``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SS
    t0 = time.perf_counter()
    models = {}
    for arch in SERVE_MODELS:
        models[arch] = serve_model(arch)
        _free()
    swt = serve_while_train_path()
    _free()
    row = next(k for k in kernels if k["name"] == "ssd_diag")
    serving = models["zamba2-1.2b"]["launches"]["ssd_diag"]   # the CLI
    row["launches_by_path"] = {"hybrid": row["launches"],
                               "serving": serving,
                               "serve_while_train":
                                   swt["launches"]["ssd_diag"]}
    row["launches"] += serving + swt["launches"]["ssd_diag"]
    # the serving prefill's shape: (B, nc, L, ds, nh, hd)
    b, nc, L, ds, nh, hd = SERVE_BATCH, SERVE_PROMPT // 256, 256, 64, 64, 64
    g = torch.Generator(device="cuda").manual_seed(8)
    sets = [_ssd_inputs(b, nc, L, ds, nh, hd, torch.float32, g, True)
            for _ in range(3)]
    t = {"ms": _device_ms(SS.ssd_diag, sets),
         "plain_ms": _time_ms(ref.ssd_diag_ref, sets)}
    pairs = L * (L + 1) // 2
    flops = 2 * pairs * b * nc * (ds + nh * hd)
    bd = _bounds(flops, 4 * (2 * b * nc * L * ds + b * nc * L * nh
                             + 2 * b * nc * L * nh * hd))
    row["serving"] = {"shape": [b, nc, L, ds, nh, hd], **t,
                      "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"]}
    log(f"time ssd_diag at the serving prefill's shape {(b, nc, L, ds, nh, hd)}"
        f" f32: device {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    log("serving summary " + json.dumps(
        {a: {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in m.items()} for a, m in models.items()}))
    log(f"phase 4k took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 4l: the training launch
# ---------------------------------------------------------------------------

#: a masked MLP's kernel calls a layer and a step: the forward runs wi and
#: wg on the column kernel and wo on the contraction kernel; the backward
#: wo's dh and dw and wi's and wg's dw on the column kernel, wi's and wg's
#: dx on the contraction kernel; flash once a layer (its backward
#: recomputes the plain attention)
LAUNCH_CALLS = {"masked_matmul": 6, "masked_matmul_dk": 3,
                "flash_attention": 1, "ssd_diag": 0}
#: xLSTM-125M through the train CLI: batch 8 x 128, volume 0.5, masks
#: re-drawn every 2 steps, a checkpoint every 2 of 4 steps
XL_STEPS, XL_EVERY = 4, 2
XL_ARGS = ["--arch", "xlstm-125m", "--steps", str(XL_STEPS), "--batch", "8",
           "--seq", "128", "--volume", "0.5", "--cycle-steps", "2",
           "--ckpt-every", str(XL_EVERY), "--log-every", "1"]
#: InternVL2-1B: batch 8 x (256 stub image embeddings + 256 tokens); the
#: FL round: 2 clients x 1 local step of 4 such rows
VLM_BATCH, VLM_TEXT, VLM_FL_BATCH = 8, 256, 4
#: Qwen2.5-32B width, depth cut 64 -> 1, batch 4 x 512
QW_LAYERS, QW_BATCH, QW_SEQ = 1, 4, 512
#: the held steps' AdamW: the CLI's lr with no warmup, so the held step
#: moves every param (the warmup schedule's lr is 0 at step 0)
HOLD_TCFG = dict(learning_rate=3e-4, total_steps=10, warmup_steps=0)
#: the serving cells of the launch's families, and the decode steps held
#: against a re-prefill (xLSTM's chunkwise mLSTM takes lengths its chunk
#: count divides: 512 + 24 = 8 x 67)
LAUNCH_SERVE = {"xlstm-125m": 24, "internvl2-1b": SERVE_GEN - 1}


def _expect(layers: int, steps: int) -> dict:
    return {k: v * layers * steps for k, v in LAUNCH_CALLS.items()}


def _tree_diff(a, b) -> float:
    """Max abs difference over the tensor leaves of two trees."""
    from repro_torch.models.module import tree_paths
    tb = dict(tree_paths(b))
    return max(float((v.detach().float() - tb[k].detach().float().to(
        v.device)).abs().max()) for k, v in tree_paths(a)
        if torch.is_tensor(v))


def _hold_trees(what: str, kern, plain, rel: bool) -> float:
    """Leaf by leaf: max abs difference of the kernel path's tree (host or
    device) against the plain path's (``rel``: over the plain leaf's max
    abs), a leaf at a time on the plain tree's device; returns the
    worst."""
    from repro_torch.models.module import tree_paths
    tk = dict(tree_paths(kern))
    worst, at = 0.0, None
    for k, w in tree_paths(plain):
        w = w.float()
        d = float((tk[k].to(w.device).float() - w).abs().max())
        if rel:
            d /= max(float(w.abs().max()), 1e-30)
        if not math.isfinite(d):
            raise AssertionError(f"{what}: non-finite {k}")
        if d > worst:
            worst, at = d, k
    log(f"  {what}: worst {'relative ' if rel else ''}max|diff| "
        f"{worst:.3e} ({at})")
    return worst


def launch_xlstm() -> dict:
    """xLSTM-125M at full size through ``launch.train.main``: uninterrupted
    with a checkpoint at step ``XL_EVERY``, again without checkpoints (the
    card's own run-to-run spread), then resumed from the first run's
    mid-run checkpoint; the resumed run must end where the uninterrupted
    one ends (within twice the spread: bit for bit on a card that repeats
    itself).  The checkpoints (1.24 GB of state each) are deleted after."""
    import shutil
    from repro_torch.launch import train as TR
    from repro_torch.models.module import tree_leaves
    t0 = time.perf_counter()
    base = ROOT / "chiprun_out" / "launch_xlstm"
    shutil.rmtree(base, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    try:
        for name in ("a", "again", "resumed"):
            args = list(XL_ARGS)
            if name == "resumed":
                (base / name).mkdir(parents=True)
                shutil.copy(base / "a" / f"ckpt_{XL_EVERY}.msgpack.zst",
                            base / name)
            if name != "again":
                args += ["--ckpt-dir", str(base / name)]
            rep = {}
            _reset_all()
            t1 = time.perf_counter()
            losses = TR.main(args, report=rep)
            rep.update(losses=losses, seconds=time.perf_counter() - t1,
                       launches=_all_launches())
            runs[name] = rep
    finally:
        shutil.rmtree(base, ignore_errors=True)
    a, again, res = runs["a"], runs["again"], runs["resumed"]
    n_params = sum(v.numel() for v in tree_leaves(a["state"]["params"]))
    spread = _tree_diff(TR._saved(a["state"]), TR._saved(again["state"]))
    gap = _tree_diff(TR._saved(a["state"]), TR._saved(res["state"]))
    out = {"params_m": n_params / 1e6, "losses": a["losses"],
           "step_s": again["step_s"],
           "run_s": {k: r["seconds"] for k, r in runs.items()},
           "resumed_from": res["start"], "run_to_run": spread,
           "resumed_vs_uninterrupted": gap,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "seconds": time.perf_counter() - t0}
    log("launch xlstm-125m " + json.dumps(
        out, default=lambda v: round(v, 6) if isinstance(v, float) else v))
    zero = {k: 0 for k in LAUNCH_CALLS}
    for name, rep in runs.items():
        if rep["launches"] != zero:
            raise AssertionError(f"launch xlstm {name}: launches "
                                 f"{rep['launches']}, want none (xLSTM "
                                 f"reaches no kernel)")
    if not all(math.isfinite(x) for x in a["losses"] + res["losses"]):
        raise AssertionError("launch xlstm: non-finite loss")
    if res["start"] != XL_EVERY or len(res["losses"]) != XL_STEPS - XL_EVERY:
        raise AssertionError(f"launch xlstm: resumed at {res['start']} with "
                             f"{len(res['losses'])} steps")
    if res["state"]["helios"]["rng"] != a["state"]["helios"]["rng"]:
        raise AssertionError("launch xlstm: resumed Helios key path differs")
    if not gap <= 2 * spread:
        raise AssertionError(f"launch xlstm: resumed run ends {gap} from the "
                             f"uninterrupted one (run to run {spread})")
    del runs, a, again, res
    return out


def _launch_setting(cfg, batch: int, text: int, g):
    """A launch train state on the card (params from seed 0, AdamW, Helios
    at volume 0.5 with block-granular MLP masks) and one batch of Markov
    tokens (and a VLM's stub image embeddings)."""
    from repro_torch.configs import HeliosConfig, TrainConfig
    from repro_torch.core import soft_train as ST
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.launch import steps as S
    hcfg = HeliosConfig(contribution="grad_ema", mask_block=BLOCK)
    tcfg = TrainConfig(**HOLD_TCFG)
    t0 = time.perf_counter()
    state = S.init_train_state(0, cfg, hcfg, tcfg, "cuda")
    state["helios"] = ST.begin_cycle(ST.set_volume(state["helios"], 0.5),
                                     hcfg)
    b = {"tokens": torch.as_tensor(markov_tokens(batch, text, cfg.padded_vocab),
                                   device="cuda")}
    if cfg.family == "vlm":
        b["image_embeds"] = torch.randn(batch, cfg.num_image_tokens,
                                        cfg.d_model, device="cuda",
                                        generator=g)
    log(f"launch {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}; state ready in "
        f"{time.perf_counter() - t0:.1f} s")
    return hcfg, tcfg, state, b


def _rt(kernels: str) -> dict:
    from repro_torch.models import default_runtime
    rt = default_runtime()
    rt["kernels"], rt["mask_block"] = kernels, BLOCK
    return rt


def _hold_step(cfg, hcfg, tcfg, state, batch, host: bool, want=None,
               tap=None) -> dict:
    """One ``make_train_step`` step from ``state`` on each path, the
    kernels' counters zeroed before and read after each; the kernel path
    held to the plain path at 1e-4: loss and gradient norm (relative), the
    new params (absolute), AdamW's first moment and the Eq. 1 scores (per
    leaf, relative: the clipped gradients).  ``host``: the first path's
    result goes to the host before the second runs.  ``want``: the kernel
    path's launches (default: a masked MLP and flash a layer).  ``tap``
    (a :class:`RouteTap`, MoE): the plain path runs first and its expert
    choices are replayed into the kernel path."""
    from repro_torch.launch import steps as S
    from repro_torch.models.module import tree_map
    res = {}
    order = ("reference", "cuda") if tap else ("cuda", "reference")
    for kernels in order:
        step = S.make_train_step(cfg, hcfg, tcfg, _rt(kernels))
        _reset_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (tap.use("record" if kernels == "reference" else "replay")
              if tap else contextlib.nullcontext()):
            new, met = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _all_launches()
        kept = {"params": new["params"], "m": new["opt"]["m"],
                "scores": new["helios"]["scores"]}
        if host and kernels == order[0]:
            kept = tree_map(lambda t: t.cpu(), kept)
        res[kernels] = {"loss": float(met["loss"]),
                        "grad_norm": float(met["grad_norm"]),
                        "launches": launches, "step_s": wall, **kept}
        del new, met, kept
        _free()
    if tap:
        tap.report(f"launch {cfg.name} one step, plain choices replayed",
                   cfg.num_layers - cfg.first_k_dense,
                   cfg.num_experts_per_tok, gate=True)
    k, p = res["cuda"], res["reference"]
    log(f"launch {cfg.name} one step: loss {k['loss']:.7f} vs {p['loss']:.7f},"
        f" grad norm {k['grad_norm']:.6f} vs {p['grad_norm']:.6f}; step "
        f"{k['step_s']:.3f} s vs {p['step_s']:.3f} s (first calls); "
        f"launches {json.dumps(k['launches'])}")
    worst = {"params": _hold_trees(f"{cfg.name} params", k["params"],
                                   p["params"], rel=False),
             "m": _hold_trees(f"{cfg.name} AdamW m", k["m"], p["m"],
                              rel=True),
             "scores": _hold_trees(f"{cfg.name} scores", k["scores"],
                                   p["scores"], rel=True)}
    for what in ("loss", "grad_norm"):
        worst[what] = abs(k[what] - p[what]) / max(abs(p[what]), 1e-30)
    if not all(v <= F32_TOL for v in worst.values()):
        raise AssertionError(f"launch {cfg.name}: the kernel path's step "
                             f"disagrees with the plain path: {worst}")
    want = want or _expect(cfg.num_layers, 1)
    if k["launches"] != want or any(p["launches"].values()):
        raise AssertionError(f"launch {cfg.name}: launches {k['launches']} "
                             f"(plain {p['launches']}), want {want}")
    return {"hold": worst, "launches": k["launches"],
            "step_s": {"cuda": k["step_s"], "reference": p["step_s"]}}


def _step_walls(cfg, hcfg, tcfg, state, batch) -> dict:
    """Step walls after the held step's warm-up, in turns: kernel, plain,
    plain, kernel (host clock to a synchronize)."""
    from repro_torch.launch import steps as S
    walls = {"cuda": [], "reference": []}
    for kernels in ("cuda", "reference", "reference", "cuda"):
        step = S.make_train_step(cfg, hcfg, tcfg, _rt(kernels))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, _ = step(state, batch)
        torch.cuda.synchronize()
        walls[kernels].append(time.perf_counter() - t0)
        del new
    _free()
    return walls


def launch_vlm(g) -> dict:
    """InternVL2-1B at full width and depth: one held step, step walls in
    turns, and one ``make_fl_round_step`` round of 2 clients x 1 local
    step held kernel path against plain path."""
    from repro_torch.configs import INTERNVL2_1B
    from repro_torch.core import soft_train as ST
    from repro_torch.launch import steps as S
    from repro_torch.models import build
    from repro_torch.models.module import tree_leaves, tree_map
    cfg = INTERNVL2_1B
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    hcfg, tcfg, state, batch = _launch_setting(cfg, VLM_BATCH, VLM_TEXT, g)
    n_params = sum(v.numel() for v in tree_leaves(state["params"]))
    out = {"params_b": n_params / 1e9, "tokens": VLM_BATCH * (
        VLM_TEXT + cfg.num_image_tokens)}
    out.update(_hold_step(cfg, hcfg, tcfg, state, batch, host=False))
    out["walls"] = _step_walls(cfg, hcfg, tcfg, state, batch)
    out["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # the fused FL round: clients at volumes 0.5 and 1
    n = 2
    schema = build(cfg).mask_schema
    helios = ST.stack_states([ST.begin_cycle(ST.set_volume(ST.init_state(
        schema, 1.0, c, "cuda"), v), hcfg) for c, v in enumerate((0.5, 1.0))])
    fl_state = {"params": S.stack_clients(state["params"], n),
                "opt": S.stack_clients(state["opt"], n),
                "step": state["step"], "helios": helios}
    del state
    _free()
    fl_batch = {k: v[:VLM_FL_BATCH * n].reshape(
        (n, 1, VLM_FL_BATCH) + tuple(v.shape[1:])) for k, v in batch.items()}
    res = {}
    for kernels in ("cuda", "reference"):
        rnd = S.make_fl_round_step(cfg, hcfg, tcfg, _rt(kernels), n)
        _reset_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, met = rnd(fl_state, fl_batch)
        torch.cuda.synchronize()
        res[kernels] = {"wall": time.perf_counter() - t0,
                        "launches": _all_launches(),
                        "loss": float(met["loss"]),
                        "alpha": met["alpha"].tolist(),
                        "global": tree_map(lambda t: t[0].cpu(),
                                           new["params"])}
        del new, met
        _free()
    k, p = res["cuda"], res["reference"]
    log(f"launch {cfg.name} FL round (2 clients x 1 step): loss "
        f"{k['loss']:.7f} vs {p['loss']:.7f}, alpha {k['alpha']} vs "
        f"{p['alpha']}, wall {k['wall']:.3f} s vs {p['wall']:.3f} s; "
        f"launches {json.dumps(k['launches'])}")
    fl_worst = _hold_trees(f"{cfg.name} FL global", k["global"], p["global"],
                           rel=False)
    want = _expect(cfg.num_layers, n)
    if not (fl_worst <= F32_TOL and k["alpha"] == p["alpha"]
            and abs(k["loss"] - p["loss"]) <= F32_TOL * abs(p["loss"])):
        raise AssertionError(f"launch {cfg.name} FL round: kernel path "
                             f"disagrees with plain ({fl_worst})")
    if k["launches"] != want or any(p["launches"].values()):
        raise AssertionError(f"launch {cfg.name} FL round launches "
                             f"{k['launches']}, want {want}")
    out.update(fl_hold=fl_worst, fl_launches=k["launches"],
               fl_wall={"cuda": k["wall"], "reference": p["wall"]},
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               seconds=time.perf_counter() - t0)
    log(f"launch {cfg.name}: step peak {out['step_peak_gib']:.2f} GiB, "
        f"with the FL round {out['peak_gib']:.2f} GiB")
    del fl_state, res, batch, fl_batch
    _free()
    return out


def launch_qwen(g) -> dict:
    """Qwen2.5-32B width with the depth cut 64 -> 2: one held step, the
    kernel path's result on the host before the plain path runs."""
    from repro_torch.configs import QWEN2_5_32B
    from repro_torch.models.module import tree_leaves
    cfg = dataclasses.replace(QWEN2_5_32B, num_layers=QW_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    hcfg, tcfg, state, batch = _launch_setting(cfg, QW_BATCH, QW_SEQ, g)
    n_params = sum(v.numel() for v in tree_leaves(state["params"]))
    out = {"params_b": n_params / 1e9, "tokens": QW_BATCH * QW_SEQ}
    out.update(_hold_step(cfg, hcfg, tcfg, state, batch, host=True))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["seconds"] = time.perf_counter() - t0
    log(f"launch {cfg.name} ({QW_LAYERS} of {QWEN2_5_32B.num_layers} layers,"
        f" {out['params_b']:.4f} B params): peak {out['peak_gib']:.2f} GiB; "
        f"{out['seconds']:.1f} s")
    del state, batch
    _free()
    return out


def launch_serving() -> dict:
    """xLSTM-125M and InternVL2-1B (the image prefix in the cache) served
    through the serve CLI at the 4k cell: no kernel launched; the last
    decode step held against one prefill over the same sequence at
    max(1e-4, twice a 2^-23-nudged twin's drift)."""
    out = {}
    for arch, steps in LAUNCH_SERVE.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = _serve_cli(arch, "cuda")
        cfg, params, batch = rep["cfg"], rep["params"], rep["batch"]
        toks, srv = rep["tokens"], rep["server"]
        if any(rep["launches"].values()):
            raise AssertionError(f"serve {arch} launches {rep['launches']}")
        _, dec = _forced(srv, params, batch, toks, steps)
        full = _full_prefill(srv, params, batch, toks, steps)
        consistency = _max_diff(dec[-1], full)
        readings = _serve_readings(srv, params, batch, toks)
        _nudge(params, 1.0 + 2.0 ** -23)
        drift = _max_diff(_full_prefill(srv, params, batch, toks, steps),
                          full)
        gate = max(F32_TOL, 2 * drift)
        pos = SERVE_PROMPT + cfg.num_image_tokens + steps
        out[arch] = {"consistency": consistency, "drift": drift,
                     "gate": gate, "positions": pos, **readings,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "seconds": time.perf_counter() - t0}
        log(f"serve {arch}: last decode step against one prefill over the "
            f"same {pos} positions {consistency:.3e}; nudged drift "
            f"{drift:.3e}; gate {gate:.3e}; prefill "
            f"{readings['prefill_ms']:.3f} ms, decode "
            f"{readings['decode_ms_per_token']:.4f} ms a step (bound "
            f"{readings['decode_bound_ms']:.4f} ms); peak "
            f"{out[arch]['peak_gib']:.2f} GiB")
        if not (consistency <= gate and all(
                bool(torch.isfinite(x).all()) for x in dec + [full])):
            raise AssertionError(f"serve {arch}: decode disagrees with a "
                                 f"re-prefill: {consistency} > {gate}")
        del rep, params, batch, srv, dec, full
        _free()
    return out


def launch_kernels(g) -> tuple:
    """The masked pair and flash at the launch's shapes: each against its
    plain version (f32, twice, bit-identical), then timed beside its bound
    and ``torch.matmul`` / SDPA.  Returns {kernel: {shape label: times}}
    and the worst f32 errors."""
    from repro_torch.configs import INTERNVL2_1B, QWEN2_5_32B
    worst = {"masked_matmul": 0.0, "masked_matmul_dk": 0.0,
             "flash_attention": 0.0}
    times = {k: {} for k in worst}
    for name, cfg, m in (("internvl2-1b", INTERNVL2_1B,
                          VLM_BATCH * (VLM_TEXT + 256)),
                         ("qwen2.5-32b", QWEN2_5_32B, QW_BATCH * QW_SEQ)):
        d, ff = cfg.d_model, cfg.d_ff
        layouts = (("wi/wg fwd", "masked_matmul", m, d, ff, "row", "row"),
                   ("wi/wg dw", "masked_matmul", d, m, ff, "col", "row"),
                   ("wo dh", "masked_matmul", m, d, ff, "row", "col"),
                   ("wo fwd", "masked_matmul_dk", m, ff, d, "row", "row"),
                   ("wi/wg dx", "masked_matmul_dk", m, ff, d, "row", "col"))
        for label, kernel, mm, k, n, xl, wl in layouts:
            fn, plain, x, w, live, dead = _operands(kernel, mm, k, n, xl, wl,
                                                    0.5, torch.float32, g)
            err, config = _check_call(f"{name} {label} M={mm} K={k} N={n} "
                                      f"P=0.5", fn, plain, x, w, live, dead,
                                      BLOCK, torch.float32)
            worst[kernel] = max(worst[kernel], err)
            del x, w, dead
            if label in ("wi/wg fwd", "wo fwd"):
                t = _time_call(f"{name} {label}", kernel, mm, k, n, xl, wl,
                               0.5, g, 1)
                times[kernel][name] = {"shape": [mm, k, n], "config": config,
                                       **t}
            _free()
        shape = (VLM_BATCH if name == "internvl2-1b" else QW_BATCH,
                 cfg.num_heads, 512, cfg.resolved_head_dim, True)
        err = _check_flash_case(*shape, torch.float32, g)
        worst["flash_attention"] = max(worst["flash_attention"], err)
        t, bd, flops = _flash_times(*shape, seed=31)
        _flash_line(shape, t, bd, flops, cfg.num_layers)
        times["flash_attention"][name] = {
            "shape": list(shape[:4]), **t, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "bound_f32_ms": bd["bound_f32_ms"]}
        _free()
    _reset_all()
    return times, worst


def _add_to_rows(kernels: list, key: str, times: dict, worst: dict,
                 paths: dict) -> None:
    """Add each path's launches ({path: {kernel: launches}}) to the rows
    of ``kernels`` that ``times`` names, and the phase's shapes' times and
    worst error under ``key``."""
    for row in kernels:
        name = row["name"]
        if name not in times:
            continue
        own = {path: n[name] for path, n in paths.items()}
        row.setdefault("launches_by_path", {}).update(own)
        row["launches"] += sum(own.values())
        row[key] = {"shapes": times[name], "max_abs_err": worst[name]}


def launch_phase(kernels: list) -> None:
    """Phase 4l; adds the launch paths' launches, its shapes' times and
    errors to the rows of ``kernels``."""
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(41)
    xl = launch_xlstm()
    _free()
    vlm = launch_vlm(g)
    qwen = launch_qwen(g)
    serving = launch_serving()
    t1 = time.perf_counter()
    times, worst = launch_kernels(g)
    log(f"launch kernel checks and times took {time.perf_counter() - t1:.1f}"
        f" s")
    _add_to_rows(kernels, "launch", times, worst,
                 {"launch_internvl2_step": vlm["launches"],
                  "launch_internvl2_fl_round": vlm["fl_launches"],
                  "launch_qwen2.5_step": qwen["launches"]})
    log("launch summary " + json.dumps(
        {"xlstm": xl, "internvl2-1b": vlm, "qwen2.5-32b": qwen,
         "serving": serving},
        default=lambda v: round(v, 6) if isinstance(v, float) else str(v)))
    log(f"phase 4l took {time.perf_counter() - t0:.1f} s")



# ---------------------------------------------------------------------------
# phase 4m: the paper's reproduction at full width
# ---------------------------------------------------------------------------

#: LeNet's masked fc layers (K, N), each one partial column block of 128:
#: fc0 256 -> 120, fc1 120 -> 84
LENET_LAYERS = {"fc0": (256, 120), "fc1": (120, 84)}
#: LeNet's batches on the main path: 32 in the tables, quickstart and
#: elastic_scaling; 16 in async_events and observability
LENET_BATCHES = (BATCH, 16)
#: the client-axis calls held: (C, M, every client's P or None, shared).
#: observability's BatchedFLRun trains cohorts of 4 (4 capable clients, 4
#: stragglers) at batch 16, a capable cohort's first step on the shared
#: weights; AsyncFLRun's buckets under jitter hold one client at batch 16,
#: its one block live or dead; C 4 at batch 32 is the timed cohort.  None:
#: client 0 without its live block, the others with it
LENET_CLIENT_CASES = ((4, BATCH, None, False), (4, 16, None, False),
                      (4, 16, None, True), (1, 16, 1.0, False),
                      (1, 16, 0.0, False))
#: the cohort the client-axis entries are timed at
LENET_CLIENTS = 4
#: the tables' rounds, the reference harness's defaults
REPRO_ROUNDS = {"fig5": 14, "speedup": 16, "fig6": 10, "fig7": 12,
                "ablation": 10}
SINGLE = ("masked_matmul", "masked_matmul_dk")


def check_lenet_kernels() -> tuple:
    """The masked pair at LeNet's fc shapes: forward, dx and dw at batch
    32 and 16 with the layer's one block live and dead, then the
    client-axis entries at LENET_CLIENT_CASES, each call held against its
    plain version and repeated bit-identical; then the device time of each
    forward and dx at batch 32, P = 1, beside its bound, its plain version
    and ``torch.matmul`` / ``torch.bmm``.  Returns (worst f32 error per
    kernel row, times per kernel row)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = {k: 0.0 for k in SINGLE + tuple(f"{k}_clients" for k in SINGLE)}
    for layer, (k, n) in LENET_LAYERS.items():
        for kind in ("fwd", "dx", "dw"):
            for m in LENET_BATCHES:
                for p in (1.0, 0.0):
                    fn, plain, x, w, live, dead = _case(kind, m, k, n, p,
                                                        torch.float32, g)
                    err, config = _check_call(
                        f"LeNet {layer} {kind} m={m} k={k} n={n} P={p}", fn,
                        plain, x, w, live, dead, BLOCK, torch.float32)
                    if p and kind != "dw" and config != "splitk":
                        raise AssertionError(f"LeNet {layer} {kind} m={m} "
                                             f"took {config}, not splitk")
                    worst[fn.__name__] = max(worst[fn.__name__], err)
            for c, m, p, shared in LENET_CLIENT_CASES:
                if shared and kind == "dw":
                    continue        # dw's operands are the clients' own
                fn, plain, x, w, live, counts, dead, _ = _client_case(
                    kind, c, m, k, n, torch.float32, g, shared, p)
                err, config = _check_client_call(
                    f"LeNet {layer} {kind} C={c} m={m} k={k} n={n} "
                    f"{'shared' if shared else 'mixed' if p is None else p}",
                    fn, plain, x, w, live, counts, dead, torch.float32)
                if kind != "dw" and config != "splitk":
                    raise AssertionError(f"LeNet client {layer} {kind} C={c} "
                                         f"m={m} took {config}, not splitk")
                worst[fn.__name__] = max(worst[fn.__name__], err)
    # LeNet's params (under 0.2 MB) stay in the 50 MB L2 on
    # the main path, so the calls rotate over 8 sets, warm in the L2
    times = {k: {} for k in worst}
    for layer, (k, n) in LENET_LAYERS.items():
        for kind in ("fwd", "dx"):
            call = LAYER_CALLS[kind](BATCH, k, n)
            times[call[0]][f"{layer} {kind}"] = _time_call(
                f"LeNet {layer} {kind}", *call, 1.0, g, 8)
            times[f"{call[0]}_clients"][f"{layer} {kind}"] = \
                _time_client_call(f"LeNet {layer}", kind, LENET_CLIENTS,
                                  BATCH, k, n, 1.0, g, 8)
    from repro_torch.kernels import masked_matmul as K
    K.reset_launches()
    return worst, times


def _table_runs(fn, **kw) -> tuple:
    """Run a ``paper_figures`` table with the masked pair's counters zeroed
    before and read after each of its runs: (its rows, [(history,
    single-client launches, client-axis launches)] in run order)."""
    from repro_torch.drivers import paper_figures as PF
    from repro_torch.kernels import masked_matmul as K
    runs, inner = [], PF._run_scheme

    def counted(*a, **k):
        K.reset_launches()
        hist = inner(*a, **k)
        runs.append((hist, *_counts()))
        return hist

    PF._run_scheme = counted
    try:
        rows = fn(**kw)
    finally:
        PF._run_scheme = inner
    return rows, runs


def _check_table_runs(what: str, runs, model: str) -> dict:
    """Every loss finite; the masked pair launched in every run of LeNet and
    AlexNet (the sequential engine: single-client entries only) and in
    none of ResNet-18's.  Returns the launches summed."""
    total = {k: 0 for k in SINGLE}
    for i, (hist, single, client) in enumerate(runs):
        if not all(math.isfinite(h["loss"]) for h in hist):
            raise AssertionError(f"{what} run {i}: a non-finite loss "
                                 f"{[h['loss'] for h in hist]}")
        launched = min(single.values()) > 0
        if any(client.values()) or launched != (model != "resnet18") or \
                (model == "resnet18" and any(single.values())):
            raise AssertionError(f"{what} run {i}: masked launches {single}"
                                 f" / client-axis {client} on {model}")
        total = _add(total, single)
    return total


def _no_launches(what: str, single: dict, client: dict) -> None:
    """A plain path's run launched neither kernel of the pair."""
    if any(single.values()) or any(client.values()):
        raise AssertionError(f"{what}: the plain path launched masked "
                             f"kernels {single} / client-axis {client}")


def _same_clocks(what: str, a, b, rows: bool) -> None:
    """Two paths' runs with identical cycles, sim times and volumes, and
    (``rows``) identical row names and sim times a cycle."""
    (rows_a, runs_a), (rows_b, runs_b) = a, b
    if rows and [r.split(",")[:2] for r in rows_a] != \
            [r.split(",")[:2] for r in rows_b]:
        raise AssertionError(f"{what}: rows differ {rows_a} vs {rows_b}")
    if len(runs_a) != len(runs_b):
        raise AssertionError(f"{what}: {len(runs_a)} runs vs {len(runs_b)}")
    for (ha, _, _), (hb, _, _) in zip(runs_a, runs_b):
        # an event-driven run's rows carry no volumes
        for key in ("cycle", "time", "volumes"):
            if [h.get(key) for h in ha] != [h.get(key) for h in hb]:
                raise AssertionError(f"{what}: history {key} differs: "
                                     f"{[h.get(key) for h in ha]} vs "
                                     f"{[h.get(key) for h in hb]}")


#: the tables phase 4m runs: (table, its keywords, model); Fig. 5 one
#: model a call, so that each call takes that model's params
REPRO_CALLS = (("fig5", {"models": ("lenet",)}, "lenet"),
               ("fig5", {"models": ("alexnet",)}, "alexnet"),
               ("fig5", {"models": ("resnet18",)}, "resnet18"),
               ("speedup", {}, "lenet"), ("fig6", {}, "lenet"),
               ("fig7", {}, "lenet"), ("ablation", {}, "lenet"))
#: phase 4m's rounds for a model's Fig. 5 where they are cut from the
#: reference's (the whole script's time limit: ResNet-18's 10 runs of 14
#: rounds took 33-42 s and stay at chance)
REPRO_CUT_ROUNDS = {"resnet18": 7}


def repro_figures(twins=(), cut_rounds=None) -> dict:
    """The five tables at the reference's rounds (a model in ``cut_rounds``
    at its rounds there) and full widths (Fig. 5 on LeNet, AlexNet and
    ResNet-18, the others on LeNet) on the kernel path;
    each table of a model in ``twins`` also on a 2^-23-nudged plain twin,
    and AlexNet's also on the plain path (clocks identical on every
    path), with each run's final accuracy on the paths and the table's
    spread against them; then each P_s row's first round held kernel
    against plain.  Returns the single-client launches."""
    from repro_torch.configs import HeliosConfig
    from repro_torch.drivers import paper_figures as PF
    from repro_torch.kernels import masked_matmul as K
    from repro_torch.models import init_params
    total = {k: 0 for k in SINGLE}
    for name, kw, model in REPRO_CALLS:
        t0 = time.perf_counter()
        paths = [("cuda", "cuda", None)]
        if model == "alexnet":
            paths.append(("plain", "reference", None))
        if model in twins:
            nudged = {k: v * (1 + 2.0 ** -23) for k, v in init_params(
                PF.model_config(model, "full"), 0, "cuda").items()}
            paths.append(("nudged", "reference", nudged))
        got = {}
        for path, kernels, init in paths:
            got[path] = _table_runs(
                PF.TABLES[name], widths="full", device="cuda",
                kernels=kernels, init_params=init,
                rounds=(cut_rounds or {}).get(model, REPRO_ROUNDS[name]),
                **kw)
        launched = _check_table_runs(f"{name} {model}", got["cuda"][1],
                                     model)
        for path in got:
            if path != "cuda":
                for i, (_, single, client) in enumerate(got[path][1]):
                    _no_launches(f"{name} {model} {path} run {i}", single,
                                 client)
        total = _add(total, launched)
        # the speedup's time column is the crossing's, an accuracy's
        for path in got:
            if path != "cuda":
                _same_clocks(f"{name} {model} kernel vs {path}", got["cuda"],
                             got[path], rows=name != "speedup")
        accs = {path: [h[-1]["acc"] for h, _, _ in runs]
                for path, (_, runs) in got.items()}
        for path, row in ((p, r) for p in got for r in got[p][0]):
            log(f"repro {path:6s} {row}")
        for i, acc in enumerate(accs["cuda"]):
            others = "".join(f", {p} {accs[p][i]:.4f}" for p in got
                             if p != "cuda")
            log(f"repro {name} {model} run {i}: final acc kernel {acc:.4f}"
                f"{others}")
        spread = {p: max(abs(x - y) for x, y in zip(accs["cuda"], accs[p]))
                  for p in got if p != "cuda"}
        log(f"repro {name} {model}: {len(accs['cuda'])} runs in "
            f"{time.perf_counter() - t0:.1f} s ({len(paths)} paths); final "
            f"accuracy spread kernel vs {json.dumps(spread)}; masked "
            f"launches {json.dumps(launched)}")
    # each P_s row's first round, kernel path against plain path
    world = PF._world("lenet", 4, widths="full")
    for p_s in PF.P_S:
        runs = {}
        for kernels in ("cuda", "reference"):
            K.reset_launches()
            runs[kernels] = PF.make_run(world, "helios", 2, 2,
                                        hcfg=HeliosConfig(p_s=p_s),
                                        device="cuda", kernels=kernels)
            timed_run(runs[kernels], 1)
            if kernels == "cuda":
                single, _ = _counts()
                total = _add(total, single)
            else:
                _no_launches(f"ablation p_s={p_s} plain", *_counts())
        diff = _hold_paths(f"ablation p_s={p_s} first round", runs["cuda"],
                           runs["reference"], ("cycle", "time", "volumes",
                                               "ratios"))
        log(f"ablation p_s={p_s}: first round max|param diff| kernel vs "
            f"plain {diff:.3e}; masked launches {json.dumps(single)}")
        if min(single.values()) <= 0:
            raise AssertionError(f"ablation p_s={p_s}: no masked launch "
                                 f"{single}")
    return total


def repro_examples() -> tuple:
    """The four example drivers at their own settings on full LeNet:
    quickstart, the elastic join / leave on both paths, async_events with
    64 clients (dropout 0.1, jitter 0.3) and observability's armed
    BatchedFLRun.  Returns (single-client, client-axis) launches."""
    from repro_torch.configs import CNNS
    from repro_torch.drivers.async_events import async_events
    from repro_torch.drivers.elastic_scaling import elastic_scaling
    from repro_torch.drivers.observability import observability
    from repro_torch.drivers.quickstart import quickstart
    from repro_torch.kernels import masked_matmul as K
    lenet = CNNS["lenet"]
    single, client = {k: 0 for k in SINGLE}, {k: 0 for k in SINGLE}
    K.reset_launches()
    out = quickstart(lenet, device="cuda", kernels="cuda")
    s1, c1 = _counts()
    log(f"quickstart: cycles (loss, selected) {out['cycles']}, masked "
        f"launches {json.dumps(s1)}")
    if min(s1.values()) <= 0 or any(c1.values()) or \
            not all(math.isfinite(lo) for lo, _ in out["cycles"]):
        raise AssertionError(f"quickstart: launches {s1} / {c1}, cycles "
                             f"{out['cycles']}")
    single = _add(single, s1)
    runs = {}
    for kernels in ("cuda", "reference"):
        K.reset_launches()
        runs[kernels], new = elastic_scaling(lenet, "cuda", kernels)
        if kernels == "cuda":
            s1, _ = _counts()
            single = _add(single, s1)
        else:
            _no_launches("elastic", *_counts())
        log(f"elastic ({kernels}): newcomer cid {new.cid} straggler "
            f"{new.is_straggler} volume {new.volume:.4f}; accs "
            f"{[round(h['acc'], 4) for h in runs[kernels].history]}")
        if not new.is_straggler:
            raise AssertionError("elastic: the newcomer is not a straggler")
    for x, y in zip(runs["cuda"].history, runs["reference"].history):
        for key in ("cycle", "time", "volumes", "ratios"):
            if x[key] != y[key]:
                raise AssertionError(f"elastic: history {key} differs: "
                                     f"{x[key]} vs {y[key]}")
    log(f"elastic: max|param diff| kernel vs plain after 10 rounds x 5 "
        f"local steps {_param_diff(runs['cuda'], runs['reference']):.3e}; "
        f"masked launches {json.dumps(s1)}")
    if len(runs["cuda"].history) != len(runs["reference"].history) or \
            min(s1.values()) <= 0:
        raise AssertionError(f"elastic: histories or launches {s1}")
    K.reset_launches()
    ev = async_events(lenet, clients=64, jitter=0.3, dropout=0.1,
                      device="cuda", kernels="cuda")
    s1, c1 = _counts()
    seq, bkt = ev["sequential"]["run"], ev["bucketed"]["run"]
    log(f"async_events (64 clients, dropout 0.1, jitter 0.3): events/s "
        f"sequential {ev['sequential']['events_per_s']:.2f}, bucketed "
        f"{ev['bucketed']['events_per_s']:.2f}; masked launches "
        f"{json.dumps(s1)}, client-axis {json.dumps(c1)}")
    if (seq.events_processed, seq.events_dropped) != \
            (bkt.events_processed, bkt.events_dropped) or \
            min(s1.values()) <= 0 or min(c1.values()) <= 0:
        raise AssertionError(f"async_events: events {seq.events_processed} /"
                             f" {bkt.events_processed}, launches {s1} {c1}")
    single, client = _add(single, s1), _add(client, c1)
    obs = {}
    for kernels in ("cuda", "reference"):
        K.reset_launches()
        run, summ = observability(
            lenet, out=str(ROOT / "chiprun_out" / f"obs_repro_{kernels}"),
            device="cuda", kernels=kernels)
        obs[kernels] = run
        s1, c1 = _counts()
        log(f"observability ({kernels}): summary {json.dumps(summ)}; "
            f"client-axis launches {json.dumps(c1)}")
        if summ["rounds"] != len(run.history):
            raise AssertionError(f"observability: rounds {summ['rounds']} "
                                 f"vs {len(run.history)}")
        if kernels == "reference":
            _no_launches("observability", s1, c1)
            continue
        if min(c1.values()) <= 0 or any(s1.values()):
            raise AssertionError(f"observability: launches {s1} / {c1}")
        client = _add(client, c1)
    diff = _hold_paths("observability", obs["cuda"], obs["reference"],
                       ("cycle", "time", "volumes", "ratios"))
    log(f"observability: max|param diff| kernel vs plain after "
        f"{len(obs['cuda'].history)} rounds {diff:.3e}")
    return single, client


def repro_phase(kernels: list) -> None:
    """Phase 4m; adds its launches, LeNet's shapes' times and errors to the
    masked pair's rows of ``kernels``."""
    t0 = time.perf_counter()
    worst, times = check_lenet_kernels()
    log(f"LeNet kernel checks and times took {time.perf_counter() - t0:.1f}"
        f" s")
    t1 = time.perf_counter()
    tables = repro_figures(cut_rounds=REPRO_CUT_ROUNDS)
    log(f"the five tables took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    ex_single, ex_client = repro_examples()
    log(f"the four examples took {time.perf_counter() - t1:.1f} s")
    paths = {k: {"repro_tables": tables[k], "repro_examples": ex_single[k]}
             for k in SINGLE}
    paths.update({f"{k}_clients": {"repro_examples": ex_client[k]}
                  for k in SINGLE})
    for row in kernels:
        name = row["name"]
        if name not in paths:
            continue
        row.setdefault("launches_by_path", {})
        row["launches_by_path"].update(paths[name])
        row["launches"] += sum(paths[name].values())
        row["lenet"] = {"shapes": times[name], "max_abs_err": worst[name]}
    log(f"phase 4m took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 4n: DeepSeek-V2 (MLA) and SeamlessM4T (encoder-decoder)
# ---------------------------------------------------------------------------

#: DeepSeek-V2 at its published widths, with the cuts one card needs:
#: FLRun at 2 of 60 layers (the dense first layer and one MoE layer) and 8
#: of 160 routed experts (~10 f32 model copies), the launch's train step
#: at 2 layers and 16 routed experts (~6 copies: params, AdamW's moments,
#: the new state, the gradients), serving at 2 layers with all 160
#: routed experts
DS_FL = {"num_layers": 2, "num_experts": 8}
DS_LAUNCH = {"num_layers": 2, "num_experts": 16}
DS_SERVE = {"num_layers": 2}
#: the dense first layer's masked MLP at the LM batch (4 x 512 tokens,
#: d_model 5120, d_ff 12288)
DS_MLP = mlp_calls(LM_TOKENS, 5120, 12288)
#: a local step's kernel calls: the dense layer's masked MLP; MLA attends
#: through attn_impl (no flash: q / k head dim 192), the MoE layer takes
#: no kernel
DS_CALLS = {"masked_matmul": 6, "masked_matmul_dk": 3, "flash_attention": 0,
            "ssd_diag": 0}
#: SeamlessM4T-large-v2 at full size: launch steps at batch 8 x 512 with
#: stub frame embeddings 8 x 512 x 1024, in microbatches of 4
SM_ARCH, SM_BATCH, SM_SEQ, SM_STEPS, SM_MICRO = \
    "seamless-m4t-large-v2", 8, 512, 3, 2


def check_ds_kernels(g) -> tuple:
    """The masked pair at the dense first layer's six layouts, P = 0.5 and
    1, against its plain version (f32, twice, bit-identical, on
    ``tile128``); then the forward calls timed beside their bounds, the
    plain version and ``torch.matmul``.  Returns ({kernel: {label:
    times}}, the worst f32 errors)."""
    worst = {"masked_matmul": 0.0, "masked_matmul_dk": 0.0}
    for label, kernel, m, k, n, xl, wl in DS_MLP:
        for p in (0.5, 1.0):
            fn, plain, x, w, live, dead = _operands(kernel, m, k, n, xl, wl,
                                                    p, torch.float32, g)
            err, config = _check_call(f"DeepSeek-V2 {label} M={m} K={k} "
                                      f"N={n} P={p}", fn, plain, x, w, live,
                                      dead, BLOCK, torch.float32)
            if config != "tile128":
                raise AssertionError(f"DeepSeek-V2 {label} took {config}, "
                                     f"not tile128")
            worst[kernel] = max(worst[kernel], err)
            del x, w, dead
    _free()
    times = {k: {} for k in worst}
    for label, kernel, m, k, n, xl, wl in DS_MLP:
        if label not in ("wi/wg fwd", "wo fwd"):
            continue
        for p in (0.5, 1.0):
            t = _time_call(f"DeepSeek-V2 {label}", kernel, m, k, n, xl, wl, p,
                           g, 1)
            times[kernel][f"{label} P={p}"] = {"shape": [m, k, n], **t}
            _free()
    _reset_all()
    return times, worst


def ds_setting():
    """DeepSeek-V2 with ``DS_FL``'s cuts on the LM's data and fleet."""
    from repro_torch.configs import DEEPSEEK_V2_236B, HeliosConfig
    from repro_torch.data.federated import partition_by_topic
    from repro_torch.data.synthetic import markov_topic_tokens
    from repro_torch.models import init_params
    from repro_torch.models.module import tree_leaves
    cfg = dataclasses.replace(DEEPSEEK_V2_236B, **DS_FL)
    tokens, topics = markov_topic_tokens(256, LM_SEQ, LM_VOCAB, n_topics=8)
    test_tokens, _ = markov_topic_tokens(16, LM_SEQ, LM_VOCAB, n_topics=8,
                                         seed=9)
    parts = partition_by_topic(topics, 4, topics_per_client=2)
    t0 = time.perf_counter()
    init = init_params(cfg, 0, "cpu")        # host copy, reused by every run
    n = sum(v.numel() for v in tree_leaves(init))
    log(f"DeepSeek-V2 config: published widths (d_model {cfg.d_model}, "
        f"{cfg.num_heads} MLA heads, q / kv latent {cfg.q_lora_rank} / "
        f"{cfg.kv_lora_rank}, q-k head dims {cfg.qk_nope_head_dim} + "
        f"{cfg.qk_rope_head_dim}, v {cfg.v_head_dim}, dense d_ff {cfg.d_ff}, "
        f"experts of {cfg.moe_d_ff}, {cfg.num_shared_experts} shared, top-"
        f"{cfg.num_experts_per_tok}, vocab {cfg.vocab_size}); depth cut "
        f"{DEEPSEEK_V2_236B.num_layers} -> {cfg.num_layers}, routed experts "
        f"{DEEPSEEK_V2_236B.num_experts} -> {cfg.num_experts}; {n / 1e9:.4f}"
        f" B params drawn in {time.perf_counter() - t0:.1f} s; batch "
        f"{LM_BATCH} x {LM_SEQ} tokens, a 2 + 2 Table-I fleet, lr 0.05")
    return cfg, HeliosConfig(mask_block=BLOCK), {"tokens": tokens}, \
        {"tokens": test_tokens}, parts, init


def ds_path(st) -> dict:
    """Helios ``run_sync(2)`` at one local step on the plain path and then
    the kernel path, each kernel-path step replaying the plain path's
    expert choices from the same params; the kernel run's launches
    counted; history, straggler ratios and params held; a third round of
    each run (evaluation off, routing its own) timed; then the one-step
    hold with a straggler's masks and with full masks."""
    cfg = st[0]
    torch.cuda.reset_peak_memory_stats()
    hists, host, walls, tap, cross = {}, {}, {}, RouteTap(), RouteTap()
    launches, strag_masks, params = {}, None, None
    for name, kernels in (("plain", "reference"), ("cuda", "cuda")):
        run = make_lm_run("helios", kernels, st, local_steps=1)
        own_loss = run.adapter.loss_fn
        if name == "plain":
            record_routing(run, cross)
        else:
            shadow_plain_routing(run, tap, cross)
        _reset_all()
        hists[name], wall = timed_run(run, 2)
        launches[name] = _all_launches()
        log(f"DeepSeek-V2 helios {name}: 2 rounds x 1 local step in "
            f"{wall:.3f} s (the kernel path's with the plain forward that "
            f"records its routing); launches {json.dumps(launches[name])}")
        for row in hists[name]:
            log("  history", json.dumps(row))
        host[name] = _host_params(run)
        if not all(bool(torch.isfinite(v).all()) for v in host[name].values()):
            raise AssertionError(f"DeepSeek-V2 {name}: non-finite params")
        run.adapter.loss_fn = own_loss
        _, walls[name] = timed_run(run, 1, eval_every=0)
        if name == "cuda":
            strag = [r for c, r in zip(run.clients, hists[name][-1]["ratios"])
                     if c.is_straggler]
            if not strag or max(strag) >= 1.0:
                raise AssertionError(f"DeepSeek-V2 straggler ratios not below"
                                     f" 1: {strag}")
            strag_masks = next(c for c in run.clients
                               if c.is_straggler).helios_state["masks"]
            params = run.global_params
        del run
        _free()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: v * 4 * 2 for k, v in DS_CALLS.items()}
    log(f"DeepSeek-V2 round wall (a third round, evaluation off): kernel "
        f"{walls['cuda']:.3f} s, plain {walls['plain']:.3f} s; peak "
        f"{peak:.2f} GiB")
    if launches["cuda"] != want or any(launches["plain"].values()):
        raise AssertionError(f"DeepSeek-V2 launches {launches}, want {want} "
                             f"on the kernel path (the dense first layer's "
                             f"masked MLP) and none on the plain path")
    if peak > GR_PEAK_GIB:
        raise AssertionError(f"DeepSeek-V2 path peak {peak:.2f} GiB passes "
                             f"{GR_PEAK_GIB} GiB")
    k = cfg.num_experts_per_tok
    moe_layers = cfg.num_layers - cfg.first_k_dense
    tap.report("DeepSeek-V2 helios 2 rounds x 1 local step, each step's "
               "plain choices replayed into the kernel path", moe_layers, k,
               gate=True)
    cross.report("DeepSeek-V2 helios 2 rounds x 1 local step, the plain "
                 "run's choices against the plain path's on the kernel "
                 "run's params (ungated)", moe_layers, k, gate=False)
    diff = _host_diff(host["cuda"], host["plain"])
    log(f"DeepSeek-V2 helios 2 rounds x 1 local step: max|param diff| "
        f"kernel vs plain {diff:.3e}")
    del host
    for x, y in zip(hists["cuda"], hists["plain"]):
        for key in ("cycle", "time", "volumes", "ratios"):
            if x[key] != y[key]:
                raise AssertionError(f"DeepSeek-V2 history {key} differs: "
                                     f"{x[key]} vs {y[key]}")
        if abs(x["ce"] - y["ce"]) > F32_TOL or \
                abs(x["loss"] - y["loss"]) > F32_TOL:
            raise AssertionError(f"DeepSeek-V2 history differs: {x} vs {y}")
    if not diff <= F32_TOL:
        raise AssertionError(f"DeepSeek-V2 kernel path drifts from the plain "
                             f"path: {diff}")
    check_moe_step(st, params, strag_masks, "DeepSeek-V2")
    del params, strag_masks
    _free()
    return {"launches": launches["cuda"], "round_wall_s": walls,
            "peak_gib": peak, "hold": diff}


def ds_launch(g) -> dict:
    """``make_train_step`` at ``DS_LAUNCH``: one held step on each path
    (the plain path's expert choices replayed into the kernel path), then
    step walls in turns: three steps a path."""
    from repro_torch.configs import DEEPSEEK_V2_236B
    from repro_torch.models.module import tree_leaves
    cfg = dataclasses.replace(DEEPSEEK_V2_236B, **DS_LAUNCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    hcfg, tcfg, state, batch = _launch_setting(cfg, LM_BATCH, LM_SEQ, g)
    n_params = sum(v.numel() for v in tree_leaves(state["params"]))
    out = {"params_b": n_params / 1e9, "tokens": LM_BATCH * LM_SEQ}
    out.update(_hold_step(cfg, hcfg, tcfg, state, batch, host=True,
                          want=dict(DS_CALLS), tap=RouteTap()))
    out["walls"] = _step_walls(cfg, hcfg, tcfg, state, batch)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["seconds"] = time.perf_counter() - t0
    log(f"launch {cfg.name} ({cfg.num_layers} layers, {cfg.num_experts} "
        f"routed experts, {out['params_b']:.4f} B params): step walls "
        f"{json.dumps(out['walls'])}; peak {out['peak_gib']:.2f} GiB; "
        f"{out['seconds']:.1f} s")
    del state, batch
    _free()
    return out


def _check_cache(label: str, srv, params, batch, cfg) -> None:
    """The padded cache's layout: MLA's latent and RoPE key (no K / V) at
    the prompt plus the generated tokens; an encoder-decoder's self K / V
    there and its cross K / V at the encoder's length."""
    from repro_torch.launch import serve as SV
    _, cache = srv.prefill(params, batch)
    cache = SV.pad_cache(cache, SERVE_PROMPT + SERVE_GEN)
    if cfg.use_mla:
        shapes = [{k: tuple(v.shape) for k, v in c.items()}
                  for c in cache["kv"]]
        ok = all(set(c) == {"c_kv", "k_rope"}
                 and c["c_kv"][-2] == SERVE_PROMPT + SERVE_GEN
                 and c["c_kv"][-1] == cfg.kv_lora_rank
                 and c["k_rope"][-1] == cfg.qk_rope_head_dim for c in shapes)
    else:
        shapes = {w: tuple(cache["kv"][w]["k"].shape)
                  for w in ("self", "cross")}
        ok = shapes["self"][-3] == SERVE_PROMPT + SERVE_GEN and \
            shapes["cross"][-3] == SERVE_PROMPT
    log(f"serve {label}: padded cache {shapes}")
    if not ok:
        raise AssertionError(f"serve {label}: cache layout {shapes}")
    del cache


def _serve_hold(label: str, cfg, srv, params, batch, toks) -> dict:
    """The last decode step against one prefill over the same tokens at
    max(1e-4, twice a 2^-23-nudged twin's drift), a MoE model on the
    capacity-free dense dispatch with its routing flips gated; the
    readings (prefill ms, decode ms a step beside its byte bound); the
    params are nudged in place at the end."""
    from repro_torch.launch import serve as SV
    steps = SERVE_GEN - 1
    hold = srv
    if cfg.family == "moe":
        hold = SV.GenerationServer(cfg, SERVE_BATCH, SERVE_PROMPT,
                                   gen=SERVE_GEN, kernels="cuda")
        hold.rt["moe_impl"] = "dense"
    dec_log, full_log = _RouterLog(), _RouterLog()
    with dec_log.use():
        _, dec = _forced(hold, params, batch, toks, steps)
    with full_log.use():
        full = _full_prefill(hold, params, batch, toks, steps)
    if not all(bool(torch.isfinite(x).all()) for x in dec + [full]):
        raise AssertionError(f"serve {label}: non-finite logits")
    consistency = _max_diff(dec[-1], full)
    if cfg.family == "moe":
        _routing_flips(dec_log, full_log, cfg.num_layers - cfg.first_k_dense,
                       cfg.num_experts_per_tok, SERVE_PROMPT + steps)
    del dec, dec_log, full_log
    _check_cache(label, srv, params, batch, cfg)
    readings = _serve_readings(srv, params, batch, toks)
    _nudge(params, 1.0 + 2.0 ** -23)
    drift = _max_diff(_full_prefill(hold, params, batch, toks, steps), full)
    gate = max(F32_TOL, 2 * drift)
    log(f"serve {label}: last decode step against one prefill over the "
        f"same {SERVE_PROMPT + steps} tokens {consistency:.3e}; nudged drift"
        f" {drift:.3e}; gate {gate:.3e}; prefill "
        f"{readings['prefill_ms']:.3f} ms, decode "
        f"{readings['decode_ms_per_token']:.4f} ms a step (byte bound "
        f"{readings['decode_bound_ms']:.4f} ms: params "
        f"{readings['param_gb']:.3f} GB + live cache), profiled step "
        f"{readings['profiled_decode_step_ms']:.3f} ms, idle share "
        f"{readings['decode_idle_share']:.4f}"
        + (" (moe_impl dense)" if cfg.family == "moe" else ""))
    if not consistency <= gate:
        raise AssertionError(f"serve {label}: decode disagrees with a "
                             f"re-prefill: {consistency} > {gate}")
    del hold, full
    return {"consistency": consistency, "drift": drift, "gate": gate,
            **readings}


def ds_serving() -> dict:
    """DeepSeek-V2 at ``DS_SERVE`` through ``GenerationServer`` at the 4k
    cell (the serve CLI takes whole configs): greedy generation with the
    counters zeroed before and read after (no kernel: serving attends
    through attn_impl and runs the plain MLP), then the hold."""
    from repro_torch.configs import DEEPSEEK_V2_236B
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.launch import serve as SV
    from repro_torch.models import init_params
    from repro_torch.models.module import tree_leaves
    import numpy as np
    cfg = dataclasses.replace(DEEPSEEK_V2_236B, **DS_SERVE)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, "cuda")
    n_params = sum(v.numel() for v in tree_leaves(params))
    log(f"serve DeepSeek-V2: {cfg.num_layers} of "
        f"{DEEPSEEK_V2_236B.num_layers} layers, all {cfg.num_experts} routed "
        f"experts, {n_params / 1e9:.4f} B params drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    srv = SV.GenerationServer(cfg, SERVE_BATCH, SERVE_PROMPT, gen=SERVE_GEN,
                              kernels="cuda")
    batch = SV.serve_batch(markov_tokens(SERVE_BATCH, SERVE_PROMPT,
                                         cfg.padded_vocab, seed=0), "cuda",
                           cfg, np.random.default_rng(0))
    _reset_all()
    toks = srv(params, batch)
    launches = _all_launches()
    log(f"serve DeepSeek-V2: launches {json.dumps(launches)}; tokens[0][:8] "
        f"{toks[0, :8].tolist()}")
    if any(launches.values()):
        raise AssertionError(f"serve DeepSeek-V2 launches {launches}")
    out = {"layers": cfg.num_layers, "params_b": n_params / 1e9,
           **_serve_hold("DeepSeek-V2", cfg, srv, params, batch, toks)}
    out.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               seconds=time.perf_counter() - t0)
    log(f"serve DeepSeek-V2: peak {out['peak_gib']:.2f} GiB; "
        f"{out['seconds']:.1f} s")
    del params, srv, batch, toks
    _free()
    return out


def seamless_launch() -> dict:
    """SeamlessM4T at full size: ``SM_STEPS`` ``make_train_step`` steps
    (AdamW, Helios at volume 0.5) at ``SM_BATCH`` x ``SM_SEQ`` on
    ``launch.train.make_batch``'s batches: no kernel launched, every loss
    and param finite; step walls and the peak."""
    import numpy as np
    from repro_torch.configs import (SEAMLESS_M4T_LARGE_V2, HeliosConfig,
                                     TrainConfig)
    from repro_torch.core import soft_train as ST
    from repro_torch.data.synthetic import markov_tokens
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    from repro_torch.models.module import tree_leaves
    cfg = SEAMLESS_M4T_LARGE_V2
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    hcfg = HeliosConfig(contribution="grad_ema", mask_block=BLOCK)
    tcfg = TrainConfig(**HOLD_TCFG, microbatches=SM_MICRO)
    state = S.init_train_state(0, cfg, hcfg, tcfg, "cuda")
    state["helios"] = ST.begin_cycle(ST.set_volume(state["helios"], 0.5),
                                     hcfg)
    n_params = sum(v.numel() for v in tree_leaves(state["params"]))
    data = markov_tokens(64, SM_SEQ + 1, cfg.padded_vocab)
    rng = np.random.default_rng(0)
    step = S.make_train_step(cfg, hcfg, tcfg, _rt("cuda"))
    walls, losses = [], []
    _reset_all()
    for _ in range(SM_STEPS):
        batch = TR.make_batch(cfg, data, rng, SM_BATCH, SM_SEQ, "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        losses.append(float(met["loss"]))
    launches = _all_launches()
    finite = all(bool(torch.isfinite(v).all())
                 for v in tree_leaves(state["params"]))
    out = {"params_b": n_params / 1e9, "losses": losses, "step_s": walls,
           "launches": launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "seconds": time.perf_counter() - t0}
    log(f"launch {cfg.name} (full size: {cfg.enc_layers} + {cfg.dec_layers} "
        f"layers, {out['params_b']:.4f} B params; batch {SM_BATCH} x "
        f"{SM_SEQ} with frame embeddings {SM_BATCH} x {SM_SEQ} x "
        f"{cfg.d_model}, {SM_MICRO} microbatches): losses {losses}, step "
        f"walls {walls}; launches {json.dumps(launches)}; peak "
        f"{out['peak_gib']:.2f} GiB")
    if any(launches.values()) or not finite or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"launch {cfg.name}: launches {launches}, "
                             f"finite params {finite}, losses {losses}")
    del state, step
    _free()
    return out


def seamless_serving() -> dict:
    """SeamlessM4T at full size through the serve CLI at the 4k cell: no
    kernel launched; the self cache padded, the cross cache at the
    encoder's 512 frames; the hold."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rep = _serve_cli(SM_ARCH, "cuda")
    cfg, params, batch = rep["cfg"], rep["params"], rep["batch"]
    toks, srv = rep["tokens"], rep["server"]
    log(f"serve {SM_ARCH}: CLI prefill {rep['prefill_s']:.3f} s, decode "
        f"{rep['decode_s']:.3f} s for {SERVE_GEN - 1} steps; launches "
        f"{json.dumps(rep['launches'])}; frame embeddings "
        f"{tuple(batch['enc_embeds'].shape)}")
    if any(rep["launches"].values()) or \
            not bool(torch.isfinite(rep["prefill_logits"]).all()):
        raise AssertionError(f"serve {SM_ARCH}: launches {rep['launches']} "
                             f"or non-finite prefill logits")
    del rep
    out = _serve_hold(SM_ARCH, cfg, srv, params, batch, toks)
    out.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               seconds=time.perf_counter() - t0)
    log(f"serve {SM_ARCH}: peak {out['peak_gib']:.2f} GiB; "
        f"{out['seconds']:.1f} s")
    del params, srv, batch, toks
    _free()
    return out


def families_phase(kernels: list) -> None:
    """Phase 4n; adds DeepSeek-V2's masked-pair launches and its shape's
    times and errors to the rows of ``kernels``."""
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(51)
    times, worst = check_ds_kernels(g)
    st = ds_setting()
    fl = ds_path(st)
    del st
    _free()
    launch = ds_launch(g)
    serving = ds_serving()
    sm_launch = seamless_launch()
    sm_serving = seamless_serving()
    _add_to_rows(kernels, "deepseek_v2", times, worst,
                 {"deepseek_v2_flrun": fl["launches"],
                  "deepseek_v2_launch_step": launch["launches"]})
    log("families summary " + json.dumps(
        {"deepseek_v2_flrun": fl, "deepseek_v2_launch": launch,
         "deepseek_v2_serving": serving, "seamless_launch": sm_launch,
         "seamless_serving": sm_serving},
        default=lambda v: round(v, 6) if isinstance(v, float) else str(v)))
    log(f"phase 4n took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 4o: the batched engines on the dense LM and the hybrid
# ---------------------------------------------------------------------------

#: clients a cohort of the 2 + 2 fleet holds, and helios's cohorts a round
#: (the stragglers, the capables)
COHORT, COHORTS = 2, 2
#: the dense LM's client-axis masked calls a layer and cohort step: wi, wg
#: forward and dw, wo's dh and dwᵀ (column kernel); wo forward and wi / wg
#: dx (dk kernel)
LM_CLIENT_CALLS = {"masked_matmul": 6, "masked_matmul_dk": 3}
#: the shapes the kernels see with a cohort folded into the batch axis:
#: flash (C·B, H, S, hd, causal), ssd_diag (C·B, nc, L, ds, nh, hd)
FLASH_COHORT = (COHORT * LM_BATCH,) + FLASH_CASES[0][1:]
SSD_COHORT = (COHORT * LM_BATCH,) + SSD_CASES[0][1:]
#: device memory the dense LM's cohorts may hold before the run is cut
COHORT_PEAK_GIB = 72.0
#: the bucket engine's capable cycles on the hybrid, and its snapshot cap:
#: the ring holds max(cap, anchors + 1) + 1 model copies (the default cap
#: of 64 is 107 GiB at the hybrid's width); both engines take the same cap
HY_ASYNC_CYCLES, HY_SNAPSHOT_CAP = 4, 4


def check_cohort_kernels(g) -> list:
    """The kernels at the folded cohort shapes against their plain versions,
    then timed: flash at ``FLASH_COHORT`` (SDPA beside it), ``ssd_diag`` at
    ``SSD_COHORT`` (the model's decay), the masked pair's client entries at
    C = 2, M 2048, K 4096, N 11008 (wi / wg forward, dx and dw at P = 0.5 a
    client, forward and dx with the capable cohort's shared weight and
    every block live; all on tile128).  Returns the kernel rows (their
    launches filled in by the paths)."""
    from repro_torch.kernels import masked_matmul as K
    rows = []
    err = _check_flash_case(*FLASH_COHORT, torch.float32, g)
    t, bd, flops = _flash_times(*FLASH_COHORT, seed=63)
    _flash_line(FLASH_COHORT, t, bd, flops, LM_LAYERS * COHORTS)
    rows.append({"name": "flash_attention_cohort", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:70",
                 "shape": list(FLASH_COHORT[:4]), "launches": 0,
                 "max_abs_err": err, **t, "bound_ms": bd["bound_ms"],
                 "bound_by": bd["bound_by"],
                 "bound_f32_ms": bd["bound_f32_ms"]})
    err = _check_ssd_case(SSD_COHORT, torch.float32, True, 0, g)
    row = time_ssd(err, 0, HY_LAYERS * COHORTS, SSD_COHORT,
                   "ssd_diag_cohort", seed=64)
    rows.append({**row, "shape": list(SSD_COHORT)})
    c, m, k, n = COHORT, LM_TOKENS, LM_D, LM_FF
    worst = {"masked_matmul_clients": 0.0, "masked_matmul_dk_clients": 0.0}
    for kind, shared in (("fwd", False), ("dx", False), ("dw", False),
                         ("fwd", True), ("dx", True)):
        fn, plain, x, w, live, counts, dead, _ = _client_case(
            kind, c, m, k, n, torch.float32, g, shared,
            p=None if shared else 0.5)
        e, config = _check_client_call(
            f"LM {kind} C={c} M={m} K={k} N={n}"
            f"{' shared' if shared else ''}", fn, plain, x, w, live, counts,
            dead, torch.float32)
        if config != "tile128":
            raise AssertionError(f"LM cohort {kind} took {config}, not "
                                 f"tile128")
        worst[fn.__name__] = max(worst[fn.__name__], e)
        del x, w, dead
        _free()
    for kind, name in (("fwd", "masked_matmul"), ("dx", "masked_matmul_dk")):
        t = _time_client_call("LM wi/wg", kind, c, m, k, n, 0.5, g)
        rows.append({"name": f"{name}_clients_lm", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/masked_matmul.cu",
                     "replaces": "src/repro/kernels/masked_matmul.py:"
                                 + ("87" if name == "masked_matmul" else
                                    "103"),
                     "shape": [c, m, k, n], "launches": 0,
                     "max_abs_err": worst[f"{name}_clients"], **t})
        _free()
    K.reset_launches()
    return rows


def _cohort_launches(what: str, want: dict) -> dict:
    """Every counter after a cohort run against ``want`` (kernel ->
    launches; the client-axis pair as ``<kernel>_clients``): nothing else
    launched, flash and ssd_diag on 16-byte copies, the client-axis pair
    on tile128."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import masked_matmul as K
    from repro_torch.kernels import ssd_scan as SS
    got = {**_all_launches(), **{f"{k}_clients": v
                                 for k, v in K.CLIENT_LAUNCHES.items()}}
    log(f"{what} launches {json.dumps(got)}; client-axis by configuration "
        f"{json.dumps(K.CLIENT_CONFIG_LAUNCHES)}")
    full = {k: want.get(k, 0) for k in got}
    client = sum(K.CLIENT_LAUNCHES.values())
    if got != full or K.CLIENT_CONFIG_LAUNCHES["tile128"] != client or \
            FA.CONFIG_LAUNCHES["unaligned"] or SS.CONFIG_LAUNCHES["unaligned"]:
        raise AssertionError(f"{what}: launches {got}, want {full} (client "
                             f"configurations {K.CLIENT_CONFIG_LAUNCHES}, "
                             f"flash {FA.CONFIG_LAUNCHES}, ssd_diag "
                             f"{SS.CONFIG_LAUNCHES})")
    return got


def check_cohort_step(st, run, what: str) -> None:
    """One vmapped training step of each cohort on the kernel path (the
    round's first step: the global params, each client its own batch and
    masks) against plain autograd client by client: loss and every
    gradient within 1e-4 relative."""
    from repro_torch.core import soft_train as ST
    from repro_torch.federated.adapter import make_adapter
    from repro_torch.models.module import tree_paths
    cfg, _, train, _, _, _ = st
    batch = {"tokens": torch.as_tensor(
        train["tokens"][:COHORT * LM_BATCH]).cuda().reshape(
            COHORT, LM_BATCH, -1)}
    plain = make_adapter(cfg, "reference", BLOCK, torch.device("cuda"))
    step = torch.func.grad_and_value(run.adapter.loss_fn)
    strag = ST.stack_states([c.helios_state for c in run.clients
                             if c.is_straggler])["masks"]
    for who, masks, m_dim in (("straggler cohort", strag, 0),
                              ("capable cohort", run._ones, None)):
        grads, loss = torch.func.vmap(step, in_dims=(None, 0, m_dim))(
            run.global_params, batch, masks)
        grads = dict(tree_paths(grads))
        worst, at = 0.0, ""
        for i in range(COHORT):
            params = dict(tree_paths(run.global_params))
            for v in params.values():
                v.requires_grad_(True)
            mi = masks if m_dim is None else {k: v[i] for k, v in
                                              masks.items()}
            li = plain.loss_fn(run.global_params,
                               {"tokens": batch["tokens"][i]}, mi)
            gi = torch.autograd.grad(li, list(params.values()))
            for v in params.values():
                v.requires_grad_(False)
            li = li.detach()
            if not abs(float(loss[i] - li)) <= F32_TOL * abs(float(li)):
                raise AssertionError(f"{what} {who}: loss {float(loss[i])} "
                                     f"vs {float(li)}")
            for key, gk in zip(params, gi):
                d = float((grads[key][i] - gk).abs().max()) / \
                    max(float(gk.abs().max()), 1e-30)
                if d > worst:
                    worst, at = d, key
            del gi, li
        log(f"{what} step {who}: losses {[float(v) for v in loss]}, worst "
            f"max|grad diff|/max|grad| against per-client plain autograd "
            f"{worst:.3e} ({at})")
        del grads, loss
        _free()
        if not worst <= F32_TOL:
            raise AssertionError(f"{what} {who}: the vmapped step disagrees "
                                 f"with plain autograd ({worst} at {at})")


def _cohort_runs(st, what: str, want: dict, profile: bool = False) -> dict:
    """``BatchedFLRun`` helios run_sync(2) x 1 local step on the kernel path
    (counters zeroed before and read after against ``want``, the peak, a
    warm third round's wall, then each cohort's vmapped step against plain
    autograd and, with ``profile``, a round under the profiler), then the
    batched plain path and ``FLRun``'s plain path from the same params,
    both held at 1e-4."""
    from repro_torch.federated import BatchedFLRun
    from repro_torch.models.module import tree_paths
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    run = make_lm_run("helios", "cuda", st, local_steps=1,
                      engine=BatchedFLRun)
    hist, wall = timed_run(run, 2)
    out = {"launches": _cohort_launches(f"{what} batched helios", want),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "walls": {"batched cuda": wall}}
    for row in hist:
        log("  history", json.dumps(row))
    for k, v in tree_paths(run.global_params):
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: non-finite {k}")
    strag = [r for c, r in zip(run.clients, hist[-1]["ratios"])
             if c.is_straggler]
    if not strag or max(strag) >= 1.0:
        raise AssertionError(f"{what} straggler ratios not below 1: {strag}")
    host, hists = {"cuda": _host_params(run)}, {"cuda": hist}
    _, out["round_s"] = timed_run(run, 1, eval_every=0)
    log(f"{what} batched helios: 2 rounds x 1 local step in {wall:.3f} s "
        f"(evaluation included), a third round {out['round_s']:.3f} s; "
        f"peak {out['peak_gib']:.2f} GiB")
    check_cohort_step(st, run, what)
    if profile:
        out["profile"] = profile_round(run, f"batched helios {what} round "
                                            f"(2 + 2, 1 local step)")
    del run
    _free()
    for name, engine in (("batched plain", BatchedFLRun),
                         ("FLRun plain", None)):
        r = make_lm_run("helios", "reference", st, local_steps=1,
                        engine=engine)
        hists[name], out["walls"][name] = timed_run(r, 2)
        host[name] = _host_params(r)
        del r
        _free()
    out["vs_batched_plain"] = _hold_lm(
        f"{what} batched kernel vs batched plain", hists["cuda"],
        host["cuda"], hists["batched plain"], host["batched plain"], False)
    out["vs_flrun_plain"] = _hold_lm(
        f"{what} batched kernel vs FLRun plain", hists["cuda"], host["cuda"],
        hists["FLRun plain"], host["FLRun plain"], True)
    log(f"{what} helios run_sync(2) x 1 local step: max|param diff| batched "
        f"kernel vs batched plain {out['vs_batched_plain']:.3e}, vs FLRun "
        f"plain {out['vs_flrun_plain']:.3e}; walls s (2 rounds, evaluation "
        f"included) {json.dumps(out['walls'])}")
    return out


def lm_cohort_path(st) -> dict:
    """The dense LM at DeepSeek-7B width on ``BatchedFLRun``
    (:func:`_cohort_runs`, profiled): flash once a layer, local step and
    cohort, the masked MLP on the client-axis pair, nothing else; the peak
    beside the memory arithmetic."""
    from repro_torch.models.module import tree_leaves
    cfg, init = st[0], st[5]
    copy = 4 * sum(v.numel() for v in tree_leaves(init)) / 2 ** 30
    logits = COHORT * LM_BATCH * LM_SEQ * cfg.padded_vocab * 4 / 2 ** 30
    log(f"LM cohort memory arithmetic: one copy {copy:.2f} GiB; a cohort of "
        f"{COHORT} holds stacked params, grads and momentum (6 copies), the "
        f"other cohort's results, the global and the aggregation ~4 more: "
        f"{10 * copy:.2f}-{11 * copy:.2f} GiB, plus the vmapped logits "
        f"{logits:.2f} GiB and their gradient")
    steps = LM_LAYERS * COHORTS * 2                 # x 1 step x 2 rounds
    out = _cohort_runs(st, "LM cohort", {
        "flash_attention": steps,
        **{f"{k}_clients": v * steps for k, v in LM_CLIENT_CALLS.items()}},
        profile=True)
    out["arithmetic_gib"] = [10 * copy, 11 * copy, logits]
    log(f"LM cohort peak {out['peak_gib']:.2f} GiB against the arithmetic's "
        f"{10 * copy:.2f}-{11 * copy:.2f} GiB + logits {logits:.2f} GiB")
    if out["peak_gib"] > COHORT_PEAK_GIB:
        raise AssertionError(f"LM cohort peak {out['peak_gib']:.2f} GiB past "
                             f"{COHORT_PEAK_GIB} GiB")
    return out


def hybrid_cohort_path(st) -> dict:
    """Zamba2 at full width (``HY_LAYERS`` Mamba2 layers) on
    ``BatchedFLRun`` (:func:`_cohort_runs`: ``ssd_diag`` once a Mamba2
    layer, local step and cohort, no other kernel), then the bucket
    engine's asyn on the kernel path against its plain path and against
    ``FLRun.run_async``'s plain path: events equal, history's cycles and
    times equal between the bucket runs, params within 1e-4."""
    from repro_torch.federated import AsyncFLRun, FLRun
    cfg = st[0]
    out = _cohort_runs(st, "hybrid cohort",
                       {"ssd_diag": cfg.num_layers * COHORTS * 2})
    runs, walls = {}, {}
    for name, kernels, engine in (("bucket cuda", "cuda", AsyncFLRun),
                                  ("bucket plain", "reference", AsyncFLRun),
                                  ("FLRun plain", "reference", FLRun)):
        _reset_all()
        r = make_lm_run("asyn", kernels, st, local_steps=1, engine=engine)
        _, walls[name] = timed_async(r, HY_ASYNC_CYCLES,
                                     snapshot_cap=HY_SNAPSHOT_CAP)
        if name == "bucket cuda":
            buckets = list(r.bucket_sizes)
            # each bucket's training is one vmapped local step
            out["async_launches"] = _cohort_launches(
                f"hybrid bucket engine asyn (buckets {buckets})",
                {"ssd_diag": cfg.num_layers * len(buckets)})
        runs[name] = (r.events_processed, list(r.history), _host_params(r))
        del r
        _free()
    ev = {k: v[0] for k, v in runs.items()}
    a, b, s = runs["bucket cuda"], runs["bucket plain"], runs["FLRun plain"]
    out["async_vs_plain"] = _host_diff(a[2], b[2])
    out["async_vs_flrun"] = _host_diff(a[2], s[2])
    log(f"hybrid asyn run_async({HY_ASYNC_CYCLES}) x 1 local step: buckets "
        f"{buckets}, events {json.dumps(ev)}; max|param diff| bucket kernel "
        f"vs bucket plain {out['async_vs_plain']:.3e}, vs FLRun plain "
        f"{out['async_vs_flrun']:.3e}; walls s {json.dumps(walls)}")
    same_rows = [(x["cycle"], x["time"]) for x in a[1]] == \
        [(y["cycle"], y["time"]) for y in b[1]]
    if len(set(ev.values())) != 1 or not same_rows or \
            not max(out["async_vs_plain"], out["async_vs_flrun"]) <= 1e-4:
        raise AssertionError(f"hybrid bucket engine: events {ev}, history "
                             f"rows equal {same_rows}, params "
                             f"{out['async_vs_plain']} / "
                             f"{out['async_vs_flrun']}")
    out.update(buckets=buckets, events=ev, async_walls=walls)
    return out


def _add_launches(kernels: list, path: str, counts: dict) -> None:
    """Add a path's launches ({row name: launches}) to the rows of
    ``kernels``."""
    for row in kernels:
        n = counts.get(row["name"], 0)
        if n:
            row.setdefault("launches_by_path", {})[path] = n
            row["launches"] += n


def cohort_phase(kernels: list) -> None:
    """Phase 4o; appends the folded-shape rows to ``kernels`` and adds the
    cohort paths' launches to the kernels' own rows."""
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(61)
    rows = check_cohort_kernels(g)
    t1 = time.perf_counter()
    st = lm_setting()
    lm = lm_cohort_path(st)
    del st
    _free()
    t2 = time.perf_counter()
    st = hybrid_setting()
    hy = hybrid_cohort_path(st)
    del st
    _free()
    log(f"phase 4o: kernel checks and times {t1 - t0:.1f} s, the LM "
        f"{t2 - t1:.1f} s, the hybrid {time.perf_counter() - t2:.1f} s")
    lm_l, hy_l = lm["launches"], hy["launches"]
    by_row = {"flash_attention_cohort": lm_l["flash_attention"],
              "masked_matmul_clients_lm": lm_l["masked_matmul_clients"],
              "masked_matmul_dk_clients_lm": lm_l["masked_matmul_dk_clients"],
              "ssd_diag_cohort": hy_l["ssd_diag"]
              + hy["async_launches"]["ssd_diag"]}
    if min(by_row.values()) <= 0:
        raise AssertionError(f"a kernel never launched on phase 4o's paths: "
                             f"{by_row}")
    for row in rows:
        row["launches"] = by_row[row["name"]]
    kernels += rows
    _add_launches(kernels, "lm_cohort",
                  {"flash_attention": lm_l["flash_attention"],
                   "masked_matmul_clients": lm_l["masked_matmul_clients"],
                   "masked_matmul_dk_clients":
                       lm_l["masked_matmul_dk_clients"]})
    _add_launches(kernels, "hybrid_cohort",
                  {"ssd_diag": by_row["ssd_diag_cohort"]})
    log("cohort summary " + json.dumps(
        {"lm": lm, "hybrid": hy},
        default=lambda v: round(v, 6) if isinstance(v, float) else str(v)))
    log(f"phase 4o took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 4p: the population engine
# ---------------------------------------------------------------------------

#: AlexNet's population (half stragglers) and its cohort a round: the
#: reference example's defaults; one local step of batch 16, lr 0.05
POP_N, POP_K, POP_BATCH = 1024, 32, 16
#: LeNet's population, sampled POP_LENET_K a round under topk
POP_LENET_N, POP_LENET_K = 100_000, 64
#: the three-way wall's full-participation fleet
POP_WALL_N = 64


def _pop_rows(pop: dict, idx) -> dict:
    """Copies of population rows ``idx``, flattened to {path: array}."""
    from repro_torch.models.module import tree_paths
    return {k: v[idx].copy() for k, v in tree_paths(pop)}


def _pop_run(kernels: str, st, n: int, k: int, sampler: str = "uniform",
             engine=None, **kw):
    """A helios run over ``n`` clients of ``st``'s IID partition (half
    stragglers), ``k`` a round (0: all), on ``ShardedFLRun`` unless
    ``engine`` is given."""
    from repro_torch.federated import ShardedFLRun
    return make_run("helios", kernels, st, fleet=(n - n // 2, n // 2),
                    engine=engine or ShardedFLRun, local_steps=1,
                    batch_size=POP_BATCH, participation=k, sampler=sampler,
                    **kw)


def alexnet_population_path(st) -> dict:
    """Full-width AlexNet, a population of POP_N clients, POP_K a round:
    uniform and time-weighted ``run_sync(2)`` on the kernel path with the
    counters zeroed before and read after (6 client-axis launches a local
    step and rank block, none single-client), undrawn rows bit for bit as
    they were, the kernel path held to the plain path; round walls in
    turns, a profiled round with its peak; then the three-way wall at
    POP_WALL_N clients: ``ShardedFLRun`` against ``BatchedFLRun`` and
    ``FLRun`` on the card."""
    import numpy as np
    from repro_torch.core import soft_train as ST
    from repro_torch.data.federated import partition_iid, partition_iid_lazy
    from repro_torch.federated import BatchedFLRun, FLRun
    from repro_torch.kernels import masked_matmul as K
    cfg, hcfg, train, test, _ = st
    pop = (cfg, hcfg, train, test,
           list(partition_iid_lazy(len(train["labels"]), POP_N, seed=0)))
    out = {"launches": {k: 0 for k in CLIENT_CALLS_PER_STEP}}
    runs = {}
    for sampler, kernels in (("uniform", "cuda"), ("uniform", "reference"),
                             ("time_weighted", "cuda")):
        run = _pop_run(kernels, pop, POP_N, POP_K, sampler)
        before = _pop_rows(run._pop_state, slice(None))
        K.reset_launches()
        hist, wall = timed_run(run, 2)
        what = f"sharded {sampler} {kernels}"
        if kernels == "cuda":
            got = _expect_client_launches(what, 2, {"splitk": 4,
                                                   "tile128": 2})
            out["launches"] = _add(out["launches"], got)
        elif any(K.LAUNCHES.values()) or any(K.CLIENT_LAUNCHES.values()):
            raise AssertionError(f"{what}: the plain path launched a kernel")
        _finite(run, what)
        drawn = sorted({i for c in run.cohort_log for i in c})
        undrawn = np.setdiff1d(np.arange(POP_N), drawn)
        after = _pop_rows(run._pop_state, slice(None))
        for key, v in before.items():
            if not np.array_equal(v[undrawn], after[key][undrawn]):
                raise AssertionError(f"{what}: undrawn rows moved ({key})")
        strag = [i for i in drawn if run.clients[i].is_straggler]
        cycles = run._pop_state["cycle"]
        want = [sum(i in c for c in run.cohort_log) for i in strag]
        if cycles[strag].tolist() != want or any(
                cycles[i] for i in drawn if i not in strag):
            raise AssertionError(f"{what}: cycles {cycles[drawn]} not the "
                                 f"draws")
        ratios = [r for c, r in zip(run.cohort_log[-1], hist[-1]["ratios"])
                  if run.clients[c].is_straggler]
        if not ratios or max(ratios) >= 1.0:
            raise AssertionError(f"{what}: straggler ratios {ratios}")
        log(f"{what}: 2 rounds in {wall:.3f} s (first rounds of the run), "
            f"cohorts {run.cohort_log}, {len(drawn)} of {POP_N} drawn, "
            f"{len(undrawn)} undrawn rows bit-identical, kpad {run._kpad}, "
            f"acc {[round(h['acc'], 4) for h in hist]}")
        runs[sampler, kernels] = run
    a, b = runs["uniform", "cuda"], runs["uniform", "reference"]
    diff = _hold_batched("sharded population", a, b)
    if runs["time_weighted", "cuda"].cohort_log == a.cohort_log:
        raise AssertionError("the time-weighted sampler drew the uniform "
                             "cohorts")
    nbytes = ST.population_nbytes(a._pop_state)
    log(f"sharded population run_sync(2) kernel path held to the plain path:"
        f" max|param diff| {diff:.3e}; population rows on the host "
        f"{nbytes} B ({nbytes / POP_N:.1f} B a client)")
    # round walls: the two paths' warm runs, two rounds each, in turns
    walls = {"cuda": [], "reference": []}
    for kernels in ("cuda", "reference", "reference", "cuda"):
        run = runs["uniform", kernels]
        walls[kernels].append(timed_run(run, 2, eval_every=0)[1] / 2)
    log(f"sharded population round wall s (K={POP_K} of {POP_N}, warm): "
        + json.dumps(walls))
    _free()
    torch.cuda.reset_peak_memory_stats()
    prof = profile_round(a, f"sharded round (K={POP_K} of {POP_N})",
                         host_top=10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"sharded population round peak device memory {peak:.3f} GiB")
    out.update(walls=walls, peak_gib=peak, host_bytes=nbytes, hold=diff,
               profile=prof)
    del runs, a, b
    _free()
    # the three-way wall: every client of a POP_WALL_N fleet, 2 rounds
    wall_st = (cfg, hcfg, train, test,
               partition_iid(len(train["labels"]), POP_WALL_N))
    three = {}
    for engine in (FLRun, BatchedFLRun, None):
        K.reset_launches()
        run = _pop_run("cuda", wall_st, POP_WALL_N, 0, engine=engine)
        timed_run(run, 2)
        _finite(run, f"three-way {type(run).__name__}")
        three[type(run).__name__] = run
    got = _expect_client_launches("sharded full participation", 2,
                                  {"splitk": 4, "tile128": 2})
    out["launches"] = _add(out["launches"], got)
    s = three["ShardedFLRun"]
    d_b = _hold_batched("sharded vs batched", s, three["BatchedFLRun"])
    d_f = _hold_batched("sharded vs sequential", s, three["FLRun"])
    log(f"three-way wall at {POP_WALL_N} clients, 2 rounds x 1 step, kernel "
        f"path: max|param diff| sharded vs batched {d_b:.3e}, vs FLRun "
        f"{d_f:.3e}")
    out["three_way"] = {"batched": d_b, "sequential": d_f}
    return out


def check_population_kernels(g) -> tuple:
    """The client-axis pair at the LeNet cohort's shapes (C = POP_LENET_K,
    M = POP_BATCH; fc0 K 256, N 120; fc1 K 120, N 84): forward, dx and dw,
    the clients' one block live or dead, held against the plain versions
    and repeated bit-identical; then fc0's forward and dx timed at P = 1
    beside their bounds, the plain versions and ``torch.bmm``.  Returns
    the kernel rows (launches filled in by the path)."""
    from repro_torch.kernels import masked_matmul as K
    worst = {"masked_matmul_clients": 0.0, "masked_matmul_dk_clients": 0.0}
    c, m = POP_LENET_K, POP_BATCH
    for layer, (k, n) in LENET_LAYERS.items():
        for kind in ("fwd", "dx", "dw"):
            fn, plain, x, w, live, counts, dead, _ = _client_case(
                kind, c, m, k, n, torch.float32, g)
            err, config = _check_client_call(
                f"LeNet population {layer} {kind} C={c} m={m} k={k} n={n}",
                fn, plain, x, w, live, counts, dead, torch.float32)
            if kind != "dw" and config != "splitk":
                raise AssertionError(f"LeNet population {layer} {kind} took "
                                     f"{config}, not splitk")
            worst[fn.__name__] = max(worst[fn.__name__], err)
    rows = []
    k, n = LENET_LAYERS["fc0"]
    for kind, name in (("fwd", "masked_matmul"), ("dx", "masked_matmul_dk")):
        t = _time_client_call("LeNet population fc0", kind, c, m, k, n, 1.0,
                              g, 8)
        rows.append({"name": f"{name}_clients_population", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/masked_matmul.cu",
                     "replaces": "src/repro/kernels/masked_matmul.py:"
                                 + ("87" if name == "masked_matmul" else
                                    "103"),
                     "shape": [c, m, k, n], "launches": 0,
                     "max_abs_err": worst[f"{name}_clients"], **t})
    K.reset_launches()
    return rows


def lenet_population_path() -> dict:
    """Full-width LeNet, a population of POP_LENET_N clients cycling an
    8-device Table-I template fleet over one shared index array (the
    reference's ``benchmarks/million_worker.py`` build), POP_LENET_K a
    round under ``topk``: set-up time, a warm-up round, then 2 rounds with
    the counters zeroed before and read after (6 client-axis launches a
    local step, none single-client), every param finite, undrawn rows at
    their initial values, error rows for the drawn clients only, the
    round wall, the host bytes and the peak."""
    import numpy as np
    from repro_torch.configs import LENET, HeliosConfig
    from repro_torch.core import soft_train as ST
    from repro_torch.data.synthetic import class_gaussian_images
    from repro_torch.federated import (Client, ShardedFLRun, make_fleet,
                                       setup_clients)
    from repro_torch.kernels import masked_matmul as K
    cfg, hcfg = LENET, HeliosConfig()
    imgs, labels = class_gaussian_images(4096, cfg.image_size,
                                         cfg.in_channels, cfg.num_classes)
    ti, tl = class_gaussian_images(256, cfg.image_size, cfg.in_channels,
                                   cfg.num_classes, seed=99)
    t0 = time.perf_counter()
    tmpl = setup_clients(make_fleet(4, 4), [np.arange(8)] * 8, hcfg,
                         device="cuda")
    idx = np.arange(len(labels))
    clients = [Client(cid=i, profile=tmpl[i % 8].profile, data_idx=idx,
                      volume=tmpl[i % 8].volume,
                      is_straggler=tmpl[i % 8].is_straggler)
               for i in range(POP_LENET_N)]
    run = ShardedFLRun(cfg, hcfg, "helios", clients,
                       {"images": imgs, "labels": labels},
                       {"images": ti, "labels": tl}, local_steps=1,
                       batch_size=POP_BATCH, lr=0.05,
                       participation=POP_LENET_K, compression="topk",
                       kernels="cuda", device="cuda")
    setup_s = time.perf_counter() - t0
    nbytes = ST.population_nbytes(run._pop_state)
    timed_run(run, 1, eval_every=0)                       # warm-up round
    _free()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    _, wall = timed_run(run, 2, eval_every=0)
    launches = dict(K.CLIENT_LAUNCHES)
    want = {k: v * 2 for k, v in CLIENT_CALLS_PER_STEP.items()}
    log(f"LeNet population client-axis launches {json.dumps(launches)}, "
        f"single-client {json.dumps(K.LAUNCHES)} over 2 rounds")
    if launches != want or any(K.LAUNCHES.values()):
        raise AssertionError(f"LeNet population launches {launches} / "
                             f"{K.LAUNCHES}, want {want} / none")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _finite(run, "LeNet population")
    drawn = sorted({i for c in run.cohort_log for i in c})
    rest = np.setdiff1d(np.arange(POP_LENET_N), drawn)
    pop = run._pop_state
    fresh = all(bool((pop[part][k][rest] == fill).all())
                for part, fill in (("masks", 1), ("scores", 0),
                                   ("skip_counts", 0)) for k in pop[part]) \
        and not pop["cycle"][rest].any() and \
        not pop["rng"]["splits"][rest].any()
    touched = run._err_store.touched()
    if not fresh or touched != len(drawn):
        raise AssertionError(f"LeNet population: undrawn rows moved "
                             f"({not fresh}) or error rows {touched} != "
                             f"{len(drawn)} drawn")
    acc = run.evaluate()
    up = run.uplink_bytes() / run.uplink_updates
    log(f"LeNet population N={POP_LENET_N} K={POP_LENET_K} topk: set-up "
        f"{setup_s:.3f} s, round {wall / 2:.4f} s (warm), host rows "
        f"{nbytes} B ({nbytes / POP_LENET_N:.1f} B a client), peak "
        f"{peak:.3f} GiB, {len(drawn)} drawn over {len(run.cohort_log)} "
        f"rounds, error rows {touched} ({run._err_store.nbytes()} B), "
        f"uplink {up:.1f} B an update (dense {4 * run._n_params} B), acc "
        f"{acc:.4f}")
    return {"setup_s": setup_s, "round_s": wall / 2, "host_bytes": nbytes,
            "peak_gib": peak, "launches": launches}


def population_phase(kernels: list) -> None:
    """Phase 4p; appends the LeNet cohort's rows to ``kernels`` and adds the
    AlexNet paths' launches to the client-axis rows."""
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(67)
    rows = check_population_kernels(g)
    t1 = time.perf_counter()
    alex = alexnet_population_path(setting())
    _free()
    t2 = time.perf_counter()
    lenet = lenet_population_path()
    _free()
    log(f"phase 4p: kernel checks and times {t1 - t0:.1f} s, AlexNet "
        f"{t2 - t1:.1f} s, LeNet {time.perf_counter() - t2:.1f} s")
    for row in rows:
        row["launches"] = lenet["launches"][row["name"].replace(
            "_clients_population", "")]
    kernels += rows
    _add_launches(kernels, "population_sharded",
                  {f"{k}_clients": v for k, v in alex["launches"].items()})
    log("population summary " + json.dumps(
        {"alexnet": alex, "lenet": lenet},
        default=lambda v: round(v, 6) if isinstance(v, float) else str(v)))
    log(f"phase 4p took {time.perf_counter() - t0:.1f} s")


def _device_us(e) -> float:
    """Self device time of a profiler row (the attribute was renamed)."""
    t = getattr(e, "self_device_time_total", None)
    return float(t if t is not None else e.self_cuda_time_total)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    start = time.perf_counter()
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

    def mark(what: str) -> None:
        log(f"[{time.perf_counter() - start:.1f} s] {what} done")

    mark("build")
    worst = check_kernels()
    st = setting()
    launches = main_path(st)
    time_rounds(st)
    mark("phases 3, 4, 5")
    async_launches = async_path(st)
    cohort_launches = cohort_path(six_client_setting(st))
    mark("phases 4d, 4e")
    client_worst = check_client_kernels()
    batched_launches = batched_path(st)
    time_batched_rounds(st)
    population = population_path(st)
    mark("phases 3d, 4g")
    scheme_launches = schemes_path(st)
    comp_launches = compression_path(st)
    client_kernels = time_client_kernels(
        client_worst, {"batched": batched_launches,
                       "population": population["launches"],
                       **scheme_launches["client"],
                       "compression": comp_launches["client"]})
    del st
    _free()
    resnet_path()
    _free()
    mark("phases 4i, 4j, 4f")

    flash_worst = check_flash()
    lm_st = lm_setting()
    lm_launches = lm_path(lm_st)
    lm_times = time_lm_mlp()
    kernels = time_kernels(worst, {"alexnet": launches,
                                   "async": async_launches,
                                   "cohort": cohort_launches,
                                   **scheme_launches["single"],
                                   "compression": comp_launches["single"],
                                   "lm": lm_launches}, lm_times)
    kernels += client_kernels
    kernels.append(time_flash(flash_worst, lm_launches["flash_attention"],
                              lm_launches["flash_attention"] // 4))
    time_lm_round(lm_st)
    del lm_st
    _free()
    mark("phases 3b, 4b, 5b")

    ssd_worst = check_ssd()
    hy_st = hybrid_setting()
    hy_launches = hybrid_path(hy_st)
    kernels.append(time_ssd(ssd_worst, hy_launches["ssd_diag"],
                            hy_launches["ssd_diag"] // 4))
    time_hybrid_round(hy_st)
    del hy_st
    _free()
    mark("phases 3c, 4c, 5c")

    granite_phase(kernels)
    _free()
    mark("phases 3e, 4h, 5d")

    serve_phase(kernels)
    _free()
    mark("phase 4k")

    launch_phase(kernels)
    _free()
    mark("phase 4l")

    repro_phase(kernels)
    _free()
    mark("phase 4m")

    families_phase(kernels)
    _free()
    mark("phase 4n")

    cohort_phase(kernels)
    _free()
    mark("phase 4o")

    population_phase(kernels)

    log(f"chip_smoke.py ran {time.perf_counter() - start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
