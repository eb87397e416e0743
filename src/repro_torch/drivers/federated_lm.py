# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Federated language-model training through the family-adapter seam: the
example's three-scheme table on a token-stream family.

The round engines that reproduce the paper's CNN testbed federate a small
transformer (or the Mamba2 hybrid) on Non-IID token streams: clients hold
documents from a few Markov "topics" (``data.synthetic.markov_topic_tokens``
+ ``data.federated.partition_by_topic``), stragglers soft-train rotating
sub-models, and the server tracks test cross-entropy.  Syn FL, ST-only and
Helios each print their CE trajectory, simulated time and time per cycle.

    python -m repro_torch.drivers.federated_lm --rounds 6
    python -m repro_torch.drivers.federated_lm --engine batched --clients 16
    python -m repro_torch.drivers.federated_lm --arch zamba2-1.2b \\
        --engine batched --device cpu --rounds 2

``--engine batched`` runs :class:`BatchedFLRun`: each local step of a
cohort is one vmapped step, whose flash attention / ``ssd_diag`` calls and
masked MLP products are one kernel launch for the whole cohort.  It takes
the dense and hybrid families; a MoE or xLSTM ``--arch`` raises the
engine's refusal.  The configs are ``reduced()``, as in the example; the
engines run the CUDA kernels on the GPU and their plain versions on the
CPU unless ``--kernels`` says otherwise.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Mapping, Optional

import numpy as np

from repro_torch.configs import ARCHS, HeliosConfig, reduced
from repro_torch.data.federated import label_distribution, partition_by_topic
from repro_torch.data.synthetic import markov_topic_tokens
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated import (BatchedFLRun, FLRun, make_fleet,
                                   setup_clients)

#: the table's schemes, in the example's order
SCHEMES = ("syn", "st_only", "helios")


def federated_lm(arch: str = "deepseek-7b", rounds: int = 6,
                 clients: int = 4, engine: str = "sequential",
                 topics: int = 8, seq: int = 48, data_vocab: int = 64,
                 device: DeviceLike = None, kernels: Optional[str] = None,
                 init_params: Optional[Mapping] = None
                 ) -> Dict[str, List[dict]]:
    """Print the three-scheme table on ``reduced(ARCHS[arch])`` and return
    {scheme: history}.  ``init_params`` starts every run from the same
    params (None draws them from the engines' seed)."""
    dev = resolve_device(device)
    runner = BatchedFLRun if engine == "batched" else FLRun
    cfg = reduced(ARCHS[arch])
    hcfg = HeliosConfig()

    dv = min(data_vocab, cfg.vocab_size)
    tokens, topic_ids = markov_topic_tokens(96 * clients, seq, dv,
                                            n_topics=topics, seed=0)
    test_tokens, _ = markov_topic_tokens(192, seq, dv, n_topics=topics,
                                         seed=99)
    parts = partition_by_topic(topic_ids, clients, topics_per_client=2)
    cover = (label_distribution(topic_ids, parts, topics) > 0).sum(axis=1)
    print(f"== {arch} ({cfg.family}), {clients} clients, {topics} topics "
          f"(each client covers {cover.min()}-{cover.max()}), "
          f"engine={engine} ==")
    print(f"model-uniform CE = ln({cfg.vocab_size}) = "
          f"{np.log(cfg.vocab_size):.2f}; stream-uniform = ln({dv}) = "
          f"{np.log(dv):.2f}; Markov floor ~= ln(8) = 2.08")

    nc = clients - clients // 2
    out = {}
    for scheme in SCHEMES:
        fleet = setup_clients(make_fleet(nc, clients // 2), parts, hcfg,
                              device=dev)
        run = runner(cfg, hcfg, scheme, fleet, {"tokens": tokens},
                     {"tokens": test_tokens}, local_steps=4, batch_size=8,
                     lr=0.5, seed=0, eval_batch=64, kernels=kernels,
                     device=dev, init_params=init_params)
        hist = run.run_sync(rounds)
        traj = " -> ".join(f"{h['ce']:.2f}" for h in hist)
        print(f"{scheme:7s} | CE {traj} | sim time {hist[-1]['time']:6.1f} "
              f"| time/cycle {hist[-1]['time'] / hist[-1]['cycle']:.2f}")
        out[scheme] = hist
    print("\nstragglers soft-train sub-models; Helios's Eq. 10 aggregation "
          "weighs them by selected fraction — same engines, new family.")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-7b",
                    help="a token-stream family (dense / moe / ssm / "
                         "hybrid), reduced(); the batched engine takes "
                         "dense and hybrid")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--engine", default="sequential",
                    choices=["sequential", "batched"])
    ap.add_argument("--topics", type=int, default=8)
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--data-vocab", type=int, default=64,
                    help="token stream vocab (<= model vocab)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--kernels", default=None,
                    choices=["cuda", "reference"],
                    help="default: cuda on a GPU, reference on the CPU")
    a = ap.parse_args(argv)
    federated_lm(a.arch, a.rounds, a.clients, a.engine, a.topics, a.seq,
                 a.data_vocab, a.device, a.kernels)


if __name__ == "__main__":
    main()
