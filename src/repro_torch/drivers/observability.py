# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Produce and read one telemetry run log (the ``repro_torch.obs`` layer).

Every engine does its accounting through a ``repro_torch.obs.Recorder``
(counters, byte gauges, device-scalar accumulators): that layer is always
on.  Arming telemetry (``REPRO_OBS=on``, or in-process as below) also
streams dual-clock events: every span / round / bucket event carries the
engine's SIMULATED clock (deterministic: fixed-seed streams are identical
across engines) next to the host WALL clock (what the instrumented
sections really cost).  ``flush()`` writes the JSONL event log and run
manifest that ``python -m repro_torch.obs`` reads.  The run is
``BatchedFLRun`` helios on a half-straggler non-IID fleet, one local step
of batch 16 at lr 0.05 a round.

    python -m repro_torch.drivers.observability --out obs_demo
    python -m repro_torch.obs report obs_demo
    python -m repro_torch.obs diff obs_demo other_run

``--profile-round N`` (or ``REPRO_OBS_PROFILE=N``) writes a
``torch.profiler`` Chrome trace of round N into ``<out>/profile``.
"""
from __future__ import annotations

import argparse
import os
from typing import Mapping, Optional, Tuple

from repro_torch.configs import CNNS, HeliosConfig, ModelConfig, reduced
from repro_torch.data.federated import partition_noniid
from repro_torch.data.synthetic import class_gaussian_images
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated import BatchedFLRun, make_fleet, setup_clients
from repro_torch.obs import Recorder, load_events, render, summarize

DEFAULT_OUT = os.path.join("chiprun_out", "obs_demo")


def observability(cfg: Optional[ModelConfig] = None, clients: int = 8,
                  rounds: int = 4, out: str = DEFAULT_OUT,
                  profile_round: Optional[int] = None,
                  device: DeviceLike = None, kernels: Optional[str] = None,
                  init_params: Optional[Mapping] = None
                  ) -> Tuple[BatchedFLRun, dict]:
    """Run ``rounds`` rounds on ``cfg`` (reduced LeNet by default) under an
    armed recorder, flush the run log into ``out``, print its report and
    return (the run, the log's ``summarize``)."""
    dev = resolve_device(device)
    cfg = cfg or reduced(CNNS["lenet"])
    imgs, labels = class_gaussian_images(
        1024, cfg.image_size, cfg.in_channels, cfg.num_classes, seed=0)
    ti, tl = class_gaussian_images(
        128, cfg.image_size, cfg.in_channels, cfg.num_classes, seed=99)
    n = clients
    hcfg = HeliosConfig()
    parts = partition_noniid(labels, n, shards_per_client=4, seed=0)
    fleet = setup_clients(make_fleet(n - n // 2, n // 2), parts, hcfg,
                          device=dev)

    # an explicitly armed recorder overrides REPRO_OBS for this run only
    rec = Recorder(armed=True, profile_round=profile_round,
                   profile_dir=os.path.join(out, "profile"))
    run = BatchedFLRun(cfg, hcfg, "helios", fleet,
                       {"images": imgs, "labels": labels},
                       {"images": ti, "labels": tl},
                       local_steps=1, batch_size=16, lr=0.05, seed=0,
                       recorder=rec, kernels=kernels, device=dev,
                       init_params=init_params)
    run.run_sync(rounds)

    flushed = rec.flush(out)
    print(f"== run log: {flushed['events']} ==\n")
    events = load_events(out)
    print(render(events))
    summ = summarize(events)
    print(f"\n== summary: {summ['rounds']} rounds, "
          f"final {summ.get('metric_name')}={summ.get('final_metric'):.3f}, "
          f"uplink {summ['uplink_mb']:.2f} MB / "
          f"downlink {summ['downlink_mb']:.2f} MB ==")
    if profile_round is None:
        print("rerun with --profile-round 1 (or REPRO_OBS_PROFILE=1) to drop "
              "a torch.profiler trace next to the log")
    return run, summ


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="lenet",
                    choices=["lenet", "alexnet", "resnet18"])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="run-log directory (events.jsonl + manifest.json)")
    ap.add_argument("--profile-round", type=int, default=None,
                    help="capture a torch.profiler trace around this round")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--kernels", default=None,
                    choices=["reference", "cuda"],
                    help="the soft-training substrate (default: cuda on a "
                         "GPU, reference on the CPU)")
    args = ap.parse_args()
    observability(reduced(CNNS[args.model]), args.clients,
                  args.rounds, args.out, args.profile_round, args.device,
                  args.kernels)


if __name__ == "__main__":
    main()
