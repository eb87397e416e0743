# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""The clients group of the population engine (``ShardedFLRun``).

The reference shards a round's cohort over a 1-D ``("clients",)`` device
mesh in one process (``make_client_mesh``).  The PyTorch form is one
process a card under ``torch.distributed``: every rank runs the same host
loop from the same seeds, trains its own block of cohort slots, and the
engine sums partial aggregates with ``all_reduce`` and shares per-slot rows
with ``all_gather``.  :class:`ClientGroup` is that axis: the rank, the
world size, how many ranks train (``shards``) and the device the rank's
tensors live on.

Without a process group the group is world 1 and runs no collective.  The
caller starts the process group (``init_process_group`` below, or its own
``torch.distributed.init_process_group`` call: NCCL for the card, gloo for
the CPU); nothing here reads a cluster's environment except ``LOCAL_RANK``
for the default card.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


def _default_device(device: DeviceLike) -> torch.device:
    """``device`` resolved; the card defaults to ``cuda:{LOCAL_RANK}``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def init_process_group(device: DeviceLike = None, init_method: str = "env://",
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None) -> torch.device:
    """Start the default process group for ``device``'s type (NCCL on the
    card, gloo on the CPU) and return the rank's device.  ``rank`` and
    ``world_size`` default to ``RANK`` / ``WORLD_SIZE`` (``torchrun``
    sets them with ``env://``'s address)."""
    dev = _default_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
        else world_size
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


@dataclasses.dataclass(frozen=True)
class ClientGroup:
    """This rank's view of the clients axis.  The first ``shards`` ranks
    train a block of cohort slots each; a rank past them trains nothing,
    adds zeros to every sum and still receives every gathered row."""

    rank: int
    size: int
    shards: int
    device: torch.device

    @property
    def trains(self) -> bool:
        return self.rank < self.shards

    def all_reduce_sum(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The elementwise sums over every rank of ``tensors`` (one
        collective for all of them, f32); world 1 returns them as they
        are."""
        if self.size == 1:
            return tensors
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return out

    def all_gather(self, blocks: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """Each rank's (b, ...) block of per-slot rows, concatenated over
        the training ranks into (shards · b, ...) leaves: one collective a
        dtype.  World 1 returns the block as it is."""
        if self.size == 1:
            return blocks
        out = {}
        by_dtype: Dict[torch.dtype, List[str]] = {}
        for k, v in blocks.items():
            by_dtype.setdefault(v.dtype, []).append(k)
        for names in by_dtype.values():
            b = blocks[names[0]].shape[0]
            flat = torch.cat([blocks[k].reshape(b, -1) for k in names],
                             dim=1).contiguous()
            parts = [torch.empty_like(flat) for _ in range(self.size)]
            dist.all_gather(parts, flat)
            flat = torch.cat(parts[:self.shards])
            at = 0
            for k in names:
                w = blocks[k][0].numel()
                out[k] = flat[:, at:at + w].reshape(
                    (self.shards * b,) + blocks[k].shape[1:])
                at += w
        return out


def make_client_group(max_shards: Optional[int] = None,
                      device: DeviceLike = None) -> ClientGroup:
    """The clients group over the default process group (world 1 when
    there is none).  ``max_shards`` caps the training ranks, so a small
    cohort does not spread one client a rank and pad the rest.  The
    device is ``cuda:{LOCAL_RANK}`` unless the caller asks for another
    (the CPU only by name)."""
    dev = _default_device(device)
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    shards = size if max_shards is None else max(1, min(size, max_shards))
    return ClientGroup(rank=rank, size=size, shards=shards, device=dev)
