# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Parameter specs as the single source of truth for a model's parameters.

A model is a flat dict of :class:`P` leaves keyed like the JAX package's
specs (``conv0_w``, ``fc0_b``, ...).  ``init_params`` turns a spec into
tensors; a leaf's logical axes name its maskable unit dim (``filters``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter leaf: shape + logical axes + initializer."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: Optional[float] = None  # stddev override
    dtype: Any = None              # dtype override

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _fan_in(p: P) -> int:
    """Fan-in heuristic: product of all dims except the last."""
    if len(p.shape) <= 1:
        return max(1, p.shape[0] if p.shape else 1)
    return max(1, int(np.prod(p.shape[:-1])))


def _leaf_seed(seed: int, path: str) -> int:
    """Deterministic per-leaf generator seed from the run seed and the path."""
    digest = hashlib.blake2b(f"{seed}/{path}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


def init_params(spec: Dict[str, P], seed: int = 0, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Concrete parameters: N(0, 1/fan_in) weights, zero biases.

    Each leaf draws from its own CPU ``torch.Generator`` seeded from
    (seed, path), so the values do not depend on the device they land on.
    """
    dev = resolve_device(device)
    out = {}
    for path, p in tree_paths(spec, is_leaf=lambda v: isinstance(v, P)):
        dt = p.dtype or dtype
        if p.init == "zeros":
            t = torch.zeros(p.shape, dtype=dt)
        elif p.init == "ones":
            t = torch.ones(p.shape, dtype=dt)
        else:
            g = torch.Generator().manual_seed(_leaf_seed(seed, path))
            scale = p.scale if p.scale is not None else 1.0 / np.sqrt(_fan_in(p))
            t = (torch.randn(p.shape, generator=g) * scale).to(dt)
        out[path] = t.to(dev)
    return out


def tree_paths(tree, is_leaf=None):
    """List of ('a/b/c', leaf) pairs in deterministic (sorted) order."""
    out = []

    def rec(node, path):
        if isinstance(node, dict) and (is_leaf is None or not is_leaf(node)):
            for k in sorted(node):
                rec(node[k], path + (k,))
        else:
            out.append(("/".join(path), node))

    rec(tree, ())
    return out
