# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Parameter specs as the single source of truth for a model's parameters.

A model is a dict of :class:`P` leaves keyed like the JAX package's specs:
flat for the CNNs (``conv0_w``, ``fc0_b``, ...), nested for the LM
(``embed/embedding``, ``blocks/attn/wq``, ...).  ``init_params`` turns a
spec into tensors; ``logical_axes`` gives each leaf's axis names, which
name its maskable unit dim (``filters``, ``heads``, ``mlp``).  ``stack``
prepends a ``layers`` axis to every leaf of a per-layer spec.

Parameters, gradients and masks are plain nested dicts of tensors with the
spec's structure; :func:`tree_map`, :func:`tree_paths` and
:func:`unflatten` walk them, and :func:`unstack` splits a stack into its
layers.
"""
from __future__ import annotations

import dataclasses
import hashlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter leaf: shape + logical axes + initializer."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed
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


def _draw(path: str, p: P, seed: int, dtype: torch.dtype,
          dev: torch.device) -> torch.Tensor:
    dt = p.dtype or dtype
    if p.init == "zeros":
        t = torch.zeros(p.shape, dtype=dt)
    elif p.init == "ones":
        t = torch.ones(p.shape, dtype=dt)
    else:
        g = torch.Generator().manual_seed(_leaf_seed(seed, path))
        if p.scale is not None:
            scale = p.scale
        elif p.init == "embed":
            scale = 1.0
        else:
            scale = 1.0 / np.sqrt(_fan_in(p))
        t = torch.randn(p.shape, generator=g).mul_(scale).to(dt)
    return t.to(dev)


#: host threads drawing leaves at once (each holds one leaf in host memory)
INIT_THREADS = 4


def init_params(spec: Dict[str, Any], seed: int = 0, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Concrete parameters: N(0, 1/fan_in) weights (N(0, scale) for
    ``embed`` leaves), zero biases, in the spec's nesting.

    Each leaf draws from its own CPU ``torch.Generator`` seeded from
    (seed, path), so the values depend neither on the device they land on
    nor on the order of the draws; large leaves are drawn on
    :data:`INIT_THREADS` host threads (a full-depth 7 B model's draw is
    bound by the host's normal sampler).
    """
    dev = resolve_device(device)
    leaves = tree_paths(spec, is_leaf=lambda v: isinstance(v, P))
    order = sorted(range(len(leaves)),
                   key=lambda i: -int(np.prod(leaves[i][1].shape)))
    with ThreadPoolExecutor(INIT_THREADS) as pool:
        futs = {i: pool.submit(_draw, *leaves[i], seed, dtype, dev)
                for i in order}
        out = {leaves[i][0]: futs[i].result() for i in range(len(leaves))}
    return unflatten(out)


def _map_spec(fn, spec):
    if isinstance(spec, dict):
        return {k: _map_spec(fn, v) for k, v in spec.items()}
    return fn(spec)


def logical_axes(spec):
    """The spec's tree with each leaf replaced by its axis-name tuple."""
    return _map_spec(lambda p: p.axes, spec)


def stack(spec, n: int, axis_name: str = "layers"):
    """Stack a per-layer spec n times (leading ``layers`` axis)."""
    return _map_spec(lambda p: dataclasses.replace(
        p, shape=(n,) + p.shape, axes=(axis_name,) + p.axes), spec)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure (the first
    tree's keys lead)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unstack(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree (leading ``layers``
    axis on every leaf).  One ``unbind`` a leaf: its backward stacks the
    layers' gradients once, where indexing each layer (``t[i]``) builds a
    full-size zero-filled gradient a layer and adds them up."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda p: p[i], parts) for i in range(n)]


def tree_leaves(tree) -> list:
    """The leaves in :func:`tree_paths` order."""
    return [v for _, v in tree_paths(tree)]


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{'a/b/c': leaf} -> nested dicts (a flat CNN dict comes back as is)."""
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def tree_paths(tree, is_leaf=None):
    """List of ('a/b/c', leaf) pairs in deterministic (sorted) order."""
    out = []
    _walk(tree, (), is_leaf, out)
    return out


def _walk(node, path, is_leaf, out) -> None:
    # a module-level function, not a closure that calls itself: such a
    # closure is a reference cycle that keeps ``out``, and with it every
    # leaf, alive until the cyclic collector runs (a model copy per call
    # at full width)
    if isinstance(node, dict) and (is_leaf is None or not is_leaf(node)):
        for k in sorted(node):
            _walk(node[k], path + (k,), is_leaf, out)
    else:
        out.append(("/".join(path), node))
