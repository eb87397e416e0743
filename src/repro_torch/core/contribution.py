# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Collaboration-contribution metric (paper Eq. 1).

U^{ij}(S_k) = theta^{ij}(S_k) - theta^{ij}(S_{k-1}) per neuron, reduced with
an L1 norm over every other entry of the parameters that carry the unit.

* :func:`unit_scores` is driven by LOGICAL AXES (the LM): for unit key
  ``mlp`` every parameter with an ``mlp`` axis contributes |delta| summed
  over all its other dims, aligned to the (layers, units) mask layout.
* :func:`cnn_unit_scores` is the CNN testbed's: the mask-schema keys are
  parameter-name prefixes (conv0, fc1, ...) and the unit dim is the LAST
  dim of the weight (HWIO / (din, dout)).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.module import tree_map, tree_paths

#: mask-schema key -> the logical axis that identifies the unit dim
UNIT_AXES = {
    "mlp": "mlp",
    "heads": "heads",
    "enc_heads": "heads",
    "cross_heads": "heads",
    "enc_mlp": "mlp",
    "experts": "experts",
    "ssm_heads": "ssm_heads",
    "slstm_heads": "ssm_heads",
}


def _reduce_to_units(arr: torch.Tensor, axes: tuple, unit_axis: str,
                     layered: bool) -> Optional[torch.Tensor]:
    """|arr| summed over every dim except (layers?, unit_axis)."""
    stacked = layered and bool(axes) and axes[0] == "layers"
    keep = [0] if stacked else []
    try:
        keep.append(axes.index(unit_axis))
    except ValueError:
        return None
    red = tuple(i for i in range(arr.dim()) if i not in keep)
    out = arr.float().abs()
    if red:                     # sum(dim=()) would reduce over EVERY dim
        out = out.sum(dim=red)
    return out if stacked else out[None]                  # (1, units)


def unit_scores(delta_tree, axes_tree, schema: Dict[str, tuple],
                key_prefixes: Optional[Dict[str, str]] = None
                ) -> Dict[str, torch.Tensor]:
    """Per-unit L1 scores of a param-delta (or grad) tree:
    {schema_key: (layers, units) float32}.  ``key_prefixes`` restricts a
    schema key to param paths containing a path component, as do keys of
    the form ``"prefix:axis"``; the reference's encoder / cross-attention
    path filters are kept as they are."""
    params = dict(tree_paths(delta_tree))
    axes = dict(tree_paths(axes_tree, is_leaf=lambda x: isinstance(x, tuple)))
    dev = next(iter(params.values())).device
    out = {key: torch.zeros(shape, dtype=torch.float32, device=dev)
           for key, shape in schema.items()}
    for path, arr in params.items():
        for key, r in leaf_unit_scores(path, arr, axes.get(path), schema,
                                       key_prefixes):
            out[key] = out[key] + r
    return out


def leaf_unit_scores(path: str, arr: torch.Tensor, ax: Optional[tuple],
                     schema: Dict[str, tuple],
                     key_prefixes: Optional[Dict[str, str]] = None):
    """(schema key, its (layers, units) share) for each key of ``schema``
    that the leaf at ``path`` (logical axes ``ax``) scores into; a key's
    :func:`unit_scores` entry is zero plus its shares in tree order."""
    if ax is None:
        return
    for key, shape in schema.items():
        if ":" in key:
            prefix, axis_key = key.split(":", 1)
        else:
            prefix, axis_key = (key_prefixes or {}).get(key), key
        unit_axis = UNIT_AXES.get(axis_key, "filters")
        if unit_axis not in ax:
            continue
        if prefix is not None and f"/{prefix}/" not in f"/{path}/":
            continue
        if axis_key.startswith("enc_") and "enc_" not in path:
            continue
        if not axis_key.startswith("enc_") and prefix is None and \
                axis_key in ("heads", "mlp") and path.startswith("enc_"):
            continue
        if axis_key == "cross_heads" and "/cross/" not in f"/{path}/":
            continue
        if axis_key == "heads" and "cross" in path:
            continue
        r = _reduce_to_units(arr, ax, unit_axis, layered=True)
        if r is None or tuple(r.shape) != tuple(shape):
            continue
        yield key, r


def cnn_unit_scores(delta_tree: Dict[str, torch.Tensor],
                    schema: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """Per-unit |delta| L1 scores: {schema_key: (1, units) float32}."""
    out = {}
    for key, shape in schema.items():
        w = delta_tree.get(f"{key}_w")
        b = delta_tree.get(f"{key}_b")
        dev = next(iter(delta_tree.values())).device
        acc = torch.zeros(shape[-1], dtype=torch.float32, device=dev)
        if w is not None:
            acc = acc + _cnn_share(w)
        if b is not None:
            acc = acc + _cnn_share(b)
        out[key] = acc[None]                              # (1, units)
    return out


def _cnn_share(arr: torch.Tensor) -> torch.Tensor:
    """|arr| summed over every dim but the last (the unit dim)."""
    out = arr.float().abs()
    return out.sum(dim=tuple(range(arr.dim() - 1))) if arr.dim() > 1 else out


def cnn_leaf_scores(path: str, arr: torch.Tensor, schema: Dict[str, tuple]):
    """(schema key, its (1, units) share) of the CNN leaf at ``path``
    (``<key>_w`` or ``<key>_b``), as :func:`cnn_unit_scores` sums it."""
    for key in schema:
        if path in (f"{key}_w", f"{key}_b"):
            yield key, _cnn_share(arr)[None]


def delta(params_new, params_old):
    return tree_map(lambda a, b: a.float() - b.float(), params_new,
                    params_old)


def ema_update(scores_prev: Dict[str, torch.Tensor],
               scores_new: Dict[str, torch.Tensor], decay: float):
    return {k: decay * scores_prev[k] + (1 - decay) * scores_new[k]
            for k in scores_new}
