# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Expand per-unit Helios masks into parameter-space masks.

:func:`expand_masks` is driven by logical axes (the LM): a parameter whose
axes carry several maskable unit axes gets the OUTER PRODUCT of the unit
masks, and a parameter with none gets ones.  :func:`cnn_expand_masks` is
the CNN testbed's prefix-keyed variant, and
:func:`cnn_expand_masks_batch` its vmap over a stacked cohort.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.contribution import UNIT_AXES
from repro_torch.models.module import tree_paths, unflatten


def _match(key: str, path: str, axes: tuple) -> Optional[str]:
    """The unit axis name if schema ``key`` applies to this param."""
    if ":" in key:
        prefix, axis_key = key.split(":", 1)
        if f"/{prefix}/" not in f"/{path}/":
            return None
    else:
        axis_key = key
    unit_axis = UNIT_AXES.get(axis_key, "filters")
    if unit_axis not in axes:
        return None
    if axis_key.startswith("enc_") and "enc_" not in path:
        return None
    if not axis_key.startswith("enc_") and axis_key in ("heads", "mlp") and \
            path.startswith("enc_"):
        return None
    if axis_key == "cross_heads" and "/cross/" not in f"/{path}/":
        return None
    if axis_key == "heads" and "cross" in path:
        return None
    return unit_axis


def axes_by_path(axes_tree) -> Dict[str, tuple]:
    """{'a/b/c': logical axes} of a spec's axes tree."""
    return dict(tree_paths(axes_tree, is_leaf=lambda x: isinstance(x, tuple)))


def expand_mask_leaf(ax: Optional[tuple], unit_masks: Dict[str, torch.Tensor],
                     path: str, arr: torch.Tensor) -> torch.Tensor:
    """The 0/1 mask of one parameter (``path``, logical axes ``ax``): the
    outer product of every unit mask that applies to it, ones if none."""
    m = torch.ones(arr.shape, dtype=torch.float32, device=arr.device)
    if ax is None:
        return m
    layered = bool(ax) and ax[0] == "layers"
    for key, um in unit_masks.items():
        unit_axis = _match(key, path, ax)
        if unit_axis is None:
            continue
        dim = ax.index(unit_axis)
        n_layers, n_units = um.shape
        if arr.shape[dim] != n_units:
            continue
        if layered and arr.shape[0] != n_layers:
            continue
        if not layered and n_layers != 1:
            continue
        shape = [1] * arr.dim()
        shape[dim] = n_units
        if layered:
            shape[0] = n_layers
            m = m * um.reshape(shape)
        else:
            m = m * um[0].reshape(shape)
    return m


def expand_masks(axes_tree, unit_masks: Dict[str, torch.Tensor], params_tree):
    """Params-shaped 0/1 mask tree from (layers, units) unit masks.
    Parameters with no maskable axis get ones (norms, embeddings...)."""
    axes = axes_by_path(axes_tree)
    return unflatten({path: expand_mask_leaf(axes.get(path), unit_masks,
                                             path, arr)
                      for path, arr in tree_paths(params_tree)})


def cnn_expand_masks(unit_masks: Dict[str, torch.Tensor],
                     params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Params-shaped 0/1 masks: a schema key masks the OUTPUT channel (last
    dim) of ``<key>_w`` and ``<key>_b``; every other parameter gets ones."""
    out = {}
    for path, arr in params.items():
        m = torch.ones(arr.shape, dtype=torch.float32, device=arr.device)
        for key, um in unit_masks.items():
            v = um[0] if um.dim() == 2 else um
            if path == f"{key}_w" and arr.shape[-1] == v.shape[0]:
                m = m * v.reshape((1,) * (arr.dim() - 1) + (-1,))
            elif path == f"{key}_b" and arr.shape[0] == v.shape[0]:
                m = m * v
        out[path] = m
    return out


def cnn_expand_masks_batch(unit_masks: Dict[str, torch.Tensor],
                           params: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """``cnn_expand_masks`` over a stacked cohort: unit-mask leaves (C, L,
    n), ``params`` the unstacked global template; leaves (C,) +
    param.shape, ready for the stacked masked-mean aggregation."""
    return torch.func.vmap(lambda um: cnn_expand_masks(um, params))(
        unit_masks)


def selected_fraction(unit_masks: Dict[str, torch.Tensor]) -> torch.Tensor:
    """r_n of Eq. 10: fraction of maskable units selected on this client
    (a device scalar: the hot loop does not wait for it)."""
    tot = sum(m.numel() for m in unit_masks.values())
    sel = sum(m.sum() for m in unit_masks.values())
    return sel / max(tot, 1)


def selected_fractions(stacked_masks: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(C,) r_n of a stacked cohort's unit masks (leaves (C, L, n)).

    The count times the reciprocal of the total, in float32: the reference's
    compiled round program computes it so (XLA turns the division by a
    constant into that product), and the batched engine reports the same
    ratios bit for bit.  It can differ from :func:`selected_fraction` in
    the last bit.
    """
    tot = sum(m[0].numel() for m in stacked_masks.values())
    sel = sum(m.sum(dim=tuple(range(1, m.dim())))
              for m in stacked_masks.values())
    return sel * torch.tensor(1.0 / max(tot, 1), dtype=torch.float32)
