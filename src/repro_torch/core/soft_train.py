# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Soft-training cycle state machine (Section V, Fig. 4).

One Helios client's per-cycle flow:

  begin_cycle:  forced = {C_s >= threshold}            (Section VI.A)
                masks  = TopK(U) ∪ Rand ∪ forced        (Eq. 2)
  ... local training with masked forward/grads ...
  end_cycle:    U      = per-unit |theta_k - theta_{k-1}|   (Eq. 1)
                C_s    = 0 where trained else +1

The state is a plain dict: tensors on the run's device, the volume as a
float32 host scalar, and the client's key path (``core.keys``), split once
per cycle exactly as the reference splits its PRNG key.

A cohort's states stack along a leading client axis (``stack_states``):
the tensors stack on the device, the volumes and cycle counters become
host arrays and the key paths a list.  ``end_cycle`` runs on a stacked
state as it is; ``begin_cycle`` runs client by client, because each
client's draws are a host-named stream of its own.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import HeliosConfig
from repro_torch.core import contribution as C
from repro_torch.core import keys as KY
from repro_torch.core import selection as S
from repro_torch.models.module import tree_map


def full_masks(schema: Dict[str, tuple], device) -> Dict[str, torch.Tensor]:
    """All-ones unit masks — the 'train the whole model' selection shared by
    capable clients and the full-model baselines."""
    return {k: torch.ones(s, dtype=torch.float32, device=device)
            for k, s in schema.items()}


def init_state(schema: Dict[str, tuple], volume: float = 1.0, seed: int = 0,
               device=None) -> dict:
    return {
        "masks": full_masks(schema, device),
        "scores": S.init_scores(schema, device),
        "skip_counts": S.init_skip_counts(schema, device),
        "volume": np.float32(volume),
        "rng": KY.key(seed),
        "cycle": 0,
    }


def begin_cycle(state: dict, hcfg: HeliosConfig) -> dict:
    """Select this cycle's masks from scores + rotation state (block-granular
    Eq. 2 when ``hcfg.mask_block`` is set)."""
    if not hcfg.enabled:
        return state
    rng, sub = state["rng"].split()
    thresh = S.rotation_threshold(state["volume"],
                                  hcfg.rotation_threshold_auto,
                                  hcfg.rotation_threshold)
    forced = S.forced_units(state["skip_counts"], thresh)
    masks = S.select_masks(state["scores"], forced, state["volume"],
                           hcfg.p_s, sub, block=hcfg.mask_block)
    return {**state, "masks": masks, "rng": rng}


def end_cycle(state: dict, scores_new: Dict[str, torch.Tensor],
              hcfg: HeliosConfig) -> dict:
    """Fold in this cycle's contribution scores + update C_s counters."""
    if hcfg.contribution == "grad_ema":
        scores = C.ema_update(state["scores"], scores_new,
                              hcfg.contribution_ema)
    else:
        scores = scores_new                                # Eq. 1 delta
    return {
        **state,
        "scores": scores,
        "skip_counts": S.update_skip_counts(state["skip_counts"],
                                            state["masks"]),
        "cycle": state["cycle"] + 1,
    }


def cycle_scores(params_new, params_old, axes_tree,
                 schema) -> Dict[str, torch.Tensor]:
    """Eq. 1 scores from a cycle's parameter delta (axis-driven)."""
    return C.unit_scores(C.delta(params_new, params_old), axes_tree, schema)


def grad_scores(grads, axes_tree, schema) -> Dict[str, torch.Tensor]:
    """grad_ema variant: per-unit |grad| of one step (O(units) state)."""
    return C.unit_scores(grads, axes_tree, schema)


def set_volume(state: dict, volume: float) -> dict:
    return {**state, "volume": np.float32(volume)}


# ---------------------------------------------------------------------------
# batched (stacked-client) state
# ---------------------------------------------------------------------------


def _stack(*xs):
    if torch.is_tensor(xs[0]):
        return torch.stack(xs)
    if isinstance(xs[0], KY.Key):
        return list(xs)
    return np.asarray(xs)               # volumes stay float32, cycles int


def stack_states(states: Sequence[dict]) -> dict:
    """Stack per-client states into one state with a leading client axis."""
    return tree_map(_stack, *states)


def unstack_states(stacked: dict, n: int) -> List[dict]:
    """Inverse of ``stack_states``: n per-client state dicts."""
    return [tree_map(lambda x: x[i], stacked) for i in range(n)]


def set_volumes(stacked: dict, volumes: Sequence[float]) -> dict:
    """Write the (C,) volumes of a stacked state."""
    return {**stacked, "volume": np.asarray(volumes, np.float32)}
