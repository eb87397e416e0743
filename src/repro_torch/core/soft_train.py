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

A whole population's states live on the host as rows (``init_population``,
``host_states``): numpy arrays with a leading client axis, the key paths
as two integer columns (root seed, cycles split off it).  A round gathers
its cohort's rows onto the device in the stacked form and scatters them
back in place (``gather_states_host`` / ``scatter_states_host``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HeliosConfig
from repro_torch.core import contribution as C
from repro_torch.core import keys as KY
from repro_torch.core import selection as S
from repro_torch.models.module import tree_leaves, tree_map


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


# ---------------------------------------------------------------------------
# persistent-population state (partial participation)
# ---------------------------------------------------------------------------

#: the one step a cycle adds to a key path (``begin_cycle``'s split(2)[0])
_CYCLE_STEP = ("split", 2, 0)


def key_row(k: KY.Key) -> Tuple[int, int]:
    """(root seed, splits) of a key that is its root seed's first half
    split ``splits`` times, the only form ``begin_cycle`` makes; any other
    path raises rather than be stored wrong."""
    root, *steps = k.path
    if root[0] != "seed" or any(s != _CYCLE_STEP for s in steps):
        raise ValueError(f"a population row holds a seed and its cycle "
                         f"splits, not the key path {k.path}")
    return root[1], len(steps)


def row_key(seed: int, splits: int) -> KY.Key:
    return KY.Key((("seed", int(seed)),) + (_CYCLE_STEP,) * int(splits))


def init_population(schema: Dict[str, tuple], volumes: Sequence[float],
                    seeds: Sequence[int]) -> dict:
    """Host rows of a whole population, built without N per-client dicts.

    Row i equals ``init_state(schema, volume=volumes[i], seed=seeds[i])``,
    key path included, so a population engine seeds exactly like
    ``FLRun``.  Leaves are writable numpy arrays with a leading client
    axis; ``rng`` holds the key paths as ``{"seed", "splits"}`` columns.
    """
    seeds = np.asarray(list(seeds), np.int64)
    n = len(seeds)
    return {
        "masks": {k: np.ones((n,) + tuple(s), np.float32)
                  for k, s in schema.items()},
        "scores": {k: np.zeros((n,) + tuple(s), np.float32)
                   for k, s in schema.items()},
        "skip_counts": {k: np.zeros((n,) + tuple(s), np.int32)
                        for k, s in schema.items()},
        "volume": np.asarray(list(volumes), np.float32),
        "rng": {"seed": seeds, "splits": np.zeros(n, np.int64)},
        "cycle": np.zeros(n, np.int64),
    }


def host_states(stacked: dict) -> dict:
    """A stacked state (``stack_states``' form) as host population rows:
    device tensors pulled into writable numpy arrays, the key list into
    its two columns."""
    rows = [key_row(k) for k in stacked["rng"]]
    out = tree_map(lambda x: x.detach().cpu().numpy().copy()
                   if torch.is_tensor(x) else np.array(x),
                   {k: v for k, v in stacked.items() if k != "rng"})
    out["rng"] = {"seed": np.asarray([r[0] for r in rows], np.int64),
                  "splits": np.asarray([r[1] for r in rows], np.int64)}
    return out


def gather_states_host(pop: dict, idx, device) -> dict:
    """The rows ``idx`` of a host population in ``stack_states``' form:
    tensors on ``device`` (copies: later scatters cannot reach them),
    volumes and cycles as host arrays, the key paths as a list."""
    idx = np.asarray(idx, np.int64)
    out = tree_map(lambda x: x[idx],
                   {k: v for k, v in pop.items() if k != "rng"})
    for part in ("masks", "scores", "skip_counts"):
        out[part] = {k: torch.from_numpy(v).to(device)
                     for k, v in out[part].items()}
    out["rng"] = [row_key(s, n) for s, n in
                  zip(pop["rng"]["seed"][idx], pop["rng"]["splits"][idx])]
    return out


def scatter_states_host(pop: dict, idx, sub: dict) -> None:
    """Write a stacked state's rows into the host population at ``idx``
    (duplicate-free), in place: the inverse of ``gather_states_host``."""
    idx = np.asarray(idx, np.int64)
    rows = host_states(sub)

    def write(x, s):
        x[idx] = s

    tree_map(write, pop, rows)


def population_nbytes(pop: dict) -> int:
    """Host bytes of a population's rows."""
    return sum(x.nbytes for x in tree_leaves(pop))
