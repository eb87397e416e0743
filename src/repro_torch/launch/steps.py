# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Step factories of the training launch: ``train_step``, ``prefill_step``,
``serve_step`` and ``fl_round_step``, and the train state they carry.

``train_step`` integrates Helios: the state carries the soft-training
masks and contribution scores; masked units drop out of the forward pass
(zero gradients) and out of the optimizer's updates (no decay drift), and
per-unit |grad| scores accumulate by EMA for the next cycle's selection.
Mask re-selection (``soft_train.begin_cycle``) happens between steps on
the host, as in the reference; nothing here calls ``end_cycle``, so the
rotation counters stay as they are on this path.

``fl_round_step`` is the datacenter FL mapping: every client holds its own
params and optimizer state (a leading client axis), runs its local steps
in client order, and Eq. 10 alpha-weighted aggregation collapses the
client axis; every client restarts from the new global.

The update after the gradients streams leaf by leaf in tree order: each
leaf is clipped, goes through the optimizer, is masked and applied, and
its gradient is freed, so a step holds the old and the new params and
optimizer state plus the gradients, never a second gradient, update or
mask tree.  Every operation is the reference's, in its order, on each
leaf.

The kernels are float32: ``rt["kernels"] == "cuda"`` with another compute
dtype raises instead of running the plain path.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import HeliosConfig, ModelConfig, TrainConfig
from repro_torch.core import contribution as CONTRIB
from repro_torch.core import masking as MK
from repro_torch.core import soft_train as ST
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import CUDA, canonical_impl
from repro_torch.models import build, init_params, logical_axes
from repro_torch.models.module import tree_map, tree_paths, unflatten
from repro_torch.optim import (clip_scale, global_norm, make_optimizer,
                               warmup_cosine_schedule)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
#: the kernels each family's training loss reaches under kernels="cuda"
_FAMILY_KERNELS = {"dense": "masked_matmul / masked_matmul_dk, "
                            "flash_attention",
                   "vlm": "masked_matmul / masked_matmul_dk, "
                          "flash_attention",
                   "moe": "flash_attention (none under MLA), and "
                          "masked_matmul / masked_matmul_dk on a leading "
                          "dense layer",
                   "hybrid": "ssd_diag",
                   "cnn": "masked_matmul / masked_matmul_dk"}


def _dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def make_opt(cfg: ModelConfig, tcfg: TrainConfig):
    sched = warmup_cosine_schedule(tcfg.learning_rate, tcfg.warmup_steps,
                                   tcfg.total_steps)
    return make_optimizer(tcfg.optimizer, sched, b1=tcfg.beta1,
                          b2=tcfg.beta2, eps=tcfg.eps,
                          weight_decay=tcfg.weight_decay)


def _check_dtype(cfg: ModelConfig, rt: dict, cdt: torch.dtype) -> None:
    kern = rt.get("kernels")
    if cdt != torch.float32 and kern is not None and \
            canonical_impl(kern) == CUDA and cfg.family in _FAMILY_KERNELS:
        raise ValueError(
            f"kernels='cuda' runs float32 kernels ({_FAMILY_KERNELS[cfg.family]}"
            f" for the {cfg.family} family); compute_dtype {cdt} has no "
            f"kernel: use compute_dtype float32 or kernels='reference'")


def _loss_and_grads(loss_fn, params, batch, masks):
    """(loss as a device scalar, {path: gradient}) of ``loss_fn`` at
    ``params``."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    paths = tree_paths(leaves)
    loss = loss_fn(leaves, batch, masks)
    grads = torch.autograd.grad(loss, [v for _, v in paths])
    return loss.detach(), dict(zip((k for k, _ in paths), grads))


def _stream_update(opt, params, grads: Dict[str, torch.Tensor], opt_state,
                   step, scale, mask_leaf=None, score_leaf=None):
    """Clip (``grads`` times ``scale``), update, mask and apply each leaf
    in tree order, popping its gradient from ``grads``.  ``mask_leaf(path,
    update)`` -> the update's 0/1 mask; ``score_leaf(path, clipped
    gradient)`` sees each clipped gradient.  Returns (params, opt_state),
    new trees."""
    state_flat = {name: dict(tree_paths(t)) for name, t in opt_state.items()}
    new_p = {}
    new_s = {name: {} for name in opt_state}
    sc = opt.prepare(step, scale.device)
    with torch.no_grad():
        for path, p in tree_paths(params):
            g = grads.pop(path)
            g = g * scale.to(g.dtype)
            if score_leaf is not None:
                score_leaf(path, g)
            u, st = opt.leaf(sc, g, {name: flat[path] for name, flat in
                                     state_flat.items()}, p)
            del g
            if mask_leaf is not None:
                u = u * mask_leaf(path, u).to(u.dtype)
            new_p[path] = (p.float() + u).to(p.dtype)
            for name in new_s:
                new_s[name][path] = st[name]
    return unflatten(new_p), {name: unflatten(t) for name, t in new_s.items()}


def _mask_fn(axes_paths, masks):
    return lambda path, u: MK.expand_mask_leaf(axes_paths.get(path), masks,
                                               path, u)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, hcfg: HeliosConfig, tcfg: TrainConfig,
                    rt: dict):
    """``train_step(state, batch) -> (new state, {"loss", "grad_norm"})``.

    ``tcfg.microbatches`` > 1 splits the batch's leading axis and sums the
    microbatches' gradients in float32 before dividing by their count."""
    api = build(cfg)
    axes_paths = MK.axes_by_path(logical_axes(cfg))
    schema = api.mask_schema
    opt = make_opt(cfg, tcfg)
    cdt = _dt(tcfg.compute_dtype)
    _check_dtype(cfg, rt, cdt)

    def loss_fn(params, batch, masks):
        p = tree_map(lambda t: t.to(cdt) if t.dtype == torch.float32
                     and cdt != torch.float32 else t, params)
        return api.loss_fn(p, batch, cfg, rt, masks)

    def scores_of(path, g):
        if cfg.family == "cnn":
            return CONTRIB.cnn_leaf_scores(path, g, schema)
        return CONTRIB.leaf_unit_scores(path, g, axes_paths.get(path), schema)

    def train_step(state, batch):
        params = state["params"]
        masks = state["helios"]["masks"] if hcfg.enabled else None
        if tcfg.microbatches > 1:
            m = tcfg.microbatches
            grads, lsum = None, 0.0
            for i in range(m):
                b = {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))[i]
                     for k, v in batch.items()}
                loss_i, g = _loss_and_grads(loss_fn, params, b, masks)
                if grads is None:
                    grads = {k: torch.zeros(v.shape, dtype=torch.float32,
                                            device=v.device)
                             for k, v in g.items()}
                grads = {k: grads[k] + g[k].float() for k in grads}
                lsum = lsum + loss_i
                del g
            grads = {k: v / m for k, v in grads.items()}
            loss = lsum / m
        else:
            loss, grads = _loss_and_grads(loss_fn, params, batch, masks)

        gnorm = global_norm(unflatten(grads))
        scale = clip_scale(gnorm, tcfg.grad_clip)
        # grad_scores / cnn_unit_scores of the clipped gradients, summed
        # leaf by leaf in their order
        snew = {k: torch.zeros(shape, dtype=torch.float32,
                               device=gnorm.device)
                for k, shape in schema.items()}

        def score_leaf(path, g):
            for k, v in scores_of(path, g):
                snew[k] = snew[k] + v

        params, opt_state = _stream_update(
            opt, params, grads, state["opt"], state["step"], scale,
            _mask_fn(axes_paths, masks) if hcfg.enabled else None,
            score_leaf if hcfg.enabled else None)
        helios = state["helios"]
        if hcfg.enabled:
            helios = {**helios, "scores": {
                k: hcfg.contribution_ema * helios["scores"][k]
                + (1 - hcfg.contribution_ema) * snew[k] for k in snew}}
        new_state = {"params": params, "opt": opt_state,
                     "step": state["step"] + 1, "helios": helios}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_train_state(seed: int, cfg: ModelConfig, hcfg: HeliosConfig,
                     tcfg: TrainConfig, device: DeviceLike = None) -> dict:
    """Random params from ``seed``, a fresh optimizer state, step 0 and a
    full-volume Helios state (key path seed 0, as in the reference), on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    params = init_params(cfg, seed, dev, _dt(tcfg.param_dtype))
    return {"params": params, "opt": make_opt(cfg, tcfg).init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "helios": ST.init_state(build(cfg).mask_schema, 1.0, 0, dev)}


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, rt: dict):
    api = build(cfg)

    def prefill_step(params, batch):
        return api.prefill_fn(params, batch, cfg, rt, None)

    return prefill_step


def make_serve_step(cfg: ModelConfig, rt: dict):
    api = build(cfg)

    def serve_step(params, token, cache):
        return api.decode_fn(params, token, cache, cfg, rt, None)

    return serve_step


# ---------------------------------------------------------------------------
# federated round step (clients with a leading axis)
# ---------------------------------------------------------------------------


def make_fl_round_step(cfg: ModelConfig, hcfg: HeliosConfig,
                       tcfg: TrainConfig, rt: dict, num_clients: int):
    """One FL round.  ``state["params"]`` / ``["opt"]`` carry a leading
    client axis, ``state["helios"]`` is a stacked state
    (``soft_train.stack_states``); ``batch`` leaves are (C, E, B, ...).
    Each client runs its E local steps (clipped, masked optimizer updates
    at the round's ``step``) in client order; Eq. 10 alpha = r_n / sum r_m
    from each client's mask fraction; the global (an alpha tensordot over
    the client axis) comes back to every client as an expanded view."""
    api = build(cfg)
    axes_paths = MK.axes_by_path(logical_axes(cfg))
    opt = make_opt(cfg, tcfg)

    def loss_fn(params, batch, masks):
        return api.loss_fn(params, batch, cfg, rt, masks)

    def client_round(c: int, state, batch):
        params = tree_map(lambda t: t[c], state["params"])
        opt_state = tree_map(lambda t: t[c], state["opt"])
        masks = ({k: v[c] for k, v in state["helios"]["masks"].items()}
                 if hcfg.enabled else None)
        losses = []
        for e in range(next(iter(batch.values())).shape[1]):
            b = {k: v[c, e] for k, v in batch.items()}
            loss, grads = _loss_and_grads(loss_fn, params, b, masks)
            scale = clip_scale(global_norm(unflatten(grads)), tcfg.grad_clip)
            params, opt_state = _stream_update(
                opt, params, grads, opt_state, state["step"], scale,
                _mask_fn(axes_paths, masks) if hcfg.enabled else None)
            losses.append(loss)
        return params, opt_state, torch.stack(losses).mean()

    def fl_round_step(state, batch):
        client_params, client_opt, losses = [], [], []
        for c in range(num_clients):
            p, o, loss = client_round(c, state, batch)
            client_params.append(dict(tree_paths(p)))
            client_opt.append(o)
            losses.append(loss)
            del p
        leaves = tree_paths(state["params"])
        dev = leaves[0][1].device
        if hcfg.enabled:
            ratios = MK.selected_fractions(state["helios"]["masks"])
        else:
            ratios = torch.ones((num_clients,), dtype=torch.float32,
                                device=dev)
        alpha = ratios / torch.clamp(ratios.sum(), min=1e-9)
        agg = {}
        for path, _ in leaves:
            t = torch.stack([cp.pop(path) for cp in client_params])
            g = torch.tensordot(alpha.float(), t.float(), dims=1).to(t.dtype)
            agg[path] = g[None].expand((num_clients,) + tuple(g.shape))
            del t
        new_state = {"params": unflatten(agg),
                     "opt": tree_map(lambda *ts: torch.stack(ts),
                                     *client_opt),
                     "step": state["step"] + 1, "helios": state["helios"]}
        return new_state, {"loss": torch.stack(losses).mean(),
                           "alpha": alpha}

    return fl_round_step


def stack_clients(tree: Any, num_clients: int) -> Any:
    """Every leaf of ``tree`` repeated along a new leading client axis
    (copies, one a client)."""
    return tree_map(lambda t: torch.stack([t] * num_clients), tree)


__all__ = ["init_train_state", "make_fl_round_step", "make_opt",
           "make_prefill_step", "make_serve_step", "make_train_step",
           "stack_clients"]
