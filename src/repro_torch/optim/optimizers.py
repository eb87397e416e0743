# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Functional optimizers over parameter dicts, flat or nested (no
``torch.optim``): SGD, momentum, Adam and AdamW, the learning-rate
schedules and global-norm clipping.

The API mirrors the reference's gradient-transformation convention::

  opt = adamw(warmup_cosine_schedule(3e-4, 100, 1000))
  state = opt.init(params)
  updates, state = opt.update(grads, state, params, step)
  params = apply_updates(params, updates)

``update`` is ``prepare`` (the step's scalars: the lr, bias corrections)
then ``leaf`` on each leaf; a caller that streams the leaves calls the two
itself::

  sc = opt.prepare(step, device)
  u, st = opt.leaf(sc, g, {name: state[name] leaf}, p)

Local training calls ``opt.init`` at the start of every cycle, so momentum
restarts each cycle as in the reference; ``torch.optim`` would carry it over.
Updates build new tensors: the parameters a caller passed in stay intact.
Schedules, bias corrections and the clip scale are float32 tensor scalars on
the step's device, computed in the reference's order.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.models.module import tree_leaves, tree_map

Params = Dict[str, Any]


class Optimizer(NamedTuple):
    init: Callable          # params -> state, {name: tree like params}
    update: Callable        # (grads, state, params, step) -> (updates, state)
    prepare: Callable       # (step, device) -> the step's scalars
    leaf: Callable          # (scalars, g, {name: leaf}, p) -> (u, {name: leaf})


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def _optimizer(init, prepare, leaf) -> Optimizer:
    """An :class:`Optimizer` whose tree ``update`` runs ``leaf`` on every
    leaf with one ``prepare`` a step."""
    @torch.no_grad()
    def update(grads, state, params, step):
        sc = prepare(step, tree_leaves(grads)[0].device)
        names = list(state)
        out = tree_map(lambda g, p, *st: leaf(sc, g, dict(zip(names, st)), p),
                       grads, params, *(state[n] for n in names))
        return (tree_map(lambda o: o[0], out),
                {n: tree_map(lambda o: o[1][n], out) for n in names})

    return Optimizer(init, update, prepare, torch.no_grad()(leaf))


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """p <- p + u, summed in float32 and cast back to the param's dtype."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def _f32(x, device=None) -> torch.Tensor:
    """A float32 scalar tensor on ``device`` (a tensor's own by default)."""
    if torch.is_tensor(x):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int, final_frac: float = 0.1):
    """Linear warmup from 0 (the lr at step 0 is 0, so a first step moves
    nothing), then a cosine from ``peak_lr`` to ``final_frac · peak_lr``."""
    def sched(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return sched


# ---------------------------------------------------------------------------
# Gradient utilities
# ---------------------------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    """sqrt of the leaves' float32 sums of squares, summed in tree order."""
    total = 0
    for g in tree_leaves(tree):
        total = total + g.float().square().sum()
    return torch.sqrt(total)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)): the factor of every leaf."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def _zeros_like(params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def sgd(lr) -> Optimizer:
    def leaf(lrv, g, st, p):
        return -lrv * g.float(), st

    return _optimizer(lambda params: {}, lambda step, dev: _lr_at(lr, step),
                      leaf)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    def leaf(lrv, g, st, p):
        m = beta * st["m"] + g.float()
        return -lrv * m, {"m": m}

    return _optimizer(lambda params: {"m": _zeros_like(params)},
                      lambda step, dev: _lr_at(lr, step), leaf)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW.  The lr is read at ``step`` (the update's bias corrections at
    ``step + 1``); every leaf with two or more dims decays, by the leaf's
    shape and not its role, so the ``(L, d)`` norm scales of a stacked
    layer tree decay too, as in the reference."""

    def prepare(step, dev):
        step = _f32(step, dev) + 1.0
        return (1 - torch.pow(b1, step), 1 - torch.pow(b2, step),
                _f32(_lr_at(lr, step - 1), dev))

    def leaf(sc, g, st, p):
        bc1, bc2, lrv = sc
        m = b1 * st["m"] + (1 - b1) * g.float()
        v = b2 * st["v"] + (1 - b2) * g.float().square()
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        decay = weight_decay if p.dim() >= 2 else 0.0
        return -lrv * (u + decay * p.float()), {"m": m, "v": v}

    return _optimizer(lambda params: {k: _zeros_like(params)
                                      for k in ("m", "v")}, prepare, leaf)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    return adamw(lr, b1, b2, eps, weight_decay=0.0)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, kw.get("beta", 0.9))
    if name == "adam":
        return adam(lr, kw.get("b1", 0.9), kw.get("b2", 0.999),
                    kw.get("eps", 1e-8))
    if name == "adamw":
        return adamw(lr, kw.get("b1", 0.9), kw.get("b2", 0.95),
                     kw.get("eps", 1e-8), kw.get("weight_decay", 0.1))
    raise ValueError(f"the port has sgd, momentum, adam and adamw, not "
                     f"{name!r}")
