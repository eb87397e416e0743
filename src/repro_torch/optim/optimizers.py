# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Functional optimizers over parameter dicts, flat or nested (no
``torch.optim``).

The API mirrors the reference's gradient-transformation convention::

  opt = momentum(lr)
  state = opt.init(params)
  updates, state = opt.update(grads, state, params, step)
  params = apply_updates(params, updates)

Local training calls ``opt.init`` at the start of every cycle, so momentum
restarts each cycle as in the reference; ``torch.optim`` would carry it over.
Updates build new tensors: the parameters a caller passed in stay intact.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.models.module import tree_map

Params = Dict[str, Any]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable        # (grads, state, params, step) -> (updates, state)


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """p <- p + u, summed in float32 and cast back to the param's dtype."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def sgd(lr) -> Optimizer:
    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params, step):
        lrv = _lr_at(lr, step)
        return tree_map(lambda g: -lrv * g.float(), grads), state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        m = tree_map(lambda mp, g: beta * mp + g.float(), state["m"], grads)
        lrv = _lr_at(lr, step)
        return tree_map(lambda mm: -lrv * mm, m), {"m": m}

    return Optimizer(init, update)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, kw.get("beta", 0.9))
    raise ValueError(f"the port has sgd and momentum, not {name!r}")
