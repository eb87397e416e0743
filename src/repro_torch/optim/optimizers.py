# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Functional optimizers over flat parameter dicts (no ``torch.optim``).

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

from typing import Callable, Dict, NamedTuple

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable        # (grads, state, params, step) -> (updates, state)


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """p <- p + u, summed in float32 and cast back to the param's dtype."""
    return {k: (p.float() + updates[k]).to(p.dtype) for k, p in params.items()}


def sgd(lr) -> Optimizer:
    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params, step):
        lrv = _lr_at(lr, step)
        return {k: -lrv * g.float() for k, g in grads.items()}, state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        m = {k: beta * state["m"][k] + g.float() for k, g in grads.items()}
        lrv = _lr_at(lr, step)
        return {k: -lrv * mm for k, mm in m.items()}, {"m": m}

    return Optimizer(init, update)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, kw.get("beta", 0.9))
    raise ValueError(f"the port has sgd and momentum, not {name!r}")
