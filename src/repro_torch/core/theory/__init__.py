# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Proposition-2 utilities: the gradient-variance bound of soft-training.

Read by the scheme gauntlet (:mod:`repro_torch.drivers.scheme_gauntlet`),
which prices each soft-training scheme's gradient variance at its settled
straggler volumes.

Soft-training's sampled gradient is the importance-sampling estimator
ST(g)_i = D_i g_i / p_i (Eq. 5); its second moment is sum_i g_i^2 / p_i
(Eq. 6).  Keeping the top-v coordinates with p = 1 and sampling the tail
with p_i proportional to |g_i| (Wangni et al. [19]) satisfies
sum g_i^2 / p_i <= (1 + eps) sum g_i^2 with expected sparsity
<= (1 + rho) v (Eq. 9).

Ranks come from stable sorts, so tied magnitudes rank as ``jnp.argsort``
ranks them (lowest index first).
"""
from __future__ import annotations

from typing import Tuple

import torch


def st_estimate(g: torch.Tensor, p: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """One draw of the unbiased estimator ST(g)_i = D_i g_i / p_i."""
    u = torch.rand(g.shape, generator=generator, device=g.device)
    d = (u < p).to(g.dtype)
    return d * g / torch.clamp(p, min=1e-12)


def st_second_moment(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """E||ST(g)||^2 = sum_i g_i^2 / p_i (Eq. 6)."""
    return torch.sum(g * g / torch.clamp(p, min=1e-12))


def variance_inflation(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """epsilon such that E||ST(g)||^2 = (1 + eps) ||g||^2."""
    base = torch.sum(g * g)
    return st_second_moment(g, p) / torch.clamp(base, min=1e-30) - 1.0


def _top_v(absg: torch.Tensor, v: int) -> torch.Tensor:
    """Whether each coordinate ranks among the v largest magnitudes."""
    order = torch.argsort(-absg, stable=True)
    ranks = torch.argsort(order, stable=True)
    return ranks < v


def _tail_probabilities(g: torch.Tensor, v: int, mass: float, floor: float
                        ) -> torch.Tensor:
    """Top-v at p = 1, the tail p_i = |g_i| / sum(tail) * mass, clipped to
    [floor, 1]."""
    absg = torch.abs(g)
    in_top = _top_v(absg, v)
    tail = torch.where(in_top, torch.zeros_like(absg), absg)
    tail_sum = torch.clamp(torch.sum(tail), min=1e-30)
    p_tail = torch.clamp(tail / tail_sum * mass, floor, 1.0)
    return torch.where(in_top, torch.ones_like(p_tail), p_tail)


def wangni_probabilities(g: torch.Tensor, v: int) -> torch.Tensor:
    """Selection probabilities: top-v kept (p = 1), tail p_i ~ |g_i|,
    normalized to an expected v/2 extra samples (the reference's practical
    choice; only p_i in (0, 1] and the Eq. 9 bound are relied on)."""
    return _tail_probabilities(g, v, v / 2, 1e-6)


def expected_sparsity(p: torch.Tensor) -> torch.Tensor:
    """E||ST(g)||_0 = sum_i p_i (Eq. 9 left-hand side)."""
    return torch.sum(p)


def check_convergence_condition(g: torch.Tensor, v: int, rho: float
                                ) -> Tuple[torch.Tensor, float]:
    """Eq. 9: with top-v at p = 1, E||ST(g)||_0 <= (1 + rho) v for the
    Wangni tail distribution with expected tail mass rho * v.  Returns
    (left-hand side, right-hand side)."""
    p = _tail_probabilities(g, v, rho * v, 0.0)
    return expected_sparsity(p), (1 + rho) * v
