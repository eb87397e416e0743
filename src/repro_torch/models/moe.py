# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Mixture-of-Experts with capacity-based grouped dispatch.

Two execution paths, as in the reference:

* ``grouped`` (default): the (token, choice) pairs are sorted by routed
  expert id into E groups of static capacity ``cap`` (overflow goes to a
  sink row and is dropped); the expert products are batched matmuls over
  the expert axis.  ``moe_groups`` token groups are dispatched one after
  the other (the reference vmaps them).
* ``dense``: every expert sees every token, masked combine; the exact
  oracle.

Helios hook: ``expert_mask`` (float 0/1 over E) zeroes the router
probabilities of inactive experts before top-k (expert-level
soft-training).  A masked expert can still be chosen, at weight 0, when
fewer than k experts are live: such choices take capacity slots as in the
reference, so they decide which tokens overflow.

The expert products are plain ``torch.bmm`` / ``einsum``: the reference
runs no Pallas kernel here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mlp_fwd, mlp_spec
from repro_torch.models.module import P


def moe_spec(cfg):
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    spec = {
        "router": P((d, e), ("embed", "experts"), scale=0.02),
        "wi": P((e, d, ff), ("experts", "embed", "mlp")),
        "wg": P((e, d, ff), ("experts", "embed", "mlp")),
        "wo": P((e, ff, d), ("experts", "mlp", "embed")),
    }
    if cfg.num_shared_experts:
        spec["shared"] = mlp_spec(d, ff * cfg.num_shared_experts, "silu")
    return spec


def router_probs(params, x2d: torch.Tensor,
                 expert_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(T, E) f32 router softmax, masked experts at exactly 0."""
    probs = torch.softmax((x2d @ params["router"]).float(), dim=-1)
    if expert_mask is not None:
        probs = probs * expert_mask[None, :]
    return probs


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, ties broken
    lowest index first as ``jax.lax.top_k`` does (``torch.topk`` does
    not): a stable descending sort."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[:, :k], idx[:, :k]


def _route(params, x2d, cfg, expert_mask):
    """Router: (weights, idx) of shape (T, k), the weights renormalized."""
    w, idx = top_k(router_probs(params, x2d, expert_mask),
                   cfg.num_experts_per_tok)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w.to(x2d.dtype), idx


def capacity(t: int, cfg, capacity_factor: float) -> int:
    """Slots per expert for ``t`` tokens: ceil(t·k/E·cf) rounded up to a
    multiple of 8, at least 8 (Python integers, as in the reference)."""
    cap = int(math.ceil(t * cfg.num_experts_per_tok / cfg.num_experts
                        * capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)


def _grouped_ffn(params, x2d, w, idx, cfg, capacity_factor):
    """Sort-by-expert grouped dispatch on one token group. x2d: (T, d)."""
    t, d = x2d.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = capacity(t, cfg, capacity_factor)
    dev = x2d.device

    flat_e = idx.reshape(-1)                                 # (T*k,)
    flat_t = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    flat_w = w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]

    # expert counts out of place: torch.func.vmap (the batched engines)
    # refuses an in-place add of a client-batched index into a tensor made
    # here, and one_hot checks its data on the host
    counts = (se[:, None] == torch.arange(e, device=dev)).sum(0)
    start = torch.cumsum(counts, 0) - counts                 # exclusive
    pos = torch.arange(t * k, device=dev) - start[se]
    slot = torch.where(pos < cap, se * cap + pos,
                       torch.full_like(se, e * cap))         # overflow -> sink

    # the gathers are index_select, whose backward is an index_add_:
    # advanced indexing (x2d[st]) has a sort-based backward that walks a
    # row's duplicates one by one, and the sink row collects every
    # overflowed choice (thousands at full width)
    buf = x2d.new_zeros((e * cap + 1, d)).index_put(
        (slot,), x2d.index_select(0, st))
    h = buf[: e * cap].reshape(e, cap, d)

    act = F.silu(torch.bmm(h, params["wg"]))
    hid = act * torch.bmm(h, params["wi"])
    y = torch.bmm(hid, params["wo"]).reshape(e * cap, d)

    y_pad = torch.cat([y, y.new_zeros((1, d))], dim=0)
    contrib = y_pad.index_select(0, slot) * sw[:, None]
    return x2d.new_zeros((t, d)).index_add(0, st, contrib)   # segment sum


def _dense_ffn(params, x2d, w, idx, cfg):
    """Reference: all experts on all tokens, mask-combined. (T, d)."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    act = F.silu(torch.einsum("td,edf->tef", x2d, params["wg"]))
    hid = act * torch.einsum("td,edf->tef", x2d, params["wi"])
    y = torch.einsum("tef,efd->ted", hid, params["wo"])      # (T, E, d)
    experts = torch.arange(e, device=x2d.device)
    comb = x2d.new_zeros((x2d.shape[0], e))
    for j in range(k):                                       # k is small
        # one_hot, formed so vmap can batch it
        comb = comb + (idx[:, j:j + 1] == experts).to(x2d.dtype) \
            * w[:, j:j + 1]
    return torch.einsum("ted,te->td", y, comb)


def moe_fwd(params, x, cfg, *, expert_mask: Optional[torch.Tensor] = None,
            impl: str = "grouped", moe_groups: int = 1,
            capacity_factor: float = 1.25):
    """x: (B, S, d) -> (B, S, d).  ``moe_groups`` must divide B*S."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    w, idx = _route(params, x2d, cfg, expert_mask)

    if impl == "dense":
        y = _dense_ffn(params, x2d, w, idx, cfg)
    else:
        g = moe_groups
        if (b * s) % g:
            raise ValueError(f"moe_groups {g} does not divide {b * s} tokens")
        y = torch.cat([_grouped_ffn(params, xx, ww, ii, cfg, capacity_factor)
                       for xx, ww, ii in zip(x2d.chunk(g), w.chunk(g),
                                             idx.chunk(g))])

    y = y.reshape(b, s, d)
    if cfg.num_shared_experts:
        y = y + mlp_fwd(params["shared"], x, "silu", unit_mask=None)
    return y


def load_balance_loss(params, x, cfg):
    """Auxiliary load-balancing loss (Switch-style): E * sum(f_e * p_e)."""
    b, s, d = x.shape
    probs = router_probs(params, x.reshape(b * s, d), None)
    _, idx = top_k(probs, cfg.num_experts_per_tok)
    onehot = F.one_hot(idx, cfg.num_experts).float().sum(dim=1)  # (T, E)
    f = onehot.mean(dim=0) / cfg.num_experts_per_tok
    p = probs.mean(dim=0)
    return cfg.num_experts * torch.sum(f * p)
