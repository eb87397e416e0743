"""Port parity: the MoE block (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the CPU.

Configs: ``reduced(granite-moe-1b-a400m)`` (d_model 64, 8 experts of 32
hidden units, top-2) and a variant with ``first_k_dense=1`` and one shared
expert.  The MoE leaves (at the reference's init scales), activations,
expert masks and output cotangents come from numpy seeds and cross to
the port through the weight bridge.

``moe_fwd`` grouped (``moe_groups`` 1 and 2) and dense, with a random
expert mask: forward at atol 1e-5, gradients of every leaf and of the
input at atol 1e-4 (the reference's own tolerances).  Two more cases:
a mask that keeps fewer live experts than k (the zero-probability choices
tie and must be broken lowest index first, as ``jax.lax.top_k`` does;
they still take capacity slots), and ``capacity_factor=0.5``, where
tokens overflow into the sink.  ``load_balance_loss``, the router's
(weights, idx) exactly, and top-k tie rows against ``jax.lax.top_k``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.models import moe as jM  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import moe as tM  # noqa: E402
from repro_torch.models.module import tree_paths  # noqa: E402

FWD_ATOL, GRAD_ATOL = 1e-5, 1e-4
B, S = 2, 24
CFGS = {
    "granite": (JC.reduced(JC.ARCHS["granite-moe-1b-a400m"]),
                TC.reduced(TC.GRANITE_MOE_1B_A400M)),
}
CFGS["dense1_shared1"] = tuple(
    dataclasses.replace(c, first_k_dense=1, num_shared_experts=1)
    for c in CFGS["granite"])


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _moe_params(name):
    """One layer's MoE leaves (numpy, from a seed) at the reference's init
    scales: router N(0, 0.02), the rest N(0, 1/fan_in)."""
    cfg = CFGS[name][0]
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    rng = np.random.default_rng(0)

    def normal(shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    out = {"router": normal((d, e), 0.02),
           "wi": normal((e, d, ff), (e * d) ** -0.5),
           "wg": normal((e, d, ff), (e * d) ** -0.5),
           "wo": normal((e, ff, d), (e * ff) ** -0.5)}
    if cfg.num_shared_experts:
        sff = ff * cfg.num_shared_experts
        out["shared"] = {"wi": normal((d, sff), d ** -0.5),
                         "wg": normal((d, sff), d ** -0.5),
                         "wo": normal((sff, d), sff ** -0.5)}
    return out


def _inputs(seed, mask="random"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    gy = rng.normal(size=(B, S, 64)).astype(np.float32)
    em = None
    if mask == "random":
        em = (rng.random(8) < 0.6).astype(np.float32)
        em[:3] = 1.0                       # at least k live experts
    elif mask == "one_live":
        em = np.zeros(8, np.float32)
        em[5] = 1.0                        # one live expert, k = 2
    return x, gy, em


def _jax_fwd_grads(name, x, gy, em, **kw):
    jcfg = CFGS[name][0]
    p = jax.tree.map(jnp.asarray, _moe_params(name))
    mask = None if em is None else jnp.asarray(em)

    @jax.jit
    def fwd_bwd(p, x, gy):
        y, vjp = jax.vjp(lambda p, x: jM.moe_fwd(p, x, jcfg,
                                                  expert_mask=mask, **kw),
                         p, x)
        return (y, *vjp(gy))

    y, gp, gx = fwd_bwd(p, jnp.asarray(x), jnp.asarray(gy))
    return np.asarray(y), dict(tree_paths(jax.device_get(gp))), np.asarray(gx)


def _torch_fwd_grads(name, x, gy, em, **kw):
    tcfg = CFGS[name][1]
    p = params_from_numpy(_moe_params(name), device="cpu")
    leaves = dict(tree_paths(p))
    for v in leaves.values():
        v.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    mask = None if em is None else torch.tensor(em)
    y = tM.moe_fwd(p, xt, tcfg, expert_mask=mask, **kw)
    grads = torch.autograd.grad((y * torch.tensor(gy)).sum(),
                                list(leaves.values()) + [xt])
    return _np(y), {k: _np(g) for k, g in zip(leaves, grads)}, _np(grads[-1])


def _hold(name, x, gy, em, **kw):
    jy, jg, jgx = _jax_fwd_grads(name, x, gy, em, **kw)
    ty, tg, tgx = _torch_fwd_grads(name, x, gy, em, **kw)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=FWD_ATOL)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=GRAD_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(tgx, jgx, rtol=0, atol=GRAD_ATOL)
    return ty


def test_config_fields_match_jax():
    """The port's configs carry the reference's values for every field the
    port has, full and reduced."""
    full = (JC.ARCHS["granite-moe-1b-a400m"], TC.GRANITE_MOE_1B_A400M)
    for jcfg, tcfg in (full, CFGS["granite"], CFGS["dense1_shared1"]):
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert tcfg.padded_vocab == jcfg.padded_vocab
    assert full[1].padded_vocab == 49280
    assert (CFGS["granite"][1].num_experts,
            CFGS["granite"][1].num_experts_per_tok,
            CFGS["granite"][1].moe_d_ff) == (8, 2, 32)


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("impl,groups", [("grouped", 1), ("grouped", 2),
                                         ("dense", 1)])
def test_moe_fwd_and_grads_match_jax(name, impl, groups):
    x, gy, em = _inputs(1)
    _hold(name, x, gy, em, impl=impl, moe_groups=groups)


@pytest.mark.parametrize("impl", ["grouped", "dense"])
def test_moe_without_mask_matches_jax(impl):
    x, gy, _ = _inputs(2)
    _hold("granite", x, gy, None, impl=impl)


@pytest.mark.parametrize("impl", ["grouped", "dense"])
def test_fewer_live_experts_than_k(impl):
    """One live expert with k = 2: every token's second choice is a tie of
    zeros, broken lowest index first (expert 0); those zero-weight choices
    still fill capacity slots, so expert 0's slots overflow."""
    x, gy, em = _inputs(3, mask="one_live")
    _hold("granite", x, gy, em, impl=impl)
    tcfg = CFGS["granite"][1]
    p = params_from_numpy(_moe_params("granite"), device="cpu")
    w, idx = tM._route(p, torch.tensor(x).reshape(B * S, 64), tcfg,
                       torch.tensor(em))
    assert torch.equal(idx[:, 0], torch.full((B * S,), 5))
    assert torch.equal(idx[:, 1], torch.zeros(B * S, dtype=idx.dtype))
    assert torch.equal(w[:, 1], torch.zeros(B * S))
    assert B * S > tM.capacity(B * S, tcfg, 1.25)


def test_overflow_at_capacity_factor_half():
    """capacity_factor 0.5: cap = 8 for 48 tokens x 2 choices over 8
    experts, so at least 96 - 64 choices overflow into the sink."""
    x, gy, em = _inputs(4)
    tcfg = CFGS["granite"][1]
    assert tM.capacity(B * S, tcfg, 0.5) == 8
    y = _hold("granite", x, gy, em, capacity_factor=0.5)
    full = _torch_fwd_grads("granite", x, gy, em, capacity_factor=4.0)[0]
    assert np.abs(y - full).max() > 1e-3          # something was dropped
    dense = _torch_fwd_grads("granite", x, gy, em, impl="dense")[0]
    np.testing.assert_allclose(full, dense, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_route_matches_jax(name):
    x, _, em = _inputs(5)
    jcfg, tcfg = CFGS[name]
    mp = _moe_params(name)
    jw, jidx = jM._route(jax.tree.map(jnp.asarray, mp),
                         jnp.asarray(x.reshape(B * S, 64)), jcfg,
                         jnp.asarray(em))
    tw, tidx = tM._route(params_from_numpy(mp, device="cpu"),
                         torch.tensor(x.reshape(B * S, 64)), tcfg,
                         torch.tensor(em))
    np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=0, atol=1e-6)


def test_load_balance_loss_matches_jax():
    x, _, _ = _inputs(6)
    jcfg, tcfg = CFGS["granite"]
    mp = _moe_params("granite")
    jp = jax.tree.map(jnp.asarray, mp)
    want, jgrad = jax.value_and_grad(
        lambda p: jM.load_balance_loss(p, jnp.asarray(x), jcfg))(jp)
    tp = params_from_numpy(mp, device="cpu")
    tp["router"].requires_grad_(True)
    got = tM.load_balance_loss(tp, torch.tensor(x), tcfg)
    (grad,) = torch.autograd.grad(got, [tp["router"]])
    assert abs(float(got.detach()) - float(want)) <= FWD_ATOL
    np.testing.assert_allclose(_np(grad), np.asarray(jgrad["router"]),
                               rtol=0, atol=GRAD_ATOL)


def test_top_k_ties_match_jax_top_k():
    """Ties break lowest index first, as in ``jax.lax.top_k``: the pinned
    row (0.5 at experts 5 and 17, zeros elsewhere) and random rows with
    repeated values."""
    pinned = np.zeros((1, 32), np.float32)
    pinned[0, [5, 17]] = 0.5
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 4, size=(64, 32)).astype(np.float32) / 4
    for probs, k in ((pinned, 8), (rows, 8), (rows, 2), (rows[:, :8], 2)):
        jw, jidx = jax.lax.top_k(jnp.asarray(probs), k)
        tw, tidx = tM.top_k(torch.tensor(probs), k)
        np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
        np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    assert tM.top_k(torch.tensor(pinned), 8)[1].tolist() == \
        [[5, 17, 0, 1, 2, 3, 4, 6]]


def test_moe_groups_must_divide_tokens():
    x, _, _ = _inputs(8)
    p = params_from_numpy(_moe_params("granite"), device="cpu")
    with pytest.raises(ValueError, match="moe_groups"):
        tM.moe_fwd(p, torch.tensor(x), CFGS["granite"][1], moe_groups=5)


def test_masked_expert_leaves_get_zero_grad():
    """Soft-training: an expert the mask drops receives no token at
    positive weight, so its wi / wg / wo gradients are exactly zero."""
    x, gy, em = _inputs(9)
    em[[4, 6]] = 0.0
    _, tg, _ = _torch_fwd_grads("granite", x, gy, em)
    dead = np.flatnonzero(em == 0)
    for leaf in ("wi", "wg", "wo"):
        assert np.all(tg[leaf][dead] == 0), leaf
