"""Port parity for the batched, bucketed and population engines on the
MoE family: ``BatchedFLRun.run_sync(2)`` of helios, syn and helios under
``masked_mean``, and ``AsyncFLRun.run_async(6)`` of asyn, on
``reduced(granite-moe-1b-a400m)`` (4 MoE layers, 8 experts of 32 hidden
units, top-2; 240 Markov-topic streams of 32, ``mask_block=16``, the 2 + 2
fleet) against the JAX package's engines, with the setting, helpers and
tolerances of ``tests/test_torch_batched_lm.py``; ``ShardedFLRun`` at
world 1 against the port's ``BatchedFLRun``; and ``moe_fwd`` under
``torch.func.vmap`` over a client axis.

* ``moe_fwd`` with a client axis on params, tokens and expert masks,
  grouped at capacity factor 0.5 (choices overflow into the sink row) and
  dense: forward against a loop over clients and ``jax.vmap`` of the
  reference's (atol 1e-5), ``vmap(grad)`` of every leaf and the input
  against the loop's autograd and ``jax.vmap(jax.grad)`` (1e-4).
* ``ShardedFLRun`` (one block of the four clients a local step) against
  ``BatchedFLRun`` (two cohorts of two) over 2 helios rounds: the same
  history, ratios and masks, CE and loss within 1e-5, params within
  atol 1e-5.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

from repro.models import moe as jM  # noqa: E402
from repro_torch.federated import BatchedFLRun, ShardedFLRun  # noqa: E402
from repro_torch.models import moe as tM  # noqa: E402
from repro_torch.models.module import tree_map, tree_paths  # noqa: E402
from test_torch_batched_lm import (ARCHS, ATOL, GRAD_TOL, RUN_KW,  # noqa: E402
                                   _setting, check_run_async, check_run_sync)
from test_torch_keys import jax_keys  # noqa: E402

#: case -> (scheme, HeliosConfig overrides)
SYNC = {"helios": ("helios", {}), "syn": ("syn", {}),
        "masked_mean": ("helios", {"aggregation": "masked_mean"})}


@pytest.mark.parametrize("case", SYNC)
def test_batched_run_sync_matches_jax(case):
    check_run_sync("granite", *SYNC[case])


def test_bucket_engine_asyn_matches_jax():
    check_run_async("granite")


def test_sharded_world_one_matches_batched():
    """The population engine on the MoE LM: one vmapped block of the four
    clients a local step, against the batched engine's two cohorts."""
    import repro_torch.configs as TC
    from repro_torch.federated import make_fleet, setup_clients
    from repro_torch.models import init_params
    cfg = ARCHS["granite"][1]
    train, test, parts = _setting(ARCHS["granite"][2])
    hcfg = TC.HeliosConfig(mask_block=16)
    init = init_params(cfg, 0, "cpu")
    runs = []
    with jax_keys():
        for engine in (BatchedFLRun, ShardedFLRun):
            run = engine(cfg, hcfg, "helios",
                         setup_clients(make_fleet(2, 2), parts, hcfg,
                                       device="cpu"),
                         train, test, kernels="cuda", device="cpu",
                         init_params=tree_map(torch.clone, init), **RUN_KW)
            run.run_sync(2)
            runs.append(run)
    b, s = runs
    assert len(b.history) == len(s.history) == 2
    for x, y in zip(b.history, s.history):
        for k in ("cycle", "time", "volumes", "ratios"):
            assert x[k] == y[k], (k, x[k], y[k])
        assert abs(x["ce"] - y["ce"]) <= ATOL
        assert abs(x["loss"] - y["loss"]) <= ATOL
    assert min(s.history[-1]["ratios"]) < 1.0
    sp = dict(tree_paths(s.global_params))
    for k, v in tree_paths(b.global_params):
        np.testing.assert_allclose(sp[k].numpy(), v.numpy(), rtol=0,
                                   atol=ATOL, err_msg=k)
    for i, c in enumerate(b.clients):
        for k, m in c.helios_state["masks"].items():
            np.testing.assert_array_equal(
                np.asarray(s.client_state(i)["masks"][k]), m.numpy(),
                err_msg=k)


# ---------------------------------------------------------------------------
# moe_fwd under torch.func.vmap
# ---------------------------------------------------------------------------

C, B, S = 3, 2, 24
#: case -> moe_fwd keywords
DISPATCH = {"grouped_overflow": dict(impl="grouped", capacity_factor=0.5),
            "dense": dict(impl="dense")}


def _client_inputs():
    """C clients' MoE leaves (reference init scales, a seed a client),
    tokens, expert masks (at least k live) and output cotangents."""
    cfg = ARCHS["granite"][1]
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    rng = np.random.default_rng(0)

    def normal(shape, scale):
        return (rng.normal(size=(C,) + shape) * scale).astype(np.float32)

    p = {"router": normal((d, e), 0.02),
         "wi": normal((e, d, ff), (e * d) ** -0.5),
         "wg": normal((e, d, ff), (e * d) ** -0.5),
         "wo": normal((e, ff, d), (e * ff) ** -0.5)}
    x = rng.normal(size=(C, B, S, d)).astype(np.float32)
    em = (rng.random((C, e)) < 0.6).astype(np.float32)
    em[:, :2] = 1.0
    gy = rng.normal(size=(C, B, S, d)).astype(np.float32)
    return p, x, em, gy


@pytest.mark.parametrize("case", DISPATCH)
def test_moe_fwd_under_vmap(case):
    kw = DISPATCH[case]
    jcfg, tcfg = ARCHS["granite"][0], ARCHS["granite"][1]
    p, x, em, gy = _client_inputs()
    if kw["impl"] == "grouped":
        # the capacity is the call's: a client's B * S tokens
        assert tM.capacity(B * S, tcfg, 0.5) < B * S * 2 / 8 * 2
    tp = {k: torch.tensor(v) for k, v in p.items()}
    tx, tem, tgy = (torch.tensor(a) for a in (x, em, gy))

    def fwd(params, xx, mm):
        return tM.moe_fwd(params, xx, tcfg, expert_mask=mm, **kw)

    def obj(params, xx, mm, g):
        return (fwd(params, xx, mm) * g).sum()

    y = torch.func.vmap(fwd)(tp, tx, tem).numpy()
    gp, gx = torch.func.vmap(torch.func.grad(obj, argnums=(0, 1)))(
        tp, tx, tem, tgy)
    loop_y = np.stack([fwd({k: v[c] for k, v in tp.items()}, tx[c],
                           tem[c]).numpy() for c in range(C)])
    loop_g = [torch.func.grad(obj, argnums=(0, 1))(
        {k: v[c] for k, v in tp.items()}, tx[c], tem[c], tgy[c])
        for c in range(C)]

    def jfwd(params, xx, mm):
        return jM.moe_fwd(params, xx, jcfg, expert_mask=mm, **kw)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jx, jem, jgy = (jnp.asarray(a) for a in (x, em, gy))
    jy = np.asarray(jax.vmap(jfwd)(jp, jx, jem))
    jgp, jgx = jax.vmap(jax.grad(
        lambda pp, xx, mm, g: jnp.sum(jfwd(pp, xx, mm) * g),
        argnums=(0, 1)))(jp, jx, jem, jgy)
    np.testing.assert_allclose(y, loop_y, rtol=0, atol=ATOL)
    np.testing.assert_allclose(y, jy, rtol=0, atol=ATOL)
    for k in p:
        want = torch.stack([lg[0][k] for lg in loop_g]).numpy()
        np.testing.assert_allclose(gp[k].numpy(), want, rtol=0,
                                   atol=GRAD_TOL, err_msg=k)
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(jgp[k]),
                                   rtol=0, atol=GRAD_TOL, err_msg=k)
    want = torch.stack([lg[1] for lg in loop_g]).numpy()
    np.testing.assert_allclose(gx.numpy(), want, rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=0,
                               atol=GRAD_TOL)
    if kw["impl"] == "grouped":
        # something overflowed: the same call at a capacity with room for
        # every choice gives another output
        roomy = torch.func.vmap(lambda pp, xx, mm: tM.moe_fwd(
            pp, xx, tcfg, expert_mask=mm, impl="grouped",
            capacity_factor=4.0))(tp, tx, tem).numpy()
        assert np.abs(y - roomy).max() > 1e-3


def test_grouped_counts_unchanged():
    """The expert counts, formed out of place, equal the in-place
    ``index_add_`` the sequential path used, so its grouped output is
    unchanged bit for bit."""
    cfg = ARCHS["granite"][1]
    p, x, em, _ = _client_inputs()
    tp = {k: torch.tensor(v[0]) for k, v in p.items()}
    _, idx = tM._route(tp, torch.tensor(x[0]).reshape(B * S, -1), cfg,
                       torch.tensor(em[0]))
    se = torch.sort(idx.reshape(-1), stable=True).values
    counts = torch.zeros(cfg.num_experts, dtype=se.dtype).index_add_(
        0, se, torch.ones_like(se))
    assert torch.equal((se[:, None] == torch.arange(cfg.num_experts)).sum(0),
                       counts)
