"""Port parity for the gauntlet's last three schemes on the sequential
engine: ``FLRun`` of the port against the JAX package's, the async
fallback, the delayed scheme's snapshot ring and ``core.theory``.

Reduced AlexNet with ``mask_block=128`` (tests/test_torch_slice.py's
setting: the Table-I 2 + 2 non-IID fleet, 2 local steps of batch 8, lr
0.05).  Both sides start from the JAX run's initial params and the port
draws its Eq. 2 numbers through the JAX key-path backend; the JAX side
runs ``kernels="reference"``, the port ``kernels="cuda"`` (plain bodies on
the CPU).

* ``run_sync(2)`` of scaffold, fluid and delayed: identical history
  (cycle, time, volumes, ratios) and straggler masks, acc / loss / params
  within atol 1e-5; SCAFFOLD's ``c_global`` and every client's control
  row within 1e-5 / (K * lr), K local steps at rate lr (the params'
  tolerance carried through ``dc = (x - y) / (K * lr) - c``);
  ``uplink_bytes()`` and ``uplink_extra_updates`` equal to JAX's.
* ``run_async(4)`` of scaffold and delayed on ``AsyncFLRun``, which hands
  both to the sequential event loop on each side.
* the delayed ring: a read taken before a put into its slot keeps its
  values; the scheme flags against the reference's manifest.
* ``theory.*`` against ``repro.core.theory`` on seeded vectors with tied
  magnitudes: probabilities at atol 1e-6 with the same coordinates kept,
  the sums (up to 600 f32 terms, added in another order) within 1e-6 of
  their size.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.core import theory as jTH  # noqa: E402
from repro.federated import AsyncFLRun as JaxAsyncFLRun  # noqa: E402
from repro.federated import FLRun as JaxFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import make_scheme as j_make_scheme  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.core import aggregation as tAG  # noqa: E402
from repro_torch.core import theory as tTH  # noqa: E402
from repro_torch.data.federated import partition_noniid  # noqa: E402
from repro_torch.data.synthetic import class_gaussian_images  # noqa: E402
from repro_torch.federated import (SCHEMES, AsyncFLRun, FLRun,  # noqa: E402
                                   make_fleet, make_scheme, setup_clients)
from test_torch_keys import jax_keys, share_jax_programs  # noqa: E402

ATOL = 1e-5
RUN_KW = dict(local_steps=2, batch_size=8, lr=0.05, seed=0, eval_batch=64)
#: the controls' tolerance: ATOL / (K * lr)
CTRL_ATOL = ATOL / (RUN_KW["local_steps"] * RUN_KW["lr"])
NEW = ("scaffold", "fluid", "delayed")
ASYNC = ("scaffold", "delayed")


@pytest.fixture(scope="module")
def setting():
    imgs, labels = class_gaussian_images(256, 16, 3, 10, seed=0)
    ti, tl = class_gaussian_images(64, 16, 3, 10, seed=9)
    parts = partition_noniid(labels, 4, shards_per_client=4)
    return {"images": imgs, "labels": labels}, {"images": ti, "labels": tl}, \
        parts


def _pair(jcls, tcls, scheme, setting):
    """The JAX engine and the port's on the 2 + 2 fleet from the same
    initial params (the caller holds the JAX key backend)."""
    train, test, parts = setting
    jh, th = JC.HeliosConfig(mask_block=128), TC.HeliosConfig(mask_block=128)
    jrun = jcls(JC.reduced(JC.CNNS["alexnet"]), jh, scheme,
                j_setup_clients(j_make_fleet(2, 2), parts, jh), train, test,
                kernels="reference", **RUN_KW)
    if jcls is JaxFLRun:
        share_jax_programs(jrun)
    init = {k: np.asarray(v)
            for k, v in jax.device_get(jrun.global_params).items()}
    trun = tcls(TC.reduced(TC.ALEXNET), th, scheme,
                setup_clients(make_fleet(2, 2), parts, th, device="cpu"),
                train, test, kernels="cuda", device="cpu", init_params=init,
                **RUN_KW)
    return jrun, trun


@pytest.fixture(scope="module")
def sync_runs(setting):
    out = {}
    for scheme in NEW:
        with jax_keys():
            jrun, trun = _pair(JaxFLRun, FLRun, scheme, setting)
            jrun.run_sync(2)
            trun.run_sync(2)
        out[scheme] = jrun, trun
    return out


@pytest.fixture(scope="module")
def async_runs(setting):
    out = {}
    for scheme in ASYNC:
        with jax_keys():
            jrun, trun = _pair(JaxAsyncFLRun, AsyncFLRun, scheme, setting)
            jrun.run_async(4)
            trun.run_async(4)
        out[scheme] = jrun, trun
    return out


def assert_params(jparams, tparams, atol=ATOL):
    assert set(tparams) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_allclose(np.asarray(tparams[k].cpu()),
                                   np.asarray(v), rtol=0, atol=atol,
                                   err_msg=k)


def assert_controls(jrun, trun):
    """``c_global`` and every materialized control row, by cid."""
    assert_params(jrun._c_global, trun._c_global, CTRL_ATOL)
    assert sorted(trun._ctrl_store._rows) == sorted(jrun._ctrl_store._rows)
    for cid in jrun._ctrl_store._rows:
        assert_params(jrun._ctrl_store.row(cid), trun._ctrl_store.row(cid),
                      CTRL_ATOL)


def assert_history(jrun, trun, keys):
    assert len(trun.history) == len(jrun.history) > 0
    for j, t in zip(jrun.history, trun.history):
        assert set(t) == set(j)
        for k in ("scheme", "record_cadence", "downlink_mb") + keys:
            assert t[k] == j[k], (k, t[k], j[k])
        assert abs(t["acc"] - j["acc"]) <= ATOL
        assert abs(t["loss"] - j["loss"]) <= ATOL


@pytest.mark.parametrize("scheme", NEW)
def test_run_sync_matches_jax(sync_runs, scheme):
    jrun, trun = sync_runs[scheme]
    assert_history(jrun, trun, ("cycle", "time", "volumes", "ratios"))
    assert_params(jrun.global_params, trun.global_params)
    for jc, tc in zip(jrun.clients, trun.clients):
        assert jc.is_straggler == tc.is_straggler and jc.volume == tc.volume
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=k)


def test_scaffold_controls_match_jax(sync_runs):
    jrun, trun = sync_runs["scaffold"]
    assert_controls(jrun, trun)
    assert trun._ctrl_store.touched() == len(trun.clients)
    assert trun._ctrl_store.stats() == {
        "rows": 4, "bytes": 4 * 4 * trun._n_params} == \
        jrun._ctrl_store.stats()
    assert float(torch.stack([v.abs().max() for v in
                              trun._c_global.values()]).max()) > 0
    assert trun._dc_buf == []


@pytest.mark.parametrize("scheme", NEW)
def test_uplink_bytes_match_jax(sync_runs, scheme):
    jrun, trun = sync_runs[scheme]
    assert trun.uplink_updates == jrun.uplink_updates == 8
    assert trun.uplink_extra_updates == jrun.uplink_extra_updates == \
        (8 if scheme == "scaffold" else 0)
    assert trun.uplink_bytes() == jrun.uplink_bytes()
    assert trun.downlink_bytes() == jrun.downlink_bytes()


def test_cases_exercise_what_they_name(sync_runs):
    """fluid's stragglers train top-k sub-models (ratio < 1, no rotation);
    the delayed clock is the capable cohort's (1.0 a round, where syn's
    would be the slowest straggler's); scaffold bills full volume."""
    fl = sync_runs["fluid"][1]
    for c, r in zip(fl.clients, fl.history[-1]["ratios"]):
        assert (r < 1.0) == c.is_straggler
    assert [h["time"] for h in sync_runs["delayed"][1].history] == [1.0, 2.0]
    assert [h["time"] for h in sync_runs["scaffold"][1].history] == \
        [2.9, 5.8]
    assert all(r == 1.0 for r in sync_runs["delayed"][1].history[-1]["ratios"])


@pytest.mark.parametrize("scheme", ASYNC)
def test_run_async_fallback_matches_jax(async_runs, scheme):
    jrun, trun = async_runs[scheme]
    assert all(r["record_cadence"] == "event" for r in trun.history)
    assert_history(jrun, trun, ("cycle", "time", "staleness"))
    assert_params(jrun.global_params, trun.global_params)
    for name in ("events_processed", "agg_counter", "snapshot_peak",
                 "uplink_updates", "uplink_extra_updates",
                 "downlink_updates"):
        assert getattr(trun, name) == getattr(jrun, name), name
    assert trun.uplink_bytes() == jrun.uplink_bytes()
    if scheme == "scaffold":
        assert_controls(jrun, trun)


def test_delayed_ring_read_survives_put():
    """The delayed scheme's ring (cap 3, no anchors): from the third put on
    the allocator recycles the slot the round just read; the read keeps
    its values, as the reference's out-of-place ``.at[s].set`` does."""
    g = {"w": torch.zeros(3, 2)}
    ring = tAG.SnapshotRing(g, cap=3, n_anchors=0)
    for rnd in range(5):
        base = ring.read(max(0, rnd - 2))
        want = {k: v.clone() for k, v in base.items()}
        read_slot = ring.alloc.slot_of(max(0, rnd - 2))
        slot = ring.put(rnd + 1, {"w": torch.full((3, 2), rnd + 1.0)})
        assert (slot == read_slot) == (rnd >= 2)
        assert torch.equal(base["w"], want["w"])
        assert torch.equal(ring.read(rnd + 1)["w"],
                           torch.full((3, 2), rnd + 1.0))


def test_scheme_flags_match_jax():
    assert tuple(SCHEMES) == ("helios", "syn", "st_only", "random", "asyn",
                              "afo", "scaffold", "fluid", "delayed")
    for name in SCHEMES:
        assert make_scheme(name).manifest() == j_make_scheme(name).manifest()
    h = TC.HeliosConfig(p_s=0.3)
    eff = make_scheme("fluid").effective_hcfg(h)
    jeff = j_make_scheme("fluid").effective_hcfg(JC.HeliosConfig(p_s=0.3))
    assert (eff.p_s, eff.rotation_threshold_auto, eff.rotation_threshold) == \
        (jeff.p_s, jeff.rotation_threshold_auto, jeff.rotation_threshold) == \
        (1.0, False, 10 ** 9)
    assert make_scheme("fluid").agg_mode(h) == "masked_mean"


def _tied(seed, n=600):
    """A seeded vector whose magnitudes tie in groups (a quarter of the
    values drawn from 8 levels, signs mixed) and a few exact zeros."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=n).astype(np.float32)
    idx = rng.choice(n, n // 4, replace=False)
    g[idx] = rng.choice([-1.0, 1.0], n // 4) * \
        rng.choice(np.linspace(0.5, 2.0, 8), n // 4).astype(np.float32)
    g[:5] = 0.0
    return g


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("v", [1, 37, 150, 599])
def test_theory_matches_jax(seed, v):
    g = _tied(seed)
    jg, tg = jnp.asarray(g), torch.as_tensor(g)
    jp, tp = jTH.wangni_probabilities(jg, v), tTH.wangni_probabilities(tg, v)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    # ties rank as jnp.argsort ranks them: the same coordinates kept at 1
    np.testing.assert_array_equal(tp.numpy() == 1.0, np.asarray(jp) == 1.0)
    for name in ("st_second_moment", "variance_inflation"):
        want = float(getattr(jTH, name)(jg, jp))
        got = float(getattr(tTH, name)(tg, tp))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), name
    want = float(jTH.expected_sparsity(jp))
    assert abs(float(tTH.expected_sparsity(tp)) - want) <= 1e-6 * want
    (jl, jr), (tl, tr) = (jTH.check_convergence_condition(jg, v, 0.5),
                          tTH.check_convergence_condition(tg, v, 0.5))
    assert tr == jr and abs(float(tl) - float(jl)) <= 1e-6 * float(jl)
    assert float(tl) <= tr + 1e-6


def test_st_estimate_is_unbiased_and_supported():
    """``st_estimate`` with an explicit generator: zero where D_i = 0,
    g_i / p_i where kept, every coordinate at p = 1 kept, and the mean of
    many draws near g."""
    g = torch.as_tensor(_tied(2, 64))
    p = tTH.wangni_probabilities(g, 16)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tTH.st_estimate(g, p, gen) for _ in range(4000)])
    kept = draws != 0
    assert bool(kept[:, p == 1.0][:, g[p == 1.0] != 0].all())
    torch.testing.assert_close(draws[kept],
                               (g / p).expand_as(draws)[kept])
    assert float((draws.mean(0) - g).abs().max()) < 0.25 * float(
        g.abs().max())
