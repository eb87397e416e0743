"""Port parity for the async event loop: ``FLRun.run_async`` of the port
against the JAX package's ``FLRun.run_async``, plus the event core, the
mixing rule and the snapshot-aliasing guarantee the loop relies on.

Reduced AlexNet with ``mask_block=128``, the Table-I 2 + 2 non-IID fleet,
two local steps of batch 8, until the capable clients completed six
cycles.  Both sides start from the same initial params (the JAX run's,
through the weight bridge) and the port draws its Eq. 2 numbers through
the JAX key-path backend.  The JAX side runs ``kernels="pallas"``
(interpret mode) for asyn and ``"reference"`` for the other cases; the
port runs ``kernels="cuda"``, whose autograd structure runs its plain
bodies on the CPU.  Cases: asyn, afo, helios under ``run_async`` (its
stragglers soft-train per event), asyn with lognormal jitter (sigma 0.1)
and Bernoulli dropout (p 0.4), and afo with ``snapshot_cap=1``.

Why p 0.4: at p 0.2 nothing drops in the first nine events of seed 0, and
client 1 completes first, which hands client 0 a batch whose conv4
activation has a 2x2 max-pool window with two mathematically equal
largest entries.  The port's convolution computes them bit-equal
(0.2897043824) and routes the gradient to the first, as the reference
does on an exact tie; XLA's computes them 2 ulp apart (0.2897042930,
0.2897045016) and routes it to the second.  From there the two
trajectories part by 1.6e-3 in 8 events.  That is rounding deciding a
tie, not a fault of either side (the tie routing itself is pinned below).
At p 0.4 the first completion drops and the events draw other batches.

Expected: identical history keys and event counters, acc and loss within
1e-5, params within atol 1e-5, identical straggler masks.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.core import aggregation as jAG  # noqa: E402
from repro.federated import events as jEV  # noqa: E402
from repro.federated import FLRun as JaxFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.core import aggregation as tAG  # noqa: E402
from repro_torch.data.federated import partition_noniid  # noqa: E402
from repro_torch.data.synthetic import class_gaussian_images  # noqa: E402
from repro_torch.federated import (BernoulliDropout, FLRun,  # noqa: E402
                                   JitteredArrival, SimClock, make_fleet,
                                   setup_clients)
from repro_torch.federated import events as tEV  # noqa: E402
from test_torch_keys import jax_keys  # noqa: E402

ATOL = 1e-5
CYCLES = 6
RUN_KW = dict(local_steps=2, batch_size=8, lr=0.05, seed=0, eval_batch=64)
COUNTERS = ("events_processed", "events_dropped", "agg_counter",
            "snapshot_peak", "snapshot_anchor_misses", "uplink_updates",
            "downlink_updates")
#: case -> (scheme, JAX kernels, process factory or None, run_async kwargs)
CASES = {
    "asyn": ("asyn", "pallas", None, {}),
    "afo": ("afo", "reference", None, {}),
    "helios": ("helios", "reference", None, {}),
    "asyn-jitter-dropout": ("asyn", "reference", "jitter", {}),
    "afo-cap1": ("afo", "reference", None, {"snapshot_cap": 1}),
}


@pytest.fixture(scope="module")
def setting():
    imgs, labels = class_gaussian_images(256, 16, 3, 10, seed=0)
    ti, tl = class_gaussian_images(64, 16, 3, 10, seed=9)
    parts = partition_noniid(labels, 4, shards_per_client=4)
    return {"images": imgs, "labels": labels}, {"images": ti, "labels": tl}, \
        parts


def _processes(which, mod):
    if which is None:
        return {}
    return {"arrival": mod.JitteredArrival(0.1),
            "dropout": mod.BernoulliDropout(0.4)}


@pytest.fixture(scope="module")
def runs(setting):
    train, test, parts = setting
    jcfg, tcfg = JC.reduced(JC.CNNS["alexnet"]), TC.reduced(TC.ALEXNET)
    jh, th = JC.HeliosConfig(mask_block=128), TC.HeliosConfig(mask_block=128)
    out = {}
    for case, (scheme, jkernels, procs, kw) in CASES.items():
        jrun = JaxFLRun(jcfg, jh, scheme,
                        j_setup_clients(j_make_fleet(2, 2), parts, jh),
                        train, test, kernels=jkernels,
                        **_processes(procs, jEV), **RUN_KW)
        init = {k: np.asarray(v)
                for k, v in jax.device_get(jrun.global_params).items()}
        jrun.run_async(CYCLES, **kw)
        with jax_keys():
            trun = FLRun(tcfg, th, scheme,
                         setup_clients(make_fleet(2, 2), parts, th,
                                       device="cpu"),
                         train, test, kernels="cuda", device="cpu",
                         init_params=init, **_processes(procs, tEV),
                         **RUN_KW)
            trun.run_async(CYCLES, **kw)
        out[case] = jrun, trun
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_history_and_params_match_jax(runs, case):
    jrun, trun = runs[case]
    assert len(trun.history) == len(jrun.history) == CYCLES
    for j, t in zip(jrun.history, trun.history):
        assert set(t) == set(j)
        for k in ("scheme", "cycle", "time", "staleness", "record_cadence",
                  "downlink_mb"):
            assert t[k] == j[k], (k, t[k], j[k])
        assert abs(t["acc"] - j["acc"]) <= ATOL
        assert abs(t["loss"] - j["loss"]) <= ATOL
    for k, v in jrun.global_params.items():
        np.testing.assert_allclose(trun.global_params[k].numpy(),
                                   np.asarray(v), rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_counters_and_masks_match_jax(runs, case):
    jrun, trun = runs[case]
    for name in COUNTERS:
        assert getattr(trun, name) == getattr(jrun, name), name
    assert trun.rec.count("queue_peak") == jrun.rec.count("queue_peak")
    assert [c.staleness_anchor for c in trun.clients] == \
        [c.staleness_anchor for c in jrun.clients]
    # the snapshot dict stays bounded and never loses a live anchor
    cap = CASES[case][3].get("snapshot_cap", 64)
    assert trun.snapshot_anchor_misses == 0
    assert trun.snapshot_peak <= cap + len(trun.clients) + 1
    for jc, tc in zip(jrun.clients, trun.clients):
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=k)


def test_cases_exercise_what_they_name(runs):
    """Stale updates reach the mix, the lossy fleet drops events, the cap
    evicts, and helios stragglers soft-train per event (ratio < 1)."""
    assert max(r["staleness"] for r in runs["afo"][1].history) >= 1
    stale = [c.staleness_anchor for c in runs["afo"][1].clients]
    assert min(stale) < max(stale)
    assert runs["asyn-jitter-dropout"][1].events_dropped > 0
    assert runs["afo-cap1"][1].snapshot_peak < runs["afo"][1].snapshot_peak
    hel = runs["helios"][1]
    for c in hel.clients:
        if c.is_straggler:
            assert c.helios_state["cycle"] > 0
            fc0 = c.helios_state["masks"]["fc0"].numpy()
            assert 0 < fc0.sum() < fc0.size


def test_snapshots_are_never_written_in_place(setting, monkeypatch):
    """run_async keeps each global by reference as a snapshot and trains a
    straggler from it events later: every global the loop produced keeps
    its values and its storage (data_ptr) through the rest of the run."""
    train, test, parts = setting
    cfg, h = TC.reduced(TC.ALEXNET), TC.HeliosConfig(mask_block=128)
    run = FLRun(cfg, h, "afo", setup_clients(make_fleet(2, 2), parts, h,
                                             device="cpu"),
                train, test, kernels="cuda", device="cpu", **RUN_KW)
    seen = [(run.global_params,
             {k: (v.data_ptr(), v.clone()) for k, v in
              run.global_params.items()})]
    real_mix = tAG.mix

    def spy(g, c, w):
        out = real_mix(g, c, w)
        seen.append((out, {k: (v.data_ptr(), v.clone())
                           for k, v in out.items()}))
        return out

    stale_bases = []
    real_cycle = run._client_cycle

    def cycle(client, base):
        stale_bases.append(base is not run.global_params)
        return real_cycle(client, base)

    monkeypatch.setattr(tAG, "mix", spy)
    monkeypatch.setattr(run, "_client_cycle", cycle)
    run.run_async(CYCLES, eval_every=0)
    assert len(seen) == run.events_processed + 1
    assert any(stale_bases)          # some client trained from an old global
    for params, frozen in seen:
        for k, (ptr, val) in frozen.items():
            assert params[k].data_ptr() == ptr, k
            assert torch.equal(params[k], val), k
    # and a mix never hands back storage of either input
    g = {"w": torch.ones(3)}
    c = {"w": torch.zeros(3)}
    out = real_mix(g, c, 0.5)
    assert out["w"].data_ptr() not in (g["w"].data_ptr(), c["w"].data_ptr())
    assert torch.equal(g["w"], torch.ones(3))


def test_maxpool_tie_routing_matches_reference():
    """An exact tie in a max-pool window sends the gradient to the first
    entry on both sides."""
    import jax.numpy as jnp
    from repro.models import cnn as jcnn
    x = np.array([0.5, 0.5, 0.1, 0.0], np.float32).reshape(1, 2, 2, 1)
    want = np.asarray(jax.grad(lambda v: jcnn.max_pool(v).sum())(
        jnp.asarray(x)))
    t = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    got = torch.autograd.grad(torch.nn.functional.max_pool2d(t, 2).sum(), t)
    np.testing.assert_array_equal(got[0].permute(0, 2, 3, 1).numpy(), want)
    assert want.ravel().tolist() == [1.0, 0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# the event core and the mixing rule against the reference's
# ---------------------------------------------------------------------------


def test_simclock_tie_order_and_buckets_match_reference():
    """Equal-time completions pop in client-id order; buckets and the
    clock's bookkeeping match the reference's."""
    schedule = [(1.0, 3), (1.0, 1), (0.5, 7), (1.0, 2), (2.0, 0), (1.25, 5)]
    t, j = SimClock(), jEV.SimClock()
    for clock in (t, j):
        for d, cid in schedule:
            clock.schedule(d, cid)
    assert t.peak_depth == j.peak_depth == len(schedule)
    assert t.peek_time() == j.peek_time() == 0.5
    assert t.pop() == j.pop() == 7 and t.now == j.now == 0.5
    tb, jb = t.pop_bucket(), j.pop_bucket()
    assert [(e.time, e.cid) for e in tb] == \
        [(e.time, e.cid) for e in jb] == [(1.0, 1), (1.0, 2), (1.0, 3)]
    tb, jb = t.pop_bucket(horizon=1.0, max_size=1), \
        j.pop_bucket(horizon=1.0, max_size=1)
    assert [(e.time, e.cid) for e in tb] == [(e.time, e.cid) for e in jb]
    for clock in (t, j):
        clock.schedule_at(0.1, 9)        # an earlier absolute time
    assert t.now == j.now == 1.25 and len(t) == len(j) == 2
    assert [t.pop(), t.pop()] == [j.pop(), j.pop()] == [9, 0]
    assert t.now == j.now == 2.0 and t.empty() and j.empty()
    assert t.pop_bucket() == j.pop_bucket() == []
    assert t.peek_time() == j.peek_time() == float("inf")


def test_arrival_and_dropout_draws_match_reference():
    ta, ja = JitteredArrival(0.2), jEV.JitteredArrival(0.2)
    td, jd = BernoulliDropout(0.3, penalty=1.5), \
        jEV.BernoulliDropout(0.3, penalty=1.5)
    for seed in (0, 7):
        for p in (ta, ja, td, jd):
            p.reset(seed)
        got = [(ta.delay(i % 4, 1.0 + i), td.drops(i % 4)) for i in range(64)]
        want = [(ja.delay(i % 4, 1.0 + i), jd.drops(i % 4))
                for i in range(64)]
        assert got == want
    assert td.penalty == jd.penalty == 1.5
    assert tEV.ArrivalProcess().delay(0, 2.5) == 2.5
    assert not tEV.DropoutProcess().drops(0)


@pytest.mark.parametrize("stale", [0, 1, 3, 10])
@pytest.mark.parametrize("a", [0.5, 1.0])
def test_mix_and_staleness_weight_match_reference(stale, a):
    assert tAG.staleness_weight(stale, a) == jAG.staleness_weight(stale, a)
    rng = np.random.default_rng(stale)
    g = {"w": rng.normal(size=(5, 7)).astype(np.float32),
         "b": rng.normal(size=(7,)).astype(np.float32)}
    c = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in g.items()}
    w = 0.5 * tAG.staleness_weight(stale, a)
    want = jAG.mix(g, c, w)
    got = tAG.mix({k: torch.tensor(v) for k, v in g.items()},
                  {k: torch.tensor(v) for k, v in c.items()}, w)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-7)
    bf = tAG.mix({"w": torch.ones(4, dtype=torch.bfloat16)},
                 {"w": torch.zeros(4)}, w)
    assert bf["w"].dtype == torch.bfloat16
