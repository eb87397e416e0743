"""Port parity for the batched round engine and the bucketed async engine:
``BatchedFLRun`` / ``AsyncFLRun`` of the port against the JAX package's,
plus the pieces they stand on.

Reduced AlexNet with ``mask_block=128`` (fc0: 8 blocks, fc1: 4, so Eq. 2
selects whole blocks there), the Table-I non-IID fleet, batch 8.  Both
sides start from the same initial params (the JAX run's, through the
weight bridge) and the port draws its Eq. 2 numbers through the JAX
key-path backend.  The JAX side runs ``kernels="pallas"`` (interpret mode,
the Pallas pair vmapped over each cohort) for helios and ``"reference"``
for the other cases; the port runs ``kernels="cuda"``, whose vmap rules
run the client-axis wrappers' plain bodies on the CPU.

* ``run_sync(3)`` of helios / syn / st_only / random on a 2 + 2 fleet,
  helios with ``aggregation="masked_mean"``, 3 of a 3 + 3 fleet a round,
  and a join / leave sequence: identical history (cycle, time, ratios,
  volumes) and straggler masks, acc / loss / params within atol 1e-5.
  One local step where the cohort changes (sampled, elastic), as the
  sequential walls do.
* asyn and afo ``run_async(6)`` on the bucket engine, and afo on a 3 + 3
  fleet whose buckets of 3 pad to 4: identical history (with
  ``record_cadence`` and ``bucket``), ``bucket_sizes`` and counters,
  params within atol 1e-5.
* the vmapped ``masked_dense`` / ``masked_contract`` against a loop over
  clients of plain autograd (exact on the CPU, where both run the same
  plain products), with a shared weight and a shared mask;
  ``stack_states`` round trip; ``RingAllocator`` and ``aggregate_stacked``
  against the JAX package's.
* the dense LM, the hybrid, the MoE LM and xLSTM build on
  ``BatchedFLRun`` and ``AsyncFLRun``.
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
from repro.core import aggregation as jAG  # noqa: E402
from repro.federated import AsyncFLRun as JaxAsyncFLRun  # noqa: E402
from repro.federated import BatchedFLRun as JaxBatchedFLRun  # noqa: E402
from repro.federated import TABLE_I as J_TABLE_I  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.core import aggregation as tAG  # noqa: E402
from repro_torch.core import soft_train as tST  # noqa: E402
from repro_torch.data.federated import partition_noniid  # noqa: E402
from repro_torch.data.synthetic import class_gaussian_images  # noqa: E402
from repro_torch.federated import (TABLE_I, AsyncFLRun,  # noqa: E402
                                   BatchedFLRun, FLRun, make_fleet,
                                   setup_clients)
from repro_torch.kernels import masked_matmul as tK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_keys import jax_keys  # noqa: E402

ATOL = 1e-5
RUN_KW = dict(local_steps=2, batch_size=8, lr=0.05, seed=0, eval_batch=64)
#: case -> (scheme, JAX kernels, HeliosConfig overrides, fleet, run kwargs)
SYNC = {
    "helios": ("helios", "pallas", {}, (2, 2), {}),
    "syn": ("syn", "reference", {}, (2, 2), {}),
    "st_only": ("st_only", "reference", {}, (2, 2), {}),
    "random": ("random", "reference", {}, (2, 2), {}),
    "masked_mean": ("helios", "reference", {"aggregation": "masked_mean"},
                    (2, 2), {}),
    "sampled": ("helios", "reference", {}, (3, 3),
                {"participation": 3, "local_steps": 1}),
}
#: case -> (scheme, JAX kernels, fleet); three equal capable clients make
#: buckets of 3, padded to 4 (a weight-0 event on the ring's scratch row)
ASYNC = {"asyn": ("asyn", "pallas", (2, 2)),
         "afo": ("afo", "reference", (2, 2)),
         "afo-padded": ("afo", "reference", (3, 3))}
CYCLES = 6


def _data(n_clients):
    imgs, labels = class_gaussian_images(256, 16, 3, 10, seed=0)
    ti, tl = class_gaussian_images(64, 16, 3, 10, seed=9)
    parts = partition_noniid(labels, n_clients, shards_per_client=4)
    return {"images": imgs, "labels": labels}, {"images": ti, "labels": tl}, \
        parts


def _pair(jcls, tcls, scheme, jkernels, hkw, fleet, parts, data, **kw):
    """The JAX engine and the port's on the same fleet and initial params
    (the port built under the JAX key backend, which the caller holds)."""
    train, test = data
    jh = JC.HeliosConfig(mask_block=128, **hkw)
    th = TC.HeliosConfig(mask_block=128, **hkw)
    jrun = jcls(JC.reduced(JC.CNNS["alexnet"]), jh, scheme,
                j_setup_clients(j_make_fleet(*fleet), parts, jh), train, test,
                kernels=jkernels, **kw)
    init = {k: np.asarray(v)
            for k, v in jax.device_get(jrun.global_params).items()}
    trun = tcls(TC.reduced(TC.ALEXNET), th, scheme,
                setup_clients(make_fleet(*fleet), parts, th, device="cpu"),
                train, test, kernels="cuda", device="cpu", init_params=init,
                **kw)
    return jrun, trun


def _assert_same(jrun, trun, keys=("cycle", "time", "volumes", "ratios")):
    assert len(trun.history) == len(jrun.history) > 0
    for j, t in zip(jrun.history, trun.history):
        assert set(t) == set(j)
        for k in ("scheme", "record_cadence", "downlink_mb") + keys:
            assert t[k] == j[k], (k, t[k], j[k])
        assert abs(t["acc"] - j["acc"]) <= ATOL
        assert abs(t["loss"] - j["loss"]) <= ATOL
    for k, v in jrun.global_params.items():
        np.testing.assert_allclose(trun.global_params[k].numpy(),
                                   np.asarray(v), rtol=0, atol=ATOL,
                                   err_msg=k)
    for jc, tc in zip(jrun.clients, trun.clients):
        assert jc.is_straggler == tc.is_straggler and jc.volume == tc.volume
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=k)


@pytest.fixture(scope="module")
def sync_runs():
    out = {}
    for case, (scheme, jkernels, hkw, fleet, kw) in SYNC.items():
        train, test, parts = _data(sum(fleet))
        with jax_keys():
            jrun, trun = _pair(JaxBatchedFLRun, BatchedFLRun, scheme,
                               jkernels, hkw, fleet, parts, (train, test),
                               **dict(RUN_KW, **kw))
            jrun.run_sync(3)
            trun.run_sync(3)
        out[case] = jrun, trun
    return out


@pytest.mark.parametrize("case", list(SYNC))
def test_run_sync_matches_jax(sync_runs, case):
    jrun, trun = sync_runs[case]
    _assert_same(jrun, trun)
    assert trun.cohort_log == jrun.cohort_log
    assert trun.downlink_updates == jrun.downlink_updates
    assert trun.uplink_updates == jrun.uplink_updates


def test_cases_exercise_what_they_name(sync_runs):
    """Soft-training stragglers train sub-models (ratio < 1, state
    advanced and written back); the sampled run drew cohorts of 3 and left
    unsampled stragglers' state alone; syn has no straggler cohort."""
    for case in ("helios", "masked_mean", "st_only", "random"):
        trun = sync_runs[case][1]
        for c, r in zip(trun.clients, trun.history[-1]["ratios"]):
            assert (r < 1.0) == c.is_straggler, case
            assert c.helios_state["cycle"] == (3 if c.is_straggler else 0)
    samp = sync_runs["sampled"][1]
    assert all(len(c) == 3 for c in samp.cohort_log)
    for i, c in enumerate(samp.clients):
        if c.is_straggler:
            assert c.helios_state["cycle"] == \
                sum(i in cohort for cohort in samp.cohort_log)
    syn = sync_runs["syn"][1]
    assert syn._sstate is None and syn._c_idx == [0, 1, 2, 3]
    assert tK.CLIENT_LAUNCHES == {"masked_matmul": 0, "masked_matmul_dk": 0}


def test_elastic_join_leave_matches_jax():
    """examples/elastic_scaling.py's sequence (rounds, a DeepLens straggler
    joins, rounds, it leaves, a round): the cohorts are rebuilt each time."""
    train, test, parts = _data(6)
    with jax_keys():
        jrun, trun = _pair(JaxBatchedFLRun, BatchedFLRun, "helios",
                           "reference", {}, (2, 2), parts[:4], (train, test),
                           **dict(RUN_KW, local_steps=1))
        for run, table in ((jrun, J_TABLE_I), (trun, TABLE_I)):
            run.run_sync(2)
            new = run.add_client(table[3], parts[4])
            run.run_sync(2)
            run.remove_client(new.cid)
            run.run_sync(1)
    assert [len(h["volumes"]) for h in trun.history] == [4, 4, 5, 5, 4]
    assert trun._s_idx == [2, 3] and len(trun.clients) == 4
    _assert_same(jrun, trun)


@pytest.fixture(scope="module")
def async_runs():
    out = {}
    for case, (scheme, jkernels, fleet) in ASYNC.items():
        train, test, parts = _data(sum(fleet))
        with jax_keys():
            jrun, trun = _pair(JaxAsyncFLRun, BatchedFLRun, scheme, jkernels,
                               {}, fleet, parts, (train, test), **RUN_KW)
            jrun.run_async(CYCLES)
            trun.run_async(CYCLES)
        out[case] = jrun, trun
    return out


@pytest.mark.parametrize("case", list(ASYNC))
def test_run_async_matches_jax(async_runs, case):
    jrun, trun = async_runs[case]
    _assert_same(jrun, trun, ("cycle", "time", "staleness", "bucket"))
    assert all(r["record_cadence"] == "bucket" for r in trun.history)
    assert trun.bucket_sizes == jrun.bucket_sizes
    for name in ("events_processed", "events_dropped", "agg_counter",
                 "snapshot_peak", "snapshot_anchor_misses", "uplink_updates",
                 "downlink_updates"):
        assert getattr(trun, name) == getattr(jrun, name), name
    assert trun.rec.count("queue_peak") == jrun.rec.count("queue_peak")
    assert [c.staleness_anchor for c in trun.clients] == \
        [c.staleness_anchor for c in jrun.clients]
    if case == "afo-padded":
        assert 3 in trun.bucket_sizes


def test_bucket_engine_tracks_the_sequential_loop(async_runs):
    """The port's bucket engine and its sequential ``run_async`` end on the
    same global params (within rounding) from the same seed."""
    _, trun = async_runs["afo"]
    train, test, parts = _data(4)
    h = TC.HeliosConfig(mask_block=128)
    seq = FLRun(TC.reduced(TC.ALEXNET), h, "afo",
                setup_clients(make_fleet(2, 2), parts, h, device="cpu"),
                train, test, kernels="cuda", device="cpu",
                init_params=trun.init_params, **RUN_KW)
    seq.run_async(CYCLES)
    assert seq.events_processed == trun.events_processed
    for k, v in seq.global_params.items():
        np.testing.assert_allclose(trun.global_params[k].numpy(), v.numpy(),
                                   rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-1.2b",
                                  "granite-moe-1b-a400m", "xlstm-125m"])
def test_lm_families_accepted(arch):
    """The dense LM, the Mamba2 hybrid, the MoE LM and xLSTM build on both
    engines (``tests/test_torch_batched_lm.py``, ``_hybrid.py``,
    ``_moe.py`` and ``_xlstm.py`` hold their runs against JAX)."""
    cfg = TC.reduced(TC.ARCHS[arch])
    tokens = np.zeros((8, 33), np.int32)
    for cls in (BatchedFLRun, AsyncFLRun):
        run = cls(cfg, TC.HeliosConfig(), "helios", [], {"tokens": tokens},
                  {"tokens": tokens}, device="cpu")
        assert run.adapter.metric_name == "ce"


# ---------------------------------------------------------------------------
# the pieces: the vmapped masked ops, stacked states, ring, aggregation
# ---------------------------------------------------------------------------


def _masks(c, n, rng):
    m = (rng.random((c, n // 16)) < 0.5).repeat(16, axis=1)
    m[0] = 0                                   # a client with no live block
    m[-1] = 1
    return torch.as_tensor(m.astype(np.float32))


@pytest.mark.parametrize("shared", ["none", "w", "mask"])
@pytest.mark.parametrize("op", ["dense", "contract"])
def test_vmapped_masked_ops_match_a_client_loop(op, shared):
    """Forward and grads of the vmapped op against plain autograd client by
    client; masked columns of y and dw exactly zero; ``in_dims=None`` for
    the weight or the mask reaches the client-axis wrappers with a client
    stride of 0."""
    rng = np.random.default_rng(0)
    c, m, k, n = 4, 6, 40, 80
    x = torch.as_tensor(rng.normal(size=(c, m, k if op == "dense" else n))
                        .astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(c, k, n) if op == "dense" else
                                   (c, n, k)).astype(np.float32))
    mask = _masks(c, n, rng)
    if op == "contract":
        x = x * mask[:, None, :]
    fn = ops.masked_dense if op == "dense" else ops.masked_contract
    w_in = w[1] if shared == "w" else w
    m_in = mask[2] if shared == "mask" else mask

    def loss(x, w, mk, impl):
        y = fn(x, w, mk, impl=impl, block_n=16)
        return (torch.tanh(y) ** 2).sum(), y

    vm = torch.func.vmap(torch.func.grad_and_value(loss, argnums=(0, 1),
                                                   has_aux=True),
                         in_dims=(0, None if shared == "w" else 0,
                                  None if shared == "mask" else 0, None))
    (gx, gw), (lv, yv) = vm(x, w_in, m_in, "cuda")
    for i in range(c):
        xi = x[i].clone().requires_grad_(True)
        wi = (w_in if shared == "w" else w_in[i]).clone().requires_grad_(True)
        mi = m_in if shared == "mask" else m_in[i]
        li, yi = loss(xi, wi, mi, "reference")
        dx, dw = torch.autograd.grad(li, (xi, wi))
        torch.testing.assert_close(yv[i], yi.detach(), rtol=0, atol=1e-6)
        torch.testing.assert_close(gx[i], dx, rtol=0, atol=1e-6)
        torch.testing.assert_close(gw[i], dw, rtol=0, atol=1e-6)
        dead = mi == 0
        if op == "dense":
            assert bool((yv[i][:, dead] == 0).all())
            assert bool((gw[i][:, dead] == 0).all())
        else:
            assert bool((gw[i][dead] == 0).all())


def test_client_live_table_is_built_once_per_mask():
    """Steps that reuse a cohort's masks reuse their live table (keyed by
    the views the vmap rules see); an in-place write rebuilds it."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(3, 4, 32)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(32, 64)).astype(np.float32))
    mask = _masks(3, 64, rng)[:, None, :]         # (C, 1, n), as in a state
    ops._CLIENT_LIVE.clear()
    calls = []
    real = tK.live_table

    def spy(flags):
        calls.append(flags.shape)
        return real(flags)

    tK.live_table = spy
    try:
        f = torch.func.vmap(torch.func.grad(
            lambda w, x, m: ops.masked_dense(x, w, m[0], impl="cuda",
                                             block_n=16).sum()),
            in_dims=(None, 0, 0))
        for _ in range(3):
            f(w, x, mask)
        assert calls == [(3, 4)]
        mask[0, 0, :16] = 1 - mask[0, 0, :16]
        f(w, x, mask)
        assert calls == [(3, 4), (3, 4)]
    finally:
        tK.live_table = real


def test_live_table_and_client_refs():
    flags = torch.tensor([[0, 1, 0, 1], [0, 0, 0, 0], [1, 1, 1, 1.]])
    table, counts = tK.live_table(flags)
    assert counts.tolist() == [2, 0, 4]
    assert table[0, :2].tolist() == [1, 3] and table[2].tolist() == [0, 1, 2,
                                                                      3]
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(3, 5, 48)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(48, 64)).astype(np.float32))
    y = tK.masked_matmul_clients(x, w.expand(3, 48, 64), table, counts, 16)
    for c in range(3):
        keep = flags[c].repeat_interleave(16)
        torch.testing.assert_close(y[c], x[c] @ (w * keep), rtol=0, atol=0)
    # the dk kernel over 3 contraction blocks: client 1 has none live
    kflags = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1.]])
    ktable, kcounts = tK.live_table(kflags)
    keep = kflags.repeat_interleave(16, dim=1)           # (3, 48)
    y = tK.masked_matmul_dk_clients(x * keep[:, None, :],
                                    w.expand(3, 48, 64), ktable, kcounts, 16)
    for c in range(3):
        torch.testing.assert_close(y[c], (x[c] * keep[c]) @ w, rtol=0,
                                   atol=0)


def test_stack_states_round_trip():
    schema = {"fc0": (1, 64), "fc1": (1, 32)}
    states = [tST.init_state(schema, volume=0.3 + 0.2 * i, seed=i,
                             device="cpu") for i in range(3)]
    states[1] = {**states[1], "cycle": 4}
    st = tST.stack_states(states)
    assert st["masks"]["fc0"].shape == (3, 1, 64)
    assert st["volume"].dtype == np.float32 and st["rng"][2] == states[2]["rng"]
    back = tST.unstack_states(tST.set_volumes(st, [0.5, 0.6, 0.7]), 3)
    for i, (a, b) in enumerate(zip(states, back)):
        assert b["rng"] == a["rng"] and b["cycle"] == a["cycle"]
        assert b["volume"] == np.float32([0.5, 0.6, 0.7][i])
        for k in schema:
            assert torch.equal(b["skip_counts"][k], a["skip_counts"][k])
    ended = tST.end_cycle(st, st["scores"], TC.HeliosConfig())
    assert ended["cycle"].tolist() == [1, 5, 1]


def test_ring_allocator_matches_jax():
    """One event sequence of retains, releases and allocations: the same
    slots, peaks and misses as the reference's allocator."""
    rng = np.random.default_rng(3)
    ja, ta = jAG.RingAllocator(6), tAG.RingAllocator(6)
    anchors = {c: 0 for c in range(4)}
    for a in (ja, ta):
        a.seed(0)
        for _ in anchors:
            a.retain(0)
    for agg in range(1, 40):
        c = int(rng.integers(4))
        got = []
        for a in (ja, ta):
            a.release(anchors[c])
            got.append(a.alloc(agg))
            a.retain(agg)
        assert got[0] == got[1] != ta.scratch
        anchors[c] = agg
        assert ta.live_slots() == ja.live_slots()
    assert ta.peak_live == ja.peak_live and ta.anchor_misses == 0
    with pytest.raises(KeyError):
        ta.slot_of(1)
    assert ta.anchor_misses == ja.anchor_misses + 1


@pytest.mark.parametrize("mode", ["alpha_weighted", "masked_mean", "uniform"])
def test_aggregate_stacked_matches_jax(mode):
    rng = np.random.default_rng(4)
    g = {"a": rng.normal(size=(3, 5)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    st = {k: rng.normal(size=(4,) + v.shape).astype(np.float32)
          for k, v in g.items()}
    masks = {k: (rng.random((4,) + v.shape) < 0.5).astype(np.float32)
             for k, v in g.items()}
    masks["b"][:, 0] = 0                    # a coordinate nobody trained
    ratios = np.array([0.5, 1.0, 0.25, 1.0], np.float32)
    want = jAG.aggregate_stacked(mode, {k: jnp.asarray(v) for k, v in
                                        g.items()},
                                 {k: jnp.asarray(v) for k, v in st.items()},
                                 jnp.asarray(ratios),
                                 {k: jnp.asarray(v) for k, v in masks.items()})
    got = tAG.aggregate_stacked(mode, {k: torch.as_tensor(v) for k, v in
                                       g.items()},
                                {k: torch.as_tensor(v) for k, v in st.items()},
                                torch.as_tensor(ratios),
                                {k: torch.as_tensor(v) for k, v in
                                 masks.items()})
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_mix_bucket_ring_matches_jax():
    rng = np.random.default_rng(5)
    g = {"a": rng.normal(size=(3, 4)).astype(np.float32)}
    st = {"a": rng.normal(size=(3, 3, 4)).astype(np.float32)}
    w = (0.5 * np.array([1, 2, 3], np.float32) ** -0.5) * \
        np.array([1, 1, 0], np.float32)
    ring = {"a": np.zeros((5, 3, 4), np.float32)}
    jg, jr = jAG.mix_bucket_ring({"a": jnp.asarray(g["a"])},
                                 {"a": jnp.asarray(ring["a"])},
                                 jnp.asarray([2, 0, 4]),
                                 {"a": jnp.asarray(st["a"])}, jnp.asarray(w))
    tg, tr = tAG.mix_bucket_ring({"a": torch.as_tensor(g["a"])},
                                 {"a": torch.as_tensor(ring["a"])}, [2, 0, 4],
                                 {"a": torch.as_tensor(st["a"])},
                                 torch.as_tensor(w))
    np.testing.assert_allclose(tg["a"].numpy(), np.asarray(jg["a"]), atol=1e-6)
    np.testing.assert_allclose(tr["a"].numpy(), np.asarray(jr["a"]), atol=1e-6)
    np.testing.assert_allclose(
        tAG.mix_bucket({"a": torch.as_tensor(g["a"])},
                       {"a": torch.as_tensor(st["a"])},
                       torch.as_tensor(w))["a"].numpy(), np.asarray(jg["a"]),
        atol=1e-6)
    np.testing.assert_allclose(
        tAG.staleness_weights(torch.tensor([0, 1, 3]), 0.5).numpy(),
        np.asarray(jAG.staleness_weights(jnp.asarray([0, 1, 3]), 0.5)),
        rtol=1e-7)
