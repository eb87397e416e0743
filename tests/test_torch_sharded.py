"""Port parity for the population engine: the port's ``ShardedFLRun``
(world 1: no process group) against the JAX package's on its
single-device mesh, plus the host population rows it stands on.

The reference's own settings (``tests/test_sharded_engine.py``): reduced
LeNet, a 2 + 2 Table-I fleet over ``partition_noniid``, 2 local steps of
batch 32, lr 0.1, seed 0; the reduced dense LM (deepseek-7b) at batch 4.
Both sides start from the JAX run's initial params and the port draws its
Eq. 2 numbers through the JAX key-path backend.

* ``run_sync`` of helios / syn / st_only (3 rounds), helios under
  ``masked_mean`` (2), SCAFFOLD and the delayed scheme (2; both
  ``_round_extras`` paths), ``topk`` (2), the LM (2) and 2 of 4 clients a
  round over 5 rounds: params within 1e-5, ratios and volumes within
  1e-6, times within 1e-9, acc / loss within 1e-5, every population row
  against the JAX run's rows (masks, counters, cycles exactly; scores
  within 1e-5).
* the sampled run drew more than one cohort and left the rows of the
  clients it did not draw bit for bit as they were; ``sync_client_states``
  after 2 rounds puts stragglers at cycle 2 and capable clients at 0.
* afo ``run_async(16)`` on the inherited bucket engine, and the elastic
  join / leave sequence at 3 clients a round: events, history, params
  and rows against JAX's.
* ``init_population`` rows equal ``init_state``'s, key paths included;
  gather / scatter round trips in place; a foreign key path is refused.
* the MoE family is refused with the batched engines' message; the
  ``population_scale`` driver runs on the CPU at reduced LeNet and draws
  the JAX engine's cohorts.
"""
import contextlib
import io
import os

import jax
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.data.federated import partition_by_topic  # noqa: E402
from repro.data.federated import partition_iid_lazy  # noqa: E402
from repro.data.synthetic import markov_topic_tokens  # noqa: E402
from repro.federated import TABLE_I as J_TABLE_I  # noqa: E402
from repro.federated import ShardedFLRun as JaxShardedFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.core import keys as KY  # noqa: E402
from repro_torch.core import soft_train as tST  # noqa: E402
from repro_torch.data.federated import partition_noniid  # noqa: E402
from repro_torch.data.synthetic import class_gaussian_images  # noqa: E402
from repro_torch.drivers import population_scale as PS  # noqa: E402
from repro_torch.federated import (TABLE_I, ShardedFLRun,  # noqa: E402
                                   make_fleet, setup_clients)
from repro_torch.models import build  # noqa: E402
from test_torch_keys import jax_keys  # noqa: E402

ATOL = 1e-5
RUN_KW = dict(local_steps=2, lr=0.1, seed=0, eval_batch=64)
#: case -> (scheme, HeliosConfig overrides, run kwargs, rounds, LM)
SYNC = {
    "helios": ("helios", {}, {}, 3, False),
    "syn": ("syn", {}, {}, 3, False),
    "st_only": ("st_only", {}, {}, 3, False),
    "masked_mean": ("helios", {"aggregation": "masked_mean"}, {}, 2, False),
    "scaffold": ("scaffold", {}, {}, 2, False),
    "delayed": ("delayed", {}, {}, 2, False),
    "topk": ("helios", {}, {"compression": "topk"}, 2, False),
    "lm": ("helios", {}, {}, 2, True),
    "sampled": ("helios", {}, {"participation": 2}, 5, False),
}


@pytest.fixture(scope="module")
def settings():
    cfg = TC.reduced(TC.LENET)
    imgs, labels = class_gaussian_images(1200, cfg.image_size,
                                         cfg.in_channels, cfg.num_classes,
                                         seed=0)
    ti, tl = class_gaussian_images(256, cfg.image_size, cfg.in_channels,
                                   cfg.num_classes, seed=9)
    cnn = ({"images": imgs, "labels": labels}, {"images": ti, "labels": tl},
           partition_noniid(labels, 4, shards_per_client=4))
    tokens, topics = markov_topic_tokens(240, 32, 64, n_topics=8, seed=0)
    test_tokens, _ = markov_topic_tokens(64, 32, 64, n_topics=8, seed=9)
    lm = ({"tokens": tokens}, {"tokens": test_tokens},
          partition_by_topic(topics, 4, topics_per_client=2))
    return {False: cnn, True: lm}


def _pair(setting, scheme, hkw, lm, **kw):
    """The JAX engine and the port's on the same fleet and initial params
    (the caller holds the JAX key backend)."""
    train, test, parts = setting
    jcfg = JC.reduced(JC.ARCHS["deepseek-7b"] if lm else JC.CNNS["lenet"])
    tcfg = TC.reduced(TC.ARCHS["deepseek-7b"] if lm else TC.LENET)
    jh, th = JC.HeliosConfig(**hkw), TC.HeliosConfig(**hkw)
    kw = dict(RUN_KW, batch_size=4 if lm else 32, **kw)
    jrun = JaxShardedFLRun(jcfg, jh, scheme,
                           j_setup_clients(j_make_fleet(2, 2), parts, jh),
                           train, test, **kw)
    init = jax.tree.map(np.asarray, jax.device_get(jrun.global_params))
    trun = ShardedFLRun(tcfg, th, scheme,
                        setup_clients(make_fleet(2, 2), parts, th,
                                      device="cpu"),
                        train, test, device="cpu", init_params=init, **kw)
    return jrun, trun


def _rows(run, i) -> dict:
    """Client ``i``'s population row as numpy leaves (either package)."""
    st = run.client_state(i)
    out = {f"{part}/{k}": np.asarray(v) for part in
           ("masks", "scores", "skip_counts") for k, v in st[part].items()}
    out["volume"] = np.float32(st["volume"])
    out["cycle"] = int(st["cycle"])
    return out


@pytest.fixture(scope="module")
def sync_runs(settings):
    out = {}
    for case, (scheme, hkw, kw, rounds, lm) in SYNC.items():
        with jax_keys():
            jrun, trun = _pair(settings[lm], scheme, hkw, lm, **kw)
            if case == "sampled":
                # a round at a time, each client's row read after each
                before = [_rows(trun, i) for i in range(4)]
                untouched = []
                for _ in range(rounds):
                    jrun.run_sync(1)
                    trun.run_sync(1)
                    after = [_rows(trun, i) for i in range(4)]
                    untouched += [(b, a) for i, (b, a) in
                                  enumerate(zip(before, after))
                                  if i not in trun.cohort_log[-1]]
                    before = after
                trun.untouched = untouched
            else:
                jrun.run_sync(rounds)
                trun.run_sync(rounds)
        out[case] = jrun, trun
    return out


def _tree_close(got, want, what):
    if isinstance(want, dict):
        for k in want:
            _tree_close(got[k], want[k], f"{what}/{k}")
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=what)


@pytest.mark.parametrize("case", list(SYNC))
def test_run_sync_matches_jax(sync_runs, case):
    jrun, trun = sync_runs[case]
    assert trun.cohort_log == jrun.cohort_log
    assert len(trun.history) == len(jrun.history) > 0
    metric = trun.adapter.metric_name
    for t, j in zip(trun.history, jrun.history):
        assert t["cycle"] == j["cycle"] and abs(t["time"] - j["time"]) <= 1e-9
        for k in ("ratios", "volumes"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-6)
        assert abs(t[metric] - j[metric]) <= ATOL
        assert abs(t["loss"] - j["loss"]) <= ATOL
    _tree_close(trun.global_params, jax.device_get(jrun.global_params),
                "params")
    for i in range(len(trun.clients)):
        got, want = _rows(trun, i), _rows(jrun, i)
        for k, v in want.items():
            atol = ATOL if k.startswith("scores") else 0
            np.testing.assert_allclose(got[k], v, rtol=0, atol=atol,
                                       err_msg=f"client {i} {k}")
    if trun._scheme.uses_control:
        _tree_close(trun._c_global, jax.device_get(jrun._c_global), "c")
    assert trun.uplink_updates == jrun.uplink_updates
    if trun.compression != "none":
        assert sorted(trun._err_store._rows) == sorted(jrun._err_store._rows)
        assert abs(trun.uplink_bytes() - jrun.uplink_bytes()) < \
            1e-3 * jrun.uplink_bytes()


def test_cases_exercise_what_they_name(sync_runs):
    """Stragglers train sub-models (ratio < 1) and capable clients do not;
    the sampled run drew more than one cohort and left undrawn rows bit
    for bit as they were; after 2 rounds ``sync_client_states`` puts the
    stragglers at cycle 2 and the capable clients at 0."""
    for case in ("helios", "st_only", "masked_mean", "topk", "lm"):
        trun = sync_runs[case][1]
        for c, r in zip(trun.clients, trun.history[-1]["ratios"]):
            assert (r < 1.0) == c.is_straggler, case
    samp = sync_runs["sampled"][1]
    assert len({tuple(c) for c in samp.cohort_log}) > 1
    assert samp.untouched and all(len(c) == 2 for c in samp.cohort_log)
    for before, after in samp.untouched:
        for k, v in before.items():
            np.testing.assert_array_equal(after[k], v, err_msg=k)
    mm = sync_runs["masked_mean"][1]
    assert all(c.helios_state is None for c in mm.clients)
    mm.sync_client_states()
    for c in mm.clients:
        assert c.helios_state["cycle"] == (2 if c.is_straggler else 0)
        if c.is_straggler:
            assert min(float(m.mean()) for m in
                       c.helios_state["masks"].values()) < 0.9
            assert c.helios_state["rng"] == KY.key(c.cid).split()[0] \
                .split()[0]
        else:
            assert c.helios_state["rng"] == KY.key(c.cid)
    assert sync_runs["syn"][1]._kpad == 4 and sync_runs["sampled"][1]._kpad \
        == 2


def test_bucketed_async_matches_jax(settings):
    """afo on the inherited bucket engine: same events, history and
    params as JAX's ``ShardedFLRun.run_async(16)``."""
    with jax_keys():
        jrun, trun = _pair(settings[False], "afo", {}, False)
        jh = jrun.run_async(16, eval_every=4)
        th = trun.run_async(16, eval_every=4)
    assert trun.events_processed == jrun.events_processed
    assert trun.bucket_sizes == jrun.bucket_sizes
    assert len(th) == len(jh) > 0
    for t, j in zip(th, jh):
        for k in ("cycle", "time", "bucket", "record_cadence"):
            assert t[k] == j[k], k
        assert abs(t["acc"] - j["acc"]) <= ATOL
    _tree_close(trun.global_params, jax.device_get(jrun.global_params),
                "params")


def test_elastic_join_leave_matches_jax(settings):
    """``examples/elastic_scaling.py``'s sequence at 3 clients a round
    (rounds, a DeepLens straggler joins, rounds, it leaves, a round): the
    rows are materialized and restacked at each change, as in the
    reference."""
    train, test, _ = settings[False]
    parts = partition_noniid(train["labels"], 6, shards_per_client=4)
    with jax_keys():
        jrun, trun = _pair((train, test, parts[:4]), "helios", {}, False,
                           participation=3, local_steps=1)
        for run, table in ((jrun, J_TABLE_I), (trun, TABLE_I)):
            run.run_sync(2)
            new = run.add_client(table[3], parts[4])
            run.run_sync(2)
            run.remove_client(new.cid)
            run.run_sync(1)
    assert trun.cohort_log == jrun.cohort_log
    assert [len(h["volumes"]) for h in trun.history] == [4, 4, 5, 5, 4]
    for t, j in zip(trun.history, jrun.history):
        assert t["volumes"] == j["volumes"] and t["time"] == j["time"]
    _tree_close(trun.global_params, jax.device_get(jrun.global_params),
                "params")
    for i in range(4):
        got, want = _rows(trun, i), _rows(jrun, i)
        for k, v in want.items():
            atol = ATOL if k.startswith("scores") else 0
            np.testing.assert_allclose(got[k], v, rtol=0, atol=atol,
                                       err_msg=f"client {i} {k}")


def test_population_rows_equal_init_state():
    schema = build(TC.reduced(TC.LENET)).mask_schema
    vols, seeds = [1.0, 0.5, 0.25], [7, 0, 12]
    pop = tST.init_population(schema, vols, seeds)
    assert all(v.flags.writeable for part in ("masks", "scores",
                                              "skip_counts")
               for v in pop[part].values())
    for i, (v, s) in enumerate(zip(vols, seeds)):
        row = tST.unstack_states(tST.gather_states_host(pop, [i], "cpu"),
                                 1)[0]
        want = tST.init_state(schema, volume=v, seed=s, device="cpu")
        assert row["rng"] == want["rng"] and row["cycle"] == want["cycle"]
        assert row["volume"] == want["volume"] and \
            row["volume"].dtype == np.float32
        for part in ("masks", "scores", "skip_counts"):
            for k, x in want[part].items():
                assert row[part][k].dtype == x.dtype
                assert torch.equal(row[part][k], x), (part, k)
    # a cycle later the row keeps its key as seed + splits, in place
    st = tST.begin_cycle(row, TC.HeliosConfig())
    st = tST.end_cycle(st, st["scores"], TC.HeliosConfig())
    tST.scatter_states_host(pop, [2], tST.stack_states([st]))
    back = tST.unstack_states(tST.gather_states_host(pop, [2], "cpu"), 1)[0]
    assert back["rng"] == KY.key(12).split()[0] and back["cycle"] == 1
    assert pop["rng"]["splits"].tolist() == [0, 0, 1]
    for k, m in st["masks"].items():
        assert torch.equal(back["masks"][k], m)
        np.testing.assert_array_equal(pop["masks"][k][2], m.numpy())
    with pytest.raises(ValueError, match="key path"):
        tST.key_row(KY.key(3).split()[1])
    assert tST.population_nbytes(pop) == 3 * (12 * 212 + 4 + 8 + 16)


def test_moe_family_is_refused():
    cfg = TC.reduced(TC.ARCHS["granite-moe-1b-a400m"])
    hcfg = TC.HeliosConfig()
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 19"):
        ShardedFLRun(cfg, hcfg, "helios",
                     setup_clients(make_fleet(1, 1), [np.arange(8)] * 2,
                                   hcfg, device="cpu"),
                     {"tokens": np.zeros((8, 16), np.int32)},
                     {"tokens": np.zeros((2, 16), np.int32)}, device="cpu")


def test_population_scale_driver_on_the_cpu():
    """The driver at reduced LeNet, 64 clients, 8 a round: it prints its
    readings and draws the cohorts JAX's engine draws (the cohort stream
    is the reference's)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = PS.population_scale(population=64, participation=8,
                                  rounds=2, device="cpu")
    text = buf.getvalue()
    assert "rounds/s" in text and "set-up" in text and \
        "distinct cohorts: 3 of 3 rounds" in text, text
    run = got["run"]
    assert run._kpad == 8 and got["setup_s"] > 0 and 0 <= got["acc"] <= 1
    assert all(np.isfinite(v.numpy()).all()
               for v in run.global_params.values())
    cfg = JC.reduced(JC.CNNS["lenet"])
    hcfg = JC.HeliosConfig()
    labels = np.zeros(8192, np.int32)
    jrun = JaxShardedFLRun(
        cfg, hcfg, "helios",
        j_setup_clients(j_make_fleet(32, 32),
                        partition_iid_lazy(len(labels), 64, seed=0), hcfg),
        {"images": np.zeros((8192, 16, 16, 1), np.float32),
         "labels": labels}, {"images": np.zeros((1, 16, 16, 1), np.float32),
                             "labels": labels[:1]},
        participation=8)
    assert [jrun._draw_cohort() for _ in range(3)] == run.cohort_log
