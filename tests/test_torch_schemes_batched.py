"""Port parity for the gauntlet's last three schemes on the batched engine,
and for the scheme-gauntlet driver.

* ``BatchedFLRun.run_sync(2)`` of scaffold, fluid and delayed on reduced
  AlexNet (tests/test_torch_schemes.py's setting) against the JAX
  package's ``BatchedFLRun``: identical history and straggler masks,
  acc / loss / params within atol 1e-5, SCAFFOLD's controls within
  1e-5 / (K * lr), equal uplink bytes.  The batched engines fold
  SCAFFOLD's control as ``c += sum(dc) / N`` and give a delayed capable
  row ``g + 1 * (y - g)``, where the sequential ones fold dc by dc and
  keep ``y``: each port engine is held against its own JAX engine.
* 3 of a 3 + 3 fleet a round under SCAFFOLD: identical ``cohort_log``,
  control rows gathered and scattered by cid.
* ``repro_torch.drivers.scheme_gauntlet`` at 2 rounds on unreduced LeNet,
  4 + 4 non-IID, against ``benchmarks/run.py``'s ``table_scheme_gauntlet``
  (from JAX's initial params, Eq. 2 draws through the JAX key backend):
  the same keys and engines, ``sim_time``, ``uplink_mb``, ``downlink_mb``
  and the trajectory's times exactly, final accuracy within 2/512 (one
  test image in 512 either way and a margin), Prop. 2 numbers within
  1e-4 relative.
"""
import importlib.util
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.federated import BatchedFLRun as JaxBatchedFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.data.federated import partition_noniid  # noqa: E402
from repro_torch.data.synthetic import class_gaussian_images  # noqa: E402
from repro_torch.drivers.scheme_gauntlet import scheme_gauntlet  # noqa: E402
from repro_torch.federated import (BatchedFLRun, make_fleet,  # noqa: E402
                                   setup_clients)
from repro_torch.kernels import masked_matmul as tK  # noqa: E402
from test_torch_keys import jax_keys  # noqa: E402
from test_torch_schemes import (ATOL, RUN_KW, assert_controls,  # noqa: E402
                                assert_history, assert_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: case -> (scheme, fleet, run kwargs)
SYNC = {"scaffold": ("scaffold", (2, 2), {}),
        "fluid": ("fluid", (2, 2), {}),
        "delayed": ("delayed", (2, 2), {}),
        "scaffold-sampled": ("scaffold", (3, 3), {"participation": 3})}


def _data(n_clients):
    imgs, labels = class_gaussian_images(256, 16, 3, 10, seed=0)
    ti, tl = class_gaussian_images(64, 16, 3, 10, seed=9)
    parts = partition_noniid(labels, n_clients, shards_per_client=4)
    return {"images": imgs, "labels": labels}, {"images": ti, "labels": tl}, \
        parts


@pytest.fixture(scope="module")
def sync_runs():
    out = {}
    for case, (scheme, fleet, kw) in SYNC.items():
        train, test, parts = _data(sum(fleet))
        jh = JC.HeliosConfig(mask_block=128)
        th = TC.HeliosConfig(mask_block=128)
        with jax_keys():
            jrun = JaxBatchedFLRun(
                JC.reduced(JC.CNNS["alexnet"]), jh, scheme,
                j_setup_clients(j_make_fleet(*fleet), parts, jh), train,
                test, kernels="reference", **dict(RUN_KW, **kw))
            init = {k: np.asarray(v)
                    for k, v in jax.device_get(jrun.global_params).items()}
            trun = BatchedFLRun(
                TC.reduced(TC.ALEXNET), th, scheme,
                setup_clients(make_fleet(*fleet), parts, th, device="cpu"),
                train, test, kernels="cuda", device="cpu", init_params=init,
                **dict(RUN_KW, **kw))
            jrun.run_sync(2)
            trun.run_sync(2)
        out[case] = jrun, trun
    return out


@pytest.mark.parametrize("case", list(SYNC))
def test_run_sync_matches_jax(sync_runs, case):
    jrun, trun = sync_runs[case]
    assert_history(jrun, trun, ("cycle", "time", "volumes", "ratios"))
    assert_params(jrun.global_params, trun.global_params)
    assert trun.cohort_log == jrun.cohort_log
    for jc, tc in zip(jrun.clients, trun.clients):
        assert jc.is_straggler == tc.is_straggler and jc.volume == tc.volume
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=k)
    for name in ("uplink_updates", "uplink_extra_updates",
                 "downlink_updates"):
        assert getattr(trun, name) == getattr(jrun, name), name
    assert trun.uplink_bytes() == jrun.uplink_bytes()


@pytest.mark.parametrize("case", ["scaffold", "scaffold-sampled"])
def test_scaffold_controls_match_jax(sync_runs, case):
    jrun, trun = sync_runs[case]
    assert_controls(jrun, trun)
    if case == "scaffold-sampled":
        drawn = {cid for cohort in trun.cohort_log for cid in cohort}
        assert all(len(c) == 3 for c in trun.cohort_log)
        assert set(trun._ctrl_store._rows) == drawn


def test_cohorts_are_what_the_schemes_need(sync_runs):
    """scaffold and delayed train one full-model cohort of 4; fluid has a
    soft-training straggler cohort; no kernel launched on the CPU."""
    for case in ("scaffold", "delayed"):
        trun = sync_runs[case][1]
        assert trun._sstate is None and trun._c_idx == [0, 1, 2, 3]
    fl = sync_runs["fluid"][1]
    assert fl._s_idx == [2, 3] and fl._c_idx == [0, 1]
    for c, r in zip(fl.clients, fl.history[-1]["ratios"]):
        assert (r < 1.0) == c.is_straggler
    assert tK.CLIENT_LAUNCHES == {"masked_matmul": 0, "masked_matmul_dk": 0}


def _jax_gauntlet(rounds, out_path):
    spec = importlib.util.spec_from_file_location(
        "benchmarks_run", os.path.join(ROOT, "benchmarks", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.table_scheme_gauntlet(rounds=rounds, out_path=out_path)
    with open(out_path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def gauntlets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gauntlet")
    want = _jax_gauntlet(2, str(tmp / "jax.json"))
    init = {k: np.asarray(v) for k, v in jax.device_get(
        j_init_params(jax.random.PRNGKey(0), JC.CNNS["lenet"])).items()}
    with jax_keys():
        got, runs, walls = scheme_gauntlet(
            rounds=2, out_path=str(tmp / "port.json"), device="cpu",
            kernels="cuda", init_params=init)
    with open(tmp / "port.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    return want, got, runs, walls


def test_gauntlet_matches_jax_table(gauntlets):
    want, got, runs, walls = gauntlets
    assert set(got) == set(want)
    for k in ("model", "rounds", "fleet", "partition", "seed",
              "local_steps", "lr", "note"):
        assert got[k] == want[k], k
    assert list(got["schemes"]) == list(want["schemes"]) == list(runs) == \
        list(walls)
    for name, w in want["schemes"].items():
        g = got["schemes"][name]
        assert set(g) == set(w), name
        for k in ("engine", "sim_time", "uplink_mb", "downlink_mb"):
            assert g[k] == w[k], (name, k, g[k], w[k])
        assert [(t["time"], t["downlink_mb"]) for t in g["trajectory"]] == \
            [(t["time"], t["downlink_mb"]) for t in w["trajectory"]], name
        assert abs(g["final_acc"] - w["final_acc"]) <= 2 / 512, name
        if "prop2" in w:
            assert set(g["prop2"]) == set(w["prop2"]), name
            for k, v in w["prop2"].items():
                if isinstance(v, (bool, int)):
                    assert g["prop2"][k] == v, (name, k)
                else:
                    assert abs(g["prop2"][k] - v) <= 1e-4 * max(abs(v), 1e-6), \
                        (name, k, g["prop2"][k], v)
            assert g["prop2"]["eq9_holds"]


def test_gauntlet_scaffold_pays_twice_the_uplink(gauntlets):
    got = gauntlets[1]["schemes"]
    assert got["scaffold"]["uplink_mb"] == 2 * got["helios"]["uplink_mb"]
    assert got["delayed"]["sim_time"] < got["syn"]["sim_time"]
    for scheme, run in gauntlets[2].items():
        assert all(bool(torch.isfinite(v).all())
                   for v in run.global_params.values()), scheme


def test_heterogeneous_fl_table_on_both_engines(capsys):
    """The five-scheme table on reduced LeNet: every scheme on the
    sequential and the batched engine with the same simulated clocks
    (helios's cycles 2.9x shorter than syn's on the Table-I 2 + 2 fleet),
    finite losses; population mode times syn and helios."""
    from repro_torch.drivers.heterogeneous_fl import (TABLE_SCHEMES,
                                                      heterogeneous_fl)
    cfg = TC.reduced(TC.LENET)
    out = {engine: heterogeneous_fl(cfg, rounds=2, engine=engine,
                                    device="cpu")
           for engine in ("sequential", "batched")}
    for engine, res in out.items():
        assert tuple(res) == TABLE_SCHEMES
        assert all(np.isfinite(r["loss"]) for h in res.values() for r in h)
        assert [r["record_cadence"] for r in res["asyn"]] == \
            ["event" if engine == "sequential" else "bucket"] * \
            len(res["asyn"])
    for scheme in ("syn", "random", "helios"):
        assert [r["time"] for r in out["sequential"][scheme]] == \
            [r["time"] for r in out["batched"][scheme]]
    assert "Helios cycle speedup vs Syn FL: 2.90x" in capsys.readouterr().out
    pop = heterogeneous_fl(cfg, rounds=1, engine="batched", clients=6,
                           device="cpu")
    assert set(pop) == {"syn", "helios"}
    assert all(0.0 <= v[0]["acc"] <= 1.0 and v[0]["wall_s"] > 0
               for v in pop.values())
