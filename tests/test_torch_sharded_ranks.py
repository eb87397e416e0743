"""The population engine across ranks: the port's ``ShardedFLRun`` over a
gloo clients group of 2 and of 4 CPU processes against its world-1 run
and JAX's ``ShardedFLRun`` on its single-device mesh.

Reduced LeNet on the reference's setting (``tests/test_sharded_engine.py``:
a 2 + 2 non-IID fleet, 2 local steps of batch 32, lr 0.1, seed 0), all
runs from the JAX run's initial params and on the JAX key-path backend.
World 2 samples 3 clients a round (kpad 4: one padding slot), and once 1
client a round (the clients group caps its training ranks at 1: rank 1
trains nothing and still receives every row); world 4 runs all 4 clients,
one slot a rank.  helios, ``masked_mean`` and ``topk`` each, 3 rounds:

* every rank's params, history, cohorts, host population rows and error
  rows are equal bit for bit;
* rank 0's params are within 1e-5 of the world-1 run's and of JAX's,
  history (cycle, time, ratios, volumes) within 1e-6 and acc / loss
  within 1e-5; the population rows equal the world-1 run's (scores
  within 1e-5).

Under ``topk`` an ulp decides: the ranks train blocks of 2 or 1 slots
where world 1 trains 3 or 4, so their products round differently, and a
coordinate within an ulp of a row's top-k threshold is sent by one run and
kept by the other (the codec tests' near-ties).  Those cases hold params
and error rows at max(1e-5, twice the drift of a world-1 twin whose
initial params are nudged by 2^-23), as ``chip_smoke.py`` does where an
ulp decides.  Error rows are held bit for bit across ranks; against
world 1 they are held through the params (an error row is sent in the
client's next update), not coordinate by coordinate: a coordinate an ulp
from a top-k threshold or from an f16 rounding midpoint moves its row's
entry by a whole coordinate or an f16 ulp.

The ranks run ``tests/sharded_ranks_child.py`` in subprocesses on
``tcp://127.0.0.1`` at a free port, each under its own time limit.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.federated import ShardedFLRun as JaxShardedFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.data.federated import partition_noniid  # noqa: E402
from repro_torch.data.synthetic import class_gaussian_images  # noqa: E402
from repro_torch.federated import (ShardedFLRun, make_fleet,  # noqa: E402
                                   setup_clients)
from test_torch_keys import jax_keys  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
RUN_KW = dict(local_steps=2, batch_size=32, lr=0.1, seed=0, eval_batch=64)
#: case -> (HeliosConfig overrides, run kwargs, rounds)
CASES = {
    "helios-p3": ({}, {"participation": 3}, 3),
    "masked_mean-p3": ({"aggregation": "masked_mean"}, {"participation": 3},
                       3),
    "topk-p3": ({}, {"participation": 3, "compression": "topk"}, 3),
    "helios-p1": ({}, {"participation": 1}, 3),
    "helios": ({}, {}, 3),
    "masked_mean": ({"aggregation": "masked_mean"}, {}, 3),
    "topk": ({}, {"compression": "topk"}, 3),
}
#: world size -> the cases its ranks run
WORLDS = {2: ("helios-p3", "masked_mean-p3", "topk-p3", "helios-p1"),
          4: ("helios", "masked_mean", "topk")}
CHILD_TIMEOUT = 300


def _data():
    cfg = TC.reduced(TC.LENET)
    imgs, labels = class_gaussian_images(1200, cfg.image_size,
                                         cfg.in_channels, cfg.num_classes,
                                         seed=0)
    ti, tl = class_gaussian_images(256, cfg.image_size, cfg.in_channels,
                                   cfg.num_classes, seed=9)
    parts = partition_noniid(labels, 4, shards_per_client=4)
    return {"images": imgs, "labels": labels}, {"images": ti, "labels": tl}, \
        parts


def make_port_run(case: str, init, group=None):
    """The port's run of ``case`` on the CPU from ``init`` (the caller
    holds the JAX key backend)."""
    hkw, kw, _ = CASES[case]
    train, test, parts = _data()
    hcfg = TC.HeliosConfig(**hkw)
    return ShardedFLRun(TC.reduced(TC.LENET), hcfg, "helios",
                        setup_clients(make_fleet(2, 2), parts, hcfg,
                                      device="cpu"),
                        train, test, device="cpu", init_params=init,
                        group=group, **RUN_KW, **kw)


def _jax_run(case: str):
    hkw, kw, _ = CASES[case]
    train, test, parts = _data()
    hcfg = JC.HeliosConfig(**hkw)
    return JaxShardedFLRun(JC.reduced(JC.CNNS["lenet"]), hcfg, "helios",
                           j_setup_clients(j_make_fleet(2, 2), parts, hcfg),
                           train, test, **RUN_KW, **kw)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, out: Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "sharded_ranks_child.py"),
         str(r), str(world), str(port), str(out), ",".join(WORLDS[world])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _wait(procs: list) -> None:
    try:
        logs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(world, case): [per-rank results]}, plus world 1 and JAX runs."""
    out = tmp_path_factory.mktemp("ranks")
    with jax_keys():
        jax_runs = {case: _jax_run(case) for case in CASES}
    init = {k: np.asarray(v) for k, v in
            jax.device_get(jax_runs["helios"].global_params).items()}
    np.savez(out / "init.npz", **init)
    procs = {w: _spawn(w, out) for w in WORLDS}
    try:
        one, tols = {}, {}
        nudged = {k: v * np.float32(1 + 2.0 ** -23) for k, v in init.items()}
        with jax_keys():
            for case, jrun in jax_runs.items():
                jrun.run_sync(CASES[case][2])
                one[case] = make_port_run(case, init)
                one[case].run_sync(CASES[case][2])
                tols[case] = ATOL
                if "topk" in case:
                    twin = make_port_run(case, nudged)
                    twin.run_sync(CASES[case][2])
                    tols[case] = max(ATOL, 2 * _drift(one[case], twin))
    finally:
        for w in WORLDS:
            _wait(procs[w])
    ranks = {(w, case): [torch.load(out / f"{w}_{r}_{case}.pt",
                                    weights_only=False) for r in range(w)]
             for w, cases in WORLDS.items() for case in cases}
    return ranks, one, jax_runs, tols


def _drift(a, b) -> float:
    """Max |diff| of two runs' params and error rows."""
    d = [float((v - b.global_params[k]).abs().max())
         for k, v in a.global_params.items()]
    for c in a.clients:
        d += [float((v - b._err_store.row(c.cid)[k]).abs().max())
              for k, v in a._err_store.row(c.cid).items()]
    return max(d)


def _assert_equal(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_equal(a[k], b[k], f"{what}/{k}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


CASE_IDS = [(w, c) for w, cases in WORLDS.items() for c in cases]


@pytest.mark.parametrize("world,case", CASE_IDS,
                         ids=[f"world{w}-{c}" for w, c in CASE_IDS])
def test_ranks_match_world_one_and_jax(runs, world, case):
    ranks, one, jax_runs, tols = runs
    got, ref, jrun = ranks[(world, case)][0], one[case], jax_runs[case]
    tol = tols[case]
    assert got["cohorts"] == ref.cohort_log == jrun.cohort_log
    for k, v in jrun.global_params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), np.asarray(v),
                                   rtol=0, atol=tol, err_msg=k)
        np.testing.assert_allclose(got["params"][k].numpy(),
                                   ref.global_params[k].numpy(), rtol=0,
                                   atol=tol, err_msg=k)
    assert len(got["history"]) == len(jrun.history) == CASES[case][2]
    for h, r, j in zip(got["history"], ref.history, jrun.history):
        for key in ("cycle", "time"):
            assert h[key] == r[key] and abs(h[key] - j[key]) <= 1e-9, key
        for key in ("ratios", "volumes"):
            np.testing.assert_allclose(h[key], j[key], rtol=0, atol=1e-6)
            np.testing.assert_allclose(h[key], r[key], rtol=0, atol=1e-6)
        for key in ("acc", "loss"):
            assert abs(h[key] - j[key]) <= ATOL, (key, h[key], j[key])
    # the population rows: masks and counters exactly, scores to 1e-5
    for part, rows in got["pop"].items():
        flat = rows if isinstance(rows, dict) else {"": rows}
        want = ref._pop_state[part]
        want = want if isinstance(want, dict) else {"": want}
        for k, v in flat.items():
            atol = ATOL if part == "scores" else 0
            np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=atol,
                                       err_msg=f"{part}/{k}")
    # the error rows: a row for every client that trained under the codec
    if "topk" not in case:
        assert not got["err"]
    else:
        assert sorted(got["err"]) == sorted(ref._err_store._rows)
        assert all(float(v.abs().sum()) > 0 for row in got["err"].values()
                   for v in row.values())


@pytest.mark.parametrize("world", list(WORLDS))
def test_every_rank_holds_the_same_state(runs, world):
    ranks = runs[0]
    for case in WORLDS[world]:
        first, *rest = ranks[(world, case)]
        for r, other in enumerate(rest, 1):
            for key in ("params", "pop", "err", "cohorts", "history",
                        "shards", "kpad"):
                _assert_equal(first[key], other[key],
                              f"world {world} rank {r} {case} {key}")


def test_training_ranks_follow_the_cohort(runs):
    """world 2 at 3 clients a round: two training ranks over 4 slots (one
    padding slot); at 1 client a round one training rank (rank 1 trains
    nothing); world 4: four ranks of one slot each."""
    ranks = runs[0]
    assert [(r["shards"], r["kpad"]) for r in ranks[(2, "helios-p3")]] == \
        [(2, 4)] * 2
    assert [(r["shards"], r["kpad"]) for r in ranks[(2, "helios-p1")]] == \
        [(1, 1)] * 2
    assert [(r["shards"], r["kpad"]) for r in ranks[(4, "helios")]] == \
        [(4, 4)] * 4
