"""Port parity for partial participation and elastic membership.

* ``run_sync(3)`` with ``participation=3`` of a 3 capable + 3 Table-I
  straggler fleet on reduced AlexNet (``mask_block=128``), helios, for the
  ``uniform`` and the ``time_weighted`` sampler, one local step of batch 8
  a cycle, against the JAX package's ``FLRun``: identical cohort log,
  history and straggler masks, params within atol 1e-5.  The JAX side
  runs ``kernels="pallas"`` (interpret mode) for ``uniform`` and
  ``"reference"`` for ``time_weighted``; the port runs ``kernels="cuda"``
  on its CPU plain bodies.  One local step, because at two the
  ``time_weighted`` trajectory forks: the JAX package alone, with its
  initial weights moved by one ulp at random, ends 1.4e-3 away from its
  own unmoved run for two of three noise seeds, on the branch the port
  takes (the same final loss to the last digit).  Given the same inputs,
  every one of the nine client cycles of the port matches the reference
  within 3e-8.
* Full participation draws nothing from the cohort stream.
* The join / leave sequence of ``examples/elastic_scaling.py`` (rounds, a
  DeepLens straggler joins, rounds, it leaves, a round) on reduced LeNet,
  with white-box and with time-based identification: identical
  identification, assigned volume, history and params.
"""
import os

import jax
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.federated import FLRun as JaxFLRun  # noqa: E402
from repro.federated import TABLE_I as J_TABLE_I  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.data.federated import partition_noniid  # noqa: E402
from repro_torch.data.synthetic import class_gaussian_images  # noqa: E402
from repro_torch.federated import (SCHEMES, TABLE_I, FLRun,  # noqa: E402
                                   make_fleet, make_scheme, setup_clients)
from test_torch_keys import jax_keys, share_jax_programs  # noqa: E402

ATOL = 1e-5
RUN_KW = dict(local_steps=2, batch_size=8, lr=0.05, seed=0, eval_batch=64)
SAMPLERS = {"uniform": "pallas", "time_weighted": "reference"}


def _data(channels, n_clients):
    imgs, labels = class_gaussian_images(256, 16, channels, 10, seed=0)
    ti, tl = class_gaussian_images(64, 16, channels, 10, seed=9)
    parts = partition_noniid(labels, n_clients, shards_per_client=4)
    return {"images": imgs, "labels": labels}, {"images": ti, "labels": tl}, \
        parts


def _assert_same(jrun, trun):
    assert len(trun.history) == len(jrun.history)
    for j, t in zip(jrun.history, trun.history):
        for k in ("scheme", "cycle", "time", "volumes", "ratios",
                  "downlink_mb"):
            assert t[k] == j[k], (k, t[k], j[k])
        assert abs(t["acc"] - j["acc"]) <= ATOL
        assert abs(t["loss"] - j["loss"]) <= ATOL
    for k, v in jrun.global_params.items():
        np.testing.assert_allclose(trun.global_params[k].numpy(),
                                   np.asarray(v), rtol=0, atol=ATOL,
                                   err_msg=k)
    assert [c.cid for c in trun.clients] == [c.cid for c in jrun.clients]
    for jc, tc in zip(jrun.clients, trun.clients):
        assert jc.is_straggler == tc.is_straggler and jc.volume == tc.volume
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=k)


@pytest.fixture(scope="module")
def cohort_runs():
    train, test, parts = _data(3, 6)
    jcfg, tcfg = JC.reduced(JC.CNNS["alexnet"]), TC.reduced(TC.ALEXNET)
    jh, th = JC.HeliosConfig(mask_block=128), TC.HeliosConfig(mask_block=128)
    out = {}
    for sampler, jkernels in SAMPLERS.items():
        kw = dict(RUN_KW, participation=3, sampler=sampler, local_steps=1)
        jrun = JaxFLRun(jcfg, jh, "helios",
                        j_setup_clients(j_make_fleet(3, 3), parts, jh),
                        train, test, kernels=jkernels, **kw)
        share_jax_programs(jrun)
        init = {k: np.asarray(v)
                for k, v in jax.device_get(jrun.global_params).items()}
        jrun.run_sync(3)
        with jax_keys():
            trun = FLRun(tcfg, th, "helios",
                         setup_clients(make_fleet(3, 3), parts, th,
                                       device="cpu"),
                         train, test, kernels="cuda", device="cpu",
                         init_params=init, **kw)
            trun.run_sync(3)
        out[sampler] = jrun, trun
    return out


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_sampled_cohorts_match_jax(cohort_runs, sampler):
    jrun, trun = cohort_runs[sampler]
    assert trun.cohort_log == jrun.cohort_log
    assert all(len(c) == 3 and c == sorted(set(c)) for c in trun.cohort_log)
    assert trun.round == jrun.round == 3
    assert trun.downlink_updates == jrun.downlink_updates == 9
    assert trun.uplink_updates == jrun.uplink_updates == 9
    _assert_same(jrun, trun)


def test_unsampled_clients_keep_their_state(cohort_runs):
    """A straggler outside every cohort kept its initial Helios state;
    a sampled one advanced its cycle counter once per cohort it was in."""
    for _, trun in cohort_runs.values():
        for i, c in enumerate(trun.clients):
            if not c.is_straggler:
                continue
            times = sum(i in cohort for cohort in trun.cohort_log)
            assert c.helios_state["cycle"] == times


@pytest.mark.parametrize("participation", [0, 4, 9])
def test_full_participation_draws_nothing(participation):
    train, test, parts = _data(1, 4)
    cfg, h = TC.reduced(TC.LENET), TC.HeliosConfig()
    run = FLRun(cfg, h, "syn", setup_clients(make_fleet(2, 2), parts, h,
                                             device="cpu"),
                train, test, device="cpu", participation=participation,
                sampler="time_weighted", **dict(RUN_KW, local_steps=1))
    before = run.sample_rng.bit_generator.state
    run.run_sync(2, eval_every=0)
    assert run.sample_rng.bit_generator.state == before
    assert run.cohort_log == [[0, 1, 2, 3]] * 2


def test_unknown_sampler_raises():
    train, test, parts = _data(1, 4)
    cfg, h = TC.reduced(TC.LENET), TC.HeliosConfig()
    run = FLRun(cfg, h, "syn", setup_clients(make_fleet(2, 2), parts, h,
                                             device="cpu"),
                train, test, device="cpu", participation=2,
                sampler="greedy", **RUN_KW)
    with pytest.raises(ValueError, match="sampler"):
        run.run_sync(1)


@pytest.mark.parametrize("white_box", [True, False],
                         ids=["white_box", "time_based"])
def test_elastic_join_leave_matches_jax(white_box):
    """examples/elastic_scaling.py's sequence on reduced LeNet."""
    train, test, parts = _data(1, 6)
    jcfg, tcfg = JC.reduced(JC.CNNS["lenet"]), TC.reduced(TC.LENET)
    jh, th = JC.HeliosConfig(), TC.HeliosConfig()
    kw = dict(RUN_KW, local_steps=2, lr=0.1)
    jrun = JaxFLRun(jcfg, jh, "helios",
                    j_setup_clients(j_make_fleet(2, 2), parts[:4], jh),
                    train, test, **kw)
    share_jax_programs(jrun)
    init = {k: np.asarray(v)
            for k, v in jax.device_get(jrun.global_params).items()}
    with jax_keys():
        trun = FLRun(tcfg, th, "helios",
                     setup_clients(make_fleet(2, 2), parts[:4], th,
                                   device="cpu"),
                     train, test, kernels="cuda", device="cpu",
                     init_params=init, **kw)
        for run, table in ((jrun, J_TABLE_I), (trun, TABLE_I)):
            run.run_sync(2)
            new = run.add_client(table[3], parts[4], white_box=white_box)
            run.run_sync(2)
            run.remove_client(new.cid)
            run.run_sync(1)
            run._joined = new
    jn, tn = jrun._joined, trun._joined
    assert (tn.cid, tn.is_straggler, tn.volume) == \
        (jn.cid, jn.is_straggler, jn.volume)
    assert tn.cid == 4 and tn.is_straggler and 0 < tn.volume < 1
    assert len(trun.clients) == 4 and tn.cid not in \
        [c.cid for c in trun.clients]
    assert [len(h["volumes"]) for h in trun.history] == [4, 4, 5, 5, 4]
    assert trun.cohort_log == jrun.cohort_log
    _assert_same(jrun, trun)


def test_make_scheme_accepts_the_ported_names():
    assert tuple(SCHEMES) == ("helios", "syn", "st_only", "random", "asyn",
                              "afo", "scaffold", "fluid", "delayed")
    for name in SCHEMES:
        s = make_scheme(name)
        assert s.name == name
        assert s.async_native == (name in ("asyn", "afo"))
        assert s.staleness_discount == (name in ("afo", "delayed"))
        assert s.async_weight(0.5, 3, 0.5) == \
            (0.25 if name in ("afo", "delayed") else 0.5)
    with pytest.raises(ValueError, match="delayed"):
        make_scheme("fedprox")
