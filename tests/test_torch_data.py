"""Port parity for the federated data partitions
(``repro_torch.data.federated``) against the JAX package's
``repro.data.federated``.

* Each partition, eager and lazy (``partition_iid_lazy``,
  ``partition_noniid_lazy``, ``partition_by_topic_lazy``), equals the
  reference's index for index, client by client, negative indices
  included, and each lazy one equals its eager twin; a lazy non-IID
  client's indices are the sorted union of its dealt shard slices of the
  stable label order.
* ``FLRun.run_sync(2)`` of helios on reduced LeNet over
  ``partition_noniid_lazy`` against the JAX package's ``FLRun`` on the same
  deal: identical history and straggler masks, params within atol 1e-5.
* ``label_distribution`` equal on eager and lazy partitions.  The
  reference's ``LazyShardParts`` has no end (its ``__getitem__`` past the
  last client returns an empty view), so iterating it, as
  ``label_distribution`` does, fails there; the port's raises
  ``IndexError`` past the last client and its histogram equals the eager
  one.
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
import repro.data.federated as JD  # noqa: E402
from repro.federated import FLRun as JaxFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.data.federated as TD  # noqa: E402
from repro_torch.data.synthetic import class_gaussian_images  # noqa: E402
from repro_torch.federated import (FLRun, make_fleet,  # noqa: E402
                                   setup_clients)
from test_torch_keys import jax_keys, share_jax_programs  # noqa: E402

ATOL = 1e-5
#: (items, clients, shards a client, seed)
DEALS = ((300, 7, 3, 1), (2000, 6, 4, 0), (4096, 64, 4, 0), (50, 8, 2, 5))


def _labels(n, seed, classes=10):
    return np.random.default_rng(seed).integers(0, classes, n).astype(
        np.int32)


def _same_parts(got, want, n_clients):
    assert len(got) == len(want) == n_clients
    for c in range(-n_clients, n_clients):
        a, b = np.asarray(got[c]), np.asarray(want[c])
        assert len(got[c]) == len(want[c]) == len(a), c
        np.testing.assert_array_equal(a, b, err_msg=str(c))
        assert a.dtype == b.dtype, c


@pytest.mark.parametrize("deal", DEALS, ids=lambda d: "-".join(map(str, d)))
def test_iid_partitions_match_reference(deal):
    n, k, _, seed = deal
    _same_parts(TD.partition_iid(n, k, seed), JD.partition_iid(n, k, seed), k)
    lazy = TD.partition_iid_lazy(n, k, seed)
    _same_parts(lazy, JD.partition_iid_lazy(n, k, seed), k)
    _same_parts(lazy, TD.partition_iid(n, k, seed), k)
    assert sorted(np.concatenate([np.asarray(p) for p in lazy])) == \
        list(range(n))


@pytest.mark.parametrize("deal", DEALS, ids=lambda d: "-".join(map(str, d)))
def test_noniid_partitions_match_reference(deal):
    n, k, spc, seed = deal
    labels = _labels(n, seed)
    eager = TD.partition_noniid(labels, k, spc, seed)
    _same_parts(eager, JD.partition_noniid(labels, k, spc, seed), k)
    lazy = TD.partition_noniid_lazy(labels, k, spc, seed)
    _same_parts(lazy, JD.partition_noniid_lazy(labels, k, spc, seed), k)
    _same_parts(lazy, eager, k)
    topics = _labels(n, seed + 1, classes=8)
    _same_parts(TD.partition_by_topic(topics, k, spc, seed),
                JD.partition_by_topic(topics, k, spc, seed), k)
    _same_parts(TD.partition_by_topic_lazy(topics, k, spc, seed),
                JD.partition_by_topic_lazy(topics, k, spc, seed), k)


@pytest.mark.parametrize("deal", DEALS, ids=lambda d: "-".join(map(str, d)))
def test_lazy_shard_views_are_their_shard_slices(deal):
    """A client's view is the sorted union of its dealt shards: slices of
    the stable label order at ``np.array_split``'s boundaries."""
    n, k, spc, seed = deal
    labels = _labels(n, seed)
    lazy = TD.partition_noniid_lazy(labels, k, spc, seed)
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, k * spc)
    bounds = TD._split_bounds(n, k * spc)
    np.testing.assert_array_equal(bounds, JD._split_bounds(n, k * spc))
    assign = np.random.default_rng(seed).permutation(k * spc)
    for c in range(k):
        view = lazy[c]
        mine = assign[c * spc:(c + 1) * spc]
        np.testing.assert_array_equal(view._shards, mine)
        for s in mine:
            np.testing.assert_array_equal(
                order[bounds[s]:bounds[s + 1]], shards[s])
        np.testing.assert_array_equal(
            np.asarray(view), np.sort(np.concatenate([shards[s]
                                                      for s in mine])))
        assert np.asarray(view, dtype=np.int64).dtype == np.int64


def test_label_distribution_matches_reference():
    n, k, spc, seed = DEALS[0]
    labels = _labels(n, seed)
    for eager, lazy, jeager in (
            (TD.partition_noniid(labels, k, spc, seed),
             TD.partition_noniid_lazy(labels, k, spc, seed),
             JD.partition_noniid(labels, k, spc, seed)),
            (TD.partition_iid(n, k, seed), TD.partition_iid_lazy(n, k, seed),
             JD.partition_iid(n, k, seed))):
        want = JD.label_distribution(labels, jeager, 10)
        np.testing.assert_array_equal(
            TD.label_distribution(labels, eager, 10), want)
        np.testing.assert_array_equal(
            TD.label_distribution(labels, lazy, 10), want)
        assert want.sum() == n and want.shape == (k, 10)
    np.testing.assert_array_equal(
        TD.label_distribution(labels, TD.partition_iid_lazy(n, k, seed), 10),
        JD.label_distribution(labels, JD.partition_iid_lazy(n, k, seed), 10))


def test_reference_lazy_shard_parts_end_is_not_copied():
    """Past its last client the reference's ``LazyShardParts`` returns an
    empty view, so a loop over it never stops on its own and
    ``label_distribution`` raises; the port ends the sequence."""
    n, k, spc, seed = DEALS[0]
    labels = _labels(n, seed)
    jlazy = JD.partition_noniid_lazy(labels, k, spc, seed)
    assert len(jlazy[k]) == 0
    with pytest.raises(ValueError):
        JD.label_distribution(labels, jlazy, 10)
    lazy = TD.partition_noniid_lazy(labels, k, spc, seed)
    with pytest.raises(IndexError):
        lazy[k]
    with pytest.raises(IndexError):
        lazy[-k - 1]
    assert len(list(lazy)) == k


def test_flrun_over_lazy_deal_matches_jax():
    imgs, labels = class_gaussian_images(256, 16, 1, 10, seed=0)
    ti, tl = class_gaussian_images(64, 16, 1, 10, seed=9)
    train = {"images": imgs, "labels": labels}
    test = {"images": ti, "labels": tl}
    kw = dict(local_steps=2, batch_size=8, lr=0.05, seed=0, eval_batch=64)
    jh, th = JC.HeliosConfig(), TC.HeliosConfig()
    jparts = JD.partition_noniid_lazy(labels, 4, 4)
    jrun = JaxFLRun(JC.reduced(JC.CNNS["lenet"]), jh, "helios",
                    j_setup_clients(j_make_fleet(2, 2), jparts, jh),
                    train, test, **kw)
    share_jax_programs(jrun)
    init = {k: np.asarray(v)
            for k, v in jax.device_get(jrun.global_params).items()}
    jrun.run_sync(2)
    parts = TD.partition_noniid_lazy(labels, 4, 4)
    assert isinstance(parts[0], TD._LazyShardView)
    with jax_keys():
        trun = FLRun(TC.reduced(TC.LENET), th, "helios",
                     setup_clients(make_fleet(2, 2), parts, th, device="cpu"),
                     train, test, kernels="cuda", device="cpu",
                     init_params=init, **kw)
        trun.run_sync(2)
    assert len(trun.history) == len(jrun.history) == 2
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
    for jc, tc in zip(jrun.clients, trun.clients):
        assert isinstance(tc.data_idx, TD._LazyShardView)
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=k)
