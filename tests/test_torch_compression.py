"""Port parity for the uplink codec and the lossy snapshot ring:
``repro_torch.optim.compression`` against ``repro.optim.compression`` and
the lossy half of ``repro_torch.core.aggregation`` against
``repro.core.aggregation``, on the CPU.

* Every codec function on seeded leaves with ties at the top-k threshold,
  exact zeros, Eq. 2-style masks and an all-zero leaf: bit for bit
  (``torch.topk``'s k-th value, round half to even, int8 codes, the fp16
  round trip and the coordinate counts are the reference's exactly).
* The stacked form against a loop of the single form over the rows, bit
  for bit.
* The codec on a JAX run's own inputs is in
  tests/test_torch_compression_engines.py, beside the runs it reads.
* The lossy ring: ``lossy_roundtrip``, ``ring_gather_lossy`` and
  ``SnapshotRing`` (codes, scales, ``read`` and ``nbytes``) bit for bit;
  ``mix_bucket_ring_lossy``'s globals within 1e-6 of the reference's scan
  and its codes exactly those of its own globals.
* ``Recorder.accum``; one family case, ``FLRun`` on reduced deepseek-7b
  under ``delta``, one round against JAX at 1e-4 (the family-generic
  ``expand_masks`` path of the codec).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.core import aggregation as jAG  # noqa: E402
from repro.federated import FLRun as JaxFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
from repro.optim import compression as jCP  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.core import aggregation as tAG  # noqa: E402
from repro_torch.data.federated import partition_by_topic  # noqa: E402
from repro_torch.data.synthetic import markov_topic_tokens  # noqa: E402
from repro_torch.federated import FLRun, make_fleet, setup_clients  # noqa: E402
from repro_torch.obs.recorder import Recorder  # noqa: E402
from repro_torch.optim import compression as tCP  # noqa: E402
from test_torch_keys import jax_keys  # noqa: E402

LOSSY = ("topk", "quant", "delta")


#: 200 coordinates of leaf ``a`` (2048 values, k = 102) that tie at |5|
TIES = np.random.default_rng(100).permutation(2048)[:200]


def _leaves(seed: int, ties: bool = True) -> dict:
    """Seeded leaves: ``a`` with 200 coordinates at +-5 (``ties``; zero
    otherwise, so that a delta's ties survive adding its error row) where
    the k-th largest |x| falls, ``b`` quarter steps with many ties, an
    all-zero ``c``, exact zeros in ``d``."""
    r = np.random.default_rng(seed)
    a = r.normal(size=(64, 32)).astype(np.float32)
    a[:4, :16] = 0
    a.reshape(-1)[TIES] = 5.0 * np.sign(r.normal(size=200)) if ties else 0
    b = (np.round(r.normal(size=(50,)) * 4) / 4).astype(np.float32)
    c = np.zeros((3, 3, 4), np.float32)
    d = r.normal(size=(8, 5)).astype(np.float32)
    d[r.random(d.shape) < 0.5] = 0
    return {"a": a, "b": b, "c": c, "d": d}


def _masks(seed: int) -> dict:
    r = np.random.default_rng(seed)
    return {k: (r.random(v.shape) > 0.3).astype(np.float32)
            for k, v in _leaves(0).items()}


def _j(tree):
    return None if tree is None else {k: jnp.asarray(v)
                                      for k, v in tree.items()}


def _t(tree):
    return None if tree is None else {k: torch.tensor(np.asarray(v))
                                      for k, v in tree.items()}


def _equal(jtree, ttree, what=""):
    for k, v in jtree.items():
        np.testing.assert_array_equal(ttree[k].numpy(), np.asarray(v),
                                      err_msg=f"{what} {k}")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", LOSSY)
def test_compress_update_matches_jax_bit_for_bit(mode, masked):
    d, e = _leaves(1), _leaves(2, ties=False)
    m = _masks(3) if masked else None
    js, je, jc = jCP.compress_update(_j(d), _j(e), mode, 0.05, 8, _j(m))
    ts, te, tc = tCP.compress_update(_t(d), _t(e), mode, 0.05, 8, _t(m))
    _equal(js, ts, "sent")
    _equal(je, te, "new_error")
    assert tc.dtype == torch.float32 and float(tc) == float(jc)
    # the ties at the threshold are all kept (the reference's red
    # test_topk_sent_fraction_bound): more than leaf_k coordinates go out
    if mode != "quant":
        sent = int((ts["a"] != 0).sum())
        assert sent > tCP.leaf_k(2048, 0.05), sent
    # telescoping on unmasked coordinates, to the ulp of |delta + error|
    for k in d:
        keep = np.ones_like(d[k]) if m is None else m[k]
        lhs = (ts[k] + te[k]).numpy() * keep
        rhs = (d[k] + e[k]) * keep
        np.testing.assert_allclose(lhs, rhs, rtol=2 ** -23, atol=0,
                                   err_msg=k)
        if m is not None:           # masked coordinates are never sent
            assert not np.any(ts[k].numpy()[keep == 0])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", LOSSY)
def test_stacked_form_is_the_row_loop(mode, masked):
    rows = [_leaves(s) for s in (1, 4, 5)]
    errs = [_leaves(s, ties=False) for s in (2, 6, 7)]
    mrows = [_masks(s) for s in (3, 8, 9)] if masked else None

    def stack(trees):
        return {k: torch.tensor(np.stack([t[k] for t in trees]))
                for k in trees[0]}

    ss, se, sc = tCP.compress_update_stacked(
        stack(rows), stack(errs), mode, 0.05, 8,
        stack(mrows) if masked else None)
    assert sc.shape == (3,) and sc.dtype == torch.float32
    for i in range(3):
        s, e, c = tCP.compress_update(
            _t(rows[i]), _t(errs[i]), mode, 0.05, 8,
            _t(mrows[i]) if masked else None)
        for k in s:
            assert torch.equal(ss[k][i], s[k]), (i, k)
            assert torch.equal(se[k][i], e[k]), (i, k)
        assert float(sc[i]) == float(c)


def test_quantize_and_helpers_match_jax():
    x = np.array([0.0, -1.0, 1.0, 0.5, 0.0, 127.5 / 127, -0.25, 3.0],
                 np.float32)
    for bits in (4, 8, 12):
        jq, js = jCP.quantize(jnp.asarray(x), bits)
        tq, ts = tCP.quantize(torch.tensor(x), bits)
        assert tq.dtype == (torch.int8 if bits <= 8 else torch.int32)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(
            tCP.dequantize(tq, ts).numpy(),
            np.asarray(jCP.dequantize(jq, js)))
    zq, zs = tCP.quantize(torch.zeros(0), 8)
    assert zq.shape == (0,) and float(zs) == 1.0
    assert float(tCP.quantize(torch.zeros(4), 8)[1]) == float(
        jCP.quantize(jnp.zeros(4), 8)[1])
    for n, f in ((0, 0.05), (1, 0.05), (10, 0.01), (1000, 0.05), (30, 0.5)):
        assert tCP.leaf_k(n, f) == jCP.leaf_k(n, f)
    tree = _leaves(1)
    assert tCP.compressed_bytes(_t(tree), 0.05) == \
        jCP.compressed_bytes(_j(tree), 0.05)
    assert tCP.param_census(_t(tree)) == jCP.param_census(_j(tree))
    for mode in ("none",) + LOSSY:
        for bits in (4, 8):
            assert tCP.uplink_bytes(mode, 1234.0, 5000, 12, bits) == \
                jCP.uplink_bytes(mode, 1234.0, 5000, 12, bits)
    with pytest.raises(ValueError):
        tCP.uplink_bytes("gzip", 1.0, 1, 1)
    with pytest.raises(ValueError):
        tCP.compress_update(_t(tree), _t(tree), "none")
    half = {"a": torch.zeros((3, 2), dtype=torch.float16),
            "b": torch.zeros(4)}
    err = tCP.init_error(half)
    assert err["a"].dtype == torch.float16 and err["b"].dtype == torch.float32
    assert all(float(v.abs().sum()) == 0 for v in err.values())


def test_legacy_compress_matches_jax():
    g, e = _leaves(1), _leaves(2)
    js, je, jf = jCP.compress(_j(g), _j(e), 0.05)
    ts, te, tf = tCP.compress(_t(g), _t(e), 0.05)
    _equal(js, ts, "sparse")
    _equal(je, te, "error")
    assert float(tf) == pytest.approx(float(jf), rel=1e-7)


# ---------------------------------------------------------------------------
# the lossy ring
# ---------------------------------------------------------------------------


def _params(seed=0):
    r = np.random.default_rng(seed)
    return {"a": r.normal(size=(6, 5)).astype(np.float32),
            "b": (0.1 * r.normal(size=(7,))).astype(np.float32)}


@pytest.mark.parametrize("mode", ["quant", "delta"])
def test_lossy_ring_matches_jax(mode):
    p = _params()
    jr = jAG.SnapshotRing(_j(p), 4, 2, mode=mode, bits=8, fresh_window=2)
    tr = tAG.SnapshotRing(_t(p), 4, 2, mode=mode, bits=8, fresh_window=2)
    for name in ("q", "scales", "fresh_buf"):
        _equal(getattr(jr, name), getattr(tr, name), name)
    assert (tr.ref is None) == (mode == "quant")
    if tr.ref is not None:
        _equal(jr.ref, tr.ref, "ref")
    assert tr.nbytes() == jr.nbytes()
    # at cap 16 the int rows outweigh the fresh rows and the reference
    big = tAG.SnapshotRing(_t(p), 16, 2, mode=mode, fresh_window=2)
    fp = tAG.SnapshotRing(_t(p), 16, 2)
    assert big.nbytes() == jAG.SnapshotRing(
        _j(p), 16, 2, mode=mode, fresh_window=2).nbytes()
    assert big.nbytes() < fp.nbytes() == jAG.SnapshotRing(_j(p), 16,
                                                          2).nbytes()
    _equal(jr.read(0, stale=5), tr.read(0, stale=5), "stale read")
    _equal(jr.read(0, stale=1), tr.read(0, stale=1), "fresh read")
    _equal(jr.read(0), tr.read(0), "read")
    # the bucket's writes: three events, the last a padding event (weight
    # 0, scratch rows); globals within the scan's rounding, codes exactly
    # the quantization of the port's own globals
    r = np.random.default_rng(1)
    stacked = {k: r.normal(size=(3,) + v.shape).astype(np.float32)
               for k, v in p.items()}
    w = np.array([0.5, 0.5 * 2 ** -0.5, 0.0], np.float32)
    slots, fresh = [1, 2, tr.scratch], [1, 0, 2]
    jg, jq, js, jf = jAG.mix_bucket_ring_lossy(
        _j(p), jr.q, jr.scales, jr.fresh_buf, jr.ref, jnp.asarray(slots),
        jnp.asarray(fresh), _j(stacked), jnp.asarray(w), 8)
    tg, tq, ts, tf = tAG.mix_bucket_ring_lossy(
        _t(p), tr.q, tr.scales, tr.fresh_buf, tr.ref, slots, fresh,
        _t(stacked), torch.tensor(w), 8)
    for a, b in ((jg, tg), (jf, tf)):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tf["a"][2].numpy(), tf["a"][0].numpy())
    for i, (s, f) in enumerate(zip(slots, fresh)):
        row = {k: tf[k][f] for k in tf}
        dec = tAG.lossy_roundtrip(row, tr.ref, 8)
        for k in row:
            q, sc = tCP.quantize(tAG._lossy_delta(row[k], None if tr.ref is
                                                  None else tr.ref[k]), 8)
            assert torch.equal(tq[k][s], q) and float(ts[k][s]) == float(sc)
        _equal({k: np.asarray(v) for k, v in jAG.lossy_roundtrip(
            _j({k: v.numpy() for k, v in row.items()}),
            None if tr.ref is None else _j({k: v.numpy() for k, v in
                                            tr.ref.items()}), 8).items()},
               dec, f"roundtrip {i}")
    # the gather on identical ring contents: stale rows decode, fresh rows
    # read full precision
    args = ([0, 1, 2], [0, 1, 0], [0.0, 1.0, 0.0])
    jgat = jAG.ring_gather_lossy(
        _j({k: v.numpy() for k, v in tq.items()}),
        _j({k: v.numpy() for k, v in ts.items()}),
        _j({k: v.numpy() for k, v in tf.items()}),
        jr.ref, *(jnp.asarray(a) for a in args))
    tgat = tAG.ring_gather_lossy(tq, ts, tf, tr.ref, *args)
    _equal(jgat, tgat, "gather")
    np.testing.assert_array_equal(tgat["a"][1].numpy(), tf["a"][1].numpy())


def test_ring_put_is_fp32_only_and_modes_checked():
    p = _t(_params())
    with pytest.raises(ValueError):
        tAG.SnapshotRing(p, 4, 2, mode="quant").put(1, p)
    with pytest.raises(ValueError):
        tAG.SnapshotRing(p, 4, 2, mode="int4")


def test_recorder_accum_keeps_the_order_of_the_calls():
    rec = Recorder()
    assert rec.accum_raw("x") is None and rec.accum_value("x", 7.0) == 7.0
    vals = [2.0 ** 24, 1.0, 1.0, 2.0]
    for v in vals:
        rec.accum("x", torch.tensor(v))
    # f32: 2^24 + 1 rounds back to 2^24 twice, then + 2 is exact (the
    # sum in another order would be 2^24 + 4)
    assert rec.accum_raw("x").dtype == torch.float32
    assert rec.accum_value("x") == 2.0 ** 24 + 2


# ---------------------------------------------------------------------------
# one family case: the dense LM through the codec's expand_masks path
# ---------------------------------------------------------------------------


def test_deepseek_delta_round_matches_jax():
    tokens, topics = markov_topic_tokens(240, 32, 64, n_topics=8, seed=0)
    test_tokens, _ = markov_topic_tokens(64, 32, 64, n_topics=8, seed=9)
    parts = partition_by_topic(topics, 4, topics_per_client=2)
    train, test = {"tokens": tokens}, {"tokens": test_tokens}
    jh, th = JC.HeliosConfig(mask_block=16), TC.HeliosConfig(mask_block=16)
    kw = dict(local_steps=1, batch_size=4, lr=0.05, seed=0, eval_batch=64,
              compression="delta")
    jrun = JaxFLRun(JC.reduced(JC.ARCHS["deepseek-7b"]), jh, "helios",
                    j_setup_clients(j_make_fleet(2, 2), parts, jh), train,
                    test, **kw)
    init = jax.device_get(jrun.global_params)
    jrun.run_sync(1)
    with jax_keys():
        trun = FLRun(TC.reduced(TC.DEEPSEEK_7B), th, "helios",
                     setup_clients(make_fleet(2, 2), parts, th, device="cpu"),
                     train, test, device="cpu", init_params=init, **kw)
        trun.run_sync(1)
    assert trun.kernels == "reference"
    for key in ("cycle", "time", "volumes", "ratios"):
        assert trun.history[-1][key] == jrun.history[-1][key], key
    flat = dict(jax.tree_util.tree_flatten_with_path(jrun.global_params)[0])
    tflat = {"/".join(str(getattr(p, "key", p)) for p in path): v
             for path, v in flat.items()}
    from repro_torch.models.module import tree_paths
    got = dict(tree_paths(trun.global_params))
    assert set(got) == set(tflat)
    for k, v in tflat.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-4, err_msg=k)
    assert trun._err_store.touched() == jrun._err_store.touched() == 4
    assert abs(trun.uplink_bytes() - jrun.uplink_bytes()) < 1e-3
    assert trun.uplink_bytes() < 0.2 * 4 * 4 * trun._n_params
