"""Port parity for the uplink codec on the sync engines: ``FLRun`` and
``BatchedFLRun`` of the port, each against its own JAX engine, under
``compression`` = topk / quant / delta.

The reference's setting (tests/test_compression_engines.py): reduced
LeNet, a 4 + 4 IID fleet, helios, one local step of batch 8, lr 0.1.  Both
sides start from the JAX run's initial params and the port draws its Eq. 2
numbers through the JAX key-path backend.  The lossy modes turn rounding
noise into whole decisions (a code step, a coordinate in or out of the
sent set), so the engines are held at the reference's own tolerances for
them: params atol 1e-4, uplink bytes within 1e-3 absolute, update counts
and the error store's clients equal (the codec itself is held bit for bit
in tests/test_torch_compression.py).  One decision is left to the last
bit: a coordinate within two ulps of a leaf's top-k threshold (ties are
all kept) can enter or leave the sent set when the trajectories part by
an ulp (topk / delta under helios here: one coordinate of fc1_w, 6 bytes
of 139392, the inputs 1.5e-8 apart).  The bytes are therefore held within
1e-3 plus one wire coordinate for each such near-tie the port's codec met,
counted while it runs; quant bills mask coverage and is held at 1e-3.

* ``run_sync(3)`` of both engines in each mode, and under delta over 4
  of the 8 clients a round (``participation=4``, cohort logs identical:
  the error rows gathered and scattered by cid);
* the codec on a JAX run's own inputs: the pre-codec (base, new params,
  error row, masks) of the last round's updates of JAX ``FLRun`` in each
  mode give the reference's eager ``sent`` and new error exactly, and the
  decoded params within 1e-7 of the jitted engine's (XLA fuses ``b + q·s``
  there; the codes agree);
* ``comp_warmup=1`` against JAX (one dense round, then the codec), and a
  warmup covering the run bit-identical to ``compression="none"``;
* ``compression="none"`` bit-identical to a run without the field;
* bad mode / ``comp_fresh=0`` / negative warmup rejected; the error store
  grows with participation; topk's >= 10x uplink reduction; an engine
  built without ``kernels`` runs the plain versions on the CPU.
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
from repro.data.federated import partition_iid  # noqa: E402
from repro.data.synthetic import class_gaussian_images  # noqa: E402
from repro.federated import BatchedFLRun as JaxBatchedFLRun  # noqa: E402
from repro.federated import FLRun as JaxFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
from repro.optim import compression as jCP  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.federated import (BatchedFLRun, FLRun,  # noqa: E402
                                   make_fleet, setup_clients)
from repro_torch.optim import compression as tCP  # noqa: E402
from test_torch_keys import jax_keys, share_jax_programs  # noqa: E402

LOSSY = ("topk", "quant", "delta")
ATOL = 1e-4
BYTES_ATOL = 1e-3
RUN_KW = dict(local_steps=1, batch_size=8, lr=0.1, seed=0, eval_batch=64)
ENGINES = {"FLRun": (JaxFLRun, FLRun),
           "BatchedFLRun": (JaxBatchedFLRun, BatchedFLRun)}


@pytest.fixture(scope="module")
def setting():
    cfg = JC.reduced(JC.CNNS["lenet"])
    imgs, labels = class_gaussian_images(400, cfg.image_size,
                                         cfg.in_channels, cfg.num_classes,
                                         seed=0)
    ti, tl = class_gaussian_images(64, cfg.image_size, cfg.in_channels,
                                   cfg.num_classes, seed=9)
    return {"images": imgs, "labels": labels}, \
        {"images": ti, "labels": tl}, partition_iid(len(labels), 8, seed=0)


#: wire bytes of one encoded coordinate per mode (index + value)
COORD_BYTES = {"topk": 6.0, "quant": 0.0, "delta": 5.0}


class NearTies:
    """Counts, while active, the coordinates whose |x| lies within two
    ulps of their row's top-k threshold (the threshold's own excluded):
    each could cross it under a one-ulp change of the trajectory.  Every
    codec call reaches top-k through ``_rows_topk``."""

    def __init__(self):
        self.count = 0

    def __enter__(self):
        self._saved = tCP._rows_topk

        def rows(x, frac, inner=self._saved):
            r = x.abs().reshape(x.shape[0], -1)
            if r.shape[1]:
                t = torch.topk(r, tCP.leaf_k(r.shape[1], frac),
                               dim=-1).values[:, -1:]
                band = (r - t).abs() <= 2 * torch.finfo(torch.float32).eps * t
                self.count += int(band.sum()) - r.shape[0]
            return inner(x, frac)

        tCP._rows_topk = rows
        return self

    def __exit__(self, *exc):
        tCP._rows_topk = self._saved


def make_pair(setting, classes, scheme="helios", **kw):
    """The JAX engine and the port's (``classes``) on the 4 + 4 fleet from
    the same initial params (the caller holds the JAX key backend)."""
    train, test, parts = setting
    jcls, tcls = classes
    jh, th = JC.HeliosConfig(), TC.HeliosConfig()
    jrun = jcls(JC.reduced(JC.CNNS["lenet"]), jh, scheme,
                j_setup_clients(j_make_fleet(4, 4), parts, jh), train, test,
                **RUN_KW, **kw)
    if jcls is JaxFLRun:
        share_jax_programs(jrun)
    init = {k: np.asarray(v)
            for k, v in jax.device_get(jrun.global_params).items()}
    trun = tcls(TC.reduced(TC.LENET), th, scheme,
                setup_clients(make_fleet(4, 4), parts, th, device="cpu"),
                train, test, device="cpu", init_params=init, **RUN_KW, **kw)
    return jrun, trun


def make_port(setting, cls, scheme="helios", **kw):
    train, test, parts = setting
    th = TC.HeliosConfig()
    return cls(TC.reduced(TC.LENET), th, scheme,
               setup_clients(make_fleet(4, 4), parts, th, device="cpu"),
               train, test, device="cpu", **RUN_KW, **kw)


def param_diff(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(b[k].cpu())
                                   - np.asarray(v))))
               for k, v in a.items())


def assert_matches(jrun, trun, near_ties: int = 0):
    assert set(trun.global_params) == set(jrun.global_params)
    assert param_diff(jrun.global_params, trun.global_params) <= ATOL
    assert trun.uplink_updates == jrun.uplink_updates
    assert trun.uplink_dense_updates == jrun.uplink_dense_updates
    slack = near_ties * COORD_BYTES[trun.compression]
    assert abs(trun.uplink_bytes() - jrun.uplink_bytes()) < \
        BYTES_ATOL + slack, (trun.uplink_bytes(), jrun.uplink_bytes(), slack)
    assert trun.downlink_bytes() == jrun.downlink_bytes()
    assert sorted(trun._err_store._rows) == sorted(jrun._err_store._rows)


def _record_codec(jrun) -> list:
    """Make the JAX engine's per-update codec also keep its inputs and
    outputs, as numpy."""
    calls, inner = [], jrun._compress_one

    def record(*args):
        res = inner(*args)
        calls.append((jax.device_get(args), jax.device_get(res)))
        return res

    jrun._compress_one = record
    return calls


@pytest.fixture(scope="module")
def sync_runs(setting):
    out = {}
    for engine in ENGINES:
        for mode, part in [(m, 0) for m in LOSSY] + [("delta", 4)]:
            with jax_keys():
                jrun, trun = make_pair(setting, ENGINES[engine],
                                       compression=mode, participation=part)
                calls = _record_codec(jrun) if engine == "FLRun" else None
                jrun.run_sync(3, eval_every=0)
                with NearTies() as ties:
                    trun.run_sync(3, eval_every=0)
            out[engine, mode, part] = jrun, trun, ties.count
            if calls is not None and not part:
                out["codec", mode] = calls
    return out


@pytest.mark.parametrize("mode", LOSSY)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_run_sync_matches_jax(sync_runs, engine, mode):
    jrun, trun, ties = sync_runs[engine, mode, 0]
    assert_matches(jrun, trun, ties)
    assert trun.uplink_updates == 24 and trun._err_store.touched() == 8
    assert float(trun.uplink_coords) > 0


@pytest.mark.parametrize("engine", list(ENGINES))
def test_sampled_run_sync_matches_jax(sync_runs, engine):
    jrun, trun, ties = sync_runs[engine, "delta", 4]
    assert trun.cohort_log == jrun.cohort_log
    assert all(len(c) == 4 for c in trun.cohort_log)
    assert_matches(jrun, trun, ties)


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("mode", LOSSY)
def test_codec_on_jax_run_inputs(sync_runs, mode):
    calls = sync_runs["codec", mode]
    assert len(calls) == 3 * 8
    for (base, new, err, pm), (hat, nerr, coords) in calls[-8:]:
        assert any(np.any(np.asarray(v)) for v in err.values())
        jdelta = {k: jnp.asarray(new[k]) - jnp.asarray(base[k]) for k in base}
        js, je, _ = jCP.compress_update(jdelta, _j(err), mode, 0.05, 8,
                                        _j(pm))
        b, n = _t(base), _t(new)
        ts, te, tc = tCP.compress_update({k: n[k] - b[k] for k in b},
                                         _t(err), mode, 0.05, 8, _t(pm))
        assert float(tc) == float(coords)
        for k in b:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                          err_msg=f"{mode} sent {k}")
            np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]),
                                          err_msg=f"{mode} new error {k}")
            np.testing.assert_allclose((b[k] + ts[k]).numpy(),
                                       np.asarray(hat[k]), rtol=0,
                                       atol=1e-7, err_msg=k)
            np.testing.assert_allclose(te[k].numpy(), np.asarray(nerr[k]),
                                       rtol=0, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_comp_warmup_matches_jax(setting, engine):
    """One dense round, then the codec: the same split of dense and
    compressed updates as the reference, and its trajectory."""
    with jax_keys():
        jrun, trun = make_pair(setting, ENGINES[engine], compression="topk",
                               comp_warmup=1)
        jrun.run_sync(3, eval_every=0)
        with NearTies() as ties:
            trun.run_sync(3, eval_every=0)
    assert trun.uplink_dense_updates == 8
    assert_matches(jrun, trun, ties.count)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_comp_warmup_covering_run_is_dense(setting, engine):
    cls = ENGINES[engine][1]
    a = make_port(setting, cls, compression="topk", comp_warmup=3)
    a.run_sync(3, eval_every=0)
    b = make_port(setting, cls, compression="none")
    b.run_sync(3, eval_every=0)
    for k, v in b.global_params.items():
        assert torch.equal(a.global_params[k], v), k
    assert a.uplink_bytes() == b.uplink_bytes()
    assert a.uplink_dense_updates == a.uplink_updates == 24
    assert a._err_store.touched() == 0


@pytest.mark.parametrize("engine", list(ENGINES))
def test_none_is_the_run_without_the_field(setting, engine):
    cls = ENGINES[engine][1]
    a = make_port(setting, cls)
    a.run_sync(2)
    b = make_port(setting, cls, compression="none")
    b.run_sync(2)
    for k, v in a.global_params.items():
        assert torch.equal(b.global_params[k], v), k
    assert a.history == b.history
    assert a.uplink_bytes() == b.uplink_bytes() == 16 * 4.0 * a._n_params
    assert not hasattr(b, "_err_store")


def test_bad_knobs_rejected(setting):
    for kw in (dict(compression="gzip"),
               dict(compression="quant", comp_fresh=0),
               dict(compression="topk", comp_warmup=-1)):
        with pytest.raises(ValueError):
            make_port(setting, FLRun, **kw)


def test_error_store_grows_with_participation(setting):
    run = make_port(setting, BatchedFLRun, compression="topk",
                    participation=2)
    run.run_sync(3, eval_every=0)
    seen = {run.clients[i].cid for cohort in run.cohort_log for i in cohort}
    assert run._err_store.touched() == len(seen) <= 6
    assert run._err_store.nbytes() == len(seen) * 4 * run._n_params
    assert run._err_store.stats() == {"rows": len(seen),
                                      "bytes": run._err_store.nbytes()}


def test_topk_uplink_reduction_at_least_10x(setting):
    dense = make_port(setting, BatchedFLRun)
    dense.run_sync(2, eval_every=0)
    topk = make_port(setting, BatchedFLRun, compression="topk")
    topk.run_sync(2, eval_every=0)
    assert dense.uplink_bytes() / topk.uplink_bytes() >= 10.0


def test_kernels_default_follows_the_device(setting):
    """Built without ``kernels`` an engine on the CPU runs the plain
    versions ("cuda" on a CUDA device); an explicit value is honoured and
    "pallas" stays an alias of "cuda"."""
    assert make_port(setting, FLRun).kernels == "reference"
    assert make_port(setting, BatchedFLRun).kernels == "reference"
    assert make_port(setting, FLRun, kernels="pallas").kernels == "cuda"
    assert make_port(setting, FLRun, kernels="reference").kernels == \
        "reference"
    with pytest.raises(ValueError):
        make_port(setting, FLRun, kernels="triton")


def test_near_tie_count_sees_ties():
    """The counter's own check: an exact tie and a one-ulp neighbour of the
    threshold count, a value 1e-3 away does not."""
    x = torch.tensor([5.0, 4.0, 3.0, 3.0, float(np.nextafter(np.float32(3),
                                                           np.float32(0))),
                      2.997, 1.0])
    with NearTies() as ties:
        tCP.compress_update({"w": x}, {"w": torch.zeros(7)}, "topk", 3 / 7)
    assert ties.count == 2
    with NearTies() as ties:
        tCP.compress_update_stacked({"w": x[None]}, {"w": torch.zeros(1, 7)},
                                    "topk", 3 / 7)
    assert ties.count == 2
    assert tCP._rows_topk.__name__ == "_rows_topk"
