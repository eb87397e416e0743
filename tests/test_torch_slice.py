"""Port parity for the slice as a whole: ``FLRun.run_sync`` of the port
against the JAX package's ``FLRun.run_sync``.

Reduced AlexNet with ``mask_block=128`` (fc0: 8 blocks, fc1: 4 blocks, so
Eq. 2 selects whole blocks there), the Table-I 2 + 2 non-IID fleet, two
rounds of each paper sync scheme.  Both sides start from the same initial
params (the JAX run's, through the weight bridge) and the port draws its
Eq. 2 numbers through the JAX key-path backend.  The JAX side runs
``kernels="pallas"`` (interpret mode) for helios and ``"reference"`` for
the other schemes (the reference's own walls pin the two together); the
port runs ``kernels="cuda"``, whose autograd structure runs its plain
bodies on the CPU.

Expected: identical cycle/time/volumes/ratios history and accuracy,
identical straggler masks, params within atol 1e-5.
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
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.data.federated import partition_noniid  # noqa: E402
from repro_torch.data.synthetic import class_gaussian_images  # noqa: E402
from repro_torch.federated import FLRun, make_fleet, setup_clients  # noqa: E402
from repro_torch.kernels import masked_matmul as tK  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from test_torch_keys import jax_keys, share_jax_programs  # noqa: E402

ATOL = 1e-5
SCHEMES = ("helios", "syn", "st_only", "random")
RUN_KW = dict(local_steps=2, batch_size=8, lr=0.05, seed=0, eval_batch=64)


@pytest.fixture(scope="module")
def setting():
    imgs, labels = class_gaussian_images(256, 16, 3, 10, seed=0)
    ti, tl = class_gaussian_images(64, 16, 3, 10, seed=9)
    parts = partition_noniid(labels, 4, shards_per_client=4)
    return {"images": imgs, "labels": labels}, {"images": ti, "labels": tl}, \
        parts


@pytest.fixture(scope="module")
def runs(setting):
    train, test, parts = setting
    jcfg, tcfg = JC.reduced(JC.CNNS["alexnet"]), TC.reduced(TC.ALEXNET)
    jh, th = JC.HeliosConfig(mask_block=128), TC.HeliosConfig(mask_block=128)
    out = {}
    for scheme in SCHEMES:
        jrun = JaxFLRun(jcfg, jh, scheme,
                        j_setup_clients(j_make_fleet(2, 2), parts, jh),
                        train, test,
                        kernels="pallas" if scheme == "helios" else
                        "reference", **RUN_KW)
        share_jax_programs(jrun)
        init = {k: np.asarray(v)
                for k, v in jax.device_get(jrun.global_params).items()}
        jrun.run_sync(2)
        with jax_keys():
            trun = FLRun(tcfg, th, scheme,
                         setup_clients(make_fleet(2, 2), parts, th,
                                       device="cpu"),
                         train, test, kernels="cuda", device="cpu",
                         init_params=init, **RUN_KW)
            trun.run_sync(2)
        out[scheme] = jrun, trun
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_history_and_params_match_jax(runs, scheme):
    jrun, trun = runs[scheme]
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


@pytest.mark.parametrize("scheme", SCHEMES)
def test_straggler_masks_identical(runs, scheme):
    jrun, trun = runs[scheme]
    for jc, tc in zip(jrun.clients, trun.clients):
        assert jc.is_straggler == tc.is_straggler and jc.volume == tc.volume
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=f"{k}")
        np.testing.assert_array_equal(
            tc.helios_state["skip_counts"]["fc0"].numpy(),
            np.asarray(jc.helios_state["skip_counts"]["fc0"]))


@pytest.mark.parametrize("scheme", ["helios", "st_only", "random"])
def test_straggler_ratios_block_quantized(runs, scheme):
    """Soft-training stragglers train a sub-model (ratio < 1) whose fc0/fc1
    masks are block-constant at 128 with a whole number of live blocks."""
    _, trun = runs[scheme]
    for c, r in zip(trun.clients, trun.history[-1]["ratios"]):
        if not c.is_straggler:
            assert r == 1.0
            continue
        assert r < 1.0
        for k, n in (("fc0", 1024), ("fc1", 512)):
            blocks = c.helios_state["masks"][k].numpy().reshape(-1, 128)
            assert np.all(blocks.max(-1) == blocks.min(-1))
            assert 0 < blocks[:, 0].sum() < n // 128
    assert tK.LAUNCHES == {"masked_matmul": 0, "masked_matmul_dk": 0}


def test_pallas_alias_and_unknown_kernels(setting):
    train, test, parts = setting
    cfg, h = TC.reduced(TC.LENET), TC.HeliosConfig()
    kw = dict(local_steps=1, batch_size=4, device="cpu")
    run = FLRun(cfg, h, "syn", setup_clients(make_fleet(1, 1), parts[:2], h,
                                             device="cpu"),
                {"images": train["images"][..., :1], "labels": train["labels"]},
                test, kernels="pallas", **kw)
    assert run.kernels == "cuda"
    with pytest.raises(ValueError):
        FLRun(cfg, h, "syn", [], train, test, kernels="triton", **kw)
    with pytest.raises(ValueError):
        FLRun(cfg, h, "fedprox", [], train, test, **kw)


def test_entry_points_refuse_without_gpu(setting, monkeypatch):
    """No GPU and no explicit CPU request: the entry points raise instead
    of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, test, parts = setting
    h = TC.HeliosConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(TC.reduced(TC.ALEXNET), seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup_clients(make_fleet(2, 2), parts, h)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLRun(TC.reduced(TC.ALEXNET), h, "helios", [], train, test)
    assert repro_torch.__doc__
