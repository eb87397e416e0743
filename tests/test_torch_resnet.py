"""Port parity: ResNet-18 (``repro_torch.models.cnn``) against the JAX
package's ``repro.models.cnn``.

Reduced ResNet-18 (stage widths 8/16/32/64, 100 classes) with the same
numpy-drawn params carried into the port by the weight bridge and the same
numpy batch.  Logits agree at atol 1e-5 and loss gradients within 1e-4
of the largest gradient entry, with and without a straggler's masks, on an
even image side (16: stride-2 SAME pads 0 before and 1 after) and an odd
one (15: symmetric).  Then ``run_sync(2)`` of helios and syn on a 2 + 2
Table-I non-IID fleet against the JAX ``FLRun``: identical history and
straggler masks, params within atol 1e-5.  ResNet-18 masks conv filters
only, so neither run launches a masked kernel.
"""
import dataclasses
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
from repro.federated import FLRun as JaxFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
from repro.models import abstract_params  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import bridge  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.data.federated import partition_noniid  # noqa: E402
from repro_torch.data.synthetic import class_gaussian_images  # noqa: E402
from repro_torch.federated import FLRun, make_fleet, setup_clients  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from test_torch_keys import jax_keys, share_jax_programs  # noqa: E402

ATOL = 1e-5
GRAD_RTOL = 1e-4
RUN_KW = dict(local_steps=2, batch_size=8, lr=0.05, seed=0, eval_batch=64)


def _cfgs(side):
    jcfg = dataclasses.replace(JC.reduced(JC.CNNS["resnet18"]),
                               image_size=side)
    tcfg = dataclasses.replace(TC.reduced(TC.RESNET18), image_size=side)
    return jcfg, tcfg


def _params(tcfg, seed=1):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=p.shape) / np.sqrt(
        np.prod(p.shape[:-1]) if len(p.shape) > 1 else 1.0)).astype(np.float32)
        for k, p in tcnn.cnn_spec(tcfg).items()}


def _masks(schema, seed=2):
    rng = np.random.default_rng(seed)
    out = {}
    for k, (_, n) in sorted(schema.items()):
        m = (rng.random(n) < 0.6).astype(np.float32)
        m[0] = 1.0
        out[k] = m[None]
    return out


def test_spec_and_schema_match_reference():
    jcfg, tcfg = _cfgs(16)
    assert {k: p.shape for k, p in tcnn.cnn_spec(tcfg).items()} == \
        {k: v.shape for k, v in abstract_params(jcfg).items()}
    assert tcnn.cnn_mask_schema(tcfg) == jcnn.cnn_mask_schema(jcfg)
    full_j, full_t = JC.CNNS["resnet18"], TC.RESNET18
    assert {k: p.shape for k, p in tcnn.cnn_spec(full_t).items()} == \
        {k: v.shape for k, v in abstract_params(full_j).items()}
    assert tcnn.cnn_mask_schema(full_t) == jcnn.cnn_mask_schema(full_j)
    n = sum(int(np.prod(p.shape)) for p in tcnn.cnn_spec(full_t).values())
    assert 11_000_000 < n < 11_300_000


@pytest.mark.parametrize("side", [16, 15], ids=["even", "odd"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "straggler"])
def test_logits_and_grads_match_jax(side, masked):
    jcfg, tcfg = _cfgs(side)
    params = _params(tcfg)
    rng = np.random.default_rng(3)
    images = rng.normal(size=(4, side, side, 3)).astype(np.float32)
    labels = rng.integers(0, 100, size=4).astype(np.int32)
    masks = _masks(tcnn.cnn_mask_schema(tcfg)) if masked else None

    jm = None if masks is None else {k: jnp.asarray(v)
                                     for k, v in masks.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jb = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    jl = np.asarray(jcnn.cnn_logits(jp, jb["images"], jcfg, jm))
    jg = jax.grad(jcnn.cnn_loss)(jp, jb, jcfg, None, jm)

    tp = {k: v.requires_grad_(True)
          for k, v in bridge.params_from_numpy(params, "cpu").items()}
    tm = None if masks is None else {k: torch.tensor(v)
                                     for k, v in masks.items()}
    tb = {"images": torch.tensor(images), "labels": torch.tensor(labels)}
    tl = tcnn.cnn_logits(tp, tb["images"], tcfg, tm, "cuda")
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=0, atol=ATOL)
    loss = tcnn.cnn_loss(tp, tb, tcfg, {"kernels": "cuda"}, tm)
    tg = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    assert set(tg) == set(jg)
    # relative to the largest gradient entry: a conv bias in front of a
    # GroupNorm of one channel a group has a true gradient of zero, which
    # both sides compute as rounding noise of ~1e-7
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jg.values())
    for k, v in jg.items():
        diff = float(np.abs(tg[k].numpy() - np.asarray(v)).max())
        assert diff <= GRAD_RTOL * scale, (k, diff, scale)


def test_stride2_same_padding_rule():
    """Even side, 3x3 at stride 2: 0 before and 1 after; odd side: 1 and 1;
    the 1x1 projection at stride 2 pads nothing."""
    assert tcnn._same_pad(16, 3, 2) == (0, 1)
    assert tcnn._same_pad(15, 3, 2) == (1, 1)
    assert tcnn._same_pad(16, 1, 2) == (0, 0)
    assert tcnn._same_pad(16, 3, 1) == (1, 1)
    assert tcnn._same_pad(28, 5, 1) == (2, 2)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 16, 5)).astype(np.float32)
    w = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    want = np.asarray(jcnn.conv2d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), stride=2))
    got = tcnn.conv2d(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(w),
                      torch.tensor(b), stride=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("c,groups", [(12, 6), (64, 8), (4, 4), (7, 7)])
def test_group_norm_group_rule(c, groups):
    """min(8, C) groups, decremented until they divide C (12 -> 6), of
    consecutive channels, against the reference's NHWC reshape."""
    assert tcnn._groups(c) == groups
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 5, 6, c)) * 2 + 1).astype(np.float32)
    want = np.asarray(jcnn.group_norm(jnp.asarray(x)))
    got = tcnn.group_norm(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=ATOL)
    if groups != c:            # other groupings give other numbers
        other = torch.nn.functional.group_norm(
            torch.tensor(x).permute(0, 3, 1, 2), c, eps=1e-5)
        assert np.abs(other.permute(0, 2, 3, 1).numpy() - want).max() > 0.1


def test_avg_pool_shortcut_matches_reference():
    """The avg-pool shortcut (stride 2 with cin == w), which the published
    widths never reach, against the reference's reduce_window."""
    x = np.random.default_rng(6).normal(size=(2, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jcnn.avg_pool(jnp.asarray(x), 2))
    got = tcnn.avg_pool(torch.tensor(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = _cfgs(16)
    imgs, labels = class_gaussian_images(256, 16, 3, 100, seed=0)
    ti, tl = class_gaussian_images(64, 16, 3, 100, seed=9)
    parts = partition_noniid(labels, 4, shards_per_client=4)
    train, test = {"images": imgs, "labels": labels}, \
        {"images": ti, "labels": tl}
    jh, th = JC.HeliosConfig(mask_block=128), TC.HeliosConfig(mask_block=128)
    out = {}
    calls = []
    real = tops.masked_dense
    mp = pytest.MonkeyPatch()
    mp.setattr(tops, "masked_dense",
               lambda *a, **kw: calls.append(1) or real(*a, **kw))
    for scheme in ("helios", "syn"):
        jrun = JaxFLRun(jcfg, jh, scheme,
                        j_setup_clients(j_make_fleet(2, 2), parts, jh),
                        train, test, **RUN_KW)
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
    mp.undo()
    out["masked_dense_calls"] = len(calls)
    return out


@pytest.mark.parametrize("scheme", ["helios", "syn"])
def test_run_sync_matches_jax(runs, scheme):
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
    for jc, tc in zip(jrun.clients, trun.clients):
        assert jc.is_straggler == tc.is_straggler and jc.volume == tc.volume
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=k)
    if scheme == "helios":
        ratios = trun.history[-1]["ratios"]
        assert all(r < 1.0 for c, r in zip(trun.clients, ratios)
                   if c.is_straggler)
    # no call site: the masked dense op (and so its kernels) is never
    # reached, though the run asked for kernels="cuda"
    assert trun.kernels == "cuda" and runs["masked_dense_calls"] == 0
