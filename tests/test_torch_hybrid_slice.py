"""Port parity for the hybrid slice: the Mamba2 + shared-attention model
(``repro_torch.models.hybrid``) and ``FLRun.run_sync`` on it, against the
JAX package, on ``reduced(zamba2-1.2b)`` (4 Mamba2 layers of 8 heads x 16
with state 16 and chunk 32, the shared block of 4 heads and d_ff 96 before
layers 0 and 2, d_model 64, vocab 256).

Model level: ``hybrid_loss`` and every gradient leaf at atol 1e-5, with and
without straggler masks, on the kernel path (``kernels="cuda"``, plain
bodies on the CPU) and the plain path; Eq. 1 unit scores at atol 1e-6
relative, parameter-space masks exactly, and Eq. 2 masks on the
{"ssm_heads", "heads", "mlp"} schema bit for bit under the test-only JAX
key-path backend.  The shared block's parameters are not stacked: its
``heads`` and ``mlp`` units are (1, n) rows.

The slice: 240 Markov-topic token streams of 64 (two SSD chunks of 32)
over a 64-token alphabet, split by topic over a 2 capable + 2 Table-I
straggler fleet, ``HeliosConfig(mask_block=16)`` (the d_ff of 96 pools
into 6 blocks; the 8 SSM heads and 4 attention heads stay unit-granular),
2 local steps of batch 4, lr 0.05, two rounds of helios and of syn.  Both
sides start from the JAX run's initial params; the JAX side runs
``kernels="reference"`` (its hybrid reaches no Pallas kernel), the port
``kernels="cuda"``.  Expected: identical cycle/time/volumes/ratios
history, cross-entropy and loss within 1e-5, identical straggler masks,
params within atol 1e-5.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.core import contribution as jC  # noqa: E402
from repro.core import masking as jMK  # noqa: E402
from repro.core import selection as jS  # noqa: E402
from repro.federated import FLRun as JaxFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
from repro.models import api as jAPI  # noqa: E402
from repro.models import hybrid as jH  # noqa: E402
from repro.models.module import tree_paths  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import contribution as tC  # noqa: E402
from repro_torch.core import keys as KY  # noqa: E402
from repro_torch.core import masking as tMK  # noqa: E402
from repro_torch.core import selection as tS  # noqa: E402
from repro_torch.data.federated import partition_by_topic  # noqa: E402
from repro_torch.data.synthetic import markov_topic_tokens  # noqa: E402
from repro_torch.federated import FLRun, make_fleet, setup_clients  # noqa: E402
from repro_torch.kernels import flash_attention as tFA  # noqa: E402
from repro_torch.kernels import masked_matmul as tK  # noqa: E402
from repro_torch.kernels import ssd_scan as tSS  # noqa: E402
from repro_torch.models import build, logical_axes, make_full_masks  # noqa: E402
from repro_torch.models import hybrid as tH  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from test_torch_keys import (_jax_key, jax_keys,  # noqa: E402
                             share_jax_programs)

ATOL = 1e-5
B, S = 2, 64
JCFG = JC.reduced(JC.ARCHS["zamba2-1.2b"])
TCFG = TC.reduced(TC.ZAMBA2_1_2B)
SCHEMES = ("helios", "syn")
RUN_KW = dict(local_steps=2, batch_size=4, lr=0.05, seed=0, eval_batch=48)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _init():
    return jax.device_get(jAPI.init_params(jax.random.PRNGKey(0), JCFG))


def _masks(seed):
    """Random unit masks on the hybrid schema (at least one unit per row)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in jH.mask_schema(JCFG).items():
        m = (rng.random(shape) < 0.5).astype(np.float32)
        m[:, 0] = 1.0
        out[k] = m
    return out


def test_config_and_schema_match_jax():
    for cfg, jcfg in ((TCFG, JCFG), (TC.ZAMBA2_1_2B, JC.ARCHS["zamba2-1.2b"])):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert build(TCFG).mask_schema == jH.mask_schema(JCFG) == {
        "ssm_heads": (4, 8), "heads": (1, 4), "mlp": (1, 96)}
    assert build(TC.ZAMBA2_1_2B).mask_schema == {
        "ssm_heads": (38, 64), "heads": (1, 32), "mlp": (1, 8192)}
    jaxes = dict(tree_paths(jAPI.logical_axes(JCFG),
                            is_leaf=lambda x: isinstance(x, tuple)))
    taxes = dict(tree_paths(logical_axes(TCFG),
                            is_leaf=lambda x: isinstance(x, tuple)))
    assert taxes == jaxes
    # the nested tree (mamba/*, mamba_norms/*, shared_attn/{attn,mlp}/*)
    # crosses the weight bridge both ways unchanged
    jp = _init()
    tp = params_from_numpy(jp, device="cpu")
    assert {k: v.shape for k, v in tree_paths(jp)} == \
        {k: tuple(v.shape) for k, v in tree_paths(tp)}
    back = dict(tree_paths(params_to_numpy(tp)))
    for k, v in tree_paths(jp):
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(masked):
    rt = jAPI.default_runtime(JCFG)
    masks = {k: jnp.asarray(v) for k, v in _masks(5).items()} \
        if masked else None
    tokens = np.random.default_rng(5).integers(0, JCFG.vocab_size, (B, S))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jH.hybrid_loss(p, batch, JCFG, rt, masks)))(_init())
    return float(loss), dict(tree_paths(jax.device_get(grads))), tokens


@pytest.mark.parametrize("kernels", ["cuda", "reference"])
@pytest.mark.parametrize("masked", [False, True])
def test_hybrid_loss_and_grads_match_jax(masked, kernels):
    """The loss and every gradient leaf; the shared block's gradient sums
    its two invocations.  Under straggler masks the masked-out SSM heads,
    attention heads and MLP units get exactly-zero gradients."""
    jloss, jgrads, tokens = _jax_loss_grads(masked)
    tp = params_from_numpy(_init(), device="cpu")
    leaves = dict(tree_paths(tp))
    for v in leaves.values():
        v.requires_grad_(True)
    rt = tT.default_runtime()
    rt["kernels"], rt["mask_block"] = kernels, 16
    masks = {k: torch.tensor(v) for k, v in _masks(5).items()} \
        if masked else None
    loss = tH.hybrid_loss(tp, {"tokens": torch.tensor(tokens)}, TCFG, rt,
                          masks)
    assert abs(float(loss.detach()) - jloss) <= ATOL
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(_np(g), jgrads[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    if masked:
        m = _masks(5)
        wx = _np(grads["mamba/wx"])                       # (L, d, nh, hd)
        assert np.all(wx.transpose(0, 2, 1, 3)[m["ssm_heads"] == 0] == 0)
        wq = _np(grads["shared_attn/attn/wq"])            # (d, H, hd)
        assert np.all(wq[:, m["heads"][0] == 0] == 0)
        wi = _np(grads["shared_attn/mlp/wi"])             # (d, d_ff)
        assert np.all(wi[:, m["mlp"][0] == 0] == 0)


@pytest.mark.parametrize("masked", [False, True])
def test_unit_scores_and_expand_masks_match_jax(masked):
    """Eq. 1 scores and parameter-space masks on the hybrid schema: the
    stacked ``ssm_heads`` rows and the unstacked shared block's (1, n)
    ``heads`` and ``mlp`` rows."""
    rng = np.random.default_rng(6)
    d = jax.tree.map(lambda v: rng.normal(size=v.shape).astype(np.float32),
                     _init())
    schema = jH.mask_schema(JCFG)
    want = jC.unit_scores(d, jAPI.logical_axes(JCFG), schema)
    got = tC.unit_scores(params_from_numpy(d, device="cpu"),
                         logical_axes(TCFG), build(TCFG).mask_schema)
    for k in schema:
        assert tuple(got[k].shape) == schema[k]
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=0,
                                   atol=1e-6 * float(np.abs(want[k]).max()),
                                   err_msg=k)
    um = _masks(7) if masked else {
        k: np.asarray(v) for k, v in jAPI.make_full_masks(JCFG).items()}
    jm = jMK.expand_masks(jAPI.logical_axes(JCFG),
                          {k: jnp.asarray(v) for k, v in um.items()}, d)
    tm = tMK.expand_masks(logical_axes(TCFG),
                          {k: torch.tensor(v) for k, v in um.items()},
                          params_from_numpy(d, device="cpu"))
    jflat, tflat = dict(tree_paths(jm)), dict(tree_paths(tm))
    assert set(jflat) == set(tflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(_np(tflat[k]), np.asarray(v),
                                      err_msg=k)
    if masked:                  # every unit type reached its parameters
        for path in ("mamba/wx", "shared_attn/attn/wq",
                     "shared_attn/mlp/wi"):
            assert float(tflat[path].min()) == 0.0, path
    else:
        assert all(bool((t == 1).all()) for t in tflat.values())
        assert all(bool((v == 1).all())
                   for v in make_full_masks(TCFG, "cpu").values())


j_select = jax.jit(jS.select_masks, static_argnames=("p_s", "block"))


def test_select_masks_hybrid_schema_bit_identical():
    """ssm_heads (n = 8) and heads (n = 4) draw unit-granular, mlp
    (n = 96) block-pooled at 16, in one call."""
    rng = np.random.default_rng(8)
    schema = jH.mask_schema(JCFG)
    scores = {k: rng.random(s).astype(np.float32) for k, s in schema.items()}
    forced = {k: rng.random(s) < 0.1 for k, s in schema.items()}
    for i, volume in enumerate((0.125, 0.4, 0.75, 1.0)):
        key = KY.key(12).fold_in(i)
        want = j_select({k: jnp.asarray(v) for k, v in scores.items()},
                        {k: jnp.asarray(v) for k, v in forced.items()},
                        jnp.asarray(volume, jnp.float32), p_s=0.1,
                        key=_jax_key(key.path), block=16)
        with jax_keys():
            got = tS.select_masks({k: torch.tensor(v) for k, v in
                                   scores.items()},
                                  {k: torch.tensor(v) for k, v in
                                   forced.items()}, volume, 0.1, key,
                                  block=16)
        for k in schema:
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                          err_msg=f"{k} P={volume}")


# ---------------------------------------------------------------------------
# the slice: FLRun.run_sync on the hybrid
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setting():
    tokens, topics = markov_topic_tokens(240, S, 64, n_topics=8, seed=0)
    test_tokens, _ = markov_topic_tokens(64, S, 64, n_topics=8, seed=9)
    parts = partition_by_topic(topics, 4, topics_per_client=2)
    return {"tokens": tokens}, {"tokens": test_tokens}, parts


@pytest.fixture(scope="module")
def runs(setting):
    train, test, parts = setting
    jh, th = JC.HeliosConfig(mask_block=16), TC.HeliosConfig(mask_block=16)
    tK.reset_launches()
    tFA.reset_launches()
    tSS.reset_launches()
    out = {}
    for scheme in SCHEMES:
        jrun = JaxFLRun(JCFG, jh, scheme,
                        j_setup_clients(j_make_fleet(2, 2), parts, jh),
                        train, test, kernels="reference", **RUN_KW)
        share_jax_programs(jrun)
        init = jax.device_get(jrun.global_params)
        jrun.run_sync(2)
        with jax_keys():
            trun = FLRun(TCFG, th, scheme,
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
        assert abs(t["ce"] - j["ce"]) <= ATOL
        assert abs(t["loss"] - j["loss"]) <= ATOL
    tparams = dict(tree_paths(trun.global_params))
    jparams = dict(tree_paths(jax.device_get(jrun.global_params)))
    assert set(tparams) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_allclose(tparams[k].numpy(), v, rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_straggler_masks_identical(runs, scheme):
    jrun, trun = runs[scheme]
    for jc, tc in zip(jrun.clients, trun.clients):
        assert jc.is_straggler == tc.is_straggler and jc.volume == tc.volume
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=k)
            np.testing.assert_array_equal(
                tc.helios_state["skip_counts"][k].numpy(),
                np.asarray(jc.helios_state["skip_counts"][k]), err_msg=k)


def test_helios_stragglers_train_sub_models(runs):
    """Soft-training stragglers train a sub-model (ratio < 1) over every
    unit type; no CUDA kernel launched on the CPU."""
    _, trun = runs["helios"]
    for c, r in zip(trun.clients, trun.history[-1]["ratios"]):
        if not c.is_straggler:
            assert r == 1.0
            continue
        assert r < 1.0
        masks = c.helios_state["masks"]
        for k in ("ssm_heads", "heads", "mlp"):
            assert 0 < float(masks[k].sum()) < masks[k].numel(), k
        blocks = masks["mlp"].numpy().reshape(1, -1, 16)
        assert np.all(blocks.max(-1) == blocks.min(-1))
    assert tSS.LAUNCHES == {"ssd_diag": 0}
    assert tK.LAUNCHES == {"masked_matmul": 0, "masked_matmul_dk": 0}
    assert tFA.LAUNCHES == {"flash_attention": 0}


def test_make_adapter_dispatch_hybrid():
    from repro_torch.federated.adapter import TokenLMAdapter, make_adapter
    ad = make_adapter(TCFG, "cuda", 16, torch.device("cpu"))
    assert isinstance(ad, TokenLMAdapter) and ad.metric_name == "ce"
    assert ad.rt["kernels"] == "cuda" and ad.eval_rt["kernels"] == "reference"
    assert ad.schema == {"ssm_heads": (4, 8), "heads": (1, 4), "mlp": (1, 96)}


def test_hybrid_entry_points_refuse_without_gpu(setting, monkeypatch):
    """No GPU and no explicit CPU request: the hybrid's entry points raise
    instead of quietly running on the CPU."""
    from repro_torch.models import init_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, test, parts = setting
    h = TC.HeliosConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(TCFG, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_full_masks(TCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup_clients(make_fleet(2, 2), parts, h)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLRun(TCFG, h, "helios", [], train, test)


def test_hybrid_modules_import_with_jax_blocked():
    """The hybrid slice's modules import in a process where ``jax`` and the
    JAX package cannot be imported (test_torch_imports.py checks every
    port file's import statements)."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.kernels.ssd_scan\n"
        "from repro_torch.configs import ZAMBA2_1_2B, reduced\n"
        "from repro_torch.models import build, hybrid, ssm\n"
        "from repro_torch.federated.adapter import make_adapter\n"
        "assert build(reduced(ZAMBA2_1_2B)).mask_schema\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
