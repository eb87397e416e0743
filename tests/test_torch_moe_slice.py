"""Port parity for the MoE slice: the MoE LM (``repro_torch.models.
transformer`` with ``models.moe``) and ``FLRun.run_sync`` on it, against
the JAX package, on ``reduced(granite-moe-1b-a400m)`` (4 MoE layers of 4
heads x 16 with 2 KV heads, 8 experts of 32 hidden units, top-2, tied
embeddings, d_model 64, vocab 256) and on a stack-scoped variant with
``first_k_dense=1`` and one shared expert (a dense first layer with d_ff
96, then 3 MoE layers; schema keys ``dense_blocks:heads``,
``moe_blocks:heads``, ``mlp``, ``experts``).

Model level: ``lm_loss`` and every gradient leaf at atol 1e-5, with and
without straggler masks, on the kernel path (``kernels="cuda"``, plain
bodies on the CPU) and the plain path; Eq. 1 unit scores at atol 1e-6
relative and parameter-space masks exactly, on the ``experts`` axis, the
router's ``(embed, experts)`` leaf and the prefix keys.

The slice, in tests/test_torch_lm_slice.py's setting: 240 Markov-topic
token streams of 32 over a 64-token alphabet, split by topic over a 2
capable + 2 Table-I straggler fleet, ``HeliosConfig(mask_block=16)``, 2
local steps of batch 4, lr 0.05, two rounds of helios, syn, st_only and
random under ``alpha_weighted``, helios under ``masked_mean``, and helios
on the variant; this file runs helios and the variant, and
tests/test_torch_moe_slice_baselines.py the other four.  Both sides start
from the JAX run's initial params; the port draws its Eq. 2 numbers
through the JAX key-path backend.  The JAX side runs
``kernels="reference"``, the port ``kernels="cuda"``.
Expected: identical cycle/time/volumes/ratios history, cross-entropy and
loss within 1e-5, identical straggler masks, params within atol 1e-5.
"""
import dataclasses
import functools
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
from repro.core import contribution as jC  # noqa: E402
from repro.core import masking as jMK  # noqa: E402
from repro.federated import FLRun as JaxFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
from repro.models import api as jAPI  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models.module import tree_paths  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import contribution as tC  # noqa: E402
from repro_torch.core import masking as tMK  # noqa: E402
from repro_torch.data.federated import partition_by_topic  # noqa: E402
from repro_torch.data.synthetic import markov_topic_tokens  # noqa: E402
from repro_torch.federated import FLRun, make_fleet, setup_clients  # noqa: E402
from repro_torch.kernels import flash_attention as tFA  # noqa: E402
from repro_torch.kernels import masked_matmul as tK  # noqa: E402
from repro_torch.models import build, logical_axes, make_full_masks  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.module import P  # noqa: E402
from test_torch_keys import jax_keys, share_jax_programs  # noqa: E402

ATOL = 1e-5
B, S = 2, 24
CFGS = {
    "granite": (JC.reduced(JC.ARCHS["granite-moe-1b-a400m"]),
                TC.reduced(TC.GRANITE_MOE_1B_A400M)),
}
CFGS["dense1_shared1"] = tuple(
    dataclasses.replace(c, first_k_dense=1, num_shared_experts=1)
    for c in CFGS["granite"])
SCHEMAS = {
    "granite": {"heads": (4, 4), "experts": (4, 8)},
    "dense1_shared1": {"dense_blocks:heads": (1, 4),
                       "moe_blocks:heads": (3, 4), "mlp": (1, 96),
                       "experts": (3, 8)},
}
#: case -> (config, scheme, aggregation)
CASES = {
    "helios": ("granite", "helios", "alpha_weighted"),
    "syn": ("granite", "syn", "alpha_weighted"),
    "st_only": ("granite", "st_only", "alpha_weighted"),
    "random": ("granite", "random", "alpha_weighted"),
    "helios-masked_mean": ("granite", "helios", "masked_mean"),
    "helios-dense1_shared1": ("dense1_shared1", "helios", "alpha_weighted"),
}
RUN_KW = dict(local_steps=2, batch_size=4, lr=0.05, seed=0, eval_batch=48)
#: the cases this file runs; test_torch_moe_slice_baselines.py runs the
#: rest, so two workers share the JAX runs
LOCAL_CASES = ("helios", "helios-dense1_shared1")


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _init(name):
    """The JAX initializer's params, jitted (one compile, not one a leaf)."""
    cfg = CFGS[name][0]
    return jax.device_get(jax.jit(lambda k: jAPI.init_params(k, cfg))(
        jax.random.PRNGKey(0)))


def _masks(name, seed):
    """Random unit masks on the schema (at least one unit per row)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in jT.mask_schema(CFGS[name][0]).items():
        m = (rng.random(shape) < 0.5).astype(np.float32)
        m[:, 0] = 1.0
        out[k] = m
    return out


@pytest.mark.parametrize("name", sorted(CFGS))
def test_config_and_schema_match_jax(name):
    jcfg, tcfg = CFGS[name]
    assert build(tcfg).mask_schema == jT.mask_schema(jcfg) == SCHEMAS[name]
    jaxes = dict(tree_paths(jAPI.logical_axes(jcfg),
                            is_leaf=lambda x: isinstance(x, tuple)))
    taxes = dict(tree_paths(logical_axes(tcfg),
                            is_leaf=lambda x: isinstance(x, tuple)))
    assert taxes == jaxes
    assert taxes["moe_blocks/moe/router"] == ("layers", "embed", "experts")
    # the nested moe leaves cross the weight bridge both ways unchanged
    jp = _init(name)
    tp = params_from_numpy(jp, device="cpu")
    assert {k: v.shape for k, v in tree_paths(jp)} == \
        {k: tuple(v.shape) for k, v in tree_paths(tp)}
    back = dict(tree_paths(params_to_numpy(tp)))
    for k, v in tree_paths(jp):
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_full_granite_schema_and_size():
    cfg = TC.GRANITE_MOE_1B_A400M
    jcfg = JC.ARCHS["granite-moe-1b-a400m"]
    assert build(cfg).mask_schema == jT.mask_schema(jcfg) == {
        "heads": (24, 16), "experts": (24, 32)}
    tshapes = {k: p.shape for k, p in tree_paths(
        build(cfg).spec, is_leaf=lambda v: isinstance(v, P))}
    jshapes = {k: tuple(v.shape)
               for k, v in tree_paths(jAPI.abstract_params(jcfg))}
    assert tshapes == jshapes
    # the reference's count leaves out the 49 norm scales of 1024
    n = sum(int(np.prod(s)) for s in tshapes.values())
    assert n == jcfg.n_params() + 49 * 1024 == 1_334_756_352


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(name, masked):
    jcfg = CFGS[name][0]
    rt = jAPI.default_runtime(jcfg)
    masks = {k: jnp.asarray(v) for k, v in _masks(name, 5).items()} \
        if masked else None
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, S))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jT.lm_loss(p, batch, jcfg, rt, masks)))(_init(name))
    return float(loss), dict(tree_paths(jax.device_get(grads))), tokens


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("kernels", ["cuda", "reference"])
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_and_grads_match_jax(name, masked, kernels):
    """The loss and every gradient leaf.  Under straggler masks the
    masked-out experts and heads (and the dense layer's MLP units) get
    exactly-zero gradients."""
    jloss, jgrads, tokens = _jax_loss_grads(name, masked)
    tcfg = CFGS[name][1]
    tp = params_from_numpy(_init(name), device="cpu")
    leaves = dict(tree_paths(tp))
    for v in leaves.values():
        v.requires_grad_(True)
    rt = tT.default_runtime()
    rt["kernels"], rt["mask_block"] = kernels, 16
    masks = {k: torch.tensor(v) for k, v in _masks(name, 5).items()} \
        if masked else None
    loss = tT.lm_loss(tp, {"tokens": torch.tensor(tokens)}, tcfg, rt, masks)
    assert abs(float(loss.detach()) - jloss) <= ATOL
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(_np(g), jgrads[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    if masked:
        m = _masks(name, 5)
        dead = m["experts"] == 0                          # (L, E)
        for leaf in ("wi", "wg", "wo"):
            g = _np(grads[f"moe_blocks/moe/{leaf}"])      # (L, E, ., .)
            assert np.all(g[dead] == 0), leaf
        wq = _np(grads["moe_blocks/attn/wq"])             # (L, d, H, hd)
        hk = "heads" if "heads" in m else "moe_blocks:heads"
        assert np.all(wq.transpose(0, 2, 1, 3)[m[hk] == 0] == 0)
        if "mlp" in m:
            wi = _np(grads["dense_blocks/mlp/wi"])        # (1, d, d_ff)
            assert np.all(wi.transpose(0, 2, 1)[m["mlp"] == 0] == 0)


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("masked", [False, True])
def test_unit_scores_and_expand_masks_match_jax(name, masked):
    """Eq. 1 scores and parameter-space masks on the MoE schema: the
    ``experts`` axis of wi / wg / wo and of the router's (embed, experts)
    leaf, and the stack-scoped head keys of the variant."""
    jcfg, tcfg = CFGS[name]
    rng = np.random.default_rng(6)
    d = jax.tree.map(lambda v: rng.normal(size=v.shape).astype(np.float32),
                     _init(name))
    schema = jT.mask_schema(jcfg)
    want = jC.unit_scores(d, jAPI.logical_axes(jcfg), schema)
    got = tC.unit_scores(params_from_numpy(d, device="cpu"),
                         logical_axes(tcfg), build(tcfg).mask_schema)
    for k in schema:
        assert tuple(got[k].shape) == schema[k]
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=0,
                                   atol=1e-6 * float(np.abs(want[k]).max()),
                                   err_msg=k)
    # the expert score counts the router column too
    router = np.abs(d["moe_blocks"]["moe"]["router"]).sum(axis=1)
    experts = sum(np.abs(d["moe_blocks"]["moe"][leaf]).sum(axis=(2, 3))
                  for leaf in ("wi", "wg", "wo"))
    np.testing.assert_allclose(_np(got["experts"]), router + experts,
                               rtol=1e-5)
    um = _masks(name, 7) if masked else {
        k: np.asarray(v) for k, v in jAPI.make_full_masks(jcfg).items()}
    jm = jMK.expand_masks(jAPI.logical_axes(jcfg),
                          {k: jnp.asarray(v) for k, v in um.items()}, d)
    tm = tMK.expand_masks(logical_axes(tcfg),
                          {k: torch.tensor(v) for k, v in um.items()},
                          params_from_numpy(d, device="cpu"))
    jflat, tflat = dict(tree_paths(jm)), dict(tree_paths(tm))
    assert set(jflat) == set(tflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(_np(tflat[k]), np.asarray(v),
                                      err_msg=k)
    if masked:                  # every unit type reached its parameters
        paths = ["moe_blocks/moe/router", "moe_blocks/moe/wi",
                 "moe_blocks/moe/wo", "moe_blocks/attn/wq"]
        if "mlp" in um:
            paths += ["dense_blocks/attn/wq", "dense_blocks/mlp/wi"]
        for path in paths:
            assert float(tflat[path].min()) == 0.0, path
    else:
        assert all(bool((t == 1).all()) for t in tflat.values())
        assert all(bool((v == 1).all())
                   for v in make_full_masks(tcfg, "cpu").values())


# ---------------------------------------------------------------------------
# the slice: FLRun.run_sync on the MoE LM
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setting():
    tokens, topics = markov_topic_tokens(240, 32, 64, n_topics=8, seed=0)
    test_tokens, _ = markov_topic_tokens(64, 32, 64, n_topics=8, seed=9)
    parts = partition_by_topic(topics, 4, topics_per_client=2)
    return {"tokens": tokens}, {"tokens": test_tokens}, parts


def _run(case, setting):
    train, test, parts = setting
    name, scheme, agg = CASES[case]
    jcfg, tcfg = CFGS[name]
    jh = JC.HeliosConfig(mask_block=16, aggregation=agg)
    th = TC.HeliosConfig(mask_block=16, aggregation=agg)
    jrun = JaxFLRun(jcfg, jh, scheme,
                    j_setup_clients(j_make_fleet(2, 2), parts, jh),
                    train, test, kernels="reference", **RUN_KW)
    share_jax_programs(jrun)
    init = jax.device_get(jrun.global_params)
    jrun.run_sync(2)
    with jax_keys():
        trun = FLRun(tcfg, th, scheme,
                     setup_clients(make_fleet(2, 2), parts, th, device="cpu"),
                     train, test, kernels="cuda", device="cpu",
                     init_params=init, **RUN_KW)
        trun.run_sync(2)
    return jrun, trun


def lazy_runs(setting):
    """case -> (JAX run, port run), each made on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run(case, setting)
        return cache[case]
    return get


@pytest.fixture(scope="module")
def runs(setting):
    return lazy_runs(setting)


def check_history_and_params(jrun, trun):
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


def check_straggler_masks(jrun, trun):
    for jc, tc in zip(jrun.clients, trun.clients):
        assert jc.is_straggler == tc.is_straggler and jc.volume == tc.volume
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=k)
            np.testing.assert_array_equal(
                tc.helios_state["skip_counts"][k].numpy(),
                np.asarray(jc.helios_state["skip_counts"][k]), err_msg=k)


@pytest.mark.parametrize("case", LOCAL_CASES)
def test_history_and_params_match_jax(runs, case):
    check_history_and_params(*runs(case))


@pytest.mark.parametrize("case", LOCAL_CASES)
def test_straggler_masks_identical(runs, case):
    check_straggler_masks(*runs(case))


def test_helios_stragglers_train_sub_models(runs):
    """Soft-training stragglers train a sub-model (ratio < 1) over both
    unit types, heads and experts; no CUDA kernel launched on the CPU."""
    tK.reset_launches()
    tFA.reset_launches()
    for case in ("helios", "helios-dense1_shared1"):
        _, trun = runs(case)
        for c, r in zip(trun.clients, trun.history[-1]["ratios"]):
            if not c.is_straggler:
                assert r == 1.0
                continue
            assert r < 1.0
            masks = c.helios_state["masks"]
            assert 0 < float(masks["experts"].sum()) < \
                masks["experts"].numel()
    assert tK.LAUNCHES == {"masked_matmul": 0, "masked_matmul_dk": 0}
    assert tFA.LAUNCHES == {"flash_attention": 0}


def test_make_adapter_dispatch_moe():
    from repro_torch.federated.adapter import TokenLMAdapter, make_adapter
    ad = make_adapter(CFGS["granite"][1], "cuda", 16, torch.device("cpu"))
    assert isinstance(ad, TokenLMAdapter) and ad.metric_name == "ce"
    assert ad.rt["kernels"] == "cuda" and ad.eval_rt["kernels"] == "reference"
    assert (ad.rt["moe_impl"], ad.rt["moe_groups"]) == ("grouped", 1)
    assert ad.schema == SCHEMAS["granite"]


def test_mla_and_vlm_refused():
    """MLA is not refused: the LM and ``reduced`` take DeepSeek-V2's latent
    attention (its parity walls are tests/test_torch_mla.py), and a MoE
    config with ``use_mla`` gets the reference's reduced latent sizes and
    MLA's leaves in place of the GQA projections.  The VLM is ported (the
    image prefix, since the training launch) but, as in the reference, has
    no FL adapter: the engines refuse it."""
    from repro_torch.federated.adapter import make_adapter
    base = CFGS["granite"][1]
    mla_cfg = TC.reduced(dataclasses.replace(
        TC.GRANITE_MOE_1B_A400M, use_mla=True, q_lora_rank=1536,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128))
    assert (mla_cfg.q_lora_rank, mla_cfg.kv_lora_rank,
            mla_cfg.qk_nope_head_dim, mla_cfg.qk_rope_head_dim,
            mla_cfg.v_head_dim) == (32, 16, 16, 8, 16)
    attn = build(mla_cfg).spec["moe_blocks"]["attn"]
    assert set(attn) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm",
                         "wk_b", "wv_b", "wo"}
    assert build(mla_cfg).mask_schema == build(base).mask_schema
    vlm = TC.reduced(TC.INTERNVL2_1B)
    assert build(vlm).mask_schema == {"heads": (4, 4), "mlp": (4, 96)}
    with pytest.raises(NotImplementedError, match="supported families"):
        make_adapter(vlm, "cuda", 16, torch.device("cpu"))


def test_batched_engines_refuse_moe():
    """The batched and bucketed async engines run the CNN testbed only."""
    from repro_torch.federated import AsyncFLRun, BatchedFLRun
    tokens = np.zeros((8, 33), np.int32)
    for cls in (BatchedFLRun, AsyncFLRun):
        with pytest.raises(NotImplementedError, match="moe family"):
            cls(CFGS["granite"][1], TC.HeliosConfig(), "helios", [],
                {"tokens": tokens}, {"tokens": tokens}, device="cpu")


def test_unstack_gradients_match_layer_indexing():
    """``module.unstack`` (one ``unbind`` a leaf) gives the same layers and
    bit-identical stacked gradients as indexing each layer."""
    from repro_torch.models.module import tree_map, unstack
    tp = params_from_numpy(_init("granite"), device="cpu")["moe_blocks"]
    leaves = dict(tree_paths(tp))
    g = torch.Generator().manual_seed(0)
    weights = {k: torch.randn(v.shape[1:], generator=g)
               for k, v in leaves.items()}
    grads = []
    for split in (lambda t, n: unstack(t, n),
                  lambda t, n: [tree_map(lambda v: v[i], t)
                                for i in range(n)]):
        for v in leaves.values():
            v.requires_grad_(True)
        layers = split(tp, 4)
        loss = sum((dict(tree_paths(p))[k] * weights[k]).sum() * (i + 1)
                   for i, p in enumerate(layers) for k in weights)
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    for k, a, b in zip(leaves, *grads):
        assert torch.equal(a, b), k
