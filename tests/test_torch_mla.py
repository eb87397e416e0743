"""Port parity for DeepSeek-V2: Multi-head Latent Attention
(``repro_torch.models.mla``) and the MoE LM around it against the JAX
package, on ``reduced(deepseek-v2-236b)`` (d_model 64, 4 heads, q / kv
latent ranks 32 / 16, q-k head dims 16 + 8 RoPE, value head dim 16; a
dense first layer with d_ff 96, then 3 MoE layers of 8 experts of 32
hidden units, top-2, 2 shared experts; vocab 256), params drawn with
numpy from a seed and bridged to both packages.

* ``mla_fwd`` (its latent cache too) and the absorbed ``mla_decode``
  against JAX's at atol 1e-5, with and without a head mask;
* the port's prefill and absorbed decode against JAX's at 1e-5, and
  prefill + decode against one longer prefill: at the reference's own
  tolerance (atol 5e-3) with the default grouped expert dispatch, at
  1e-5 with the capacity-free dense one;
* ``lm_loss`` and every gradient against JAX at 1e-4, masked and not, on
  the kernel path (plain bodies on the CPU) and the plain path; the dense
  first layer's masked MLP against JAX's ``kernels="pallas"`` (the
  masked-matmul pair in Pallas interpret mode), forward and gradients;
* Eq. 1 scores and parameter-space masks on MLA's leaves, whose head axis
  is in the middle;
* ``FLRun.run_sync(2)`` of helios and syn in tests/test_torch_lm_slice.py's
  setting (``HeliosConfig(mask_block=16)``, a 2 + 2 fleet, 2 local steps
  of batch 4, lr 0.05) against JAX's ``FLRun``: history, straggler masks,
  params within 1e-5;
* three ``make_train_step`` steps (Helios at volume 0.5, grad-EMA scores,
  AdamW) against JAX's.

The port's Eq. 2 draws go through the JAX key-path backend.
"""
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
from repro.core import soft_train as jST  # noqa: E402
from repro.federated import FLRun as JaxFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
from repro.launch import steps as jS  # noqa: E402
from repro.models import api as jAPI  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import mla as jMLA  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models.module import tree_paths  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import contribution as tC  # noqa: E402
from repro_torch.core import masking as tMK  # noqa: E402
from repro_torch.core import soft_train as ST  # noqa: E402
from repro_torch.data.federated import partition_by_topic  # noqa: E402
from repro_torch.data.synthetic import markov_topic_tokens  # noqa: E402
from repro_torch.federated import FLRun, make_fleet, setup_clients  # noqa: E402
from repro_torch.launch import serve as SV  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import build, default_runtime, logical_axes  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import mla as tMLA  # noqa: E402
from repro_torch.models.module import P, unflatten  # noqa: E402
from test_torch_keys import jax_keys, share_jax_programs  # noqa: E402

ARCH = "deepseek-v2-236b"
JCFG, TCFG = JC.reduced(JC.ARCHS[ARCH]), TC.reduced(TC.ARCHS[ARCH])
SCHEMA = {"dense_blocks:heads": (1, 4), "moe_blocks:heads": (3, 4),
          "mlp": (1, 96), "experts": (3, 8)}
ATOL, GRAD_ATOL = 1e-5, 1e-4
B, S_LEN = 2, 24
TCFG_RUN = dict(learning_rate=1e-3, total_steps=10, warmup_steps=1)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def numpy_params(jcfg, seed: int) -> dict:
    """Params of ``jcfg`` drawn with numpy: weights normal / sqrt(fan-in)
    (the layer axis aside), norm scales 1 + 0.1 N, norm and QKV biases
    0.3 N (so every leaf counts)."""
    rng = np.random.default_rng(seed)
    axes = dict(tree_paths(jAPI.logical_axes(jcfg),
                           is_leaf=lambda x: isinstance(x, tuple)))
    out = {}
    for path, leaf in tree_paths(jAPI.abstract_params(jcfg)):
        shape, name = tuple(leaf.shape), path.split("/")[-1]
        z = rng.standard_normal(shape)
        if name == "scale":
            v = 1.0 + 0.1 * z
        elif name in ("bias", "bq", "bk", "bv"):
            v = 0.3 * z
        else:
            dims = shape[1:] if axes[path][0] == "layers" else shape
            v = z / np.sqrt(max(1, int(np.prod(dims[:-1]))))
        out[path] = v.astype(np.float32)
    return unflatten(out)


@functools.lru_cache(maxsize=None)
def _params():
    return numpy_params(JCFG, 0)


def _jparams():
    return jax.tree.map(jnp.asarray, _params())


def _masks(seed):
    """Random unit masks on the schema (at least one unit per row)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in SCHEMA.items():
        m = (rng.random(shape) < 0.5).astype(np.float32)
        m[:, 0] = 1.0
        out[k] = m
    return out


def _block_masks(seed, block=16):
    """Masks whose dense-layer MLP units live or die by blocks of
    ``block`` (the Pallas pair skips whole blocks)."""
    m = _masks(seed)
    rng = np.random.default_rng(seed + 1)
    live = (rng.random(96 // block) < 0.5).astype(np.float32)
    live[0] = 1.0
    m["mlp"] = np.repeat(live, block)[None]
    return m


def _tokens(seed, s=S_LEN):
    return np.random.default_rng(seed).integers(0, 256, (B, s)).astype(
        np.int32)


def test_config_and_schema_match_jax():
    assert build(TCFG).mask_schema == jT.mask_schema(JCFG) == SCHEMA
    for f in ("q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim", "num_shared_experts",
              "first_k_dense", "num_experts", "num_experts_per_tok",
              "moe_d_ff", "d_ff", "padded_vocab"):
        assert getattr(TCFG, f) == getattr(JCFG, f), f
    assert (TCFG.q_lora_rank, TCFG.kv_lora_rank, TCFG.qk_nope_head_dim,
            TCFG.qk_rope_head_dim, TCFG.v_head_dim) == (32, 16, 16, 8, 16)
    jaxes = dict(tree_paths(jAPI.logical_axes(JCFG),
                            is_leaf=lambda x: isinstance(x, tuple)))
    taxes = dict(tree_paths(logical_axes(TCFG),
                            is_leaf=lambda x: isinstance(x, tuple)))
    assert taxes == jaxes
    for leaf in ("wq_b", "wk_b", "wv_b"):
        assert taxes[f"moe_blocks/attn/{leaf}"][2] == "heads"
    assert taxes["moe_blocks/attn/wo"][1] == "heads"
    # the full config's every leaf, as the reference lays it out
    full_j, full_t = JC.ARCHS[ARCH], TC.ARCHS[ARCH]
    assert full_t == TC.get_model_config(ARCH)
    tshapes = {k: p.shape for k, p in tree_paths(
        build(full_t).spec, is_leaf=lambda v: isinstance(v, P))}
    jshapes = {k: tuple(v.shape)
               for k, v in tree_paths(jAPI.abstract_params(full_j))}
    assert tshapes == jshapes
    assert build(full_t).mask_schema == jT.mask_schema(full_j)


def _attn_inputs(masked, seed=3):
    attn = jax.tree.map(lambda v: v[1], _params()["moe_blocks"]["attn"])
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S_LEN, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S_LEN), (B, S_LEN)).astype(np.int32)
    hm = _masks(seed)["moe_blocks:heads"][1] if masked else None
    return attn, x, pos, hm


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("masked", [False, True])
def test_mla_fwd_matches_jax(masked):
    attn, x, pos, hm = _attn_inputs(masked)
    want, wcache = jax.jit(lambda a, xx, pp, m: jMLA.mla_fwd(
        a, xx, pp, JCFG, head_mask=m, return_cache=True))(
        _j(attn), jnp.asarray(x), jnp.asarray(pos),
        None if hm is None else jnp.asarray(hm))
    got, gcache = tMLA.mla_fwd(
        _t(attn), torch.tensor(x), torch.tensor(pos).long(), TCFG,
        head_mask=None if hm is None else torch.tensor(hm),
        return_cache=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)
    assert set(gcache) == set(wcache) == {"c_kv", "k_rope"}
    for k in wcache:
        np.testing.assert_allclose(_np(gcache[k]), np.asarray(wcache[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    alone = tMLA.mla_fwd(_t(attn), torch.tensor(x), torch.tensor(pos).long(),
                         TCFG, head_mask=None if hm is None else
                         torch.tensor(hm))
    np.testing.assert_array_equal(_np(alone), _np(got))


@pytest.mark.parametrize("masked", [False, True])
def test_mla_decode_matches_jax(masked):
    """The absorbed decode at position 20 of a 28-slot latent cache: the
    output and the cache (written in place on the port's side)."""
    attn, _, _, hm = _attn_inputs(masked)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, 1, 64)).astype(np.float32)
    cache = {"c_kv": rng.normal(size=(B, 28, 16)).astype(np.float32),
             "k_rope": rng.normal(size=(B, 28, 8)).astype(np.float32)}
    pos = 20
    want, wcache = jax.jit(lambda a, xx, c, p, m: jMLA.mla_decode(
        a, xx, c, p, JCFG, head_mask=m))(
        _j(attn), jnp.asarray(x), _j(cache), jnp.int32(pos),
        None if hm is None else jnp.asarray(hm))
    tcache = _t(cache)
    got, gcache = tMLA.mla_decode(
        _t(attn), torch.tensor(x), tcache, pos, TCFG,
        head_mask=None if hm is None else torch.tensor(hm))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)
    assert gcache is tcache
    for k in cache:
        np.testing.assert_allclose(_np(gcache[k]), np.asarray(wcache[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    with pytest.raises(ValueError, match="outside the latent cache"):
        tMLA.mla_decode(_t(attn), torch.tensor(x), tcache, 28, TCFG)


@functools.lru_cache(maxsize=None)
def _serve_setting():
    """tests/test_recurrences.py's own setting: params from
    ``PRNGKey(2)``, 2 x 18 tokens from its fold_in(1), the prompt 17."""
    key = jax.random.PRNGKey(2)
    params = jax.device_get(jax.jit(lambda k: jAPI.init_params(k, JCFG))(
        key))
    toks = np.asarray(jax.random.randint(jax.random.fold_in(key, 1),
                                         (B, 18), 0, JCFG.vocab_size))
    return params, {"tokens": toks[:, :17]}, {"tokens": toks}


def _grow(cache, s):
    """JAX's prefill cache padded by one slot (every latent leaf)."""
    return {**cache, "kv": [jax.tree.map(
        lambda v: jnp.pad(v, [(0, 0)] * (v.ndim - 2) + [(0, 1), (0, 0)]), c)
        for c in cache["kv"]]}


@functools.lru_cache(maxsize=None)
def _jax_serve(moe_impl):
    """JAX's prefill over 17 and 18 tokens, and its decode of token 18
    from the first prefill's cache padded by one slot."""
    api = jAPI.build(JCFG)
    rt = jAPI.default_runtime(JCFG, JC.SMOKE_SHAPE)
    rt["attn_impl"], rt["moe_impl"] = "dense", moe_impl
    masks = jAPI.make_full_masks(JCFG)
    params, bs, bs1 = _serve_setting()
    jp = _j(params)
    prefill = jax.jit(lambda p, b: api.prefill_fn(p, b, JCFG, rt, masks))
    l17, cache = prefill(jp, _j(bs))
    l18, _ = prefill(jp, _j(bs1))
    ld, _ = jax.jit(lambda p, t, c: api.decode_fn(p, t, c, JCFG, rt, masks))(
        jp, jnp.asarray(bs1["tokens"][:, 17:18]), _grow(cache, 17))
    return np.asarray(l17), np.asarray(l18), np.asarray(ld)


def _port_serve(moe_impl):
    api = build(TCFG)
    rt = default_runtime()
    rt["moe_impl"] = moe_impl
    masks = {k: torch.ones(v) for k, v in SCHEMA.items()}
    params, bs, bs1 = _serve_setting()
    tp = _t(params)
    with torch.no_grad():
        l17, cache = api.prefill_fn(tp, _t(bs), TCFG, rt, masks)
        l18, _ = api.prefill_fn(tp, _t(bs1), TCFG, rt, masks)
        assert [set(c) for c in cache["kv"]] == [{"c_kv", "k_rope"}] * 2
        assert tuple(cache["kv"][1]["c_kv"].shape) == (3, B, 17, 16)
        cache = SV.pad_cache(cache, 18)
        assert tuple(cache["kv"][0]["k_rope"].shape) == (1, B, 18, 8)
        ld, cache = api.decode_fn(tp, torch.tensor(bs1["tokens"][:, 17:18]),
                                  cache, TCFG, rt, masks)
        assert cache["pos"] == 18
        with pytest.raises(ValueError, match="outside the latent cache"):
            api.decode_fn(tp, torch.tensor(bs1["tokens"][:, 17:18]), cache,
                          TCFG, rt, masks)
    return _np(l17), _np(l18), _np(ld)


@pytest.mark.parametrize("moe_impl", ["grouped", "dense"])
def test_prefill_and_absorbed_decode_match_jax(moe_impl):
    """In tests/test_recurrences.py's setting: the prefill logits over 17
    and 18 tokens, and the absorbed decode's logits from the padded latent
    cache, each against JAX's at 1e-5; the decode against the prefill over
    the same 18 tokens at the reference's own tolerance (atol 5e-3, rtol
    2e-3)."""
    got = _port_serve(moe_impl)
    for g, want in zip(got, _jax_serve(moe_impl)):
        np.testing.assert_allclose(g, want, rtol=0, atol=ATOL)
    _, l18, ld = got
    np.testing.assert_allclose(ld, l18, rtol=2e-3, atol=5e-3)


def test_reference_decode_gap_is_the_expert_capacity():
    """The reference's test allows MLA 5e-3 between prefill + absorbed
    decode and one longer prefill, naming the absorbed contraction order.
    In its own setting the gap is the grouped dispatch's expert capacity,
    which counts the call's tokens (a decode step of 2 tokens keeps
    choices a prefill of 36 drops): in both packages the gap passes 1e-4
    under the grouped dispatch and stays under 1e-5 under the
    capacity-free dense one."""
    for impl, serve in (("grouped", _jax_serve), ("grouped", _port_serve),
                        ("dense", _jax_serve), ("dense", _port_serve)):
        _, l18, ld = serve(impl)
        gap = float(np.abs(ld - l18).max())
        assert (gap > 1e-4) if impl == "grouped" else (gap <= ATOL), \
            (impl, serve.__name__, gap)


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(masks_seed):
    rt = jAPI.default_runtime(JCFG)
    masks = None
    if masks_seed is not None:
        masks = _j(_block_masks(masks_seed))
    batch = {"tokens": jnp.asarray(_tokens(5))}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jT.lm_loss(p, batch, JCFG, rt, masks)))(_jparams())
    return float(loss), dict(tree_paths(jax.device_get(grads)))


def _port_loss_grads(masks_seed, kernels):
    tp = _t(_params())
    leaves = dict(tree_paths(tp))
    for v in leaves.values():
        v.requires_grad_(True)
    rt = default_runtime()
    rt["kernels"], rt["mask_block"] = kernels, 16
    masks = None
    if masks_seed is not None:
        masks = {k: torch.tensor(v) for k, v in
                 _block_masks(masks_seed).items()}
    loss = build(TCFG).loss_fn(tp, {"tokens": torch.tensor(_tokens(5))},
                               TCFG, rt, masks)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return float(loss.detach()), grads


@pytest.mark.parametrize("kernels", ["cuda", "reference"])
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_and_grads_match_jax(masked, kernels):
    """The loss and every gradient leaf at 1e-4; under straggler masks the
    dead heads' MLA query columns and the dead MLP units get exactly-zero
    gradients."""
    seed = 5 if masked else None
    tl, tg = _port_loss_grads(seed, kernels)
    jl, jg = _jax_loss_grads(seed)
    assert abs(tl - jl) <= GRAD_ATOL
    assert set(tg) == set(jg)
    for k, g in tg.items():
        np.testing.assert_allclose(_np(g), jg[k], rtol=0, atol=GRAD_ATOL,
                                   err_msg=k)
    if masked:
        m, g = _block_masks(5), tg
        wq_b = _np(g["moe_blocks/attn/wq_b"])             # (L, r, H, k)
        assert np.all(wq_b.transpose(0, 2, 1, 3)[
            m["moe_blocks:heads"] == 0] == 0)
        wi = _np(g["dense_blocks/mlp/wi"])                # (1, d, d_ff)
        assert np.all(wi.transpose(0, 2, 1)[m["mlp"] == 0] == 0)


def test_dense_layer_masked_mlp_matches_pallas():
    """The dense first layer's masked MLP: JAX on the Pallas pair
    (interpret mode) against the port's plain path, the forward at 1e-5
    and both input and weight gradients at 1e-4."""
    mlp = {k: v[0] for k, v in _params()["dense_blocks"]["mlp"].items()}
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, S_LEN, 64)).astype(np.float32)
    ct = rng.normal(size=(B, S_LEN, 64)).astype(np.float32)
    um = _block_masks(8)["mlp"][0]
    want, vjp = jax.vjp(
        lambda p, xx: jL.mlp_fwd(p, xx, "silu", unit_mask=jnp.asarray(um),
                                 kernels="pallas", mask_block=16),
        _j(mlp), jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))
    tp = {k: v.requires_grad_(True) for k, v in _t(mlp).items()}
    tx = torch.tensor(x, requires_grad=True)
    got = tL.mlp_fwd(tp, tx, "silu", unit_mask=torch.tensor(um))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)
    gx, *gp = torch.autograd.grad(got, [tx] + list(tp.values()),
                                  torch.tensor(ct))
    np.testing.assert_allclose(_np(gx), np.asarray(jgx), rtol=0,
                               atol=GRAD_ATOL)
    for k, g in zip(tp, gp):
        np.testing.assert_allclose(_np(g), np.asarray(jgp[k]), rtol=0,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_unit_scores_and_expand_masks_match_jax(masked):
    """Eq. 1 scores and parameter-space masks: MLA's head axis is the
    middle axis of wq_b / wk_b / wv_b and the first of wo, and the
    stack-scoped head keys reach both stacks."""
    rng = np.random.default_rng(6)
    d = jax.tree.map(lambda v: rng.normal(size=v.shape).astype(np.float32),
                     _params())
    want = jax.jit(lambda t: jC.unit_scores(t, jAPI.logical_axes(JCFG),
                                            SCHEMA))(d)
    got = tC.unit_scores(_t(d), logical_axes(TCFG), SCHEMA)
    for k in SCHEMA:
        assert tuple(got[k].shape) == SCHEMA[k]
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=0,
                                   atol=1e-6 * float(np.abs(want[k]).max()),
                                   err_msg=k)
    attn = d["moe_blocks"]["attn"]
    heads = sum(np.abs(attn[k]).sum(axis=(1, 3)) for k in
                ("wq_b", "wk_b", "wv_b")) + np.abs(attn["wo"]).sum(axis=(2, 3))
    np.testing.assert_allclose(_np(got["moe_blocks:heads"]), heads,
                               rtol=1e-5)
    um = _masks(7) if masked else {k: np.ones(s, np.float32)
                                   for k, s in SCHEMA.items()}
    jm = dict(tree_paths(jax.jit(lambda m, t: jMK.expand_masks(
        jAPI.logical_axes(JCFG), m, t))(_j(um), d)))
    tm = dict(tree_paths(tMK.expand_masks(logical_axes(TCFG), _t(um),
                                          _t(d))))
    assert set(jm) == set(tm)
    for k, v in jm.items():
        np.testing.assert_array_equal(_np(tm[k]), np.asarray(v), err_msg=k)
    if masked:
        for path in ("moe_blocks/attn/wq_b", "moe_blocks/attn/wv_b",
                     "moe_blocks/attn/wo", "dense_blocks/attn/wk_b",
                     "dense_blocks/mlp/wo", "moe_blocks/moe/router"):
            assert float(tm[path].min()) == 0.0, path
        for path in ("moe_blocks/attn/wq_a", "moe_blocks/attn/wkv_a",
                     "moe_blocks/moe/shared/wi"):
            assert bool((tm[path] == 1).all()), path


# ---------------------------------------------------------------------------
# FLRun.run_sync on DeepSeek-V2, and the launch's train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setting():
    tokens, topics = markov_topic_tokens(240, 32, 64, n_topics=8, seed=0)
    test_tokens, _ = markov_topic_tokens(64, 32, 64, n_topics=8, seed=9)
    parts = partition_by_topic(topics, 4, topics_per_client=2)
    return {"tokens": tokens}, {"tokens": test_tokens}, parts


RUN_KW = dict(local_steps=2, batch_size=4, lr=0.05, seed=0, eval_batch=48)


@pytest.mark.parametrize("scheme", ["helios", "syn"])
def test_flrun_matches_jax(setting, scheme, monkeypatch):
    """Two rounds from the numpy params: history (cycle, time, volumes,
    ratios, downlink), ce and loss within 1e-5, straggler masks and
    rotation counters equal, the global params within 1e-5; helios's
    stragglers train a sub-model over heads and experts."""
    import repro.federated.runtime as jR
    train, test, parts = setting
    jh = JC.HeliosConfig(mask_block=16)
    th = TC.HeliosConfig(mask_block=16)
    # the JAX run starts from the numpy params: its eager initializer
    # (a compile a leaf shape) would draw params nobody reads
    monkeypatch.setattr(jR, "init_params", lambda key, cfg: _jparams())
    jrun = JaxFLRun(JCFG, jh, scheme,
                    j_setup_clients(j_make_fleet(2, 2), parts, jh),
                    train, test, kernels="reference", **RUN_KW)
    share_jax_programs(jrun)
    jrun.run_sync(2)
    with jax_keys():
        trun = FLRun(TCFG, th, scheme,
                     setup_clients(make_fleet(2, 2), parts, th, device="cpu"),
                     train, test, kernels="cuda", device="cpu",
                     init_params=_params(), **RUN_KW)
        trun.run_sync(2)
    assert len(trun.history) == len(jrun.history) == 2
    for j, t in zip(jrun.history, trun.history):
        for k in ("scheme", "cycle", "time", "volumes", "ratios",
                  "downlink_mb"):
            assert t[k] == j[k], (k, t[k], j[k])
        assert abs(t["ce"] - j["ce"]) <= ATOL
        assert abs(t["loss"] - j["loss"]) <= ATOL
    for jc, tc in zip(jrun.clients, trun.clients):
        for k, m in jc.helios_state["masks"].items():
            np.testing.assert_array_equal(tc.helios_state["masks"][k].numpy(),
                                          np.asarray(m), err_msg=k)
            np.testing.assert_array_equal(
                tc.helios_state["skip_counts"][k].numpy(),
                np.asarray(jc.helios_state["skip_counts"][k]), err_msg=k)
    tparams = dict(tree_paths(trun.global_params))
    jparams = dict(tree_paths(jax.device_get(jrun.global_params)))
    assert set(tparams) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_allclose(tparams[k].numpy(), v, rtol=0, atol=ATOL,
                                   err_msg=k)
    ratios = trun.history[-1]["ratios"]
    for c, r in zip(trun.clients, ratios):
        if scheme == "syn" or not c.is_straggler:
            assert r == 1.0
            continue
        assert r < 1.0
        masks = c.helios_state["masks"]
        for k in ("experts", "moe_blocks:heads"):
            assert 0 < float(masks[k].sum()) < masks[k].numel(), k


def train_states(jcfg, tcfg, params, volume=0.5):
    """The same launch train state in both packages: ``params`` (numpy)
    bridged, AdamW's fresh state, Eq. 2 masks of one ``begin_cycle`` at
    ``volume`` drawn through the JAX key path."""
    hj = JC.HeliosConfig(enabled=True, contribution="grad_ema")
    ht = TC.HeliosConfig(enabled=True, contribution="grad_ema")
    tc_j, tc_t = JC.TrainConfig(**TCFG_RUN), TC.TrainConfig(**TCFG_RUN)
    jstate = jS.init_train_state(jax.random.PRNGKey(0), jcfg, hj, tc_j)
    jstate["params"] = _j(params)
    jstate["helios"] = jST.begin_cycle(
        jST.set_volume(jstate["helios"], volume), hj)
    tp = _t(params)
    with jax_keys():
        helios = ST.begin_cycle(ST.set_volume(ST.init_state(
            build(tcfg).mask_schema, 1.0, 0, "cpu"), volume), ht)
    tstate = {"params": tp, "opt": S.make_opt(tcfg, tc_t).init(tp),
              "step": torch.zeros((), dtype=torch.int32), "helios": helios}
    return (hj, tc_j, jstate), (ht, tc_t, tstate)


def run_train_steps(jcfg, tcfg, params, batches):
    """``make_train_step`` over ``batches`` (numpy dicts) in both
    packages; returns (JAX state, port state, [(JAX, port) metrics])."""
    (hj, tc_j, jstate), (ht, tc_t, tstate) = train_states(jcfg, tcfg,
                                                          params)
    jstep = jax.jit(jS.make_train_step(jcfg, hj, tc_j,
                                       jAPI.default_runtime(jcfg)))
    rt = default_runtime()
    rt["kernels"] = "cuda"
    tstep = S.make_train_step(tcfg, ht, tc_t, rt)
    metrics = []
    for nb in batches:
        jstate, jm = jstep(jstate, _j(nb))
        tstate, tm = tstep(tstate, {k: torch.as_tensor(v)
                                    for k, v in nb.items()})
        metrics.append((jm, tm))
    return jstate, tstate, metrics


def check_train_states(jstate, tstate, metrics, what, exempt=None):
    """Losses and gradient norms, params and AdamW's state within 1e-5
    (``exempt`` maps a param leaf to its own bound), masks equal, the
    grad-EMA scores within 1e-5 of their size."""
    for jm, tm in metrics:
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= ATOL
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            ATOL * max(1.0, float(jm["grad_norm"]))
    for name in ("params", "opt"):
        jt = dict(tree_paths(jax.device_get(jstate[name])))
        tt = dict(tree_paths(tstate[name]))
        assert set(jt) == set(tt), name
        for k, v in jt.items():
            atol = (exempt or {}).get(k, ATOL) if name == "params" else ATOL
            np.testing.assert_allclose(_np(tt[k]), np.asarray(v), rtol=0,
                                       atol=atol, err_msg=f"{what} {k}")
    assert int(tstate["step"]) == int(jstate["step"]) == len(metrics)
    jh = jax.device_get(jstate["helios"])
    for k, m in jh["masks"].items():
        np.testing.assert_array_equal(tstate["helios"]["masks"][k].numpy(),
                                      np.asarray(m), err_msg=k)
    for k, sc in jh["scores"].items():
        sc = np.asarray(sc)
        np.testing.assert_allclose(tstate["helios"]["scores"][k].numpy(), sc,
                                   rtol=0, atol=ATOL * max(1.0, sc.max()),
                                   err_msg=k)
    assert min(float(m.mean()) for m in tstate["helios"]["masks"].values()) \
        < 1.0


def test_train_steps_match_jax():
    rng = np.random.default_rng(7)
    batches = [{"tokens": rng.integers(0, JCFG.padded_vocab, (B, S_LEN))
                .astype(np.int32)} for _ in range(3)]
    check_train_states(*run_train_steps(JCFG, TCFG, _params(), batches),
                       what=ARCH)


def test_make_adapter_dispatch():
    from repro_torch.federated.adapter import TokenLMAdapter, make_adapter
    ad = make_adapter(TCFG, "cuda", 16, torch.device("cpu"))
    assert isinstance(ad, TokenLMAdapter) and ad.schema == SCHEMA
