"""Port parity: the dense LM's modules against the JAX package, on
``reduced(deepseek-7b)`` (4 layers, d_model 64, 4 heads of 16, d_ff 96,
vocab 256) with the JAX initial params carried across by the weight bridge.

Norms, RoPE, attention with a head mask, the masked MLP, and ``lm_loss``
with every gradient leaf agree at atol 1e-5; the port runs its kernel path
(``kernels="cuda"``, plain bodies on the CPU) and its plain path, the JAX
side its reference path (pinned to its Pallas path by
tests/test_kernel_softtrain.py).  Eq. 1 unit scores agree at atol 1e-6,
parameter-space masks exactly, and Eq. 2 masks on the {"heads", "mlp"}
schema bit for bit under the test-only JAX key-path backend.
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
from repro.core import selection as jS  # noqa: E402
from repro.models import api as jAPI  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import contribution as tC  # noqa: E402
from repro_torch.core import keys as KY  # noqa: E402
from repro_torch.core import masking as tMK  # noqa: E402
from repro_torch.core import selection as tS  # noqa: E402
from repro_torch.models import build, logical_axes, make_full_masks  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.module import tree_paths  # noqa: E402
from test_torch_keys import _jax_key, jax_keys  # noqa: E402

ATOL = 1e-5
B, S = 2, 24
JCFG = JC.reduced(JC.ARCHS["deepseek-7b"])
TCFG = TC.reduced(TC.DEEPSEEK_7B)
MASKED = [False, True]


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _init():
    return jax.device_get(jAPI.init_params(jax.random.PRNGKey(0), JCFG))


def _params():
    """(JAX params, port params) from the same numbers."""
    jp = _init()
    return jp, params_from_numpy(jp, device="cpu")


def _masks(seed):
    """Random unit masks on the LM schema (at least one unit per row)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in jT.mask_schema(JCFG).items():
        m = (rng.random(shape) < 0.5).astype(np.float32)
        m[:, 0] = 1.0
        out[k] = m
    return out


def _tokens(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, JCFG.vocab_size, size=(B, S)).astype(np.int32)


def test_config_and_schema_match_jax():
    assert TCFG.padded_vocab == JCFG.padded_vocab == 256
    assert TCFG.resolved_head_dim == JCFG.resolved_head_dim == 16
    assert TC.DEEPSEEK_7B.padded_vocab == JC.ARCHS["deepseek-7b"].padded_vocab
    assert build(TCFG).mask_schema == jT.mask_schema(JCFG) == {
        "heads": (4, 4), "mlp": (4, 96)}
    jaxes = dict(tree_paths(jAPI.logical_axes(JCFG),
                            is_leaf=lambda x: isinstance(x, tuple)))
    taxes = dict(tree_paths(logical_axes(TCFG),
                            is_leaf=lambda x: isinstance(x, tuple)))
    assert taxes == jaxes
    jp, tp = _params()
    assert {k: v.shape for k, v in tree_paths(jp)} == \
        {k: tuple(v.shape) for k, v in tree_paths(tp)}
    back = params_to_numpy(tp)
    for k, v in tree_paths(jp):
        np.testing.assert_array_equal(dict(tree_paths(back))[k], v)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, 64)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    want = jL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    got = tL.apply_norm({k: torch.tensor(v) for k, v in p.items()},
                        torch.tensor(x), kind)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("theta", [10_000.0, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tL.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)


def _layer(tree, i=0):
    return jax.tree.map(lambda t: t[i], tree)


@pytest.mark.parametrize("impl", ["cuda", "auto"])
@pytest.mark.parametrize("masked", MASKED)
def test_attention_fwd_matches_jax(masked, impl):
    jp, _ = _params()
    attn = _layer(jp["blocks"]["attn"], 1)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    hm = _masks(3)["heads"][1] if masked else None
    want = jL.attention_fwd({k: jnp.asarray(v) for k, v in attn.items()},
                            jnp.asarray(x), jnp.asarray(pos),
                            head_mask=None if hm is None else jnp.asarray(hm))
    got = tL.attention_fwd({k: torch.tensor(v) for k, v in attn.items()},
                           torch.tensor(x), torch.tensor(pos), impl=impl,
                           head_mask=None if hm is None else torch.tensor(hm))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("kernels", ["cuda", None])
@pytest.mark.parametrize("masked", MASKED)
def test_mlp_fwd_matches_jax(masked, kernels, activation):
    jp, _ = _params()
    mlp = _layer(jp["blocks"]["mlp"], 2)
    if activation == "gelu":                  # the ungated MLP: wi, wo
        mlp = {k: v for k, v in mlp.items() if k != "wg"}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    um = _masks(4)["mlp"][2] if masked else None
    want = jL.mlp_fwd({k: jnp.asarray(v) for k, v in mlp.items()},
                      jnp.asarray(x), activation,
                      unit_mask=None if um is None else jnp.asarray(um))
    got = tL.mlp_fwd({k: torch.tensor(v) for k, v in mlp.items()},
                     torch.tensor(x), activation,
                     unit_mask=None if um is None else torch.tensor(um),
                     kernels=kernels, mask_block=16)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(masked):
    jp, _ = _params()
    rt = jAPI.default_runtime(JCFG)
    masks = {k: jnp.asarray(v) for k, v in _masks(5).items()} \
        if masked else None
    batch = {"tokens": jnp.asarray(_tokens(5))}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jT.lm_loss(p, batch, JCFG, rt, masks)))(jp)
    return float(loss), dict(tree_paths(jax.device_get(grads)))


@pytest.mark.parametrize("kernels", ["cuda", "reference"])
@pytest.mark.parametrize("masked", MASKED)
def test_lm_loss_and_grads_match_jax(masked, kernels):
    jloss, jgrads = _jax_loss_grads(masked)
    _, tp = _params()
    leaves = dict(tree_paths(tp))
    for v in leaves.values():
        v.requires_grad_(True)
    rt = tT.default_runtime()
    rt["kernels"], rt["mask_block"] = kernels, 16
    masks = {k: torch.tensor(v) for k, v in _masks(5).items()} \
        if masked else None
    loss = tT.lm_loss(tp, {"tokens": torch.tensor(_tokens(5))}, TCFG, rt,
                      masks)
    assert abs(float(loss.detach()) - jloss) <= ATOL
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(_np(g), jgrads[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    if masked:              # frozen MLP units: exactly zero wi/wg columns
        dead = _masks(5)["mlp"] == 0
        for name in ("wi", "wg"):
            g = _np(grads[f"blocks/mlp/{name}"])
            assert np.all(g.transpose(0, 2, 1)[dead] == 0)


def _delta_tree(seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda v: rng.normal(size=v.shape).astype(np.float32), _init())


@pytest.mark.parametrize("masked", MASKED)
def test_unit_scores_and_expand_masks_match_jax(masked):
    d = _delta_tree(6)
    schema = jT.mask_schema(JCFG)
    want = jC.unit_scores(d, jAPI.logical_axes(JCFG), schema)
    got = tC.unit_scores(params_from_numpy(d, device="cpu"),
                         logical_axes(TCFG), build(TCFG).mask_schema)
    for k in schema:
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
    if not masked:
        assert all(bool((t == 1).all()) for t in tflat.values())
        assert all(bool((v == 1).all())
                   for v in make_full_masks(TCFG, "cpu").values())


j_select = jax.jit(jS.select_masks, static_argnames=("p_s", "block"))


@pytest.mark.parametrize("p_s", [0.1, 0.0])
def test_select_masks_lm_schema_bit_identical(p_s):
    """Heads (n = 4 < 4·16) draw unit-granular, mlp (n = 96) block-pooled
    at 16, in one call."""
    rng = np.random.default_rng(8)
    schema = jT.mask_schema(JCFG)
    scores = {k: rng.random(s).astype(np.float32) for k, s in schema.items()}
    forced = {k: rng.random(s) < 0.1 for k, s in schema.items()}
    for i, volume in enumerate((0.125, 0.4, 0.75, 1.0)):
        key = KY.key(11).fold_in(i)
        want = j_select({k: jnp.asarray(v) for k, v in scores.items()},
                        {k: jnp.asarray(v) for k, v in forced.items()},
                        jnp.asarray(volume, jnp.float32), p_s=p_s,
                        key=_jax_key(key.path), block=16)
        with jax_keys():
            got = tS.select_masks({k: torch.tensor(v) for k, v in
                                   scores.items()},
                                  {k: torch.tensor(v) for k, v in
                                   forced.items()}, volume, p_s, key,
                                  block=16)
        for k in schema:
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                          err_msg=f"{k} P={volume}")
        blocks = _np(got["mlp"]).reshape(4, -1, 16)
        assert np.all(blocks.max(-1) == blocks.min(-1))


def test_tree_paths_keeps_no_leaf_alive():
    """Walking a tree leaves no reference cycle behind: a leaf is freed as
    soon as its last reference goes, without the cyclic collector (at full
    width every such cycle kept a model copy alive)."""
    import gc
    import weakref
    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    gc.disable()
    try:
        assert [k for k, _ in tree_paths({"a": {"b": leaf}, "c": leaf})] == \
            ["a/b", "c"]
        del leaf
        assert ref() is None
    finally:
        gc.enable()
