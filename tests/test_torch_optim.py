"""Port parity: the optimizers, schedules and clipping of
``repro_torch.optim`` against ``repro.optim`` on the same trees.

The trees are drawn with numpy from a seed: a stacked ``(L, d)`` norm scale,
a ``(d, f)`` weight, a ``(d,)`` bias and a ``(L, H, hd)`` attention leaf,
nested as the LM nests them.  Values are held at 1e-7 relative (the
float32 arithmetic of the reference, op for op), including the warmup
schedule's lr of 0 at step 0 (a first step that moves nothing) and AdamW's
decay of every leaf with two or more dims, whatever its role.

Three float32 operations are not the same to the last bit in XLA and in
torch on the CPU (ROADMAP §3; pinned by
``test_xla_float32_ops_differ_from_torch``): torch's CPU ``sqrt`` is not
correctly rounded (one ulp off the IEEE result, which XLA gives, for 0.6 %
of inputs), ``cos`` is another approximation in each, and a sum reduces in
another order.  What passes through one of them (the cosine part of the
schedule, the global norm and the clipped leaves, Adam's and AdamW's
updates) is held at four float32 ulps, 4 · 2^-23 relative; everything
else at 1e-7.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

from repro.optim import optimizers as JO  # noqa: E402
from repro_torch.models.module import tree_paths  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402

RTOL = 1e-7
#: four float32 ulps: values behind a sqrt, a cos or a sum
ULPS = 4 * 2.0 ** -23


def _tree(seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"blocks": {"attn_norm": {"scale": draw(3, 8)},
                       "attn": {"wq": draw(3, 4, 2)}},
            "mlp": {"wi": draw(8, 12), "bias": draw(8)},
            "final_norm": {"scale": draw(8)}}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.as_tensor(v)
            for k, v in tree.items()}


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _close(t_tree, j_tree, rtol=RTOL):
    jt = dict(tree_paths(j_tree))
    tt = dict(tree_paths(t_tree))
    assert set(jt) == set(tt)
    for k, v in jt.items():
        np.testing.assert_allclose(np.asarray(tt[k]), np.asarray(v),
                                   rtol=rtol, atol=0, err_msg=k)


@pytest.mark.parametrize("warmup,total", [(5, 40), (0, 10), (3, 3)])
def test_warmup_cosine_schedule_matches_jax(warmup, total):
    js = JO.warmup_cosine_schedule(3e-4, warmup, total)
    ts = TO.warmup_cosine_schedule(3e-4, warmup, total)
    for step in list(range(0, total + 6)) + [0.5, 2.25]:
        want = np.float32(js(step))
        got = ts(step)
        assert got.dtype == torch.float32
        # the warmup ramp is exact arithmetic; the cosine part reads cos
        rtol = RTOL if step < warmup else ULPS
        np.testing.assert_allclose(float(got), want, rtol=rtol, atol=0,
                                   err_msg=str(step))
    if warmup:
        assert float(ts(0)) == 0.0 == float(js(0))      # lr 0 at step 0


def test_constant_schedule_matches_jax():
    got = TO.constant_schedule(0.05)(7)
    assert got.dtype == torch.float32
    assert float(got) == float(JO.constant_schedule(0.05)(7))


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_global_norm_and_clip_match_jax(max_norm):
    tree = _tree(0, scale=2.0)
    jn = JO.global_norm(_j(tree))
    tn = TO.global_norm(_t(tree))
    np.testing.assert_allclose(float(tn), float(jn), rtol=ULPS, atol=0)
    jc, jn2 = JO.clip_by_global_norm(_j(tree), max_norm)
    tc, tn2 = TO.clip_by_global_norm(_t(tree), max_norm)
    assert float(tn2) == float(tn)
    _close(tc, jc, ULPS)
    # given the same norm, the scale and the clipped leaves are exact
    scale = TO.clip_scale(torch.tensor(float(jn)), max_norm)
    want = np.minimum(np.float32(1.0), np.float32(max_norm)
                      / np.maximum(np.float32(jn), np.float32(1e-9)))
    assert float(scale) == float(want)
    if max_norm > float(tn):                            # no clip: unchanged
        _close(tc, _j(tree), rtol=0)


@pytest.mark.parametrize("name,kw", [
    ("adamw", {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1}),
    ("adam", {"b1": 0.9, "b2": 0.999, "eps": 1e-8}),
    ("momentum", {"beta": 0.9}),
    ("sgd", {}),
])
def test_make_optimizer_steps_match_jax(name, kw):
    """Five steps of each optimizer under the warmup-cosine schedule (the
    first at lr 0): params, updates and states at 1e-7 relative, four ulps
    for Adam's and AdamW's (their sqrt and the schedule's cos)."""
    rtol = ULPS if name in ("adamw", "adam") else RTOL
    jsched = JO.warmup_cosine_schedule(1e-2, 2, 10)
    tsched = TO.warmup_cosine_schedule(1e-2, 2, 10)
    jopt = JO.make_optimizer(name, jsched, **kw)
    topt = TO.make_optimizer(name, tsched, **kw)
    jp, tp = _j(_tree(1)), _t(_tree(1))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _tree(10 + step, scale=0.3)
        ju, js = jopt.update(_j(g), js, jp, step)
        tu, ts = topt.update(_t(g), ts, tp, step)
        _close(tu, ju, rtol)
        jp, tp = JO.apply_updates(jp, ju), TO.apply_updates(tp, tu)
        _close(tp, jp, rtol)
        for k in js:
            _close(ts[k], js[k], rtol)
        if step == 0 and name in ("adamw", "adam"):
            # AdamW reads the lr at step - 1 after its +1: lr(0) = 0
            for v in tree_paths(tu):
                assert not bool(v[1].any()), v[0]


def test_adamw_decays_by_ndim_not_role():
    """With zero gradients, AdamW's update is -lr · wd · p on every leaf with
    ndim >= 2 (the stacked (L, d) norm scale included) and 0 on 1-D
    leaves, as in the reference."""
    topt = TO.adamw(0.5, weight_decay=0.1)
    jopt = JO.adamw(0.5, weight_decay=0.1)
    tree = _tree(2)
    zeros = {k: ({kk: np.zeros_like(vv) for kk, vv in v.items()}
                 if not isinstance(next(iter(v.values())), dict) else
                 {kk: {kkk: np.zeros_like(vvv) for kkk, vvv in vv.items()}
                  for kk, vv in v.items()})
             for k, v in tree.items()}
    tu, _ = topt.update(_t(zeros), topt.init(_t(tree)), _t(tree), 3)
    ju, _ = jopt.update(_j(zeros), jopt.init(_j(tree)), _j(tree), 3)
    _close(tu, ju)          # zero moments: no sqrt of a nonzero value
    flat = dict(tree_paths(tu))
    assert bool(flat["blocks/attn_norm/scale"].ne(0).all())      # (L, d)
    assert bool(flat["mlp/wi"].ne(0).all())
    assert not bool(flat["mlp/bias"].any())                      # (d,)
    assert not bool(flat["final_norm/scale"].any())


def test_make_optimizer_unknown_name_raises():
    with pytest.raises(ValueError):
        TO.make_optimizer("lion", 0.1)


def test_xla_float32_ops_differ_from_torch():
    """The finding behind ``ULPS``: on the same float32 inputs torch's CPU
    sqrt is one ulp off the IEEE result (XLA's) for some inputs, and cos
    and a sum of squares differ between the two in the last bits."""
    rng = np.random.default_rng(0)
    x = rng.random(10000).astype(np.float32)
    js, ts = np.asarray(jnp.sqrt(jnp.asarray(x))), \
        torch.sqrt(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(
        js, np.sqrt(x.astype(np.float64)).astype(np.float32))
    assert 0 < int((js != ts).sum()) < 500
    jc, tc = np.asarray(jnp.cos(jnp.asarray(3 * x))), \
        torch.cos(torch.as_tensor(3 * x)).numpy()
    assert int((jc != tc).sum()) > 0
    for a, b in ((js, ts), (jc, tc)):
        assert np.all(np.abs(a - b) <= np.spacing(np.abs(b)))
    sq = [(jnp.sum(jnp.square(jnp.asarray(v))),
           torch.as_tensor(v).square().sum())
          for v in (rng.standard_normal(1000).astype(np.float32)
                    for _ in range(20))]
    assert any(float(a) != float(b) for a, b in sq)
    for a, b in sq:
        np.testing.assert_allclose(float(b), float(a), rtol=ULPS)
