"""Port parity for long sequences: ``models.layers.chunked_attention`` and
the dispatch that routes self-attention of 4096 tokens and more to it,
against the JAX package, and the input-shape suite of ``configs``.

* ``chunked_attention`` at S 4096 and 8192 (causal and not, GQA 2:1 and
  none, heads of 8) against the reference's: values at atol 1e-5, the
  gradients of q, k and v under a fixed N(0, 1) cotangent at 1e-4; and
  against the port's dense attention.
* The chunk split is the reference's (``n = S // chunk`` chunks of
  ``S // n``): at 4100 queries it does not cover the sequence, and both
  packages raise.
* ``attend`` under ``impl="cuda"``: flash below 4096 (the kernel
  wrapper's plain body on the CPU), the chunked lowering from 4096 with
  equal query and key lengths, dense attention for a shorter query.
* ``lm_loss`` at S 4096 on ``reduced(deepseek-7b)`` (the transformer
  stack) and ``reduced(zamba2-1.2b)`` (the hybrid's shared attention),
  batch 1, from the JAX initial params: the loss at atol 1e-5 and every
  gradient leaf at 1e-4, on the kernel path and the plain path.
* ``SHAPES``, ``applicable``, ``cells``, ``get_shape``, ``SMOKE_SHAPE``,
  ``ShapeConfig.tokens_per_step`` and ``ModelConfig.is_subquadratic``
  equal the reference's for all ten configs.
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
from repro.models import api as jAPI  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models.module import tree_paths  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as tFA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import build, default_runtime  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402

ATOL, GRAD_TOL = 1e-5, 1e-4
#: case -> (S, query heads, KV heads, causal)
CASES = {"4096-causal-gqa": (4096, 2, 1, True),
         "4096-full": (4096, 2, 2, False),
         "8192-causal-gqa": (8192, 2, 1, True)}
HD = 8
LOSS_ARCHS = {"deepseek": "deepseek-7b", "zamba2": "zamba2-1.2b"}


def _qkv(s, h, kv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, s, n, HD)).astype(np.float32)
            for n in (h, kv, kv)] + \
        [rng.normal(size=(1, s, h, HD)).astype(np.float32)]


@pytest.mark.parametrize("case", CASES)
def test_chunked_attention_matches_jax(case):
    s, h, kv, causal = CASES[case]
    q, k, v, gy = _qkv(s, h, kv)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    y = tL.chunked_attention(tq, tk, tv, causal=causal)
    tg = torch.autograd.grad((y * torch.tensor(gy)).sum(), (tq, tk, tv))

    def jfwd(q, k, v):
        return jL.chunked_attention(q, k, v, causal=causal)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jy, vjp = jax.vjp(jfwd, jq, jk, jv)
    jg = vjp(jnp.asarray(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL)
    for i, (t, j) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"operand {i}")
    with torch.no_grad():
        dense = tL.dense_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(y.detach().numpy(), dense.numpy(), rtol=0,
                               atol=ATOL)


def test_chunk_split_fails_where_the_reference_fails():
    """4100 queries: 8 chunks of 512 leave 4 over.  The reference's reshape
    raises; the port raises before it, naming the split."""
    q, k, v, _ = _qkv(4100, 2, 1)
    with pytest.raises(TypeError):
        jL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True)
    with pytest.raises(ValueError, match="8 chunks of 512"):
        tL.chunked_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), causal=True)
    # through the dispatch too, as JAX's attend
    with pytest.raises(ValueError):
        tL.attend(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                  causal=True, impl="cuda")


def test_attend_routes_like_the_reference(monkeypatch):
    """Under ``impl="cuda"``: flash below ``CHUNKED_FROM``, chunked from
    it, dense for a query shorter than its keys."""
    seen = []
    real = tL.chunked_attention

    def chunked(*a, **kw):
        seen.append("chunked")
        return real(*a, **kw)

    monkeypatch.setattr(tL, "chunked_attention", chunked)
    assert tL.CHUNKED_FROM == 4096
    for s, sk, want_flash, want_chunked in ((4095, 4095, 1, 0),
                                            (4096, 4096, 0, 1),
                                            (4096 - 1024, 4096, 0, 0)):
        q = torch.zeros(1, s, 2, HD)
        k = torch.zeros(1, sk, 1, HD)
        seen.clear()
        calls = []
        monkeypatch.setattr(tops, "flash_attention",
                            lambda *a, **kw: calls.append(1) or
                            a[0].new_zeros(a[0].shape))
        tL.attend(q, k, k, causal=s == sk, impl="cuda")
        assert (len(calls), len(seen)) == (want_flash, want_chunked), s
    assert tFA.LAUNCHES == {"flash_attention": 0}


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(arch):
    jcfg = JC.reduced(JC.ARCHS[LOSS_ARCHS[arch]])
    jp = jax.device_get(jAPI.init_params(jax.random.PRNGKey(0), jcfg))
    batch = {"tokens": jnp.asarray(_tokens(jcfg.vocab_size))}
    rt = jAPI.default_runtime(jcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jAPI.build(jcfg).loss_fn(p, batch, jcfg, rt, None)))(jp)
    return jp, float(loss), dict(tree_paths(jax.device_get(grads)))


def _tokens(vocab):
    rng = np.random.default_rng(7)
    return rng.integers(0, vocab, size=(1, tL.CHUNKED_FROM)).astype(
        np.int32)


@pytest.mark.parametrize("kernels", ["cuda", "reference"])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_at_4096_matches_jax(arch, kernels, monkeypatch):
    """4096 tokens: every self-attention (the transformer stack's, the
    hybrid's shared block) takes the chunked lowering on both sides."""
    jp, jloss, jgrads = _jax_loss_grads(arch)
    tcfg = TC.reduced(TC.ARCHS[LOSS_ARCHS[arch]])
    calls = []
    real = tL.chunked_attention
    monkeypatch.setattr(tL, "chunked_attention",
                        lambda *a, **kw: calls.append(a[0].shape[1]) or
                        real(*a, **kw))
    tp = params_from_numpy(jp, device="cpu")
    leaves = dict(tree_paths(tp))
    for v in leaves.values():
        v.requires_grad_(True)
    rt = default_runtime()
    rt["kernels"] = kernels
    loss = build(tcfg).loss_fn(
        tp, {"tokens": torch.tensor(_tokens(tcfg.vocab_size))}, tcfg, rt,
        None)
    assert calls and set(calls) == {tL.CHUNKED_FROM}
    assert abs(float(loss.detach()) - jloss) <= ATOL
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(grads) == set(jgrads)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[key], rtol=0,
                                   atol=GRAD_TOL, err_msg=key)


def test_shape_suite_matches_jax():
    assert list(TC.SHAPES) == list(JC.SHAPES)
    for name, shape in JC.SHAPES.items():
        assert dataclasses.asdict(TC.get_shape(name)) == \
            dataclasses.asdict(shape)
        assert TC.get_shape(name).tokens_per_step == shape.tokens_per_step
    assert dataclasses.asdict(TC.SMOKE_SHAPE) == \
        dataclasses.asdict(JC.SMOKE_SHAPE)
    assert set(TC.ARCHS) == set(JC.ARCHS)
    for name, cfg in JC.ARCHS.items():
        assert TC.ARCHS[name].is_subquadratic == cfg.is_subquadratic
        for sname, shape in JC.SHAPES.items():
            assert TC.applicable(TC.ARCHS[name], TC.SHAPES[sname]) == \
                JC.applicable(cfg, shape)
    assert TC.cells(TC.ARCHS) == JC.cells(JC.ARCHS)
    runs = {(m, s) for m, s, ok, _ in TC.cells(TC.ARCHS) if ok}
    assert ("zamba2-1.2b", "long_500k") in runs
    assert ("xlstm-125m", "long_500k") in runs
    assert ("deepseek-7b", "long_500k") not in runs
    assert len(runs) == 4 * 10 - 8
