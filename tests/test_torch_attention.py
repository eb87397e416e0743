"""Port parity: flash attention (``repro_torch.kernels.ops.flash_attention``)
against the JAX package's ``ops.flash_attention`` (Pallas in interpret mode)
and its oracle ``ref.flash_attention_ref``.

On the CPU the port's kernel wrapper computes its plain version, so these
tests pin the autograd structure around the CUDA forward kernel: the
forward, and dq/dk/dv through the recompute backward, on aligned and
ragged causal lengths and on a non-causal aligned one.  Tolerances are the
reference's own (tests/test_kernel_softtrain.py): forward atol 1e-5,
gradients atol/rtol 1e-4.  The CUDA kernel itself is held against the same
plain version on the card by ``chip_smoke.py``.
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

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tFA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ATOL = 1e-5
GRAD_TOL = 1e-4
CASES = [(32, True), (100, True), (128, True), (128, False)]


def _qkv(seed, s, hd=16, b=2, h=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, hd)).astype(np.float32)
            for _ in range(3)]


def _jax_fwd_grads(fn, q, k, v):
    y, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v)))
    grads = vjp(2.0 * y)                          # d sum(y²) / dy
    return np.asarray(y), [np.asarray(g) for g in grads]


def _torch_fwd_grads(fn, q, k, v):
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    y = fn(*leaves)
    grads = torch.autograd.grad((y ** 2).sum(), leaves)
    return y.detach().numpy(), [g.numpy() for g in grads]


@functools.lru_cache(maxsize=None)
def _jax_side(s, causal):
    """The JAX op (interpret mode) and its oracle, once per case."""
    q, k, v = _qkv(s, s)
    return (_jax_fwd_grads(
        lambda a, b, c: jops.flash_attention(a, b, c, causal=causal), q, k, v),
        _jax_fwd_grads(
        lambda a, b, c: jref.flash_attention_ref(a, b, c, causal=causal),
        q, k, v))


@pytest.mark.parametrize("impl", ["cuda", "reference"])
@pytest.mark.parametrize("s,causal", CASES)
def test_flash_attention_matches_jax(s, causal, impl):
    q, k, v = _qkv(s, s)
    (jy, jg), (ry, rg) = _jax_side(s, causal)
    ty, tg = _torch_fwd_grads(
        lambda a, b, c: tops.flash_attention(a, b, c, causal=causal,
                                             impl=impl), q, k, v)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ty, ry, rtol=0, atol=ATOL)
    for name, t, j, r in zip(("dq", "dk", "dv"), tg, jg, rg):
        np.testing.assert_allclose(t, j, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(t, r, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_transposed_views_and_kernel_counter():
    """``attend`` hands over (B, S, H, hd) tensors seen as (B, H, S, hd);
    the result must not depend on the layout, and a CPU call launches no
    kernel."""
    q, k, v = _qkv(5, 48)
    want = tref.flash_attention_ref(*(torch.tensor(t) for t in (q, k, v)))
    views = [torch.tensor(t.transpose(0, 2, 1, 3).copy()).transpose(1, 2)
             for t in (q, k, v)]
    assert not views[0].is_contiguous()
    tFA.reset_launches()
    got = tops.flash_attention(*views, causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert tFA.LAUNCHES == {"flash_attention": 0}


def _bad(kind):
    t = torch.zeros
    if kind == "rank":
        return t(2, 8, 16), t(2, 8, 16), t(2, 8, 16), True
    if kind == "k_vs_v":
        return t(1, 2, 8, 16), t(1, 2, 8, 16), t(1, 2, 4, 16), False
    if kind == "heads":
        return t(1, 3, 8, 16), t(1, 2, 8, 16), t(1, 2, 8, 16), False
    if kind == "head_dim":
        return t(1, 2, 8, 16), t(1, 2, 8, 32), t(1, 2, 8, 32), False
    return t(1, 2, 8, 16), t(1, 2, 12, 16), t(1, 2, 12, 16), True


@pytest.mark.parametrize("impl", ["cuda", "reference"])
@pytest.mark.parametrize("kind", ["rank", "k_vs_v", "heads", "head_dim",
                                  "causal_cross_length"])
def test_flash_attention_preconditions_raise(kind, impl):
    q, k, v, causal = _bad(kind)
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, v, causal=causal, impl=impl)


def test_non_causal_cross_length_runs():
    """Non-causal attention over another key length is allowed (the kernel
    masks a ragged key tile, so unlike the TPU kernel it needs no aligned
    keys)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 2, 20, 16)).astype(np.float32)
    kv = rng.normal(size=(1, 2, 37, 16)).astype(np.float32)
    got = tops.flash_attention(torch.tensor(q), torch.tensor(kv),
                               torch.tensor(kv), causal=False)
    want = jref.flash_attention_ref(q, kv, kv, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
