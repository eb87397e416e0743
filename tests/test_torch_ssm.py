"""Port parity: the Mamba2 SSD path (``repro_torch.kernels.ops.ssd_diag``,
``repro_torch.models.ssm``) against the JAX package.

On the CPU the port's kernel wrapper computes its plain version, so these
tests pin the autograd structure around the CUDA forward kernel: the
intra-chunk term against the JAX Pallas kernel in interpret mode and its
oracle, its recompute backward against plain autograd, ``ssd_chunked``
(kernel and plain path) against the JAX ``ssd_chunked`` forward and
``jax.grad``, and against the step-by-step oracle.  Tolerances are the
reference's own: forward atol 1e-5, gradients 1e-4.  The CUDA kernel
itself is held against the same plain version on the card by
``chip_smoke.py``.

The reference's ``ssd_chunked`` exponentiates its whole (L, L) decay
before masking it; at the published chunk of 256 the masked ``inf``
becomes NaN in the gradient of dt.  The port exponentiates the kept
entries only; ``test_reference_decay_overflow_is_not_copied`` records the
divergence.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_diag as j_ssd_diag  # noqa: E402
from repro.models import api as jAPI  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_scan as tSS  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

ATOL = 1e-5
GRAD_TOL = 1e-4
#: the shapes of the reference's test_ssd_diag: (b, nc, L, ds, nh, hd)
DIAG_SHAPES = [(1, 2, 64, 16, 2, 32), (2, 1, 128, 64, 4, 64)]
JCFG = JC.reduced(JC.ARCHS["zamba2-1.2b"])
TCFG = TC.reduced(TC.ZAMBA2_1_2B)


def _diag_inputs(seed, b, nc, L, ds, nh, hd):
    """cr, br, dtx ~ N(0, 1); a decreasing cumulative log-decay, as in the
    reference's test."""
    rng = np.random.default_rng(seed)
    cr = rng.normal(size=(b, nc, L, ds)).astype(np.float32)
    br = rng.normal(size=(b, nc, L, ds)).astype(np.float32)
    a = -np.abs(rng.normal(size=(b, nc, L, nh))).astype(np.float32) * 0.1
    cum = np.cumsum(a, axis=2).astype(np.float32)
    dtx = rng.normal(size=(b, nc, L, nh, hd)).astype(np.float32)
    return cr, br, cum, dtx


@pytest.mark.parametrize("impl", ["cuda", "reference"])
@pytest.mark.parametrize("shape", DIAG_SHAPES)
def test_ssd_diag_matches_jax_kernel(shape, impl):
    ins = _diag_inputs(0, *shape)
    jins = [jnp.asarray(t) for t in ins]
    want_kernel = np.asarray(j_ssd_diag(*jins, interpret=True))
    want_ref = np.asarray(jref.ssd_diag_ref(*jins))
    tSS.reset_launches()
    got = tops.ssd_diag(*(torch.tensor(t) for t in ins), impl=impl).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL)
    assert tSS.LAUNCHES == {"ssd_diag": 0}        # no kernel on the CPU


@pytest.mark.parametrize("shape", DIAG_SHAPES)
def test_ssd_diag_op_grads_match_plain_autograd(shape):
    """The kernel op's recompute backward against plain autograd in the
    port and ``jax.vjp`` of the reference oracle: all four cotangents,
    ``cum`` included (it carries dt's and A's gradients)."""
    ins = _diag_inputs(1, *shape)
    gy = np.random.default_rng(2).normal(
        size=shape[:3] + shape[4:]).astype(np.float32)
    _, vjp = jax.vjp(jref.ssd_diag_ref, *(jnp.asarray(t) for t in ins))
    jgrads = vjp(jnp.asarray(gy))
    for impl in ("cuda", "reference"):
        leaves = [torch.tensor(t, requires_grad=True) for t in ins]
        y = tops.ssd_diag(*leaves, impl=impl)
        grads = torch.autograd.grad(y, leaves, torch.tensor(gy))
        for name, g, j in zip(("cr", "br", "cum", "dtx"), grads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(j),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"{impl} {name}")


def test_ssd_diag_ragged_and_strided_operands():
    """A ragged L and non-contiguous views give the same numbers as
    contiguous copies (the kernel reads strided operands in place)."""
    cr, br, cum, dtx = (torch.tensor(t) for t in
                        _diag_inputs(3, 2, 1, 45, 16, 3, 16))
    y = tSS.ssd_diag(cr, br, cum, dtx)
    wide = torch.zeros(2, 1, 45, 5, 16)
    wide[:, :, :, 1:4] = dtx
    got = tSS.ssd_diag(cr, br, cum, wide[:, :, :, 1:4])
    np.testing.assert_allclose(got.numpy(), y.numpy(), rtol=0, atol=ATOL)
    assert tuple(y.shape) == (2, 1, 45, 3, 16)


def test_ssd_diag_operand_checks_raise():
    cr, br, cum, dtx = (torch.tensor(t) for t in
                        _diag_inputs(4, 1, 1, 32, 16, 2, 16))
    with pytest.raises(ValueError, match="cr and br"):
        tops.ssd_diag(cr, br[..., :8], cum, dtx)
    with pytest.raises(ValueError, match="cum must be"):
        tops.ssd_diag(cr, br, cum[:, :, :16], dtx)
    with pytest.raises(ValueError, match="dtx must be"):
        tops.ssd_diag(cr, br, cum, dtx[:, :, :, :1])
    with pytest.raises(ValueError, match="kernels/impl"):
        tops.ssd_diag(cr, br, cum, dtx, impl="triton")


def _chunked_inputs(seed, b=2, s=64, nh=3, hd=8, ds=4):
    """The setting of the reference's tests/test_recurrences.py."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    Bm = rng.normal(size=(b, s, ds)).astype(np.float32)
    Cm = rng.normal(size=(b, s, ds)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, nh)))).astype(np.float32)
    A = -np.abs(rng.normal(size=(nh,))).astype(np.float32)
    return xh, Bm, Cm, dt, A


def _t(arrs, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrs]


@pytest.mark.parametrize("kernels", ["cuda", "reference"])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_chunked_matches_jax(chunk, kernels):
    """Forward (y, h_final) and the gradients of xh, Bm, Cm, dt and A of
    sum(y · g) against ``jax.grad`` of the JAX ``ssd_chunked``.  y reaches
    |y| ≈ 10 here, where f32 sums taken in another order differ by about
    1e-5: the forward is held to 1e-5 of max(1, max|y|)."""
    ins = _chunked_inputs(5)
    g = np.random.default_rng(6).normal(size=ins[0].shape).astype(np.float32)

    def jloss(*a):
        y, _ = jssm.ssd_chunked(*a, chunk=chunk)
        return (y * g).sum()

    jy, jh = jssm.ssd_chunked(*(jnp.asarray(a) for a in ins), chunk=chunk)
    jgrads = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in ins))
    leaves = _t(ins, grad=True)
    y, h = tssm.ssd_chunked(*leaves, chunk, kernels=kernels)
    for got, want in ((y, jy), (h, jh)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(want).max()))
    grads = torch.autograd.grad((y * torch.tensor(g)).sum(), leaves)
    for name, t, j in zip(("xh", "Bm", "Cm", "dt", "A"), grads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_recurrent(chunk):
    """The chunked algorithm (kernel path) against the step-by-step
    oracle, at the reference's tolerance (tests/test_recurrences.py)."""
    ins = _t(_chunked_inputs(0))
    y_c, h_c = tssm.ssd_chunked(*ins, chunk=chunk, kernels="cuda")
    y_r, h_r = tssm.ssd_recurrent_ref(*ins)
    np.testing.assert_allclose(y_c.numpy(), y_r.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h_c.numpy(), h_r.numpy(), rtol=1e-4,
                               atol=1e-4)
    jy, jh = jssm.ssd_recurrent_ref(*(jnp.asarray(a) for a in
                                      _chunked_inputs(0)))
    np.testing.assert_allclose(y_r.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(h_r.numpy(), np.asarray(jh), rtol=0,
                               atol=ATOL)


def _recurrent_dt_grad_f64(xh, Bm, Cm, dt, A):
    """d sum(y) / d dt of the step-by-step recurrence, in float64."""
    xh, Bm, Cm, A = (torch.tensor(a, dtype=torch.float64)
                     for a in (xh, Bm, Cm, A))
    leaf = torch.tensor(dt, dtype=torch.float64, requires_grad=True)
    b, s, nh, hd = xh.shape
    h = torch.zeros(b, nh, hd, Bm.shape[-1], dtype=torch.float64)
    total = 0.0
    for t in range(s):
        d = leaf[:, t]
        h = h * torch.exp(d * A)[:, :, None, None] + \
            d[:, :, None, None] * xh[:, t, :, :, None] * Bm[:, t, None, None]
        total = total + torch.einsum("bhpi,bi->", h, Cm[:, t])
    return torch.autograd.grad(total, leaf)[0].numpy()


def test_reference_decay_overflow_is_not_copied():
    """At the published chunk (L = 256), dt = 0.69 and A = -1 (A_log
    initialises to zeros), the reference's gradient of dt is NaN: its
    masked-out decay entries overflow to inf and the backward computes
    0 · inf.  The port's gradient is finite and within 1e-4 relative of
    a float64 evaluation of the step-by-step recurrence."""
    b, s, nh, hd, ds = 1, 256, 2, 8, 4
    rng = np.random.default_rng(7)
    xh = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    Bm = rng.normal(size=(b, s, ds)).astype(np.float32)
    Cm = rng.normal(size=(b, s, ds)).astype(np.float32)
    dt = np.full((b, s, nh), 0.69, np.float32)
    A = -np.ones((nh,), np.float32)

    def jloss(dt_):
        y, _ = jssm.ssd_chunked(jnp.asarray(xh), jnp.asarray(Bm),
                                jnp.asarray(Cm), dt_, jnp.asarray(A),
                                chunk=256)
        return y.sum()

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(dt)))
    assert np.isnan(jg).any()

    grads = {}
    for kernels in ("cuda", "reference"):
        leaf = torch.tensor(dt, requires_grad=True)
        y, _ = tssm.ssd_chunked(*_t([xh, Bm, Cm]), leaf, torch.tensor(A),
                                256, kernels=kernels)
        grads[kernels] = torch.autograd.grad(y.sum(), leaf)[0]
    want = _recurrent_dt_grad_f64(xh, Bm, Cm, dt, A)
    for kernels, g in grads.items():
        assert bool(torch.isfinite(g).all()), kernels
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=kernels)


@functools.lru_cache(maxsize=None)
def _layer_params():
    """Layer 1 of the reduced zamba2's Mamba2 stack, JAX initialisation."""
    jp = jax.device_get(jAPI.init_params(jax.random.PRNGKey(0), JCFG))
    return {k: v[1] for k, v in jp["mamba"].items()}


@pytest.mark.parametrize("kernels", ["cuda", "reference"])
@pytest.mark.parametrize("masked", [False, True])
def test_mamba2_fwd_matches_jax(masked, kernels):
    """The full Mamba2 block (projections, causal conv, chunked SSD with
    S = 64 over chunks of 32, gate, output projection) with and without a
    head mask, forward and every parameter gradient."""
    p = _layer_params()
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 64, JCFG.d_model)).astype(np.float32)
    nh = JCFG.ssm_expand * JCFG.d_model // JCFG.ssm_head_dim
    hm = (rng.random(nh) < 0.5).astype(np.float32) if masked else None
    g = rng.normal(size=x.shape).astype(np.float32)

    def jfwd(params):
        return jssm.mamba2_fwd(params, jnp.asarray(x), JCFG,
                               head_mask=None if hm is None
                               else jnp.asarray(hm))

    jy, vjp = jax.vjp(jfwd, {k: jnp.asarray(v) for k, v in p.items()})
    (jg,) = vjp(jnp.asarray(g))
    tp = params_from_numpy(p, device="cpu")
    for v in tp.values():
        v.requires_grad_(True)
    y = tssm.mamba2_fwd(tp, torch.tensor(x), TCFG,
                        head_mask=None if hm is None else torch.tensor(hm),
                        kernels=kernels)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL)
    grads = torch.autograd.grad(y, list(tp.values()), torch.tensor(g))
    for k, t in zip(tp, grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(jg[k]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)
    if masked:                      # masked-out heads: zero wx/wdt grads
        dead = hm == 0
        assert np.all(grads[list(tp).index("wx")].numpy()[:, dead] == 0)
        assert np.all(grads[list(tp).index("wdt")].numpy()[:, dead] == 0)
