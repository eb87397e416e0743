"""Port parity: the masked kernel ops (``repro_torch.kernels.ops``) against
the JAX package's ``impl="pallas"`` ops (Pallas in interpret mode).

On the CPU the port's kernel wrappers compute their plain versions, so
these tests pin the autograd structure around the CUDA kernels (forward,
dx through the contraction-skipping kernel, dw through the column-skipping
kernel, the re-multiply by the unit mask) on aligned, non-block-constant
and ragged shapes.  Tolerance atol 1e-5 (f32, inputs scaled so every value
is O(1)); masked gradient columns must be exactly 0.  The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py``.
"""
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
from repro_torch.kernels import masked_matmul as tK  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ATOL = 1e-5


def _unit_mask(rng, n, frac, block=None):
    m = (rng.random(n) < frac).astype(np.float32)
    m[0] = 1.0                                    # never fully dead
    if block:
        m = np.asarray(jops.block_align_mask(jnp.asarray(m), block))
    return m


def _inputs(seed, m, k, n, frac, block):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    g = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(np.float32)
    return x, w, g, _unit_mask(rng, n, frac, block)


def _jax_fwd_grads(fn, a, w, um, g):
    y, vjp = jax.vjp(lambda a_, w_: fn(a_, w_, jnp.asarray(um)),
                     jnp.asarray(a), jnp.asarray(w))
    da, dw = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(da), np.asarray(dw)


def _torch_fwd_grads(fn, a, w, um, g):
    ta = torch.tensor(a, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    y = fn(ta, tw, torch.tensor(um))
    da, dw = torch.autograd.grad(y, (ta, tw), torch.tensor(g))
    return y.detach().numpy(), da.numpy(), dw.numpy()


@pytest.mark.parametrize("m,k,n,bn", [
    (32, 48, 96, 32),            # aligned
    (5, 37, 84, 32),             # every axis ragged vs the blocks
    (16, 64, 64, 128),           # block larger than the whole axis
])
@pytest.mark.parametrize("frac", [0.3, 1.0])
def test_masked_dense_matches_jax(m, k, n, bn, frac):
    x, w, g, um = _inputs(0, m, k, n, frac, bn)
    want = _jax_fwd_grads(lambda a, b, u: jops.masked_dense(
        a, b, u, impl="pallas", block_n=bn), x, w, um, g)
    got = _torch_fwd_grads(lambda a, b, u: tops.masked_dense(
        a, b, u, impl="cuda", block_n=bn), x, w, um, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    dead = um == 0
    assert np.all(got[0][:, dead] == 0.0)          # masked outputs
    assert np.all(got[2][:, dead] == 0.0)          # frozen-neuron dw


def test_masked_dense_non_block_constant_mask():
    """A unit mask that is NOT block-constant (a live block holding dead
    units) stays exact: the kernel output is re-multiplied by the mask."""
    x, w, g, _ = _inputs(3, 8, 16, 64, 0.5, None)
    um = _unit_mask(np.random.default_rng(4), 64, 0.5, block=None)
    want = _jax_fwd_grads(lambda a, b, u: jops.masked_dense(
        a, b, u, impl="pallas", block_n=32), x, w, um, g)
    got = _torch_fwd_grads(lambda a, b, u: tops.masked_dense(
        a, b, u, impl="pallas", block_n=32), x, w, um, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[0], x @ (w * um[None, :]), atol=ATOL)
    assert np.all(got[2][:, um == 0] == 0.0)


@pytest.mark.parametrize("m,n,k2,bn", [(32, 96, 24, 32), (7, 84, 11, 32)])
@pytest.mark.parametrize("frac", [0.3, 1.0])
def test_masked_contract_matches_jax(m, n, k2, bn, frac):
    h, w, g, um = _inputs(1, m, n, k2, 1.0, None)
    um = _unit_mask(np.random.default_rng(2), n, frac, block=bn)
    h = h * um[None, :]                   # h came through a masked layer
    want = _jax_fwd_grads(lambda a, b, u: jops.masked_contract(
        a, b, u, impl="pallas", block_n=bn), h, w, um, g)
    got = _torch_fwd_grads(lambda a, b, u: tops.masked_contract(
        a, b, u, impl="cuda", block_n=bn), h, w, um, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    dead = um == 0
    assert np.all(got[1][:, dead] == 0.0)          # dh dead columns
    assert np.all(got[2][dead] == 0.0)             # dw dead rows


def test_reference_impl_matches_kernel_impl():
    x, w, g, um = _inputs(5, 6, 40, 70, 0.5, 32)
    for impl in ("reference", "cuda"):
        np.testing.assert_allclose(
            _torch_fwd_grads(lambda a, b, u: tops.masked_dense(
                a, b, u, impl=impl, block_n=32), x, w, um, g)[0],
            x @ (w * um[None, :]), atol=ATOL)
    with pytest.raises(ValueError):
        tops.masked_dense(torch.tensor(x), torch.tensor(w), torch.tensor(um),
                          impl="triton")


def test_plain_kernels_skip_dead_blocks():
    """The plain versions the CPU takes: live-list semantics of the column
    and contraction kernels, ragged tail block included."""
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(size=(5, 70)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(70, 84)).astype(np.float32))
    live = tK.live_blocks(torch.tensor([1.0, 0.0, 1.0]))     # blocks of 32
    assert live.dtype == torch.int32 and live.tolist() == [0, 2]
    y = tK.masked_matmul(x, w, live, 32)
    col = np.zeros(84, np.float32)
    col[:32] = col[64:] = 1
    np.testing.assert_allclose(y.numpy(), x.numpy() @ (w.numpy() * col),
                               atol=1e-4)
    assert np.all(y.numpy()[:, 32:64] == 0)
    yk = tK.masked_matmul_dk(x, w, live, 32)
    row = np.zeros(70, np.float32)
    row[:32] = row[64:] = 1
    np.testing.assert_allclose(yk.numpy(),
                               (x.numpy() * row) @ w.numpy(), atol=1e-4)
    np.testing.assert_array_equal(
        tref.masked_matmul_ref(x, w, live, 32).numpy(), y.numpy())
    assert tK.LAUNCHES == {"masked_matmul": 0, "masked_matmul_dk": 0}


# ---------------------------------------------------------------------------
# block_align_mask / _block_alive: the port against the reference, and the
# reference's properties (idempotent, superset, block-constant)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,block", [(1, 1), (7, 3), (84, 32), (96, 32),
                                     (130, 64)])
def test_block_align_and_alive_match_jax(n, block):
    rng = np.random.default_rng(n + block)
    for frac in (0.1, 0.5, 0.9):
        m = (rng.random(n) < frac).astype(np.float32)
        got = tops.block_align_mask(torch.tensor(m), block).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jops.block_align_mask(jnp.asarray(m), block)))
        np.testing.assert_array_equal(
            tops._block_alive(torch.tensor(m), block).numpy(),
            np.asarray(jops._block_alive(jnp.asarray(m), block)))


hyp = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

_masks = st.lists(st.booleans(), min_size=1, max_size=96).map(
    lambda bits: torch.tensor(np.asarray(bits, np.float32)))
_blocks = st.integers(1, 64)


@settings(max_examples=40, deadline=None)
@given(_masks, _blocks)
def test_block_align_idempotent(m, block):
    once = tops.block_align_mask(m, block)
    assert torch.equal(once, tops.block_align_mask(once, block))


@settings(max_examples=40, deadline=None)
@given(_masks, _blocks)
def test_block_align_superset(m, block):
    out = tops.block_align_mask(m, block)
    assert bool(torch.all(out >= m))
    assert set(out.unique().tolist()) <= {0.0, 1.0}


@settings(max_examples=40, deadline=None)
@given(_masks, _blocks)
def test_block_align_block_constant(m, block):
    """Every full block of the output is all-0 or all-1; the ragged tail's
    real entries are too."""
    out = tops.block_align_mask(m, block).numpy()
    n = out.shape[-1]
    for lo in range(0, n, block):
        b = out[lo:lo + block]
        assert b.max() == b.min()
