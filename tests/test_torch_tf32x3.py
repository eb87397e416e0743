"""The 3xTF32 split product of the port's tensor-core kernels, emulated on
the CPU, and the kernels' C interface against their ctypes declarations.

``csrc/flash_attention.cu`` and ``csrc/ssd_scan.cu`` run every f32 product
as three TF32 tensor-core products: ``hi = cvt.rna.tf32.f32(x)`` (the int32
bit pattern rounded at bit 13, ties away from zero), ``lo = x - hi`` (exact
in f32; the MMA reads its top 19 bits, i.e. cuts it to TF32), and
``ah·bl + al·bh + ah·bh`` summed in f32 per 8-deep k-step, the two small
products first.  The emulation below does the same in numpy, per k-step,
and holds causal attention at the LM slice's per-head shape (S 512, hd 128)
and the SSD intra-chunk term at the hybrid's (L 256, ds 64, hd 64, the
model's decay at init) to the f64 result within ``chip_smoke.py``'s f32
gate, and to the JAX package's reference on the same inputs.  One TF32
product misses that gate; its error is pinned too, which is why the
kernels pay for three.  The kernels themselves run only on the card
(``chip_smoke.py``).
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as tFA  # noqa: E402
from repro_torch.kernels import ssd_scan as tSS  # noqa: E402

#: chip_smoke.py's gate for f32 kernels, relative to the output's scale
F32_TOL = 1e-4
K_STEP = 8                       # depth of one m16n8k8 MMA
TF32_MASK = np.uint32(0xFFFFE000)


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round the bit pattern at bit 13, ties away."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & TF32_MASK).view(np.float32)


def cut_tf32(x: np.ndarray) -> np.ndarray:
    """What the MMA reads of an f32 register: its top 19 bits."""
    return (np.asarray(x, np.float32).view(np.uint32) & TF32_MASK).view(
        np.float32)


def split(x: np.ndarray):
    """The kernels' split, as the MMA sees it: (hi, lo cut to TF32)."""
    x = np.asarray(x, np.float32)
    hi = rna_tf32(x)
    return hi, cut_tf32(x - hi)


def _mma(acc, a, b):
    """One MMA: exact products of TF32 operands, summed into f32."""
    return (acc + (a.astype(np.float64) @ b.astype(np.float64))
            .astype(np.float32)).astype(np.float32)


def matmul_tf32(a: np.ndarray, b: np.ndarray, products: int = 3):
    """a @ b in K_STEP-deep MMAs: 3xTF32 (small products first, as the
    kernels issue them) or one TF32 product."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], K_STEP):
        ak, bk = a[:, k0:k0 + K_STEP], b[k0:k0 + K_STEP]
        if products == 1:
            acc = _mma(acc, rna_tf32(ak), rna_tf32(bk))
            continue
        (ah, al), (bh, bl) = split(ak), split(bk)
        acc = _mma(acc, ah, bl)
        acc = _mma(acc, al, bh)
        acc = _mma(acc, ah, bh)
    return acc


def _attention(q, k, v, mm):
    """Causal attention of one head with the products taken by ``mm`` and
    the softmax in f32 (masked scores at -1e30, as in the kernel)."""
    s = mm(q, k.T) * np.float32(q.shape[1] ** -0.5)
    s = np.where(np.tril(np.ones(s.shape, bool)), s, np.float32(-1e30))
    p = np.exp(s - s.max(axis=1, keepdims=True)).astype(np.float32)
    return mm(p / p.sum(axis=1, keepdims=True), v)


def _ssd_term(cr, br, cum, dtx, mm):
    """The SSD intra-chunk term of one head, products taken by ``mm``, the
    decay exponentiated on the kept entries only."""
    keep = np.tril(np.ones((cr.shape[0],) * 2, bool))
    seg = np.where(keep, cum[:, None] - cum[None, :], -np.inf)
    return mm((mm(cr, br.T) * np.exp(seg)).astype(np.float32), dtx)


def _f64(a, b):
    return a.astype(np.float64) @ b.astype(np.float64)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _attention_inputs(seed=0, s=512, hd=128):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(s, hd)).astype(np.float32) for _ in range(3)]


def _ssd_inputs(seed=0, L=256, ds=64, hd=64):
    """The model's decay at init: dt = softplus(N), A = -1."""
    rng = np.random.default_rng(seed)
    cr, br = (rng.normal(size=(L, ds)).astype(np.float32) for _ in range(2))
    a = -np.log1p(np.exp(rng.normal(size=L))).astype(np.float32)
    dtx = rng.normal(size=(L, hd)).astype(np.float32)
    return cr, br, np.cumsum(a).astype(np.float32), dtx


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3.7e5, 1e30])
def test_split_reconstructs_x(scale):
    """hi + lo holds x to 2^-21 relative (hi alone to 2^-11); hi has at
    most 11 significant bits, ties round away from zero."""
    x = (np.random.default_rng(1).normal(size=4096) * scale).astype(
        np.float32)
    hi, lo = split(x)
    assert np.all(hi.view(np.uint32) & ~TF32_MASK == 0)
    assert np.all(lo.view(np.uint32) & ~TF32_MASK == 0)
    err = np.abs(x.astype(np.float64) - hi - lo.astype(np.float64))
    assert np.all(err <= 2.0 ** -21 * np.abs(x))
    assert np.all(np.abs(x.astype(np.float64) - hi) <= 2.0 ** -11 * np.abs(x))


def test_rna_ties_away_from_zero():
    # 1 + 2^-11 sits halfway between two TF32 neighbours
    x = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12],
                 np.float32)
    np.testing.assert_array_equal(rna_tf32(x),
                                  np.array([1 + 2.0 ** -10,
                                            -(1 + 2.0 ** -10), 1.0],
                                           np.float32))


def test_bf16_operand_splits_exactly():
    """A bf16 operand widened to f32 fits TF32: hi is x, lo is 0."""
    x = torch.randn(1000, generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16).float().numpy()
    hi, lo = split(x)
    np.testing.assert_array_equal(hi, x)
    assert not lo.any()


# ---------------------------------------------------------------------------
# the slice's two products, emulated
# ---------------------------------------------------------------------------


def test_attention_3xtf32_within_f32_gate():
    q, k, v = _attention_inputs()
    want = _attention(q, k, v, _f64)
    three = _attention(q, k, v, matmul_tf32)
    one = _attention(q, k, v, lambda a, b: matmul_tf32(a, b, products=1))
    f32 = _attention(q, k, v, lambda a, b: a @ b)
    assert _rel(three, want) <= 1e-6           # measured ~2e-7
    assert _rel(f32, want) <= 1e-6
    # one TF32 product misses the gate (measured ~5e-4)
    assert F32_TOL < _rel(one, want) < 2e-3
    jax_ref = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(t)[None, None] for t in (q, k, v)), causal=True))[0, 0]
    assert _rel(three, jax_ref) <= F32_TOL


def test_ssd_term_3xtf32_within_f32_gate():
    cr, br, cum, dtx = _ssd_inputs()
    want = _ssd_term(cr, br, cum, dtx, _f64)
    three = _ssd_term(cr, br, cum, dtx, matmul_tf32)
    one = _ssd_term(cr, br, cum, dtx,
                    lambda a, b: matmul_tf32(a, b, products=1))
    assert np.isfinite(three).all()
    assert _rel(three, want) <= 1e-6           # measured ~2e-7
    assert F32_TOL < _rel(one, want) < 2e-3     # measured ~5e-4
    # the reference's layout: (b, nc, L, ds) / (b, nc, L, nh) / (b, nc, L,
    # nh, hd), one batch, chunk and head
    jax_ref = np.asarray(jref.ssd_diag_ref(
        jnp.asarray(cr)[None, None], jnp.asarray(br)[None, None],
        jnp.asarray(cum)[None, None, :, None],
        jnp.asarray(dtx)[None, None, :, None]))[0, 0, :, 0]
    assert _rel(three, jax_ref) <= F32_TOL


@pytest.mark.parametrize("seed", [3, 4])
def test_split_product_beats_one_tf32_product(seed):
    """On any inputs the 3xTF32 product is a hundredfold closer to the f64
    product than one TF32 product."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(64, 256)).astype(np.float32)
    b = rng.normal(size=(256, 48)).astype(np.float32)
    want = _f64(a, b)
    three = _rel(matmul_tf32(a, b), want)
    one = _rel(matmul_tf32(a, b, products=1), want)
    assert three * 100 < one


# ---------------------------------------------------------------------------
# the C interface and the copy variants
# ---------------------------------------------------------------------------


def _c_kind(param: str):
    if "*" in param:
        return ctypes.c_void_p
    if "long long" in param:
        return ctypes.c_longlong
    if re.match(r"\s*int\s+\w+\s*$", param):
        return ctypes.c_int
    if re.match(r"\s*float\s+\w+\s*$", param):
        return ctypes.c_float
    raise AssertionError(f"unexpected C parameter {param!r}")


@pytest.mark.parametrize("mod,name", [(tFA, "helios_flash_attention"),
                                      (tSS, "helios_ssd_diag")])
def test_c_signature_matches_argtypes(mod, name):
    src = (build.CSRC / f"{mod.SOURCE}.cu").read_text()
    sig = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert sig, f"{name} not found in {mod.SOURCE}.cu"
    kinds = [_c_kind(p) for p in sig.group(1).split(",")]
    assert kinds == mod._ARGTYPES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_copy_variant_follows_alignment(dtype):
    """The model's (B, S, H, hd) views take 16-byte copies; a buffer one
    element wider than the head dim puts rows off the 16-byte grid."""
    buf = torch.zeros(2, 64, 4, 64, dtype=dtype)
    assert tFA.aligned(buf.transpose(1, 2))
    wide = torch.zeros(2, 64, 4, 65, dtype=dtype)[..., :64]
    assert not tFA.aligned(wide.transpose(1, 2))
    assert not tFA.aligned(buf.flatten()[1:].view(-1)[:4])
