# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Mamba2 (SSD) block in chunked matmul form: the training forward.

Training uses the chunked SSD algorithm: an attention-like intra-chunk term
plus a scan of chunk states across chunks.  With ``kernels="cuda"`` the
intra-chunk term runs on the ``ssd_diag`` kernel (``kernels/ssd_scan.py``),
which keeps the (L, L, nh) decay tensors out of device memory; otherwise it
is the plain einsum form.  The chunk states, the scan over chunks (a Python
loop over nc) and the inter-chunk term stay plain PyTorch, as they are
plain jnp in the reference.  Decode and the prefill cache are not ported.

Helios unit: ``ssm_heads``; state dims within a head are coupled, heads
are independent.

The reference exponentiates the whole (L, L) decay before masking it:
above the diagonal the exponent is positive and overflows at the published
chunk of 256, and the backward turns the masked ``inf`` into NaN.  The
port exponentiates the kept entries only (``kernels/ref.py``
``ssd_diag_ref``): the same forward, and the same gradients wherever the
reference's are finite.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.module import P

D_CONV = 4  # depthwise causal conv kernel width


def mamba2_spec(cfg):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nh = d_in // cfg.ssm_head_dim
    hd = cfg.ssm_head_dim
    ds = cfg.ssm_state
    return {
        "wx": P((d, nh, hd), ("embed", "ssm_heads", "head_dim")),
        "wz": P((d, nh, hd), ("embed", "ssm_heads", "head_dim")),
        "wB": P((d, ds), ("embed", "ssm_state")),
        "wC": P((d, ds), ("embed", "ssm_state")),
        "wdt": P((d, nh), ("embed", "ssm_heads")),
        "dt_bias": P((nh,), ("ssm_heads",), init="zeros"),
        "A_log": P((nh,), ("ssm_heads",), init="zeros"),
        "D": P((nh,), ("ssm_heads",), init="ones"),
        "conv": P((D_CONV, nh, hd), ("conv_k", "ssm_heads", "head_dim"),
                  scale=0.5),
        "wo": P((nh, hd, d), ("ssm_heads", "head_dim", "embed")),
    }


def _proj(params, x, head_mask):
    """Shared projections.  x: (B, S, d)."""
    xh = torch.einsum("bsd,dhk->bshk", x, params["wx"])
    z = torch.einsum("bsd,dhk->bshk", x, params["wz"])
    Bm = x @ params["wB"]                                    # (B, S, ds)
    Cm = x @ params["wC"]
    dt = F.softplus(x @ params["wdt"] + params["dt_bias"])   # (B, S, nh)
    if head_mask is not None:
        xh = xh * head_mask.to(xh.dtype)[None, None, :, None]
        dt = dt * head_mask.to(dt.dtype)[None, None, :]
    return xh, z, Bm, Cm, dt


def _causal_conv(xh, kernel):
    """Depthwise causal conv over time.  xh: (B, S, nh, hd); kernel:
    (K, nh, hd)."""
    pad = F.pad(xh, (0, 0, 0, 0, D_CONV - 1, 0))
    out = torch.zeros_like(xh)
    for i in range(D_CONV):
        out = out + pad[:, i:i + xh.shape[1]] * kernel[i][None, None]
    return F.silu(out)


def ssd_chunked(xh, Bm, Cm, dt, A, chunk: int, *,
                kernels: Optional[str] = None):
    """Chunked SSD.  xh: (B, S, nh, hd); Bm, Cm: (B, S, ds); dt: (B, S, nh);
    A: (nh,) < 0.  ``kernels="cuda"`` computes the intra-chunk term on the
    ``ssd_diag`` kernel.

    Returns (y, h_final) with h_final: (B, nh, hd, ds).
    """
    b, s, nh, hd = xh.shape
    ds = Bm.shape[-1]
    nc = max(1, s // chunk)
    L = s // nc
    f32 = torch.float32

    xr = xh.reshape(b, nc, L, nh, hd)
    Br = Bm.reshape(b, nc, L, ds).to(f32)
    Cr = Cm.reshape(b, nc, L, ds).to(f32)
    dtr = dt.reshape(b, nc, L, nh).to(f32)
    a = dtr * A[None, None, None, :]                         # (b,nc,L,nh) <= 0
    cum = torch.cumsum(a, dim=2)                             # inclusive
    dtx = dtr[..., None] * xr.to(f32)                        # (b,nc,L,nh,hd)

    # ---- intra-chunk (attention-like, per head) ----
    y_diag = ops.ssd_diag(Cr, Br, cum, dtx, impl=kernels or ops.REFERENCE)

    # ---- chunk states ----
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)           # (b,nc,L,nh)
    states = torch.einsum("bnlh,bnlhp,bnli->bnhpi", decay_out, dtx, Br)

    # ---- inter-chunk recurrence over nc (small) ----
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (b,nc,nh)
    h = torch.zeros((b, nh, hd, ds), dtype=f32, device=xh.device)
    h_starts = []
    for c in range(nc):
        h_starts.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_starts = torch.stack(h_starts, dim=1)                  # (b,nc,nh,hd,ds)

    # ---- inter contribution ----
    y_off = torch.einsum("bnli,bnhpi,bnlh->bnlhp", Cr, h_starts,
                         torch.exp(cum))
    y = (y_diag + y_off).reshape(b, s, nh, hd).to(xh.dtype)
    return y, h.to(xh.dtype)


def ssd_recurrent_ref(xh, Bm, Cm, dt, A):
    """Step-by-step oracle for tests."""
    b, s, nh, hd = xh.shape
    ds = Bm.shape[-1]
    f32 = torch.float32
    h = torch.zeros((b, nh, hd, ds), dtype=f32, device=xh.device)
    ys = []
    for t in range(s):
        a = torch.exp(dt[:, t].to(f32) * A)                  # (b, nh)
        upd = (dt[:, t, :, None, None] * xh[:, t, :, :, None].to(f32)
               * Bm[:, t, None, None, :].to(f32))
        h = h * a[:, :, None, None] + upd
        ys.append(torch.einsum("bhpi,bi->bhp", h, Cm[:, t].to(f32)))
    return torch.stack(ys, dim=1).to(xh.dtype), h.to(xh.dtype)


def mamba2_fwd(params, x, cfg, *, head_mask: Optional[torch.Tensor] = None,
               kernels: Optional[str] = None):
    """Full block in training mode: (B, S, d) -> (B, S, d)."""
    xh_raw, z, Bm, Cm, dt = _proj(params, x, head_mask)
    xh = _causal_conv(xh_raw, params["conv"])
    A = -torch.exp(params["A_log"].float())
    y, _ = ssd_chunked(xh, Bm, Cm, dt, A, cfg.ssm_chunk, kernels=kernels)
    y = y + params["D"][None, None, :, None] * xh
    y = y * F.silu(z)
    return torch.einsum("bshk,hkd->bsd", y, params["wo"])
