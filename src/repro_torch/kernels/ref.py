# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Plain PyTorch versions of the CUDA kernels (the allclose targets).

The kernel wrappers take these for tensors on the CPU, and ``chip_smoke.py``
holds each kernel against them on the card.
"""
from __future__ import annotations

import torch


def _block_mask(live: torch.Tensor, block: int, length: int,
                dtype: torch.dtype) -> torch.Tensor:
    """(length,) 0/1 mask whose blocks listed in ``live`` are 1."""
    nb = -(-length // block)
    alive = torch.zeros(nb, dtype=dtype, device=live.device)
    alive[live.long()] = 1
    return alive.repeat_interleave(block)[:length]


def masked_matmul_ref(x: torch.Tensor, w: torch.Tensor, live: torch.Tensor,
                      block_n: int) -> torch.Tensor:
    """y = x @ (w * column-block mask); ``live`` lists the live N-blocks."""
    mask = _block_mask(live, block_n, w.shape[1], w.dtype)
    return x @ (w * mask[None, :])


def masked_matmul_dk_ref(x: torch.Tensor, w: torch.Tensor, live: torch.Tensor,
                         block_k: int) -> torch.Tensor:
    """y = x @ (w * row-block mask): the contraction blocks not in ``live``
    are skipped (exact when the skipped entries of ``x`` are zero)."""
    mask = _block_mask(live, block_k, w.shape[0], w.dtype)
    return x @ (w * mask[:, None])


def masked_matmul_clients_ref(x: torch.Tensor, w: torch.Tensor,
                              live: torch.Tensor, counts: torch.Tensor,
                              block_n: int) -> torch.Tensor:
    """:func:`masked_matmul_ref` client by client: x (C, M, K), w (C, K, N),
    client c's live N-blocks ``live[c, :counts[c]]``."""
    return torch.stack([masked_matmul_ref(x[c], w[c], live[c, :int(counts[c])],
                                          block_n)
                        for c in range(x.shape[0])])


def masked_matmul_dk_clients_ref(x: torch.Tensor, w: torch.Tensor,
                                 live: torch.Tensor, counts: torch.Tensor,
                                 block_k: int) -> torch.Tensor:
    """:func:`masked_matmul_dk_ref` client by client."""
    return torch.stack([masked_matmul_dk_ref(x[c], w[c],
                                             live[c, :int(counts[c])], block_k)
                        for c in range(x.shape[0])])


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Dense softmax attention.  q, k, v: (B, H, S, hd); f32 arithmetic,
    masked scores at -1e30, output in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.arange(sq, device=s.device)[:, None] >= \
            torch.arange(sk, device=s.device)[None, :]
        s = torch.where(mask, s, torch.full((), -1e30, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def ssd_diag_ref(cr: torch.Tensor, br: torch.Tensor, cum: torch.Tensor,
                 dtx: torch.Tensor) -> torch.Tensor:
    """Mamba2 intra-chunk term (the einsum form of the reference's
    ``ssd_chunked``): ``y[l, p] = Σ_{m≤l} (C_l·B_m) · exp(cum_l − cum_m) ·
    dtx[m, p]`` per (batch, chunk, head).

    cr, br: (B, nc, L, ds); cum: (B, nc, L, nh); dtx: (B, nc, L, nh, hd)
    -> (B, nc, L, nh, hd) in dtx's dtype, f32 arithmetic.  The decay is
    exponentiated on the kept (m ≤ l) entries only: above the diagonal
    ``cum_l − cum_m`` is positive and can overflow ``exp``, whose ``inf``
    the reference masks to 0 in the forward but turns into ``0 · inf =
    NaN`` in the backward.
    """
    cum = cum.float()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,L,L,nh)
    L = cr.shape[2]
    tril = torch.ones(L, L, dtype=torch.bool, device=cr.device).tril()
    decay = torch.exp(seg.masked_fill(~tril[None, None, :, :, None],
                                      float("-inf")))
    cb = torch.einsum("bnli,bnmi->bnlm", cr.float(), br.float())
    scores = cb[..., None] * decay                          # (b,nc,L,L,nh)
    return torch.einsum("bnlmh,bnmhp->bnlhp", scores,
                        dtx.float()).to(dtx.dtype)
