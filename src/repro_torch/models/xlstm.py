# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, exponential
gating) and sLSTM (scalar memory, recurrent h-feedback), and the xLSTM LM
(family ``ssm``): training loss, prefill and decode.

mLSTM trains with the reference's STABILIZED CHUNKWISE algorithm: within a
chunk every contribution reduces to attention-like products with the
per-query stabilizer m_i = b_i + max(m0, cummax_j(i_j - b_j)); the b_i
terms cancel inside the chunk, so the intra-chunk weights are
exp(u_j - rm_i)(k_j · q_i) for j <= i.  The reference exponentiates every
(i, j) pair and then zeroes j > i; above the diagonal u_j - rm_i can exceed
88 when forget gates are near 0, the exp overflows and the backward gives
0 · inf = NaN (ROADMAP §3).  The port exponentiates the kept pairs only,
which gives the same forward values.  A step-by-step recurrent form
(:func:`mlstm_recurrent_ref`) is the oracle and the decode step.  sLSTM is
sequential (h feeds back): a loop over time steps, as the reference's
``lax.scan``.

The blocks are unrolled with per-block params (``blocks/b<i>``, mixed
types); the Helios units are each block's heads, keyed ``b<i>:ssm_heads``
(mLSTM) and ``b<i>:slstm_heads`` (sLSTM).  No block reaches a kernel, as
in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.module import P

D_CONV = 4
#: the reference's mLSTM chunk (``mlstm_fwd``'s default; ``ssm_chunk`` is
#: not read)
CHUNK = 64


def _heads(cfg) -> Tuple[int, int]:
    d_in = 2 * cfg.d_model
    nh = cfg.num_heads
    return nh, d_in // nh


def _head_scale(t: torch.Tensor, head_mask, head_dim: int) -> torch.Tensor:
    """Multiply the heads axis (``head_dim``) by the 0/1 head mask."""
    if head_mask is None:
        return t
    shape = [1] * t.dim()
    shape[head_dim] = -1
    return t * head_mask.to(t.dtype).reshape(shape)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_spec(cfg):
    d = cfg.d_model
    nh, hd = _heads(cfg)
    return {
        "wx": P((d, nh, hd), ("embed", "ssm_heads", "head_dim")),
        "wz": P((d, nh, hd), ("embed", "ssm_heads", "head_dim")),
        "conv": P((D_CONV, nh, hd), ("conv_k", "ssm_heads", "head_dim"),
                  scale=0.5),
        "wq": P((nh, hd, hd), ("ssm_heads", "head_dim", "hd2")),
        "wk": P((nh, hd, hd), ("ssm_heads", "head_dim", "hd2")),
        "wv": P((nh, hd, hd), ("ssm_heads", "head_dim", "hd2")),
        "wgi": P((nh, hd), ("ssm_heads", "head_dim"), scale=0.01),
        "bgi": P((nh,), ("ssm_heads",), init="zeros"),
        "wgf": P((nh, hd), ("ssm_heads", "head_dim"), scale=0.01),
        "bgf": P((nh,), ("ssm_heads",), init="ones"),
        "lskip": P((nh, hd), ("ssm_heads", "head_dim"), init="ones"),
        "wo": P((nh, hd, d), ("ssm_heads", "head_dim", "embed")),
    }


def _qkv_gates(params, co, xi):
    q = torch.einsum("bshk,hkl->bshl", co, params["wq"])
    k = torch.einsum("bshk,hkl->bshl", co, params["wk"]) / (
        co.shape[-1] ** 0.5)
    v = torch.einsum("bshk,hkl->bshl", xi, params["wv"])
    gi = torch.einsum("bshk,hk->bsh", co, params["wgi"]) + params["bgi"]
    gf = torch.einsum("bshk,hk->bsh", co, params["wgf"]) + params["bgf"]
    return q, k, v, gi, gf


def _mlstm_proj(params, x, head_mask):
    """(xi, co, z, q, k, v, gi, gf): the input branch xi (head-masked), its
    causal conv + SiLU co, the gate branch z and the cell's inputs."""
    xi = _head_scale(torch.einsum("bsd,dhk->bshk", x, params["wx"]),
                     head_mask, 2)
    z = torch.einsum("bsd,dhk->bshk", x, params["wz"])
    pad = F.pad(xi, (0, 0, 0, 0, D_CONV - 1, 0))
    co = torch.zeros_like(xi)
    for i in range(D_CONV):
        co = co + pad[:, i:i + xi.shape[1]] * params["conv"][i][None, None]
    co = F.silu(co)
    return (xi, co, z) + _qkv_gates(params, co, xi)


def mlstm_chunkwise(q, k, v, gi, gf, chunk: int, state=None):
    """q, k, v: (B, S, nh, hd); gi, gf: (B, S, nh).  Returns (h, new_state).

    state = (C: (B, nh, hd, hd) value-major, n: (B, nh, hd), m: (B, nh));
    the stored C and n are normalized by exp(m).  S must be a multiple of
    its chunk count max(1, S // chunk), as in the reference."""
    b, s, nh, hd = q.shape
    nc = max(1, s // chunk)
    ln = s // nc
    f32 = torch.float32

    def rs(t):
        return t.to(f32).reshape((b, nc, ln) + tuple(t.shape[2:])).unbind(1)

    qs, ks, vs, gis, gfs = rs(q), rs(k), rs(v), rs(gi), rs(gf)
    if state is None:
        C = torch.zeros((b, nh, hd, hd), dtype=f32, device=q.device)
        n = torch.zeros((b, nh, hd), dtype=f32, device=q.device)
        m = torch.full((b, nh), -1e30, dtype=f32, device=q.device)
    else:
        C, n, m = (t.to(f32) for t in state)
    tril = torch.tril(torch.ones((ln, ln), dtype=torch.bool,
                                 device=q.device))[None, :, :, None]
    hs = []
    for qc, kc, vc, gic, gfc in zip(qs, ks, vs, gis, gfs):
        logf = F.logsigmoid(gfc)                              # (b, L, nh)
        bcum = torch.cumsum(logf, dim=1)                      # inclusive
        u = gic - bcum
        # the running max of u as a masked amax, whose backward writes each
        # gradient once (cummax's backward scatters with atomics on the GPU,
        # so a run would not repeat itself bit for bit)
        lower = torch.where(tril, u[:, None, :, :], float("-inf"))
        rm = torch.maximum(lower.amax(dim=2), m[:, None, :])  # (b, L, nh)
        # exp(u_m - rm_l) for m <= l only (the reference's exp overflows
        # above the diagonal; both give 0 there)
        e = u[:, None, :, :] - rm[:, :, None, :]              # (b, Lq, Lk, nh)
        s_intra = torch.exp(torch.where(tril, e, float("-inf")))
        qk = torch.einsum("blhk,bmhk->blmh", qc, kc)
        w_carry = torch.exp(m[:, None, :] - rm)               # (b, L, nh)
        num = (torch.einsum("blmh,blmh,bmhv->blhv", qk, s_intra, vc)
               + w_carry[..., None]
               * torch.einsum("blhk,bhvk->blhv", qc, C))
        den_dot = (torch.einsum("blmh,blmh->blh", qk, s_intra)
                   + w_carry * torch.einsum("blhk,bhk->blh", qc, n))
        m_i = bcum + rm
        den = torch.maximum(den_dot.abs(), torch.exp(-m_i))
        hs.append(num / den[..., None])
        # the end-of-chunk state
        rm_last = rm[:, -1, :]                                # (b, nh)
        wj = torch.exp(u - rm_last[:, None, :])               # (b, L, nh)
        decay = torch.exp(m - rm_last)
        C = (decay[:, :, None, None] * C
             + torch.einsum("blh,blhv,blhk->bhvk", wj, vc, kc))
        n = decay[:, :, None] * n + torch.einsum("blh,blhk->bhk", wj, kc)
        m = bcum[:, -1, :] + rm_last
    h = torch.stack(hs, 1).reshape(b, s, nh, hd).to(q.dtype)
    return h, (C.to(q.dtype), n.to(q.dtype), m)


def mlstm_recurrent_ref(q, k, v, gi, gf, state=None):
    """Step-by-step oracle (the paper's stabilized recurrence); the decode
    step.  Same arguments and returns as :func:`mlstm_chunkwise`."""
    b, s, nh, hd = q.shape
    f32 = torch.float32
    if state is None:
        C = torch.zeros((b, nh, hd, hd), dtype=f32, device=q.device)
        n = torch.zeros((b, nh, hd), dtype=f32, device=q.device)
        m = torch.full((b, nh), -1e30, dtype=f32, device=q.device)
    else:
        C, n, m = (t.to(f32) for t in state)
    hs = []
    for t in range(s):
        qt, kt, vt = q[:, t].to(f32), k[:, t].to(f32), v[:, t].to(f32)
        git = gi[:, t].to(f32)
        logf = F.logsigmoid(gf[:, t].to(f32))
        m_new = torch.maximum(logf + m, git)
        fp = torch.exp(logf + m - m_new)
        ip = torch.exp(git - m_new)
        C = (fp[:, :, None, None] * C + ip[:, :, None, None]
             * torch.einsum("bhv,bhk->bhvk", vt, kt))
        n = fp[:, :, None] * n + ip[:, :, None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        dd = torch.einsum("bhk,bhk->bh", n, qt)
        den = torch.maximum(dd.abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return (torch.stack(hs, 1).to(q.dtype),
            (C.to(q.dtype), n.to(q.dtype), m))


def _mlstm_out(params, h, co, z):
    h = h + params["lskip"][None, None] * co
    y = h * F.silu(z)
    return torch.einsum("bshk,hkd->bsd", y, params["wo"])


def mlstm_fwd(params, x, cfg, *, head_mask=None, return_cache=False,
              state=None, chunk: int = CHUNK):
    """The mLSTM block over x (B, S, d).  With ``return_cache`` also the
    decode cache {"C", "n", "m", "conv": the last D_CONV - 1 raw xi}."""
    xi, co, z, q, k, v, gi, gf = _mlstm_proj(params, x, head_mask)
    h, new_state = mlstm_chunkwise(q, k, v, gi, gf, chunk, state)
    out = _mlstm_out(params, h, co, z)
    if not return_cache:
        return out
    conv_cache = F.pad(xi, (0, 0, 0, 0, D_CONV - 1, 0))[:, -(D_CONV - 1):]
    return out, {"C": new_state[0], "n": new_state[1], "m": new_state[2],
                 "conv": conv_cache}


def mlstm_decode(params, x, cache, cfg, head_mask=None):
    """One-token step (x: (B, 1, d)) on the recurrent form."""
    xi = _head_scale(torch.einsum("bsd,dhk->bshk", x, params["wx"]),
                     head_mask, 2)
    z = torch.einsum("bsd,dhk->bshk", x, params["wz"])
    window = torch.cat([cache["conv"], xi], dim=1)            # (B, K, nh, hd)
    co = F.silu(torch.einsum("bkhd,khd->bhd", window,
                             params["conv"]))[:, None]
    q, k, v, gi, gf = _qkv_gates(params, co, xi)
    h, (C, n, m) = mlstm_recurrent_ref(q, k, v, gi, gf,
                                       (cache["C"], cache["n"], cache["m"]))
    out = _mlstm_out(params, h, co, z)
    return out, {"C": C, "n": n, "m": m, "conv": window[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

_GATES = ("z", "i", "f", "o")


def slstm_spec(cfg):
    d = cfg.d_model
    nh = cfg.num_heads
    hd = d // nh
    gates = {}
    for g in _GATES:
        gates[f"w{g}"] = P((d, nh, hd), ("embed", "ssm_heads", "head_dim"))
        gates[f"r{g}"] = P((nh, hd, hd), ("ssm_heads", "head_dim", "hd2"),
                           scale=0.1)
        gates[f"b{g}"] = P((nh, hd), ("ssm_heads", "head_dim"),
                           init="ones" if g == "f" else "zeros")
    ff = max(1, int(4 * d / 3))
    gates.update({
        "ff_wi": P((d, ff), ("embed", "mlp")),
        "ff_wg": P((d, ff), ("embed", "mlp")),
        "ff_wo": P((ff, d), ("mlp", "embed")),
        "out_proj": P((nh, hd, d), ("ssm_heads", "head_dim", "embed")),
    })
    return gates


def slstm_scan(params, xg, state, head_mask=None):
    """xg: gate -> (B, S, nh, hd) input pre-activations; state: (c, n, m,
    h), each (B, nh, hd).  The exponential-gated scalar cell, one time step
    at a time.  Returns (hs (B, S, nh, hd), final state)."""
    f32 = torch.float32
    c, n, m, h = state
    hs = []
    for t in range(xg["z"].shape[1]):
        def gate(g):
            rec = torch.einsum("bhk,hkl->bhl", h, params[f"r{g}"])
            return xg[g][:, t].to(f32) + rec + params[f"b{g}"].to(f32)

        zt = torch.tanh(gate("z"))
        it = gate("i")
        ft = gate("f")
        ot = torch.sigmoid(gate("o"))
        m_new = torch.maximum(ft + m, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(ft + m - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        h = _head_scale(ot * c / torch.clamp(n, min=1e-6), head_mask, 1)
        m = m_new
        hs.append(h)
    return torch.stack(hs, 1), (c, n, m, h)


def slstm_init_state(b: int, nh: int, hd: int, device=None):
    z = torch.zeros((b, nh, hd), dtype=torch.float32, device=device)
    return (z, z, torch.full((b, nh, hd), -1e30, dtype=torch.float32,
                             device=device), z)


def slstm_fwd(params, x, cfg, *, head_mask=None, return_cache=False,
              state=None):
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    xg = {g: torch.einsum("bsd,dhk->bshk", x, params[f"w{g}"])
          for g in _GATES}
    if state is None:
        state = slstm_init_state(x.shape[0], nh, hd, x.device)
    hs, new_state = slstm_scan(params, xg, state, head_mask)
    y = torch.einsum("bshk,hkd->bsd", hs.to(x.dtype), params["out_proj"])
    # gated FFN (xLSTM post-up-projection)
    ff = L._gelu(y @ params["ff_wi"]) * F.silu(y @ params["ff_wg"])
    out = y + ff @ params["ff_wo"]
    if return_cache:
        return out, {"state": new_state}
    return out


def slstm_decode(params, x, cache, cfg, head_mask=None):
    return slstm_fwd(params, x, cfg, head_mask=head_mask,
                     return_cache=True, state=cache["state"])


# ---------------------------------------------------------------------------
# xLSTM LM assembly (family "ssm": mixed mLSTM / sLSTM stack, unrolled)
# ---------------------------------------------------------------------------


def _kind(cfg, i: int) -> str:
    return "slstm" if i in cfg.slstm_layers else "mlstm"


def xlstm_spec(cfg):
    blocks = {}
    for i in range(cfg.num_layers):
        blocks[f"b{i}"] = {
            "norm": L.norm_spec(cfg.d_model, cfg.norm),
            "cell": (slstm_spec(cfg) if _kind(cfg, i) == "slstm"
                     else mlstm_spec(cfg)),
        }
    return {
        "embed": L.embed_spec(cfg.padded_vocab, cfg.d_model,
                              cfg.tie_embeddings),
        "blocks": blocks,
        "final_norm": L.norm_spec(cfg.d_model, cfg.norm),
    }


def xlstm_mask_schema(cfg):
    """Per-block head units with a path prefix (``b3:ssm_heads``), which
    the axis-driven scores and mask expansion read as "params under
    ``b3``"."""
    nh_m, _ = _heads(cfg)
    out = {}
    for i in range(cfg.num_layers):
        if _kind(cfg, i) == "slstm":
            out[f"b{i}:slstm_heads"] = (1, cfg.num_heads)
        else:
            out[f"b{i}:ssm_heads"] = (1, nh_m)
    return out


def _xlstm_run(params, x, cfg, masks, mode: str, cache=None):
    """The block stack.  ``mode``: train | prefill (returns each block's
    state) | decode (one token from ``cache``)."""
    new_cache = []
    for i in range(cfg.num_layers):
        p = params["blocks"][f"b{i}"]
        kind = _kind(cfg, i)
        key = f"b{i}:{'slstm_heads' if kind == 'slstm' else 'ssm_heads'}"
        hm = None if masks is None or key not in masks else masks[key][0]
        h = L.apply_norm(p["norm"], x, cfg.norm)
        fwd, dec = ((slstm_fwd, slstm_decode) if kind == "slstm"
                    else (mlstm_fwd, mlstm_decode))
        if mode == "train":
            y = fwd(p["cell"], h, cfg, head_mask=hm)
        elif mode == "prefill":
            y, st = fwd(p["cell"], h, cfg, head_mask=hm, return_cache=True)
            new_cache.append(st)
        else:
            y, st = dec(p["cell"], h, cache[i], cfg, head_mask=hm)
            new_cache.append(st)
        x = x + y
    return x, (new_cache if mode != "train" else None)


def xlstm_loss(params, batch, cfg, rt=None, masks=None):
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S)."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    x, _ = _xlstm_run(params, x, cfg, masks, "train")
    h = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = L.unembed(params["embed"], h)
    mask = torch.ones(tokens.shape, dtype=logits.dtype, device=logits.device)
    mask[:, -1] = 0.0
    return L.cross_entropy_loss(logits[:, :-1], tokens[:, 1:], mask[:, :-1])


def xlstm_prefill(params, batch, cfg, rt=None, masks=None):
    """(last position's logits (B, V), cache {"states": one per block,
    "pos": the prompt length as a host int})."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    x, states = _xlstm_run(params, x, cfg, masks, "prefill")
    h = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = L.unembed(params["embed"], h[:, -1:])
    return logits[:, 0], {"states": states, "pos": tokens.shape[1]}


def xlstm_decode(params, token, cache, cfg, rt=None, masks=None):
    """One step: ``token`` (B, 1) -> (logits (B, V), the advanced cache)."""
    x = L.embed(params["embed"], token)
    x, states = _xlstm_run(params, x, cfg, masks, "decode",
                           cache=cache["states"])
    h = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = L.unembed(params["embed"], h)
    return logits[:, 0], {"states": states, "pos": cache["pos"] + 1}
