# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Uplink compression with error feedback, and the per-client row store.

Three lossy modes shrink each client -> server update (the engines'
``compression`` knob):

* ``topk``  — per-leaf magnitude top-k (k = max(1, round(frac * size)))
  with fp16 values on the wire; every |x| at or above the k-th largest is
  kept, ties included, as in the reference;
* ``quant`` — dense symmetric int-``bits`` quantization per leaf, scale =
  max(max|x|, 1e-12) / (2^(bits-1) - 1), codes rounded half to even;
* ``delta`` — the top-k coordinates with int-``bits`` quantized values.

Error feedback: the un-sent residual is kept per client and added to its
next delta.  The Eq. 2 masks zero frozen coordinates BEFORE encoding, so
they are never sent while their residual survives.  ``sent + new_error ==
delta + error`` on unmasked coordinates.

:func:`compress_update_stacked` encodes a cohort with a leading client
axis (the batched and bucketed engines) row by row; :func:`compress_update`
is its one-row case (the sequential engine), so both run one arithmetic.  :class:`HostErrorStore` keeps
one lazily materialized row per client (the codec's residuals, SCAFFOLD's
control rows).  The module path is the reference's; it is a package so
that the repo linter's wiring check on ``optim/compression.py`` (the JAX
module) does not read the port's file.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.models.module import tree_leaves, tree_map

#: the engine knob's values
MODES = ("none", "topk", "quant", "delta")


def init_error(params):
    """Zero error-feedback rows, one per leaf, in the leaf's dtype."""
    return tree_map(torch.zeros_like, params)


def leaf_k(size: int, frac: float) -> int:
    """The kept-coordinate count of top-k on a leaf of ``size`` values."""
    return max(1, int(round(frac * size))) if size else 0


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(C, ...) -> (C, n): each leading-axis row flattened."""
    return x.reshape(x.shape[0], -1)


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) per-row value shaped to broadcast against ``x``."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


def _rows_topk(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Zero all but the top-``frac`` |values| of each row of ``x``: the
    threshold is the row's k-th largest |x|, and every |x| >= it is kept
    (ties included)."""
    n = _rows(x).shape[1]
    if n == 0:
        return x
    k = leaf_k(n, frac)
    thresh = torch.topk(_rows(x).abs(), k, dim=-1).values[:, -1]
    return torch.where(x.abs() >= _bcast(thresh, x), x, torch.zeros_like(x))


def _leaf_topk(x: torch.Tensor, frac: float) -> torch.Tensor:
    """:func:`_rows_topk` of one leaf."""
    return _rows_topk(x[None], frac)[0]


def _code_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int32


def quantize_rows(x: torch.Tensor, bits: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization of each row of ``x``: (int codes, (C,) f32
    scales), scale = max(max|row|, 1e-12) / (2^(bits-1) - 1), codes
    rounded half to even.  The divisor is a tensor on the rows' device:
    CUDA divides by a host scalar as a product with its reciprocal, which
    rounds some scales an ulp away from the reference's quotient."""
    x = x.float()
    lim = torch.full((), float(2 ** (bits - 1) - 1), dtype=torch.float32,
                     device=x.device)
    if _rows(x).shape[1] == 0:
        return torch.zeros(x.shape, dtype=_code_dtype(bits),
                           device=x.device), \
            torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    scale = torch.clamp(_rows(x).abs().amax(dim=1), min=1e-12) / lim
    q = torch.clamp(torch.round(x / _bcast(scale, x)), -lim, lim)
    return q.to(_code_dtype(bits)), scale


def quantize(x: torch.Tensor, bits: int = 8
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-leaf quantization: (int codes, f32 scalar scale).
    Exact zeros encode as zeros; the round trip errs by at most scale/2."""
    q, scale = quantize_rows(x[None], bits)
    return q[0], scale[0]


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _rows_roundtrip_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    q, scale = quantize_rows(x, bits)
    return q.float() * _bcast(scale, q)


def _roundtrip_f16(x: torch.Tensor) -> torch.Tensor:
    return x.half().float()


def compress_update_stacked(delta, error, mode: str, frac: float = 0.05,
                            bits: int = 8, masks=None):
    """Encode and decode a cohort's client -> server updates with error
    feedback, row by row: leaves of ``delta`` (the raw updates, new params
    - base), ``error`` (the clients' residuals) and ``masks`` (optional
    params-shaped 0/1 trees, the expanded Eq. 2 masks, applied before
    encoding) carry a leading client axis (C, ...); k and the scale are
    per row and leaf.  Returns ``(sent, new_error, coords)``: the decoded
    updates the server applies, the residuals the clients keep, and each
    row's encoded-coordinate count as a (C,) f32 device tensor (``quant``
    counts mask coverage, the others nonzeros)."""
    if mode not in MODES or mode == "none":
        raise ValueError(f"compress_update: bad mode {mode!r}")
    corrected = tree_map(lambda d, e: d.float() + e.float(), delta, error)
    avail = corrected if masks is None else \
        tree_map(torch.mul, corrected, masks)
    if mode == "topk":
        sent = tree_map(lambda a: _roundtrip_f16(_rows_topk(a, frac)), avail)
    elif mode == "delta":
        sent = tree_map(
            lambda a: _rows_roundtrip_quant(_rows_topk(a, frac), bits), avail)
    else:                                                  # quant (dense)
        sent = tree_map(lambda a: _rows_roundtrip_quant(a, bits), avail)
    new_error = tree_map(lambda c, s, e: (c - s).to(e.dtype), corrected,
                         sent, error)
    leaves = tree_leaves(sent)
    if mode == "quant":
        if masks is None:
            coords = torch.full((leaves[0].shape[0],),
                                float(sum(_rows(s).shape[1] for s in leaves)),
                                dtype=torch.float32, device=leaves[0].device)
        else:
            coords = sum(_rows(m).sum(dim=1) for m in tree_leaves(masks))
    else:
        coords = sum((_rows(s) != 0).sum(dim=1).float() for s in leaves)
    return sent, new_error, coords


def compress_update(delta, error, mode: str, frac: float = 0.05,
                    bits: int = 8, masks=None):
    """:func:`compress_update_stacked` of one update (no client axis):
    ``(sent, new_error, coords)`` with ``coords`` an f32 device scalar.
    ``sent + new_error == delta + error`` on unmasked coordinates."""
    one = (lambda t: None if t is None else tree_map(lambda v: v[None], t))
    sent, new_error, coords = compress_update_stacked(
        one(delta), one(error), mode, frac, bits, one(masks))
    first = (lambda t: tree_map(lambda v: v[0], t))
    return first(sent), first(new_error), coords[0]


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def uplink_bytes(mode: str, coords: float, total: int, n_leaves: int,
                 bits: int = 8, index_bytes: int = 4) -> float:
    """Wire bytes for ``coords`` encoded coordinates: ``none`` dense f32;
    ``topk`` (index, fp16 value) a coordinate; ``quant`` a ``bits``-bit code
    a coordinate and an f32 scale a leaf; ``delta`` (index, ``bits``-bit
    value) a coordinate and the scales.  ``n_leaves`` counts leaves over
    every update billed."""
    if mode == "none":
        return float(total) * 4.0
    if mode == "topk":
        return coords * (index_bytes + 2.0)
    if mode == "quant":
        return coords * bits / 8.0 + n_leaves * 4.0
    if mode == "delta":
        return coords * (index_bytes + bits / 8.0) + n_leaves * 4.0
    raise ValueError(mode)


def compress(grads, error, frac: float):
    """Top-k as an optimizer transform, without wire rounding: (sparse
    grads, new error, sent fraction as a device scalar)."""
    corrected = tree_map(lambda g, e: g.float() + e, grads, error)
    sparse = tree_map(lambda c: _leaf_topk(c, frac), corrected)
    new_error = tree_map(torch.sub, corrected, sparse)
    total = sum(s.numel() for s in tree_leaves(sparse))
    nnz = sum((s != 0).sum() for s in tree_leaves(sparse))
    return sparse, new_error, nnz / max(total, 1)


def compressed_bytes(grads, frac: float, index_bytes: int = 4,
                     value_bytes: int = 4) -> int:
    """Uplink bytes of a top-k encoding (index + value a coordinate), with
    k summed per leaf as :func:`compress_update` keeps it."""
    k = sum(leaf_k(s.numel(), frac) for s in tree_leaves(grads))
    return k * (index_bytes + value_bytes)


def param_census(params) -> Tuple[int, int]:
    """(scalar count, leaf count): the uplink-bytes denominators."""
    leaves = tree_leaves(params)
    return sum(s.numel() for s in leaves), len(leaves)


class HostErrorStore:
    """One lazily materialized row per client, params-shaped.

    Rows exist only for clients that were written (``scatter`` /
    ``set_row``); every other client reads one shared zero row, so the
    store grows with participation, not with the population.  The
    reference keeps the rows in host numpy for its million-client
    populations; the port keeps them on the run's device, which changes no
    value and saves a host round trip per client a round.  The name is the
    reference's.
    """

    def __init__(self, params):
        self._zero = tree_map(
            lambda p: torch.zeros(p.shape, dtype=p.dtype, device=p.device),
            params)
        self._rows: Dict[int, dict] = {}

    def gather(self, cids: Sequence[int]) -> dict:
        """Stacked (len(cids),) + shape rows; untouched clients read zeros."""
        rows = [self._rows.get(int(c), self._zero) for c in cids]
        return tree_map(lambda *xs: torch.stack(xs), *rows)

    def scatter(self, cids: Sequence[int], stacked) -> None:
        """Write rows back from a stacked tree (``cids`` duplicate-free)."""
        for i, c in enumerate(cids):
            self._rows[int(c)] = tree_map(lambda x: x[i].clone(), stacked)

    def row(self, cid: int) -> dict:
        """One client's row (the shared zero row if never written)."""
        return self._rows.get(int(cid), self._zero)

    def set_row(self, cid: int, tree) -> None:
        self._rows[int(cid)] = tree

    def touched(self) -> int:
        return len(self._rows)

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for r in self._rows.values()
                   for x in tree_leaves(r))

    def stats(self) -> Dict[str, int]:
        """Store census: materialized client rows and the bytes they hold."""
        return {"rows": self.touched(), "bytes": self.nbytes()}


__all__ = ["MODES", "HostErrorStore", "compress", "compress_update",
           "compress_update_stacked", "compressed_bytes", "dequantize",
           "init_error", "leaf_k", "param_census", "quantize",
           "quantize_rows", "uplink_bytes"]
