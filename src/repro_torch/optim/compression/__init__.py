# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Per-client row store of the uplink path: :class:`HostErrorStore`.

The reference keeps one lazily materialized row per client for its codec's
error feedback and for SCAFFOLD's client controls.  The port has SCAFFOLD;
the codec itself (top-k / quantized uplink, the lossy ring modes) is not
ported yet.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.models.module import tree_leaves, tree_map


class HostErrorStore:
    """One lazily materialized f32 row per client, params-shaped.

    Rows exist only for clients that were written (``scatter`` /
    ``set_row``); every other client reads one shared zero row.  The
    reference keeps the rows in host numpy for its million-client
    populations; the port keeps them on the run's device, which changes no
    value (both are f32) and saves a host round trip per client a round.
    The name is the reference's.
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
