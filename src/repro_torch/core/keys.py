# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Random draws named by key paths.

The reference draws every random number of a Helios cycle from a tree of
split / fold_in steps below one root key per client.  A :class:`Key` here
records that path (``seed(cid) / split(2)[1] / fold_in(i) / split(L)[r]
...``) instead of holding random state, and a backend turns a path plus a
shape into numbers.  The default backend seeds a ``torch.Generator``
(Philox on CUDA) from a hash of the path, so each path names one fixed,
independent stream.  Another backend can walk the same path with another
generator; the tests install one that reproduces the reference's draws bit
for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Iterator, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Key:
    """A node of the key tree: the steps from a root seed down to here."""

    path: Tuple[tuple, ...]

    def split(self, num: int = 2) -> Tuple["Key", ...]:
        return tuple(Key(self.path + (("split", num, i),)) for i in range(num))

    def fold_in(self, data: int) -> "Key":
        return Key(self.path + (("fold_in", int(data)),))


def key(seed: int) -> Key:
    """The root key of one stream tree (one per client)."""
    return Key((("seed", int(seed)),))


class PhiloxBackend:
    """Default backend: one ``torch.Generator`` per path, seeded from a
    hash of the path, on the device the numbers are wanted on."""

    @staticmethod
    def seed_of(k: Key) -> int:
        digest = hashlib.blake2b(repr(k.path).encode(), digest_size=8).digest()
        return int.from_bytes(digest, "little") & (2 ** 63 - 1)

    def uniform(self, k: Key, n: int, minval: float, maxval: float,
                device: torch.device) -> torch.Tensor:
        g = torch.Generator(device=device).manual_seed(self.seed_of(k))
        u = torch.rand(n, generator=g, device=device, dtype=torch.float32)
        return u * (maxval - minval) + minval


_BACKEND = PhiloxBackend()


def uniform(k: Key, n: int, minval: float = 0.0, maxval: float = 1.0,
            device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(n,) float32 uniform in [minval, maxval) from the stream named ``k``."""
    return _BACKEND.uniform(k, n, minval, maxval, torch.device(device))


@contextlib.contextmanager
def use_backend(backend) -> Iterator[None]:
    """Route every draw through ``backend`` inside the block."""
    global _BACKEND
    prev, _BACKEND = _BACKEND, backend
    try:
        yield
    finally:
        _BACKEND = prev
