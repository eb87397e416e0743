# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Fault-tolerant checkpoints: atomic MessagePack snapshots, keep-N GC.

The reference's on-disk container, so either package reads the other's
files: ``ckpt_<step>.msgpack.zst`` holds a 5-byte header (``HCKP`` and a
codec flag, ``z`` zstd or ``d`` zlib) and the compressed MessagePack map
``{"step", "leaves", "metadata"}``.  ``leaves`` maps each leaf's path
(dict keys sorted level by level and joined by ``/``, ``<i>`` for the
items of a list or tuple, ``<empty>`` for an empty one) to
``{"dtype", "shape", "data"}`` with the raw little-endian bytes;
``metadata`` is a JSON string.  MessagePack comes from
:mod:`repro_torch.checkpoint.wire` (no ``msgpack`` package needed);
``zstandard`` compresses when it imports (looked up at the first
checkpoint, never when this module is imported), else ``zlib`` at level 6.

A write goes to a ``.tmp`` file, is flushed and fsynced, then
``os.replace``-d into place (atomic on POSIX), so a reader never sees a
partial snapshot: the ``.tmp`` never matches the key pattern, and the GC
after each save sweeps ``.tmp`` files a crash left behind.  One writer a
directory (the engines' round-end publish); any number of readers.
"""
from __future__ import annotations

import functools
import json
import os
import re
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import wire

_KEY_RE = re.compile(r"^ckpt_(\d+)\.msgpack\.zst$")

#: header = magic + a 1-byte codec flag; the flag (not the file name) says
#: how the payload is compressed
_MAGIC = b"HCKP"
_CODEC_ZSTD = b"z"
_CODEC_ZLIB = b"d"
#: decompression cap (a corrupt or hostile file cannot exhaust memory)
_MAX_PAYLOAD = 1 << 34


@functools.lru_cache(maxsize=None)
def _zstd():
    """The ``zstandard`` module, or None where it does not import."""
    try:
        import zstandard
    except ImportError:                   # optional: zlib then
        return None
    return zstandard


def codec_name() -> str:
    """The codec :func:`save` writes with here: "zstd" or "zlib"."""
    return "zlib" if _zstd() is None else "zstd"


def _compress(payload: bytes) -> bytes:
    zstandard = _zstd()
    if zstandard is not None:
        return _MAGIC + _CODEC_ZSTD + \
            zstandard.ZstdCompressor(level=3).compress(payload)
    return _MAGIC + _CODEC_ZLIB + zlib.compress(payload, 6)


def _decompress(blob: bytes) -> bytes:
    zstandard = _zstd()
    if blob[:len(_MAGIC)] == _MAGIC:
        codec = blob[len(_MAGIC):len(_MAGIC) + 1]
        data = memoryview(blob)[len(_MAGIC) + 1:]
        if codec == _CODEC_ZLIB:
            d = zlib.decompressobj()
            out = d.decompress(data, _MAX_PAYLOAD)
            if d.unconsumed_tail:
                raise ValueError(
                    "checkpoint payload exceeds the 16 GiB decompression cap")
            return out
        if codec == _CODEC_ZSTD:
            if zstandard is None:
                raise RuntimeError(
                    "checkpoint was written with zstandard, which is not "
                    "installed; install it to read the file")
            return zstandard.ZstdDecompressor().decompress(
                data, max_output_size=_MAX_PAYLOAD)
        raise ValueError(f"unknown checkpoint codec flag {codec!r}")
    # the legacy format: a raw zstd frame without a header
    if zstandard is None:
        raise RuntimeError(
            "legacy zstd checkpoint requires the zstandard package")
    return zstandard.ZstdDecompressor().decompress(
        blob, max_output_size=_MAX_PAYLOAD)


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 tensors have no numpy dtype here; "
                            "cast the tree to float32 before saving")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, path=()):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], path + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, path + (f"<{i}>",)))
        if len(tree) == 0:
            out["/".join(path) + "/<empty>"] = np.zeros((0,), np.int8)
    else:
        out["/".join(path)] = _to_numpy(tree)
    return out


def _pack_leaf(arr: np.ndarray) -> dict:
    return {"dtype": str(arr.dtype), "shape": [int(d) for d in arr.shape],
            "data": np.ascontiguousarray(arr).tobytes()}


def _unpack_leaf(d) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=d["dtype"]).reshape(d["shape"])


def save(directory: str, step: int, tree: Any, keep: int = 3,
         metadata: Optional[dict] = None) -> str:
    """Write ``tree`` (nested dicts / lists / tuples of tensors or arrays)
    as step ``step``, atomically, then keep the newest ``keep`` steps."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1 (the newest checkpoint is "
                         f"never GC'd), got {keep}")
    os.makedirs(directory, exist_ok=True)
    flat = {k: _pack_leaf(v) for k, v in _flatten(tree).items()}
    payload = wire.packb({"step": step, "leaves": flat,
                          "metadata": json.dumps(metadata or {})})
    del flat
    comp = _compress(payload)
    del payload
    final = os.path.join(directory, f"ckpt_{step}.msgpack.zst")
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.write(comp)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)                    # the atomic publish
    _gc(directory, keep)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := _KEY_RE.match(f))]
    return max(steps) if steps else None


def _read(directory: str, step: Optional[int]):
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step}.msgpack.zst")
    with open(path, "rb") as f:
        raw = _decompress(f.read())
    return wire.unpackb(raw), step


def restore(directory: str, target: Any, step: Optional[int] = None):
    """Restore into the structure of ``target``: each tensor leaf comes
    back as a new tensor of the target leaf's dtype on its device (numpy
    leaves as arrays), containers as the target's types (a NamedTuple as
    itself).  Returns (tree, step); the newest step when ``step`` is None.
    Raises FileNotFoundError when there is no checkpoint."""
    tree, step, _ = load(directory, target, step)
    return tree, step


def load(directory: str, target: Any, step: Optional[int] = None):
    """:func:`restore` and :func:`metadata` from one read of the file:
    (tree, step, metadata)."""
    obj, step = _read(directory, step)
    flat = obj["leaves"]

    def rebuild(node, path=()):
        if isinstance(node, dict):
            return {k: rebuild(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [rebuild(v, path + (f"<{i}>",)) for i, v in enumerate(node)]
            if isinstance(node, tuple):
                return type(node)(*t) if hasattr(node, "_fields") \
                    else tuple(t)
            return type(node)(t)
        key = "/".join(path)
        arr = _unpack_leaf(flat[key])
        if torch.is_tensor(node):
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"target {tuple(node.shape)}")
            return torch.from_numpy(np.array(arr)).to(
                device=node.device, dtype=node.dtype)
        leaf = np.asarray(node)
        if tuple(arr.shape) != leaf.shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"target {leaf.shape}")
        return arr.astype(leaf.dtype)

    return rebuild(target), step, json.loads(obj["metadata"])


def metadata(directory: str, step: Optional[int] = None) -> dict:
    """The JSON metadata saved with ``step`` (the newest when None)."""
    obj, _ = _read(directory, step)
    return json.loads(obj["metadata"])


def _gc(directory: str, keep: int) -> None:
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    names = os.listdir(directory)
    steps = sorted(int(m.group(1)) for f in names if (m := _KEY_RE.match(f)))
    for s in steps[:-keep]:
        try:
            os.remove(os.path.join(directory, f"ckpt_{s}.msgpack.zst"))
        except OSError:
            pass
    # tmp files a crash mid-write left (one writer: save()'s own tmp has
    # been replaced by now)
    for f in names:
        if f.endswith(".tmp") and _KEY_RE.match(f[:-len(".tmp")]):
            try:
                os.remove(os.path.join(directory, f))
            except OSError:
                pass
