"""Port parity: the checkpoint container (``repro_torch.checkpoint``)
against the JAX package's ``repro.checkpoint``.

* the port's MessagePack writer gives ``msgpack.packb``'s bytes for the
  checkpoint payload and the forms around each size boundary, and its
  reader gives ``msgpack.unpackb``'s objects;
* a checkpoint written by either package restores bit for bit in the other
  (reduced DeepSeek-7B's params, NamedTuple and list containers, int
  leaves), metadata included;
* the codec flag: ``z`` through ``zstandard`` when it imports (a stub
  stands in for it, so the case runs without it), ``d`` (zlib level 6)
  otherwise, and a clean error for a ``z`` file without ``zstandard``;
* the reference's bugfix sweep (``tests/test_serve.py``): ``keep < 1``
  raises, GC keeps exactly N and sweeps crash leftovers, NamedTuples come
  back as themselves, an empty directory raises the clean error, and a
  truncated ``.tmp`` is never observed.
"""
import collections
import os
import zlib

import jax
import msgpack
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro import checkpoint as JCKPT  # noqa: E402
from repro.models import api as jAPI  # noqa: E402
from repro_torch import checkpoint as CKPT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import checkpoint as CK  # noqa: E402
from repro_torch.checkpoint import wire  # noqa: E402

Moments = collections.namedtuple("Moments", ["mu", "nu"])


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}


def _ttree(seed=0):
    return {k: torch.as_tensor(v) for k, v in _tree(seed).items()}


@pytest.fixture(scope="module")
def lm_params():
    """reduced(deepseek-7b)'s JAX init params, host copies."""
    cfg = JC.reduced(JC.ARCHS["deepseek-7b"])
    return jax.device_get(jAPI.init_params(jax.random.PRNGKey(0), cfg))


# ---------------------------------------------------------------------------
# the MessagePack subset
# ---------------------------------------------------------------------------

BOUNDARY = {
    "uint": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1],
    "int": [-1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
            -2 ** 31 - 1, -2 ** 63],
    "str": ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "a" * 65536,
            "héllo/<0>"],
    "bin": [b"", b"x" * 255, b"x" * 256, b"x" * 65536],
    "array": [[], [1] * 15, [1] * 16, [1] * 65536],
    "map": [{}, {str(i): i for i in range(15)},
            {str(i): i for i in range(16)}],
    "other": [None, True, False, 1.5, -0.0, [None, {"a": [b"\x00"]}]],
}


def _norm(x):
    if isinstance(x, memoryview):
        return bytes(x)
    if isinstance(x, list):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("kind", list(BOUNDARY))
def test_wire_matches_msgpack_at_size_boundaries(kind):
    for obj in BOUNDARY[kind]:
        data = msgpack.packb(obj)
        assert wire.packb(obj) == data, repr(obj)[:60]
        assert _norm(wire.unpackb(data)) == msgpack.unpackb(data), \
            repr(obj)[:60]


def test_wire_payload_bytes_equal_msgpack(lm_params):
    """The checkpoint payload itself: the port's bytes are msgpack's."""
    flat = {k: CK._pack_leaf(v) for k, v in CK._flatten(
        params_from_numpy(lm_params, device="cpu")).items()}
    payload = {"step": 7, "leaves": flat,
               "metadata": '{"round": 7, "scheme": "helios"}'}
    assert wire.packb(payload) == msgpack.packb(payload)


def test_wire_rejects_truncated_and_trailing_data():
    data = msgpack.packb({"a": b"x" * 300})
    with pytest.raises(ValueError, match="ends inside"):
        wire.unpackb(data[:-1])
    with pytest.raises(ValueError, match="extra data"):
        wire.unpackb(data + b"\x00")


# ---------------------------------------------------------------------------
# crossing between the packages
# ---------------------------------------------------------------------------


def _mixed_tree(seed):
    rng = np.random.default_rng(seed)
    return {"opt": Moments(mu=_tree(seed), nu=_tree(seed + 1)),
            "steps": (np.int32(3), np.int32(4)),
            "ids": [rng.integers(0, 9, size=(5,)).astype(np.int64)],
            "none": []}


def test_port_writes_jax_reads_bit_for_bit(lm_params, tmp_path):
    d = str(tmp_path)
    port = params_from_numpy(lm_params, device="cpu")
    CKPT.save(d, 3, port, metadata={"round": 3, "sim_time": 1.5})
    out, step = JCKPT.restore(d, lm_params)
    assert step == 3 and JCKPT.metadata(d) == {"round": 3, "sim_time": 1.5}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(out),
                            jax.tree_util.tree_leaves(lm_params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    tree = _mixed_tree(1)
    CKPT.save(d, 4, tree)
    back, _ = JCKPT.restore(d, tree)
    assert type(back["opt"]) is Moments
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_jax_writes_port_reads_bit_for_bit(lm_params, tmp_path):
    d = str(tmp_path)
    JCKPT.save(d, 5, lm_params, metadata={"round": 5, "scheme": "syn"})
    target = params_from_numpy(jax.tree.map(np.zeros_like, lm_params),
                               device="cpu")
    out, step, meta = CKPT.load(d, target)
    assert step == 5 and meta == {"round": 5, "scheme": "syn"}
    assert CKPT.metadata(d, 5) == meta
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(out),
                            jax.tree_util.tree_leaves(lm_params)):
        assert torch.is_tensor(a) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    tree = _mixed_tree(2)
    JCKPT.save(d, 6, tree)
    back, _ = CKPT.restore(d, tree)
    assert type(back["opt"]) is Moments and type(back["steps"]) is tuple
    assert back["none"] == [] and back["ids"][0].dtype == np.int64
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_same_bytes_as_the_reference_file(tmp_path):
    """Same tree, same step and metadata: the two packages' files decode
    to identical payloads, and the compressed files are the same bytes."""
    tree = _tree(3)
    CKPT.save(str(tmp_path / "port"), 1, {k: torch.as_tensor(v)
                                          for k, v in tree.items()},
              metadata={"round": 1})
    JCKPT.save(str(tmp_path / "jax"), 1, tree, metadata={"round": 1})
    a = (tmp_path / "port" / "ckpt_1.msgpack.zst").read_bytes()
    b = (tmp_path / "jax" / "ckpt_1.msgpack.zst").read_bytes()
    assert a[:5] == b[:5] == b"HCKP" + (b"z" if CK._zstd() else b"d")
    assert a == b


def test_restore_keeps_target_dtype_and_checks_shape(tmp_path):
    d = str(tmp_path)
    CKPT.save(d, 1, _ttree(1))
    target = {"w": torch.zeros(3, 4, dtype=torch.float64),
              "b": torch.zeros(4)}
    out, _ = CKPT.restore(d, target)
    assert out["w"].dtype == torch.float64
    np.testing.assert_array_equal(out["b"].numpy(), _tree(1)["b"])
    with pytest.raises(ValueError, match="checkpoint shape"):
        CKPT.restore(d, {"w": torch.zeros(4, 3), "b": torch.zeros(4)})


# ---------------------------------------------------------------------------
# the codec flag
# ---------------------------------------------------------------------------


class _StubZstd:
    """Stands in for ``zstandard``: a zlib body under the ``z`` flag (the
    flag logic is what is tested; the real library is optional)."""

    class ZstdCompressor:
        def __init__(self, level):
            self.level = level

        def compress(self, data):
            return zlib.compress(data, 1)

    class ZstdDecompressor:
        def decompress(self, data, max_output_size):
            return zlib.decompress(data)


def test_zstd_flag_when_zstandard_imports(monkeypatch, tmp_path):
    d = str(tmp_path)
    monkeypatch.setattr(CK, "_zstd", lambda: _StubZstd)
    path = CKPT.save(d, 1, _ttree(1))
    assert open(path, "rb").read()[:5] == b"HCKP" + b"z"
    out, _ = CKPT.restore(d, _ttree(0))
    np.testing.assert_array_equal(out["w"].numpy(), _tree(1)["w"])
    monkeypatch.setattr(CK, "_zstd", lambda: None)
    with pytest.raises(RuntimeError, match="zstandard"):
        CKPT.restore(d, _ttree(0))
    path = CKPT.save(d, 2, _ttree(2))
    assert open(path, "rb").read()[:5] == b"HCKP" + b"d"
    out, step = JCKPT.restore(d, _tree(0))       # the reference reads it
    assert step == 2
    np.testing.assert_array_equal(out["b"], _tree(2)["b"])


def test_unknown_codec_flag_raises(tmp_path):
    (tmp_path / "ckpt_1.msgpack.zst").write_bytes(b"HCKPq" + b"\x00" * 8)
    with pytest.raises(ValueError, match="unknown checkpoint codec"):
        CKPT.restore(str(tmp_path), _ttree())


# ---------------------------------------------------------------------------
# the reference's bugfix sweep
# ---------------------------------------------------------------------------


def test_save_keep_zero_raises(tmp_path):
    with pytest.raises(ValueError, match="keep must be >= 1"):
        CKPT.save(str(tmp_path), 1, _ttree(), keep=0)


def test_gc_keeps_exactly_n(tmp_path):
    for s in range(5):
        CKPT.save(str(tmp_path), s, _ttree(s), keep=2)
    kept = sorted(f for f in os.listdir(tmp_path) if f.endswith(".zst"))
    assert kept == ["ckpt_3.msgpack.zst", "ckpt_4.msgpack.zst"]


def test_gc_sweeps_stale_tmp(tmp_path):
    stale = tmp_path / "ckpt_7.msgpack.zst.tmp"
    stale.write_bytes(b"partial garbage from a dead writer")
    CKPT.save(str(tmp_path), 8, _ttree(), keep=3)
    assert not stale.exists()
    assert CKPT.latest_step(str(tmp_path)) == 8


def test_restore_namedtuple_roundtrip(tmp_path):
    state = {"opt": Moments(mu=_ttree(1), nu=_ttree(2)),
             "steps": (np.int32(3), np.int32(4))}
    CKPT.save(str(tmp_path), 1, state)
    out, step = CKPT.restore(str(tmp_path), state)
    assert step == 1
    assert type(out["opt"]) is Moments and type(out["steps"]) is tuple
    assert torch.equal(out["opt"].mu["w"], state["opt"].mu["w"])
    assert out["steps"] == (3, 4)


def test_metadata_and_restore_empty_dir_clean_error(tmp_path):
    for fn in (lambda: CKPT.metadata(str(tmp_path)),
               lambda: CKPT.restore(str(tmp_path), _ttree()),
               lambda: CKPT.load(str(tmp_path / "missing"), _ttree())):
        with pytest.raises(FileNotFoundError, match="no checkpoints in"):
            fn()


def test_restore_ignores_truncated_tmp(tmp_path):
    CKPT.save(str(tmp_path), 1, _ttree(1))
    blob = (tmp_path / "ckpt_1.msgpack.zst").read_bytes()
    (tmp_path / "ckpt_2.msgpack.zst.tmp").write_bytes(blob[:len(blob) // 3])
    assert CKPT.latest_step(str(tmp_path)) == 1
    out, step = CKPT.restore(str(tmp_path), _ttree())
    assert step == 1
    np.testing.assert_array_equal(out["w"].numpy(), _tree(1)["w"])
