"""The key-path seam of the port (``repro_torch.core.keys``) and the
test-only backend that walks key paths with ``jax.random``.

``JaxKeyBackend`` reproduces the reference's threefry draws for any key
path, so the port's Eq. 2 masks can be held bit for bit against the JAX
package (test_torch_core.py, test_torch_slice.py).  It lives here, in the
tests, because the port itself never imports JAX.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import keys as KY  # noqa: E402


@functools.lru_cache(maxsize=4096)
def _jax_key(path):
    """Walk a key path with jax.random (prefixes are cached)."""
    op = path[-1]
    if op[0] == "seed":
        return jax.random.PRNGKey(op[1])
    parent = _jax_key(path[:-1])
    if op[0] == "split":
        return jax.random.split(parent, op[1])[op[2]]
    if op[0] == "fold_in":
        return jax.random.fold_in(parent, op[1])
    raise ValueError(op)


class JaxKeyBackend:
    """Draws the numbers ``jax.random`` gives for the same key path."""

    def uniform(self, k, n, minval, maxval, device):
        u = jax.random.uniform(_jax_key(k.path), (n,), minval=minval,
                               maxval=maxval)
        return torch.from_numpy(np.array(u)).to(device)


def jax_keys():
    """Context manager: route the port's draws through ``jax.random``."""
    return KY.use_backend(JaxKeyBackend())


def test_jax_backend_walks_the_reference_key_tree():
    """seed -> split -> fold_in -> split(L)[r] -> fold_in(1) gives the
    numbers the reference's selection draws from the same steps."""
    root = KY.key(3)
    _, sub = root.split()
    row = sub.fold_in(0xB10C).fold_in(1).split(2)[1]
    with jax_keys():
        got = KY.uniform(row.fold_in(1), 16).numpy()
    jk = jax.random.split(jax.random.PRNGKey(3))[1]
    jk = jax.random.split(jax.random.fold_in(jax.random.fold_in(jk, 0xB10C),
                                             1), 2)[1]
    want = np.asarray(jax.random.uniform(jax.random.fold_in(jk, 1), (16,)))
    np.testing.assert_array_equal(got, want)


def test_default_backend_is_deterministic_and_path_distinct():
    a, b = KY.key(0).split()
    u1 = KY.uniform(a, 64, 0.0, 1.0)
    u2 = KY.uniform(a, 64, 0.0, 1.0)
    u3 = KY.uniform(b, 64, 0.0, 1.0)
    assert torch.equal(u1, u2)
    assert not torch.equal(u1, u3)
    small = KY.uniform(a, 64, 0.0, 1e-6)
    assert float(small.max()) < 1e-6 and float(small.min()) >= 0.0
    assert KY.key(1).fold_in(7) == KY.key(1).fold_in(7)
    assert KY.key(1).fold_in(7) != KY.key(2).fold_in(7)
