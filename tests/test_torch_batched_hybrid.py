"""Port parity for the batched and bucketed round engines on the Mamba2
hybrid: ``BatchedFLRun.run_sync(2)`` of helios and syn and
``AsyncFLRun.run_async(6)`` of asyn on ``reduced(zamba2-1.2b)`` (240
Markov-topic streams of 64, two SSD chunks of 32, ``mask_block=16``, the
2 + 2 fleet), against the JAX package's engines.  The setting, the
helpers and the tolerances are ``tests/test_torch_batched_lm.py``'s; the
hybrid's cases live in a file of their own so two test workers share the
JAX side's compiles.  On the port's side every Mamba2 layer's intra-chunk
term runs through the ``ssd_diag`` Function's vmap rule (plain bodies on
the CPU); the shared attention block takes ``rt["attn_impl"]``, as in the
reference.
"""
import os

import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

from test_torch_batched_lm import check_run_async, check_run_sync  # noqa: E402


@pytest.mark.parametrize("scheme", ["helios", "syn"])
def test_batched_run_sync_matches_jax(scheme):
    check_run_sync("zamba2", scheme, {})


def test_bucket_engine_asyn_matches_jax():
    check_run_async("zamba2")
