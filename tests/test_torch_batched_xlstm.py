"""Port parity for the batched and bucketed round engines on xLSTM:
``BatchedFLRun.run_sync(2)`` of helios and syn and ``AsyncFLRun.run_async
(6)`` of asyn on ``reduced(xlstm-125m)`` (4 blocks, one sLSTM at index 1,
mLSTM heads of 16, chunk 32; 240 Markov-topic streams of 32,
``mask_block=16``, the 2 + 2 fleet), against the JAX package's engines.
The setting, the helpers and the tolerances are
``tests/test_torch_batched_lm.py``'s.  xLSTM reaches no kernel, as in the
reference: each cohort's chunkwise mLSTM and step-by-step sLSTM run under
``torch.func.vmap`` as plain tensor code.
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
    check_run_sync("xlstm", scheme, {})


def test_bucket_engine_asyn_matches_jax():
    check_run_async("xlstm")
