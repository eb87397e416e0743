"""Port parity for the MoE slice, second half: ``FLRun.run_sync`` of syn,
st_only and random under ``alpha_weighted`` and helios under
``masked_mean`` on ``reduced(granite-moe-1b-a400m)``, against the JAX
package, in tests/test_torch_moe_slice.py's setting and with its checks
(identical history and straggler masks, cross-entropy, loss and params
within atol 1e-5).  The two files divide the JAX runs, so two workers of
``--dist loadfile`` take them.
"""
import pytest

pytest.importorskip("torch")

from test_torch_moe_slice import (CASES, LOCAL_CASES,  # noqa: E402,F401
                                  check_history_and_params,
                                  check_straggler_masks, lazy_runs, setting)

BASELINE_CASES = tuple(c for c in CASES if c not in LOCAL_CASES)


@pytest.fixture(scope="module")
def runs(setting):
    return lazy_runs(setting)


def test_cases_split_between_the_two_files():
    assert BASELINE_CASES == ("syn", "st_only", "random",
                              "helios-masked_mean")


@pytest.mark.parametrize("case", BASELINE_CASES)
def test_history_and_params_match_jax(runs, case):
    check_history_and_params(*runs(case))


@pytest.mark.parametrize("case", BASELINE_CASES)
def test_straggler_masks_identical(runs, case):
    check_straggler_masks(*runs(case))
