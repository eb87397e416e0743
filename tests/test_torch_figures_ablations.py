"""Port parity for the paper's ablation tables
(``repro_torch.drivers.paper_figures``): Fig. 6 (helios against st_only
over 1-4 stragglers), Fig. 7 (IID against non-IID) and the P_s ablation,
against ``benchmarks/run.py``'s, on unreduced LeNet at 2 rounds, held as
``test_torch_figures.py`` holds Fig. 5 and the speedup: row names, order
and ``us_per_call`` and every run's cycles, sim times, volumes and ratios
exactly, accuracies within 2/512, Fig. 6's gain within 4/512.

Fig. 6 divides the last sim time by ``rounds`` where Figs. 5 and 7 divide
by the last row's ``cycle`` (the reference's quirk, kept): at 2 rounds
helios's time per cycle is 1.0 and Fig. 6's ``us_per_call`` 1e6 on both
sides.
"""
import os

import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

from test_torch_figures import (assert_histories, assert_rows,  # noqa: E402
                                jax_init, reference, run_both)

NAMES = ("fig6", "fig7", "ablation")
__all__ = ["jax_init", "reference"]          # the shared module fixtures


@pytest.fixture(scope="module")
def tables(reference, jax_init):
    return {name: run_both(reference, jax_init, name) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_table_rows_match_reference(tables, name):
    want, want_hists, got, _ = tables[name]
    assert len(want) == {"fig6": 4, "fig7": 12, "ablation": 4}[name]
    assert_rows(name, want, want_hists, got)


@pytest.mark.parametrize("name", NAMES)
def test_table_histories_match_reference(tables, name):
    _, want_hists, _, got_hists = tables[name]
    assert_histories(want_hists, got_hists)


def test_fig6_divides_by_rounds(tables):
    """Fig. 6's time column is the helios run's last sim time over
    ``rounds`` (2 here), which its history gives as well."""
    want, want_hists, got, got_hists = tables["fig6"]
    for rows, hists in ((want, want_hists), (got, got_hists)):
        for i, row in enumerate(rows):
            helios = hists[2 * i + 1]
            assert float(row.split(",")[1]) == \
                float(f"{helios[-1]['time'] / 2 * 1e6:.1f}")
