"""Port parity for the example drivers (``repro_torch.drivers.quickstart``,
``.elastic_scaling``, ``.async_events``, ``.observability``) against the
JAX package's ``examples/*.py`` run as scripts, on their own settings
(reduced LeNet), the port from JAX's initial params and its Eq. 2 draws
through the JAX key backend.

* quickstart: the volume, each cycle's printed selected fraction and the
  final masks exactly (the last cycle's fraction to one float32 ulp of a
  mask mean: XLA's mean multiplies the sum by 1/n, torch's divides); each
  cycle's printed loss, the final loss, params and Eq. 1 scores within
  1e-5 (against the script's globals and output).
* elastic_scaling: membership, the newcomer's identification and volume,
  every round's cycle and sim time exactly, accuracies within 2/512.
* async_events at 8 clients, with dropout alone (equal-time buckets of 4)
  and with jitter (buckets of 1): both engines' ``events_processed``,
  ``events_dropped`` and the bucket sizes against the JAX engines' on the
  same seeds, accuracy within 2/512 and the printed rounding.
* observability: the run log's event kinds and counts against JAX's
  (but the reference's ``compile`` events, one a jitted program: the port
  runs eagerly and compiles none), and ``summarize``'s rounds, sim time
  and bytes equal.
"""
import collections
import os
import re
import runpy
import sys

import jax
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.obs import load_events as j_load_events  # noqa: E402
from repro.obs import summarize as j_summarize  # noqa: E402
from repro_torch.drivers.async_events import async_events  # noqa: E402
from repro_torch.drivers.elastic_scaling import elastic_scaling  # noqa: E402
from repro_torch.drivers.observability import observability  # noqa: E402
from repro_torch.drivers.quickstart import quickstart  # noqa: E402
from repro_torch.obs import load_events, summarize  # noqa: E402
from test_torch_keys import jax_keys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
ACC_TOL = 2 / 512


def _example(name, capsys, *argv):
    """Run ``examples/<name>.py`` as a script; returns (its globals, its
    standard output)."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    old = sys.argv
    sys.argv = [path, *argv]
    try:
        capsys.readouterr()
        g = runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old
    return g, capsys.readouterr().out


def _jax_init():
    """The params every reduced-LeNet example starts from (seed 0)."""
    return {k: np.asarray(v) for k, v in jax.device_get(j_init_params(
        jax.random.PRNGKey(0), JC.reduced(JC.CNNS["lenet"]))).items()}


def test_quickstart_matches_the_example(capsys):
    g, out = _example("quickstart", capsys)
    with jax_keys():
        got = quickstart(device="cpu", kernels="cuda",
                         init_params=_jax_init())
    printed = re.findall(r"cycle (\d): loss=([\d.]+) selected=([\d.]+)", out)
    assert len(printed) == len(got["cycles"]) == 5
    assert got["volume"] == g["volume"]
    for (_, loss, frac), (tloss, tfrac) in zip(printed, got["cycles"]):
        assert f"{tfrac:.2f}" == frac
        assert abs(tloss - float(loss)) <= 5e-4 + ATOL
    # the fraction is a mean of the masks' means: XLA's f32 mean multiplies
    # the sum by 1/n, torch's divides, one ulp apart for some counts
    assert abs(got["cycles"][-1][1] - g["frac"]) <= 2.0 ** -24
    assert abs(got["cycles"][-1][0] - float(g["loss"])) <= ATOL
    for k, v in g["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), np.asarray(v),
                                   rtol=0, atol=ATOL, err_msg=k)
    for k, m in g["state"]["masks"].items():
        np.testing.assert_array_equal(got["state"]["masks"][k].numpy(),
                                      np.asarray(m), err_msg=k)
    for k, s in g["scores"].items():
        np.testing.assert_allclose(got["scores"][k].numpy(), np.asarray(s),
                                   rtol=0, atol=ATOL, err_msg=k)
    assert int(got["state"]["cycle"]) == int(g["state"]["cycle"]) == 5


def test_elastic_scaling_matches_the_example(capsys):
    g, out = _example("elastic_scaling", capsys)
    with jax_keys():
        trun, tnew = elastic_scaling(device="cpu", kernels="cuda",
                                     init_params=_jax_init())
    jrun, jnew = g["run"], g["new"]
    assert (tnew.cid, tnew.is_straggler, tnew.volume) == \
        (jnew.cid, jnew.is_straggler, jnew.volume)
    assert tnew.is_straggler and 0 < tnew.volume < 1
    assert [c.cid for c in trun.clients] == [c.cid for c in jrun.clients]
    assert [len(h["volumes"]) for h in trun.history] == [4] * 4 + [5] * 4 + \
        [4] * 2
    assert len(trun.history) == len(jrun.history) == 10
    for t, j in zip(trun.history, jrun.history):
        for k in ("cycle", "time", "volumes"):
            assert t[k] == j[k], (k, t[k], j[k])
        assert abs(t["acc"] - j["acc"]) <= ACC_TOL, (t["acc"], j["acc"])
    assert f"assigned P={tnew.volume:.2f}" in out


#: async_events cases: equal-time capable completions in buckets of 4 with
#: one update lost, and jittered completions in buckets of 1
ASYNC_CASES = {"dropout": ("--dropout", "0.3"),
               "jitter-dropout": ("--jitter", "0.3", "--dropout", "0.2")}


@pytest.mark.parametrize("case", list(ASYNC_CASES))
def test_async_events_matches_the_example(capsys, case):
    argv = ("--clients", "8", "--capable", "12") + ASYNC_CASES[case]
    _, out = _example("async_events", capsys, *argv)
    kw = dict(zip(argv[4::2], argv[5::2]))
    with jax_keys():
        got = async_events(clients=8, capable=12,
                           jitter=float(kw.get("--jitter", 0)),
                           dropout=float(kw.get("--dropout", 0)),
                           device="cpu", kernels="cuda",
                           init_params=_jax_init())
    lines = dict((m[0], m[1:]) for m in re.findall(
        r"(\w+)\s+\| (\d+) events \((\d+) dropped\).*acc ([\d.]+)", out))
    assert set(lines) == set(got) == {"sequential", "bucketed"}
    for name, (events, dropped, acc) in lines.items():
        run = got[name]["run"]
        assert (run.events_processed, run.events_dropped) == \
            (int(events), int(dropped)), name
        assert abs(run.evaluate() - float(acc)) <= ACC_TOL + 5e-4, name
    assert sum(int(d) for _, d, _ in lines.values()) > 0
    sizes = re.search(r"bucket sizes \{([^}]*)\}", out).group(1)
    count = collections.Counter(got["bucketed"]["run"].bucket_sizes)
    assert ", ".join(f"{s}x{c}" for s, c in sorted(count.items())) == sizes
    assert max(count) == (4 if case == "dropout" else 1)


def test_observability_matches_the_example(capsys, tmp_path):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    _example("observability", capsys, "--out", jout)
    with jax_keys():
        run, summ = observability(out=tout, device="cpu", kernels="cuda",
                                  init_params=_jax_init())
    jev, tev = j_load_events(jout), load_events(tout)
    kinds = collections.Counter(e["kind"] for e in jev)
    assert kinds.pop("compile") > 0
    assert collections.Counter(e["kind"] for e in tev) == kinds
    want = j_summarize(jev)
    assert summ == summarize(tev)
    for k in ("rounds", "sim_time", "uplink_mb", "downlink_mb"):
        assert summ[k] == want[k], (k, summ[k], want[k])
    assert summ["rounds"] == len(run.history) == 4
    assert abs(summ["final_metric"] - want["final_metric"]) <= ACC_TOL
