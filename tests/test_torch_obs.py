"""Port parity: the telemetry layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``, on reduced LeNet (a 4 + 4 IID fleet, one local
step of batch 8).

* a disarmed recorder counts but buffers no event; an armed one flushes the
  reference's run log (manifest line, events, summary line);
* each port engine's ``sim_events()`` stream (rounds, spans, volumes,
  completions, drops) and its ``staleness`` / ``queue_depth`` /
  ``bucket_size`` histograms equal its JAX engine's: ``FLRun.run_sync`` of
  helios and syn, ``FLRun.run_async`` of afo, ``BatchedFLRun.run_sync``,
  ``AsyncFLRun``'s buckets;
* a disarmed run's trajectory equals an armed run's bit for bit;
* ``python -m repro_torch.obs report`` / ``diff`` render a port run log and
  ``diff`` exits nonzero on an injected regression;
* ``maybe_profile`` writes a ``torch.profiler`` trace of the chosen round.
"""
import json
import os

import jax
import numpy as np
import pytest

# idle OpenMP threads sleep rather than spin beside other test workers;
# read when torch loads, and the thread count stays as it is
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.data.federated import partition_iid  # noqa: E402
from repro.data.synthetic import class_gaussian_images  # noqa: E402
from repro.federated import AsyncFLRun as JAsyncFLRun  # noqa: E402
from repro.federated import BatchedFLRun as JBatchedFLRun  # noqa: E402
from repro.federated import FLRun as JFLRun  # noqa: E402
from repro.federated import make_fleet as j_make_fleet  # noqa: E402
from repro.federated import setup_clients as j_setup_clients  # noqa: E402
from repro.obs import recorder as JOBS  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.federated import (AsyncFLRun, BatchedFLRun, FLRun,  # noqa: E402
                                   make_fleet, setup_clients)
from repro_torch.obs import recorder as OBS  # noqa: E402
from repro_torch.obs import report as OBR  # noqa: E402
from repro_torch.obs.__main__ import main as obs_main  # noqa: E402
from test_torch_keys import share_jax_programs  # noqa: E402

ROUNDS = 2
CYCLES = 4
RUN_KW = dict(local_steps=1, batch_size=8, lr=0.1, seed=0, eval_batch=64)
HISTS = ("staleness", "queue_depth", "bucket_size")
#: case -> (JAX engine, port engine, scheme, drive)
CASES = {
    "flrun-helios": (JFLRun, FLRun, "helios", "sync"),
    "flrun-syn": (JFLRun, FLRun, "syn", "sync"),
    "flrun-afo": (JFLRun, FLRun, "afo", "async"),
    "batched-helios": (JBatchedFLRun, BatchedFLRun, "helios", "sync"),
    "bucket-afo": (JAsyncFLRun, AsyncFLRun, "afo", "async"),
}


@pytest.fixture(scope="module")
def setting():
    imgs, labels = class_gaussian_images(400, 16, 1, 10, seed=0)
    ti, tl = class_gaussian_images(64, 16, 1, 10, seed=9)
    parts = partition_iid(len(labels), 8, seed=0)
    return {"images": imgs, "labels": labels}, \
        {"images": ti, "labels": tl}, parts


def _port(setting, cls, scheme="helios", init=None, **kw):
    train, test, parts = setting
    h = TC.HeliosConfig()
    return cls(TC.reduced(TC.LENET), h, scheme,
               setup_clients(make_fleet(4, 4), parts, h, device="cpu"),
               train, test, device="cpu", init_params=init,
               **dict(RUN_KW, **kw))


def _drive(run, drive):
    if drive == "sync":
        return run.run_sync(ROUNDS, eval_every=0)
    return run.run_async(CYCLES, eval_every=0)


@pytest.fixture(scope="module")
def engine_runs(setting):
    """Each case's JAX run and port run, both armed (JAX runs once a
    case)."""
    train, test, parts = setting
    out = {}
    for case, (jcls, tcls, scheme, drive) in CASES.items():
        jh = JC.HeliosConfig()
        jrun = jcls(JC.reduced(JC.CNNS["lenet"]), jh, scheme,
                    j_setup_clients(j_make_fleet(4, 4), parts, jh), train,
                    test, recorder=JOBS.Recorder(armed=True), **RUN_KW)
        if jcls is JFLRun:
            share_jax_programs(jrun)
        init = {k: np.asarray(v)
                for k, v in jax.device_get(jrun.global_params).items()}
        trun = _port(setting, tcls, scheme, init,
                     recorder=OBS.Recorder(armed=True))
        _drive(jrun, drive)
        _drive(trun, drive)
        out[case] = jrun, trun
    return out


# ---------------------------------------------------------------------------
# the recorder itself
# ---------------------------------------------------------------------------


def test_disarmed_recorder_counts_but_never_emits():
    rec = OBS.Recorder(armed=False)
    rec.inc("a")
    rec.inc("a", 2)
    rec.set_max("m", 5)
    rec.set_max("m", 3)
    rec.gauge("g", 1.5)
    rec.event("round", sim=0.0, x=1)
    rec.observe("h", 1.0)
    with rec.span("s", sim=0.0):
        pass
    with rec.maybe_profile(0):
        pass
    assert rec.counters == {"a": 3, "m": 5}
    assert rec.gauges == {"g": 1.5}
    assert rec.events == [] and rec.hists == {}
    rec.accum("c", torch.tensor(2.0))
    rec.accum("c", torch.tensor(3.0))
    assert rec.accum_value("c") == 5.0
    assert rec.accum_value("missing", 7.0) == 7.0


def test_arming_switch(monkeypatch):
    monkeypatch.setenv("REPRO_OBS", "on")
    assert OBS.enabled() and OBS.Recorder().armed
    with OBS.override(False):
        assert not OBS.enabled() and not OBS.Recorder().armed
    monkeypatch.setenv("REPRO_OBS", "off")
    assert not OBS.Recorder().armed
    with OBS.override(True):
        assert OBS.Recorder().armed
    assert OBS.Recorder(armed=True).armed


def test_armed_recorder_flush_matches_reference(tmp_path):
    """The same calls give the same run log as ``repro.obs`` (wall clocks
    aside)."""
    logs = {}
    for name, mod in (("port", OBS), ("jax", JOBS)):
        rec = mod.Recorder(armed=True, manifest={"engine": "unit"})
        rec.event("round", sim=1.0, round=0)
        rec.observe("staleness", 2.0)
        rec.observe("staleness", 0.0)
        rec.gauge("uplink_mb", 3.5)
        rec.inc("serve_requests", 4)
        with rec.span("train", sim=1.0, round=0):
            pass
        out = rec.flush(str(tmp_path / name))
        lines = [json.loads(line) for line in open(out["events"])]
        for ln in lines:
            ln.pop("wall", None)
            ln.pop("wall_ms", None)
        logs[name] = (lines, json.load(open(out["manifest"])),
                      rec.sim_events())
    assert logs["port"] == logs["jax"]
    lines, manifest, sims = logs["port"]
    assert lines[0] == {"kind": "manifest", "engine": "unit"}
    assert lines[-1]["kind"] == "summary" and lines[-1]["events"] == 2
    assert lines[-1]["hists"]["staleness"]["count"] == 2
    assert [e["kind"] for e in sims] == ["round", "span"]


# ---------------------------------------------------------------------------
# the engines' streams against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_sim_events_match_jax(engine_runs, case):
    jrun, trun = engine_runs[case]
    jev, tev = jrun.rec.sim_events(), trun.rec.sim_events()
    assert len(tev) == len(jev) > 0
    for i, (t, j) in enumerate(zip(tev, jev)):
        assert t == j, (i, t, j)
    kinds = {e["kind"] for e in tev}
    if CASES[case][3] == "sync":
        assert {"round", "volumes", "span"} <= kinds
    else:
        assert "completion" in kinds
    for name in HISTS:
        assert trun.rec.hists.get(name) == jrun.rec.hists.get(name), name
    for k in ("uplink_updates", "downlink_updates", "events_processed",
              "events_dropped", "agg_counter"):
        assert trun.rec.count(k) == jrun.rec.count(k), k
    assert trun.rec.gauges["uplink_mb"] == pytest.approx(
        jrun.rec.gauges["uplink_mb"], rel=1e-12)
    assert trun.rec.manifest["engine"] == jrun.rec.manifest["engine"]
    assert trun.rec.manifest["scheme_flags"] == \
        jrun.rec.manifest["scheme_flags"]


def test_bucket_events_carry_the_buckets(engine_runs):
    trun = engine_runs["bucket-afo"][1]
    buckets = [e for e in trun.rec.events if e["kind"] == "bucket"]
    assert [b["size"] for b in buckets] == trun.bucket_sizes
    assert all(b["wall_ms"] >= 0 and b["pad"] >= 0 for b in buckets)


def test_disarmed_run_trajectory_identical(setting):
    """Emission never touches the math: with telemetry off the trajectory
    is the armed run's bit for bit and no event is buffered."""
    runs = {}
    for armed in (False, True):
        with OBS.override(armed):
            run = _port(setting, BatchedFLRun)
            run.run_sync(ROUNDS)
        runs[armed] = run
    off, on = runs[False], runs[True]
    assert off.rec.events == [] and off.rec.hists == {}
    assert {e["kind"] for e in on.rec.events} >= {"history", "round", "span"}
    assert off.history == on.history
    for k, v in on.global_params.items():
        assert torch.equal(off.global_params[k], v), k
    assert off.rec.counters == on.rec.counters


# ---------------------------------------------------------------------------
# report / diff and the profiler hook
# ---------------------------------------------------------------------------


def test_report_and_diff_render_port_run_log(setting, tmp_path, capsys):
    rec = OBS.Recorder(armed=True)
    run = _port(setting, FLRun, recorder=rec)
    run.run_sync(ROUNDS)
    rec.event("promotion", step=1, round=1, promoted=True, metric=2.0,
              served_metric=None)
    rec.event("swap", step=1, round=1, staleness=0)
    rec.inc("serve_swaps")
    log = str(tmp_path / "run")
    rec.flush(log)
    assert obs_main(["report", log]) == 0
    out = capsys.readouterr().out
    assert "run manifest: engine=FLRun  scheme=helios" in out
    assert "per-round table" in out and "span census" in out
    assert "straggler timeline (volumes per round)" in out
    assert "serving plane: serve_swaps=1" in out
    assert "hot swaps" in out
    assert OBR.render(OBR.load_events(log)) in out
    assert obs_main(["diff", log, log]) == 0
    # a regression: the final accuracy falls by half
    lines = [json.loads(x) for x in open(os.path.join(log, "events.jsonl"))]
    for ln in lines:
        if ln["kind"] == "history":
            ln["acc"] = ln["acc"] * 0.5
    bad = tmp_path / "bad.jsonl"
    bad.write_text("".join(json.dumps(x) + "\n" for x in lines))
    capsys.readouterr()
    assert obs_main(["diff", log, str(bad)]) == 1
    assert "REGRESSION in: final_metric" in capsys.readouterr().out


def test_maybe_profile_writes_the_round_trace(setting, tmp_path):
    prof_dir = str(tmp_path / "prof")
    rec = OBS.Recorder(armed=True, profile_round=1, profile_dir=prof_dir)
    run = _port(setting, FLRun, recorder=rec)
    run.run_sync(ROUNDS, eval_every=0)
    traces = [e for e in rec.events if e["kind"] == "profile_trace"]
    assert [t["round"] for t in traces] == [1]
    files = os.listdir(prof_dir)
    assert files == ["round_1.trace.json"]
    assert os.path.getsize(os.path.join(prof_dir, files[0])) > 0
