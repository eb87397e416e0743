# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""The telemetry recorder: the engines' one accounting surface.

Two layers, as in the reference:

* **Accounting** (always on): counters, gauges and device-scalar
  accumulators.  The engine's history rows, byte accounting
  (``downlink_bytes``) and the async loop's read-only views
  (``events_processed``, ``snapshot_peak``, ...) read these host integers;
  incrementing one costs a dict update and never waits for the device.
  :meth:`Recorder.accum` keeps a running sum of device scalars (the uplink
  codec's ``uplink_coords``) on the device, and :meth:`Recorder.accum_value`
  is its one wait.
* **Emission** (armed only): dual-clock spans, histogram observations, the
  event list and the run log (``events.jsonl`` + ``manifest.json``, see
  :meth:`Recorder.flush`).  Armed by ``REPRO_OBS=on``, a scoped
  :func:`override`, or ``Recorder(armed=True)``.  Disarmed, every emission
  method is one boolean test and no event is ever buffered.

Every event carries the dual clock: ``sim``, the caller's simulated time
(deterministic, so fixed-seed streams compare across engines and across
packages), and ``wall``, host ``time.perf_counter`` since the recorder was
built.  :meth:`Recorder.sim_events` strips the wall side.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional

import torch

_TLS = threading.local()

#: event kinds whose payload is simulated time and host arithmetic only,
#: the same for every engine (and both packages) under a fixed seed
SIM_KINDS = ("round", "span", "completion", "drop", "volumes")


def _env_enabled() -> bool:
    return os.environ.get("REPRO_OBS", "off").strip().lower() in (
        "on", "1", "true", "yes")


def enabled() -> bool:
    """Telemetry armed?  A scoped :func:`override` beats ``REPRO_OBS``."""
    ov = getattr(_TLS, "override", None)
    return _env_enabled() if ov is None else ov


@contextlib.contextmanager
def override(value: bool):
    """Force telemetry on or off for a scope (this thread)."""
    prev = getattr(_TLS, "override", None)
    _TLS.override = bool(value)
    try:
        yield
    finally:
        _TLS.override = prev


def env_profile_round() -> Optional[int]:
    """Round to trace with ``torch.profiler`` (``REPRO_OBS_PROFILE=<round>``;
    unset or not an integer: none)."""
    v = os.environ.get("REPRO_OBS_PROFILE", "").strip()
    try:
        return int(v)
    except ValueError:
        return None


def git_sha() -> str:
    """The checkout's short commit sha for the manifest ("unknown" outside
    git)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() or "unknown"
    except Exception:
        return "unknown"


_NULL_CTX = contextlib.nullcontext()


class Recorder:
    """Counters, gauges and device accumulators (always); dual-clock spans,
    histograms, the event list and the run log (armed only).

    One recorder a run (built by ``FLRun`` unless ``recorder=`` passes one
    to arm it explicitly or to share it between runs and the serving
    plane)."""

    def __init__(self, armed: Optional[bool] = None,
                 manifest: Optional[dict] = None,
                 profile_round: Optional[int] = None,
                 profile_dir: str = "obs_profile") -> None:
        self.armed = enabled() if armed is None else bool(armed)
        self.manifest: dict = dict(manifest or {})
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, List[float]] = {}
        self.events: List[dict] = []
        self._accums: Dict[str, torch.Tensor] = {}
        self._t0 = time.perf_counter()
        self.profile_round = env_profile_round() \
            if profile_round is None else profile_round
        self.profile_dir = profile_dir

    # -- accounting (always on) ---------------------------------------------
    def inc(self, name: str, n: int = 1) -> int:
        self.counters[name] = self.counters.get(name, 0) + n
        return self.counters[name]

    def set(self, name: str, value: int) -> None:
        self.counters[name] = value

    def set_max(self, name: str, value: int) -> None:
        self.counters[name] = max(self.counters.get(name, value), value)

    def count(self, name: str, default: int = 0) -> int:
        return self.counters.get(name, default)

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def accum(self, name: str, value: torch.Tensor) -> None:
        """Add a device scalar to a running sum kept on the device (the
        sum is in the value's dtype, in the order of the calls)."""
        prev = self._accums.get(name)
        self._accums[name] = value if prev is None else prev + value

    def accum_raw(self, name: str, default=None) -> Optional[torch.Tensor]:
        """The running sum itself, still on the device."""
        return self._accums.get(name, default)

    def accum_value(self, name: str, default: float = 0.0) -> float:
        """The running sum as a host float: waits for the device."""
        v = self._accums.get(name)
        if v is None:
            return default
        return float(v)                        # repro: noqa[R3]

    # -- emission (armed only) ----------------------------------------------
    def event(self, kind: str, *, sim: Optional[float] = None,
              **fields) -> None:
        """Append one event (host values only: an emission never waits for
        the device)."""
        if not self.armed:
            return
        ev: dict = {"kind": kind, "wall": time.perf_counter() - self._t0}
        if sim is not None:
            ev["sim"] = sim
        ev.update(fields)
        self.events.append(ev)

    def observe(self, name: str, value: float) -> None:
        """One histogram observation (summarized by :meth:`hist_summary`)."""
        if not self.armed:
            return
        self.hists.setdefault(name, []).append(value)

    def span(self, name: str, sim: Optional[float] = None, **tags):
        """Dual-clock span: one ``span`` event with the caller's sim time
        and the host wall time the block took (the device may still be
        busy with the block's work when it ends)."""
        if not self.armed:
            return _NULL_CTX
        return self._span(name, sim, tags)

    @contextlib.contextmanager
    def _span(self, name, sim, tags):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.event("span", sim=sim, name=name,
                       wall_ms=(time.perf_counter() - t0) * 1e3, **tags)

    @contextlib.contextmanager
    def maybe_profile(self, round_idx: int):
        """A ``torch.profiler`` trace of ONE chosen round (armed and
        ``profile_round`` matching), written as a Chrome trace into
        ``profile_dir``; otherwise free."""
        if not self.armed or self.profile_round is None or \
                round_idx != self.profile_round:
            yield
            return
        prof = None
        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        except Exception as e:               # a build without the profiler
            prof = None
            self.event("profile_error", round=round_idx, error=str(e))
        try:
            yield
        finally:
            if prof is not None:
                try:
                    prof.__exit__(None, None, None)
                    os.makedirs(self.profile_dir, exist_ok=True)
                    path = os.path.join(self.profile_dir,
                                        f"round_{round_idx}.trace.json")
                    prof.export_chrome_trace(path)
                    self.event("profile_trace", round=round_idx,
                               dir=self.profile_dir)
                except Exception as e:
                    self.event("profile_error", round=round_idx,
                               error=str(e))

    # -- views and sinks ----------------------------------------------------
    def sim_events(self, kinds=SIM_KINDS) -> List[dict]:
        """Events of the engine-invariant kinds, wall clocks stripped."""
        return [{k: v for k, v in ev.items() if k not in ("wall", "wall_ms")}
                for ev in self.events if ev["kind"] in kinds]

    def hist_summary(self) -> Dict[str, dict]:
        out = {}
        for name, vals in self.hists.items():
            s = sorted(vals)
            n = len(s)
            out[name] = {"count": n, "min": s[0], "max": s[-1],
                         "mean": sum(s) / n,
                         "p50": s[n // 2],
                         "p90": s[min((9 * n) // 10, n - 1)],
                         "p99": s[min((99 * n) // 100, n - 1)]}
        return out

    def snapshot(self) -> dict:
        """Counters, gauges (device accumulators read here: a wait) and
        histogram summaries."""
        gauges = dict(self.gauges)
        for name in self._accums:
            gauges[name] = self.accum_value(name)
        return {"counters": dict(self.counters), "gauges": gauges,
                "hists": self.hist_summary()}

    def flush(self, out_dir: str) -> dict:
        """Write the run log: ``events.jsonl`` (a manifest line, one line an
        event, a summary line) and ``manifest.json``.  Returns the paths
        and the summary."""
        os.makedirs(out_dir, exist_ok=True)
        events_path = os.path.join(out_dir, "events.jsonl")
        manifest_path = os.path.join(out_dir, "manifest.json")
        summary = self.snapshot()
        summary["events"] = len(self.events)
        with open(manifest_path, "w") as f:
            json.dump(self.manifest, f, indent=2, default=str)
        with open(events_path, "w") as f:
            f.write(json.dumps({"kind": "manifest", **self.manifest},
                               default=str) + "\n")
            for ev in self.events:
                f.write(json.dumps(ev, default=str) + "\n")
            f.write(json.dumps({"kind": "summary", **summary},
                               default=str) + "\n")
        return {"events": events_path, "manifest": manifest_path,
                "summary": summary}
