# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Run-log reporting: render and regression-diff telemetry JSONL.

``python -m repro_torch.obs report <run>`` renders a run's manifest header, the
per-round table (history events: cycle, sim/wall clocks, metric, loss,
uplink/downlink), the straggler timeline (per-client completions and mean
staleness from the async completion stream, or per-round straggler
volumes from the sync volume stream), and the span/histogram census.

``python -m repro_torch.obs diff <old> <new>`` compares two runs' summaries
within stated tolerances and exits nonzero on a regression — the CI gate
between a fresh run log and a committed baseline.  Either side may be a
run directory, an ``events.jsonl``, or a ``BENCH_observability.json``
(whose ``summary`` block is shaped like a run-log summary exactly so the
two compare uniformly).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

#: metric keys a history row may carry, in display preference order
_METRICS = ("acc", "ce", "loss")


def load_events(path: str) -> List[dict]:
    """Events from a run log: a directory (its ``events.jsonl``), a
    ``.jsonl`` file, or a ``BENCH_observability.json`` (no events, just
    the summary line)."""
    if os.path.isdir(path):
        path = os.path.join(path, "events.jsonl")
    with open(path) as f:
        if path.endswith(".json"):
            bench = json.load(f)
            rows = [{"kind": "manifest", **bench.get("manifest", {})}]
            if "summary" in bench:
                rows.append({"kind": "summary", **bench["summary"]})
            return rows
        return [json.loads(line) for line in f if line.strip()]


def _by_kind(events: List[dict], kind: str) -> List[dict]:
    return [e for e in events if e.get("kind") == kind]


def _first(events: List[dict], kind: str) -> dict:
    rows = _by_kind(events, kind)
    return rows[0] if rows else {}


def _metric_key(row: dict) -> Optional[str]:
    for k in _METRICS:
        if k in row:
            return k
    return None


def _fmt_table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    line = "  ".join(h.ljust(w) for h, w in zip(headers, widths))
    sep = "  ".join("-" * w for w in widths)
    body = ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    return "\n".join([line, sep] + body)


def summarize(events: List[dict]) -> dict:
    """The comparable summary of one run log: final metric, simulated
    wall-clock, byte accounting, and the event census ``diff`` gates on."""
    hist = _by_kind(events, "history")
    summary = _first(events, "summary")
    counters = summary.get("counters", {})
    gauges = summary.get("gauges", {})
    out = {
        "rounds": len(hist),
        "sim_time": hist[-1]["sim"] if hist else summary.get("sim_time"),
        "events": summary.get("events", len(events)),
        "uplink_mb": gauges.get("uplink_mb", summary.get("uplink_mb")),
        "downlink_mb": gauges.get("downlink_mb",
                                  summary.get("downlink_mb")),
        "counters": counters,
    }
    if hist:
        mk = _metric_key(hist[-1])
        if mk:
            out["metric_name"] = mk
            out["final_metric"] = hist[-1][mk]
    else:
        out["metric_name"] = summary.get("metric_name")
        out["final_metric"] = summary.get("final_metric")
    return out


def render(events: List[dict]) -> str:
    """The full human-readable report for one run log."""
    parts = []
    man = _first(events, "manifest")
    if man:
        keys = ("engine", "scheme", "family", "model", "kernels",
                "compression", "clients", "participation", "seed",
                "git_sha")
        parts.append("run manifest: " + "  ".join(
            f"{k}={man[k]}" for k in keys if k in man))

    hist = _by_kind(events, "history")
    if hist:
        mk = _metric_key(hist[0]) or "metric"
        headers = ["cycle", "cadence", "sim_time", "wall_s", mk, "loss",
                   "downlink_mb"]
        rows = []
        for h in hist:
            rows.append([
                str(h.get("cycle", "?")),
                str(h.get("record_cadence", "?")),
                f"{h.get('sim', float('nan')):.3f}",
                f"{h.get('wall', float('nan')):.2f}",
                f"{h.get(mk, float('nan')):.4f}",
                f"{h.get('loss', float('nan')):.4f}",
                f"{h.get('downlink_mb', float('nan')):.2f}",
            ])
        parts.append("per-round table\n" + _fmt_table(headers, rows))

    comps = _by_kind(events, "completion")
    if comps:
        per = {}
        for c in comps:
            d = per.setdefault(c["cid"], {"n": 0, "stale": 0.0})
            d["n"] += 1
            d["stale"] += c.get("stale", 0)
        rows = [[str(cid), str(d["n"]), f"{d['stale'] / d['n']:.2f}"]
                for cid, d in sorted(per.items())]
        parts.append("straggler timeline (async completions)\n"
                     + _fmt_table(["cid", "completions", "mean_staleness"],
                                  rows))
    vols = _by_kind(events, "volumes")
    if vols:
        rows = [[str(v.get("round", "?")), f"{v.get('sim', 0.0):.3f}",
                 " ".join(f"{x:.2f}" for x in v.get("volumes", []))]
                for v in vols]
        parts.append("straggler timeline (volumes per round)\n"
                     + _fmt_table(["round", "sim_time",
                                   "straggler_volumes"], rows))

    promos = _by_kind(events, "promotion")
    swaps = _by_kind(events, "swap")
    if promos or swaps:
        summary = _first(events, "summary")
        counters = summary.get("counters", {})
        hists = summary.get("hists", {})
        head = []
        for k in ("serve_requests", "serve_swaps", "serve_promotions",
                  "serve_rejections", "published_snapshots"):
            if k in counters:
                head.append(f"{k}={counters[k]}")
        parts.append("serving plane: " + "  ".join(head))
        rows = []
        for p in promos:
            rows.append([
                str(p.get("step", "?")), str(p.get("round", "?")),
                "promote" if p.get("promoted") else "reject",
                f"{p.get('metric', float('nan')):.4f}",
                "-" if p.get("served_metric") is None
                else f"{p['served_metric']:.4f}",
            ])
        if rows:
            parts.append("promotion decisions\n" + _fmt_table(
                ["step", "round", "decision", "metric", "served_metric"],
                rows))
        rows = [[str(s.get("step", "?")), str(s.get("round", "?")),
                 str(s.get("staleness", "?"))] for s in swaps]
        if rows:
            parts.append("hot swaps\n" + _fmt_table(
                ["step", "round", "staleness_rounds"], rows))
        for name in ("request_ms", "serve_staleness"):
            if name in hists:
                parts.append(f"{name}: " + json.dumps(hists[name],
                                                      sort_keys=True))

    spans = _by_kind(events, "span")
    if spans:
        agg = {}
        for s in spans:
            d = agg.setdefault(s.get("name", "?"), {"n": 0, "ms": 0.0})
            d["n"] += 1
            d["ms"] += s.get("wall_ms", 0.0)
        rows = [[name, str(d["n"]), f"{d['ms']:.1f}",
                 f"{d['ms'] / d['n']:.2f}"]
                for name, d in sorted(agg.items())]
        parts.append("span census\n" + _fmt_table(
            ["span", "count", "total_ms", "mean_ms"], rows))

    summary = _first(events, "summary")
    if summary:
        parts.append("summary counters: " + json.dumps(
            summary.get("counters", {}), sort_keys=True))
        if summary.get("hists"):
            parts.append("histograms: " + json.dumps(summary["hists"],
                                                     sort_keys=True))
    return "\n\n".join(parts) if parts else "(empty run log)"


#: (field, relative tolerance, direction) — ``+`` means larger-is-better
#: (a drop beyond tol regresses), ``-`` means smaller-is-better
_DIFF_FIELDS = (("final_metric", 0.05, "+"),
                ("sim_time", 0.25, "-"),
                ("uplink_mb", 0.25, "-"),
                ("downlink_mb", 0.25, "-"))


def diff(old_events: List[dict], new_events: List[dict],
         tol_scale: float = 1.0) -> Tuple[List[str], List[str]]:
    """Compare two run summaries; returns (report lines, regressions).

    Loss-like metrics (``ce``/``loss``) invert the metric direction.
    Fields absent on either side are reported but never gate.
    """
    old, new = summarize(old_events), summarize(new_events)
    lines, regressions = [], []
    for field, tol, direction in _DIFF_FIELDS:
        a, b = old.get(field), new.get(field)
        if a is None or b is None:
            lines.append(f"{field}: old={a} new={b} (not compared)")
            continue
        if field == "final_metric" and \
                old.get("metric_name") in ("ce", "loss"):
            direction = "-"
        tol = tol * tol_scale
        scale = max(abs(a), 1e-9)
        delta = (b - a) / scale
        bad = delta < -tol if direction == "+" else delta > tol
        verdict = "REGRESSION" if bad else "ok"
        lines.append(f"{field}: old={a:.4f} new={b:.4f} "
                     f"delta={delta * 100:+.1f}% tol={tol * 100:.0f}% "
                     f"[{verdict}]")
        if bad:
            regressions.append(field)
    return lines, regressions


def main_report(path: str) -> int:
    print(render(load_events(path)))
    return 0


def main_diff(old_path: str, new_path: str, tol_scale: float = 1.0) -> int:
    lines, regressions = diff(load_events(old_path), load_events(new_path),
                              tol_scale)
    print(f"diff {old_path} -> {new_path}")
    for line in lines:
        print("  " + line)
    if regressions:
        print(f"REGRESSION in: {', '.join(regressions)}")
        return 1
    print("no regressions")
    return 0
