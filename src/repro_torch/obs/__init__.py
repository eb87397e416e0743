"""Observability: the engines' telemetry layer.

Free when off: arm it with ``REPRO_OBS=on`` or a scoped :func:`override`.
The :class:`Recorder` is the one accounting surface (the engines' counters
live there); armed, it also buffers dual-clock (sim + wall) events, spans
and histograms, flushed to a JSONL run log and manifest that
``python -m repro_torch.obs report|diff`` renders and compares.
"""
from repro_torch.obs.recorder import (  # noqa: F401
    SIM_KINDS,
    Recorder,
    enabled,
    env_profile_round,
    git_sha,
    override,
)
from repro_torch.obs.report import (  # noqa: F401
    diff,
    load_events,
    render,
    summarize,
)
