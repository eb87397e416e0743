# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""The port's drivers, run as ``python -m``: the paper's figure tables
(:mod:`repro_torch.drivers.paper_figures`), the comparison drivers
(:mod:`~repro_torch.drivers.scheme_gauntlet`, every scheme under one
world; :mod:`~repro_torch.drivers.heterogeneous_fl`, the five-scheme
table), the examples (:mod:`~repro_torch.drivers.quickstart`,
:mod:`~repro_torch.drivers.elastic_scaling`,
:mod:`~repro_torch.drivers.async_events`,
:mod:`~repro_torch.drivers.observability`) and
:mod:`~repro_torch.drivers.serve_while_train`."""
