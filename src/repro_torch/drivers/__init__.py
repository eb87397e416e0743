# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""The paper's comparison drivers, run as ``python -m``:
:mod:`repro_torch.drivers.scheme_gauntlet` (every scheme under one world)
and :mod:`repro_torch.drivers.heterogeneous_fl` (the five-scheme table)."""
