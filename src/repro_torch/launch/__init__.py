# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Launch entry points of the port (``python -m repro_torch.launch.serve``)."""
