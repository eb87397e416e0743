# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Atomic checkpoints in the reference's on-disk container."""
from repro_torch.checkpoint.checkpoint import (codec_name, latest_step, load,
                                               metadata, restore, save)

__all__ = ["save", "restore", "load", "latest_step", "metadata",
           "codec_name"]
