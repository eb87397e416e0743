# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Family adapter: the seam between the CNN testbed and the round engine.

Everything that varies by model family — batch sampling, the eval metric,
per-unit cycle scores and parameter-space mask expansion — lives here, so
the engine stays family-blind.  The port has the CNN family.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import contribution as C
from repro_torch.core import masking as MK
from repro_torch.models import cnn


class CNNAdapter:
    """Paper testbed: image classification, prefix-keyed mask schema."""

    metric_name = "acc"

    def __init__(self, cfg: ModelConfig, kernels: str, mask_block: int,
                 device: torch.device):
        if cfg.family != "cnn":
            raise NotImplementedError(
                f"the port federates the CNN family only, got {cfg.family!r}")
        self.cfg = cfg
        self.schema = cnn.cnn_mask_schema(cfg)
        #: execution substrate of the training loss: "reference" or "cuda"
        self.kernels = kernels
        self.mask_block = mask_block
        self.device = device

    # -- data ----------------------------------------------------------
    def num_examples(self, data: Dict[str, np.ndarray]) -> int:
        return len(next(iter(data.values())))

    def sample_batch(self, rng: np.random.Generator,
                     data: Dict[str, np.ndarray], idx: np.ndarray,
                     local_steps: int, batch_size: int) -> dict:
        """A (local_steps, batch_size)-leading batch dict from one client's
        example indices, consuming the host RNG exactly once — the same
        numpy call in the same order as the reference."""
        idx = np.asarray(idx)
        take = rng.choice(idx, size=(local_steps, batch_size),
                          replace=len(idx) < local_steps * batch_size)
        return {k: torch.as_tensor(v[take]).to(self.device)
                for k, v in data.items()}

    def eval_slice(self, data: Dict[str, np.ndarray], lo: int,
                   hi: int) -> dict:
        return {k: torch.as_tensor(v[lo:hi]).to(self.device)
                for k, v in data.items()}

    # -- family hooks --------------------------------------------------
    def loss_fn(self, params, batch, masks):
        rt = {"kernels": self.kernels, "mask_block": self.mask_block}
        return cnn.cnn_loss(params, batch, self.cfg, rt, masks)

    @torch.no_grad()
    def eval_chunk(self, params, batch):
        """(correct count as a device scalar, example count)."""
        logits = cnn.cnn_logits(params, batch["images"], self.cfg)
        correct = (logits.argmax(-1) == batch["labels"]).sum()
        return correct.float(), float(batch["labels"].shape[0])

    def cycle_scores(self, params_new, params_old):
        return C.cnn_unit_scores(C.delta(params_new, params_old), self.schema)

    def expand_masks(self, unit_masks, params):
        return MK.cnn_expand_masks(unit_masks, params)
