# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Family adapters: the seam between model families and the round engine.

Everything that varies by model family — the batch dict (images + labels
or a token stream), the eval metric (accuracy or cross-entropy), per-unit
cycle scores and parameter-space mask expansion — lives behind an adapter,
so the engine stays family-blind.  The port has the CNN testbed and the
token LMs (dense, MoE, xLSTM and the hybrid); :func:`make_adapter`
dispatches on ``cfg.family``.  The VLM has no adapter, as in the
reference: it trains through ``launch.steps`` only.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import contribution as C
from repro_torch.core import masking as MK
from repro_torch.core import soft_train as ST
from repro_torch.models import build, cnn, logical_axes, transformer


class FamilyAdapter:
    """Example-indexed data handling shared by every family, plus the
    family hooks a subclass provides."""

    #: history/metric key ("acc" higher-is-better, "ce" lower-is-better)
    metric_name = "metric"

    def __init__(self, cfg: ModelConfig, kernels: str, mask_block: int,
                 device: torch.device):
        self.cfg = cfg
        self.api = build(cfg)
        self.schema = self.api.mask_schema
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

    def sample_cohort(self, rng: np.random.Generator,
                      data: Dict[str, np.ndarray], idx_seq,
                      local_steps: int, batch_size: int,
                      pad_to: int = 0) -> dict:
        """Per-client batches drawn in cohort order, stacked along a leading
        client axis.  Padding slots (up to ``pad_to``: the async engine's
        power-of-two buckets) repeat the first client's draw WITHOUT
        consuming the host RNG, so the padded engine stays draw for draw
        with the sequential one; engines give padding slots zero weight."""
        per = [self.sample_batch(rng, data, idx, local_steps, batch_size)
               for idx in idx_seq]
        if pad_to and pad_to > len(per):
            per = per + [per[0]] * (pad_to - len(per))
        return {k: torch.stack([b[k] for b in per]) for k in per[0]}

    def eval_slice(self, data: Dict[str, np.ndarray], lo: int,
                   hi: int) -> dict:
        return {k: torch.as_tensor(v[lo:hi]).to(self.device)
                for k, v in data.items()}

    # -- family hooks --------------------------------------------------
    def loss_fn(self, params, batch, masks):
        raise NotImplementedError

    def eval_chunk(self, params, batch):
        """(metric sum as a device scalar, example count)."""
        raise NotImplementedError

    def cycle_scores(self, params_new, params_old):
        raise NotImplementedError

    def expand_masks(self, unit_masks, params):
        raise NotImplementedError


class CNNAdapter(FamilyAdapter):
    """Paper testbed: image classification, prefix-keyed mask schema."""

    metric_name = "acc"

    def loss_fn(self, params, batch, masks):
        rt = {"kernels": self.kernels, "mask_block": self.mask_block}
        return cnn.cnn_loss(params, batch, self.cfg, rt, masks)

    @torch.no_grad()
    def eval_chunk(self, params, batch):
        logits = cnn.cnn_logits(params, batch["images"], self.cfg)
        correct = (logits.argmax(-1) == batch["labels"]).sum()
        return correct.float(), float(batch["labels"].shape[0])

    def cycle_scores(self, params_new, params_old):
        return C.cnn_unit_scores(C.delta(params_new, params_old), self.schema)

    def expand_masks(self, unit_masks, params):
        return MK.cnn_expand_masks(unit_masks, params)

    def expand_masks_batch(self, unit_masks, params):
        """``expand_masks`` over a stacked cohort (leading client axis)."""
        return MK.cnn_expand_masks_batch(unit_masks, params)


class TokenLMAdapter(FamilyAdapter):
    """Token-stream LM (the dense, MoE, ssm and hybrid families): axis-driven
    scores, cross-entropy eval, logical-axes mask expansion.  ``rt``
    carries ``kernels`` into the family's loss (the dense MLP and
    attention, or the hybrid's SSD intra-chunk term)."""

    metric_name = "ce"

    def __init__(self, cfg: ModelConfig, kernels: str, mask_block: int,
                 device: torch.device):
        super().__init__(cfg, kernels, mask_block, device)
        self.axes = logical_axes(cfg)
        self.rt = transformer.default_runtime()
        self.rt["kernels"] = kernels
        self.rt["mask_block"] = mask_block
        # evaluation runs the reference substrate, as in the JAX package:
        # there are no masks to skip
        self.eval_rt = transformer.default_runtime()

    def loss_fn(self, params, batch, masks):
        return self.api.loss_fn(params, batch, self.cfg, self.rt, masks)

    @torch.no_grad()
    def eval_chunk(self, params, batch):
        ce = self.api.loss_fn(params, batch, self.cfg, self.eval_rt, None)
        n = batch["tokens"].shape[0]
        return ce * n, float(n)

    def cycle_scores(self, params_new, params_old):
        return ST.cycle_scores(params_new, params_old, self.axes, self.schema)

    def expand_masks(self, unit_masks, params):
        return MK.expand_masks(self.axes, unit_masks, params)


_ADAPTERS = {"cnn": CNNAdapter, "dense": TokenLMAdapter,
             "moe": TokenLMAdapter, "ssm": TokenLMAdapter,
             "hybrid": TokenLMAdapter}


def make_adapter(cfg: ModelConfig, kernels: str, mask_block: int,
                 device: torch.device) -> FamilyAdapter:
    """Family dispatch for the round engine."""
    try:
        cls = _ADAPTERS[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"no FamilyAdapter for family {cfg.family!r} (supported "
            f"families: {tuple(_ADAPTERS)})") from None
    return cls(cfg, kernels, mask_block, device)
