"""Model API of the port: family dispatch (the paper CNNs, the dense and
MoE LMs and the Mamba2 + shared-attention hybrid), with the token-LM
families' prefill and decode for serving."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import cnn, hybrid, transformer
from repro_torch.models import module as M


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    spec: Any
    loss_fn: Callable          # (params, batch, cfg, rt, masks) -> scalar
    #: (params, batch, cfg, rt, masks) -> (last logits, cache); None: the
    #: family has no serving path (the CNNs)
    prefill_fn: Optional[Callable]
    #: (params, token (B, 1), cache, cfg, rt, masks) -> (logits, cache)
    decode_fn: Optional[Callable]
    mask_schema: Dict[str, tuple]


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("dense", "moe"):
        return ModelAPI(cfg, transformer.lm_spec(cfg), transformer.lm_loss,
                        transformer.lm_prefill, transformer.lm_decode,
                        transformer.mask_schema(cfg))
    if cfg.family == "hybrid":
        return ModelAPI(cfg, hybrid.hybrid_spec(cfg), hybrid.hybrid_loss,
                        hybrid.hybrid_prefill, hybrid.hybrid_decode,
                        hybrid.mask_schema(cfg))
    if cfg.family == "cnn":
        return ModelAPI(cfg, cnn.cnn_spec(cfg), cnn.cnn_loss, None, None,
                        cnn.cnn_mask_schema(cfg))
    raise NotImplementedError(
        f"the port has the cnn, dense, moe and hybrid families, not "
        f"{cfg.family!r}; vlm waits (ROADMAP.md, modules to port, item 9), "
        f"ssm (xlstm) and encdec too (item 15)")


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters of ``cfg`` from ``seed``, on ``device`` (default
    ``cuda``; raises when there is no GPU and the CPU was not asked for)."""
    return M.init_params(build(cfg).spec, seed, device, dtype)


def logical_axes(cfg: ModelConfig):
    return M.logical_axes(build(cfg).spec)


#: the execution knobs threaded through the model functions (``attn_impl``,
#: ``moe_impl`` / ``moe_groups``, ``kernels`` / ``mask_block``)
default_runtime = transformer.default_runtime


def make_full_masks(cfg: ModelConfig, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32):
    """All-ones Helios masks (no compression) matching the mask schema."""
    dev = resolve_device(device)
    return {k: torch.ones(s, dtype=dtype, device=dev)
            for k, s in build(cfg).mask_schema.items()}


__all__ = ["ModelAPI", "build", "default_runtime", "init_params",
           "logical_axes", "make_full_masks"]
