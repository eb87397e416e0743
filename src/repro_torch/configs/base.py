# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Configuration dataclasses for the PyTorch port (the fields its slices read).

* :class:`ModelConfig`  — architecture of a paper-testbed CNN, a dense or
  MoE LM (with DeepSeek-V2's latent attention, MLA), the Mamba2 +
  shared-attention hybrid, the xLSTM stack, the VLM (a dense LM behind a
  stub image prefix) or the encoder-decoder (SeamlessM4T's backbone
  behind a stub audio frontend).
* :class:`HeliosConfig` — the paper's soft-training knobs (Sections IV-VI).
* :class:`TrainConfig`  — the training launch's optimizer, precision and
  microbatching.

Frozen dataclasses with the JAX package's names and defaults for the fields
the port reads, so a configuration carries over by name.  The reference's
``scan_layers`` (a ``lax.scan`` over stacked layers or an unrolled loop:
the same arithmetic) and ``TrainConfig``'s ``local_steps``,
``compress_topk`` and ``seed`` (read by nothing in either launch) are left
out: the port loops over the layers, and the train CLI takes its seed from
``--seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description; ``family`` is ``cnn``, ``dense``, ``moe``,
    ``hybrid``, ``ssm`` (xLSTM), ``vlm`` or ``encdec``.

    The LM sizes have no default in the reference; here they default to 0
    so the CNN configs need not name them."""

    name: str
    family: str
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    head_dim: int = 0                      # 0 -> d_model // num_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    activation: str = "silu"               # silu (SwiGLU) | gelu
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # ---- MoE ----
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                      # per-expert hidden size
    first_k_dense: int = 0                 # leading dense layers (DeepSeek-V2)

    # ---- MLA (DeepSeek-V2) ----
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- SSM / hybrid (Mamba2, Zamba2) ----
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0                    # hybrid: shared attn block period

    # ---- xLSTM ----
    slstm_layers: Tuple[int, ...] = ()     # indices that are sLSTM (rest mLSTM)

    # ---- enc-dec ----
    enc_layers: int = 0
    dec_layers: int = 0

    # ---- VLM ----
    num_image_tokens: int = 0              # stub frontend: precomputed patch embeds

    # ---- CNN (paper testbed) ----
    image_size: int = 0
    in_channels: int = 0
    num_classes: int = 0
    cnn_channels: Tuple[int, ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128, as the reference pads it."""
        return _round_up(self.vocab_size, 128)

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"


@dataclasses.dataclass(frozen=True)
class HeliosConfig:
    """Soft-training knobs (paper Sections IV-VI)."""

    enabled: bool = True
    p_s: float = 0.1                      # top-contribution fraction (Section VI.A)
    contribution: str = "delta"           # delta (Eq. 1) | grad_ema
    contribution_ema: float = 0.9
    # rotation regulation (Section VI.A): threshold = 1 + m / sum(p_i n_i)
    rotation_threshold_auto: bool = True
    rotation_threshold: int = 4
    # block-granular Eq. 2 selection: 0 = unit-granular (paper-exact); > 0
    # pools scores per block of this many units so the masked-matmul kernels
    # skip dead blocks structurally (match the kernels' mask block, 128)
    mask_block: int = 0
    aggregation: str = "alpha_weighted"   # alpha_weighted (Eq. 10) | masked_mean | uniform
    # volume adaptation (Section IV.C): move P toward the deadline match
    adapt_volume: bool = True
    adapt_gain: float = 0.5
    min_volume: float = 0.125


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training launch's knobs (the reference's defaults)."""

    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    microbatches: int = 1                  # gradient accumulation
