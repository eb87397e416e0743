# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.

Assigned: 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]

38 Mamba2 layers; ONE shared transformer block (32-head attention + d_ff=8192
MLP, weights shared across invocations) applied every 6 Mamba2 layers, as in
the Zamba2 design.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    attn_every=6,
    activation="silu",
)
