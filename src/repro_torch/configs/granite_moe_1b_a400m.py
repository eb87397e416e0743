# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""granite-moe-1b-a400m [moe] — IBM Granite 3.0 1B-A400M base.

Assigned: 24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

d_ff=512 is the PER-EXPERT hidden size (32 experts, top-8 routing).
Expert-level soft-training (rotating which experts train) is the natural
Helios unit here.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    moe_d_ff=512,
    num_experts=32,
    num_experts_per_tok=8,
    num_shared_experts=0,
    vocab_size=49155,          # padded_vocab -> 49280
    activation="silu",
    tie_embeddings=True,
)
