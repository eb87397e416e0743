# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""qwen2.5-32b [dense] — Qwen2.5 32B (GQA kv=8, QKV bias).

Assigned: 64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064
[hf:Qwen/Qwen2.5-0.5B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    activation="silu",
)
