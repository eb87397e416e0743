# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""qwen1.5-32b [dense] — Qwen1.5 32B (QKV bias).

Assigned: 64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064
[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    activation="silu",
)
