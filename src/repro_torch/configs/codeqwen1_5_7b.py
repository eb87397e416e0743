# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""codeqwen1.5-7b [dense] — CodeQwen1.5 7B (qwen1.5 architecture).

Assigned: 32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    activation="silu",
)
