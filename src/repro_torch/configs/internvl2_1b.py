# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""internvl2-1b [vlm] — InternViT frontend (stub) + InternLM2/Qwen2-0.5B LM.

Assigned: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655
[arXiv:2404.16821; hf]

The vision frontend is a STUB per the assignment: ``input_specs()`` provides
256 precomputed patch embeddings (448px, patch 14, pixel-unshuffle x0.5 →
1024/4 = 256 tokens) of shape (batch, 256, d_model) prepended to the text
sequence.  14 heads do not divide the 16-way model axis → attention heads
replicate while d_ff = 4864 = 16·304 tensor-shards (see parallel/sharding.py
fallback solver).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,         # padded_vocab -> 151680
    qkv_bias=True,
    num_image_tokens=256,
    activation="silu",
    tie_embeddings=True,
)
