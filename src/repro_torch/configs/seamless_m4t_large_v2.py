# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""seamless-m4t-large-v2 [audio] — encoder-decoder multimodal backbone.

Assigned: 24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206
[arXiv:2308.11596; hf]

The modality frontend (w2v-BERT speech encoder feature extractor) is a stub,
as in the reference: the batch carries precomputed frame embeddings
``enc_embeds`` of shape (batch, enc_len, d_model).  "24L" is realized as 24
encoder + 24 decoder layers (the published text-to-text backbone of
M4T-large uses 24/24), as the reference does.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=48,            # 24 enc + 24 dec
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,        # padded_vocab -> 256256 for clean 16-way sharding
    norm="layernorm",
    activation="gelu",        # NLLB/M4T uses ReLU/GELU-family FFN, not gated
    qkv_bias=True,
    tie_embeddings=True,
)
