# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""xlstm-125m [ssm] — sLSTM + mLSTM block stack.

Assigned: 12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304, sLSTM + mLSTM
[arXiv:2405.04517; unverified]

d_ff=0: xLSTM blocks carry their own up-projection (factor 2 for mLSTM,
4/3-style gated FFN folded into the sLSTM block); there is no separate FFN.
Block schedule: sLSTM at positions (5, 11), mLSTM elsewhere (the paper's
mostly-mLSTM ratio).  Sub-quadratic → runs long_500k (recurrent state decode).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_layers=(5, 11),
    norm="layernorm",
    activation="gelu",
    tie_embeddings=True,
)
