# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""deepseek-v2-236b [moe] — DeepSeek-V2 with Multi-head Latent Attention.

Assigned: 60L d_model=5120 128H (GQA kv=128) d_ff=1536 vocab=102400,
MoE 160e top-6 — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf]

MLA dims follow the published config: q_lora_rank=1536, kv_lora_rank=512,
qk_nope/rope head dims 128/64, v_head_dim=128.  The first layer is dense
(first_k_dense_replace=1, d_ff=12288) as in the release.  The MLA latent
bottleneck is NOT a Helios-maskable unit (shared across heads) — heads and
routed experts are masked instead, as in the reference.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # notional under MLA (latent cache is shared)
    d_ff=12288,                # dense first layer FFN
    moe_d_ff=1536,             # per routed/shared expert
    num_experts=160,
    num_experts_per_tok=6,
    num_shared_experts=2,
    first_k_dense=1,
    vocab_size=102400,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    activation="silu",
)
