"""granite-moe-3b-a800m [moe] — 32L d=1536 24H (GQA kv=8) d_ff=512 vocab=49155,
MoE 40 experts top-8, no shared experts. [hf:ibm-granite/granite-3.0-…; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    norm="rmsnorm",
    mlp="swiglu",
    rope=True,
    n_experts=40,
    top_k=8,
    n_shared_experts=0,
    d_ff_expert=512,
    max_seq=32768,
)
