"""qwen2-moe-a2.7b [moe] — 24L d=2048 16H (GQA kv=16) d_ff=1408 vocab=151936,
MoE 60 routed experts top-4 + 4 shared. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=151936,
    norm="rmsnorm",
    mlp="swiglu",
    rope=True,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_ff_expert=1408,
    max_seq=32768,
)
