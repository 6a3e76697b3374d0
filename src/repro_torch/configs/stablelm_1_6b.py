"""stablelm-1.6b [dense] — 24L d=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.

LayerNorm + SwiGLU (StableLM-2 1.6B uses partial rotary; we apply full
rotary — noted deviation, irrelevant to systems behaviour).
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab=100352,
    qkv_bias=False,
    norm="layernorm",
    mlp="swiglu",
    rope=True,
    max_seq=32768,
)
