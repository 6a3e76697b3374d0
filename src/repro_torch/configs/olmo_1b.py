"""olmo-1b [dense] — 16L d=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (OLMo's distinguishing choice: the LN runs on the
fallback "cluster" path with no affine weights). [arXiv:2402.00838; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab=50304,
    qkv_bias=False,
    norm="np_layernorm",
    mlp="swiglu",
    rope=True,
    tie_embeddings=True,
    max_seq=32768,
)
