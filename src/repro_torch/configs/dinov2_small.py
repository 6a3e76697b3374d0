"""DINOv2-Small (paper model b) — S=241, E=384, P=64, H=6, N=12, d_ff=1536.

11.7 GOp/inference at S=241 (paper footnote 5).  ViT-S encoder; patch
embeddings are the input (n_patches=241 incl. CLS).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dinov2-small",
    family="encoder",
    n_layers=12,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=0,
    norm="layernorm",
    mlp="gelu",
    rope=False,
    n_patches=241,
    max_seq=241,
)
