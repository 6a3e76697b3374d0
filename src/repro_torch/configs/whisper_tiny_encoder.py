"""Whisper-Tiny encoder (paper model c) — S=512, E=384, P=64, H=6, N=4, d_ff=1536.

9.74 GOp/inference at S=512 (paper footnote 6).  Audio frontend is a stub
(frame embeddings in); encoder-only.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny-encoder",
    family="encoder",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=0,
    norm="layernorm",
    mlp="gelu",
    rope=False,
    n_frames=512,
    max_seq=512,
)
