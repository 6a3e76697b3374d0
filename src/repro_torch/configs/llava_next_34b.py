"""llava-next-34b [vlm] — 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Anyres tiling frontend is a STUB: ``input_specs()`` provides precomputed
patch embeddings [B, n_patches, d_model] prepended to the token sequence.
[hf:llava-hf/llava-v1.6-…; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    norm="rmsnorm",
    mlp="swiglu",
    rope=True,
    rope_theta=5e6,
    n_patches=576,
    max_seq=32768,
)
