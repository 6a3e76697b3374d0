"""zamba2-2.7b [hybrid] — 54L d=2560 32H (GQA kv=32) d_ff=10240 vocab=32000,
ssm_state=64. Mamba2 backbone + shared attention blocks. [arXiv:2411.15242; hf]

Zamba2 applies a *shared* (weight-tied) attention+MLP block periodically
over the Mamba2 trunk; we tie one attention block reused every
``attn_every`` layers (6), matching the paper's shared-block topology.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    norm="rmsnorm",
    mlp="gelu",
    rope=True,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    attn_every=6,
    max_seq=524288,
)
