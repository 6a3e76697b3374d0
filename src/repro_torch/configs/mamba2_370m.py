"""mamba2-370m [ssm] — 48L d=1024 (attn-free) vocab=50280, ssm_state=128.

SSD (state-space duality) blocks. [arXiv:2405.21060; unverified]
The paper's attention technique is inapplicable (attention-free); int8
GEMM projections + integer activations still apply (DESIGN.md
§Arch-applicability).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    norm="rmsnorm",
    rope=False,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    max_seq=524288,
)
