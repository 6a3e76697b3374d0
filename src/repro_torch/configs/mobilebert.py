"""MobileBERT (paper model a) — S=128, E=128, P=64, H=4, N=24, d_ff=512.

4.74 GOp/inference at S=128 (paper footnote 4).  The footnote lists the
intra-block width E=128; MobileBERT's full topology adds the 512-wide
inter-block bottleneck and 4 stacked FFNs per block — required to match
the paper's op count (≈4.9 GOp with bottleneck vs 1.9 GOp without).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mobilebert",
    family="encoder",
    n_layers=24,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab=30522,
    norm="layernorm",
    mlp="gelu",
    rope=False,
    max_seq=128,
    d_bottleneck=512,
    n_ffn=4,
)
