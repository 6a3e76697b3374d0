"""seamless-m4t-large-v2 [audio] — 24L d=1024 16H (GQA kv=16) d_ff=8192
vocab=256206 — encoder-decoder, multimodal. [arXiv:2308.11596; hf]

Per the assignment, the modality frontend is a STUB: ``input_specs()``
provides precomputed frame embeddings [B, n_frames, d_model] for the
encoder; the text decoder is a standard causal stack with cross-attention.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,  # per stack
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    norm="layernorm",
    mlp="gelu",
    rope=False,
    enc_layers=24,
    dec_layers=24,
    n_frames=1024,
    max_seq=32768,
)
