"""Architecture configuration schema + input-shape cells.

One ``ArchConfig`` per assigned architecture (exact values from the
assignment table) plus the paper's own three encoder models.  ``reduced()``
derives the CPU smoke-test variant of any config (same family/topology,
tiny dims).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm | encoder

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # dense-transformer options
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm | np_layernorm
    mlp: str = "swiglu"  # swiglu | gelu
    rope: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0  # hybrid: one shared attention block every N layers

    # encoder-decoder
    enc_layers: int = 0
    dec_layers: int = 0

    # VLM / frontend stubs
    n_patches: int = 0  # vlm: patch embeddings prepended to the sequence
    n_frames: int = 0  # audio: frame embeddings into the encoder

    # MobileBERT-style bottleneck encoders
    d_bottleneck: int = 0  # outer (inter-block) width; 0 = no bottleneck
    n_ffn: int = 1  # stacked FFN count per block

    max_seq: int = 8192

    # paper-mode knobs
    ita_head_by_head: bool = False  # reproduce ITA's per-head MHA schedule

    @property
    def vocab_padded(self) -> int:
        """Embedding/LM-head allocation size: vocab padded to 256 so the
        vocab dim divides the model axis (Megatron-style padding; padded
        logits are masked in the loss)."""
        return ((self.vocab + 255) // 256) * 256 if self.vocab else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic state: long_500k runs only for these."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return self.family != "encoder"

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32,
        d_ff=256,
        vocab=512,
        max_seq=128,
    )
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, n_shared_experts=min(cfg.n_shared_experts, 1),
                  d_ff_expert=64)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.family == "hybrid":
        kw.update(attn_every=2)
    if cfg.family == "encdec":
        kw.update(enc_layers=2, dec_layers=2)
    if cfg.family == "vlm":
        kw.update(n_patches=16)
    if cfg.n_frames:
        kw.update(n_frames=16)
    return cfg.replace(**kw)


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) column of the assignment: seq_len x global_batch."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeCell("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_applicable(cfg: ArchConfig, cell: ShapeCell) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) — the long_500k rule from the assignment."""
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (skip per assignment)"
        )
    if cell.kind == "decode" and not cfg.has_decoder:
        return False, f"{cfg.name} is encoder-only: no decode step"
    return True, ""
