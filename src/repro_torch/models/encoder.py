"""Encoder-only models — the paper's three workloads, float and integer paths (torch port).

MobileBERT (tokens), DINOv2-S (patch embeddings) and the Whisper-tiny
encoder (frame embeddings).  ``forward`` / ``loss_fn`` are the float
model (optionally with QAT fake-quant), which PTQ calibrates
(``quant.ptq``).  ``forward_w8a8`` runs either backend, on
the card or on the CPU: ``"w8a8"`` is the plain integer arithmetic with
rowwise ITAMax (exact integer products, ``quant.qparams.imatmul``, and
the ``itamax`` kernel on the card), ``"ita"`` sends the GEMMs through the
``int8_gemm`` kernel and attention through the ``ita_attention`` kernel
(flash-ITAMax, 128-row KV blocks).  With ``cfg.ita_head_by_head`` the
layer runs the paper's schedule instead, on either backend: rowwise
attention one head at a time and each head's int32 partial of the output
projection, summed and requantized once.

Parameters are plain dicts; ``params["layers"]`` is a list with one dict
per layer.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import ilayernorm as iln
from repro_torch.core.attention import (  # noqa: F401  (attention_f32: the reference's name)
    MhaQParams,
    attention_f32,
    attention_rowwise_i8,
)
from repro_torch.core.quant_linear import ACT_GELU
from repro_torch.kernels.int8_gemm import int8_gemm
from repro_torch.kernels.ita_attention import ita_attention
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_fwd
from repro_torch.quant.qparams import i32, imatmul, make_qparams, requantize
from repro_torch.runtime.activations import constrain

_S_GAMMA = 1.0 / 64.0

#: sequence / KV block granule of the attention kernel path
ATTN_GRANULE = 128


def _split_heads(qkv: torch.Tensor, cfg: ArchConfig):
    b, s, _ = qkv.shape
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = torch.split(qkv, [h * d, hkv * d, hkv * d], dim=-1)
    q = q.reshape(b, s, h, d).permute(0, 2, 1, 3)
    k = k.reshape(b, s, hkv, d).permute(0, 2, 1, 3)
    v = v.reshape(b, s, hkv, d).permute(0, 2, 1, 3)
    return q, k, v


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Random float params from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    qkv_dim = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim

    def init_layer():
        return {
            "norm1": L.init_norm(cfg.norm, cfg.d_model, dtype, device),
            "attn": {
                "wqkv": L.init_linear(gen, cfg.d_model, qkv_dim, True, dtype, device),
                "wo": L.init_linear(gen, cfg.n_heads * cfg.head_dim, cfg.d_model, True,
                                    dtype, device),
            },
            "norm2": L.init_norm(cfg.norm, cfg.d_model, dtype, device),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
        }

    params = {
        "layers": [init_layer() for _ in range(cfg.n_layers)],
        "pos": (torch.randn((cfg.max_seq, cfg.d_model), generator=gen, dtype=dtype) * 0.02
                ).to(device),
        "final_norm": L.init_norm(cfg.norm, cfg.d_model, dtype, device),
    }
    if cfg.vocab:
        table = torch.randn((cfg.vocab, cfg.d_model), generator=gen, dtype=dtype) * 0.02
        params["embed"] = {"table": table.to(device)}
    return params


def embed(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    if "tokens" in batch and cfg.vocab:
        x = L.embed_lookup(params["embed"]["table"], batch["tokens"])
    elif "patches" in batch:
        x = batch["patches"]
    else:
        x = batch["frames"]
    return x + params["pos"][: x.shape[1]].to(x.dtype)


def forward(cfg: ArchConfig, params: dict, batch: dict, *, qat: bool = False,
            remat: bool = False) -> torch.Tensor:
    """Float forward: MLM logits [B, S, vocab] (tokens) or hidden states
    [B, S, D].  ``remat`` recomputes each layer's activations in the
    backward pass (the JAX package's encoder refuses the keyword, so its
    training step fails at its default ``remat=True``)."""
    x = embed(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, lp):
        return layer_fwd(cfg, lp, x, positions, qat=qat, causal=False)[0]

    for lp in params["layers"]:
        x = checkpoint(body, x, lp, use_reentrant=False) if remat else body(x, lp)
    x = constrain(L.norm_apply(cfg.norm, params["final_norm"], x), "gathered")
    if cfg.vocab and "tokens" in batch:
        return L.matmul(x, params["embed"]["table"].T)  # tied MLM head
    return x


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, **kw) -> torch.Tensor:
    """MLM cross-entropy (tokens), else the mean squared error against
    ``batch["targets"]`` (0 when absent) for patch / frame encoders."""
    out = forward(cfg, params, batch, **kw)
    if cfg.vocab and "tokens" in batch:
        logp = torch.log_softmax(out.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
        return nll.mean()
    return torch.mean((out - batch.get("targets", 0.0)) ** 2)


def _q_i8(x: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_params(cfg: ArchConfig, params: dict, q: L.QuantConfig = L.QuantConfig()) -> dict:
    """Float params -> int8 weights, int32 biases (per-tensor default scales)."""

    def quant_linear(p, s_in):
        out = {"w_q": _q_i8(p["w"], q.s_w)}
        if "b" in p:
            out["b_q"] = torch.round(p["b"] / (s_in * q.s_w)).to(torch.int32)
        return out

    def quant_norm(p):
        if not p:
            return {}
        out = {"g_q": _q_i8(p["g"], _S_GAMMA)}
        if "b" in p:
            out["beta_q"] = torch.round(p["b"] / (iln.NORM_SCALE * _S_GAMMA)).to(torch.int32)
        return out

    def quant_layer(lp):
        return {
            "norm1": quant_norm(lp["norm1"]),
            "attn": {
                "wqkv": quant_linear(lp["attn"]["wqkv"], q.s_act),
                "wo": quant_linear(lp["attn"]["wo"], q.s_act),
            },
            "norm2": quant_norm(lp["norm2"]),
            "mlp": {k: quant_linear(v, q.s_act) for k, v in lp["mlp"].items()},
        }

    qp = {
        "layers": [quant_layer(lp) for lp in params["layers"]],
        "pos_q": _q_i8(params["pos"], q.s_res),
        "final_norm": quant_norm(params["final_norm"]),
    }
    if cfg.vocab:
        qp["embed"] = {"table_q": _q_i8(params["embed"]["table"], q.s_res)}
    return qp


# ---------------------------------------------------------------------------
# Integer forward
# ---------------------------------------------------------------------------


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    zeros = torch.zeros((*x.shape[:2], pad, x.shape[3]), dtype=x.dtype, device=x.device)
    return torch.cat([x, zeros], dim=2)


def attention_ita(qh, kh, vh, s_act: float, s_out: float) -> torch.Tensor:
    """The attention kernel over 128-row KV blocks: the sequence is padded
    to the block and the padded KV tail masked with ``kv_valid`` (the plan's
    MHA runner calls this too)."""
    sq = qh.shape[2]
    pad = (-sq) % ATTN_GRANULE
    if pad:
        qh, kh, vh = _pad_seq(qh, pad), _pad_seq(kh, pad), _pad_seq(vh, pad)
    out = ita_attention(
        qh, kh, vh, s_q=s_act, s_k=s_act, s_v=s_act, s_out=s_out,
        block_k=ATTN_GRANULE, kv_valid=sq if pad else None,
    )
    return out[:, :, :sq] if pad else out


def _attention_i8(cfg, qh, kh, vh, p: MhaQParams, backend: str, s_act: float):
    """``ita``: the attention kernel; ``w8a8``: rowwise attention, whose
    softmax is the ``itamax`` kernel on the card."""
    if backend == "ita":
        return attention_ita(qh, kh, vh, s_act, s_act)
    return attention_rowwise_i8(qh, kh, vh, p)


def _linear(pq: dict, x_q: torch.Tensor, site: L.QLinearSite, backend: str) -> torch.Tensor:
    """``ita``: the ``int8_gemm`` kernel; ``w8a8``: the plain quantized
    linear, an exact integer product on any device."""
    if backend == "ita":
        return int8_gemm(x_q, pq["w_q"], pq.get("b_q"), s_in=site.s_in, s_w=site.s_w,
                         s_out=site.s_out, act=site.act, s_preact=site.s_preact)
    return L.qlinear(pq, x_q, site)


def _head_by_head(cfg: ArchConfig, wo: dict, qh, kh, vh, p_mha: MhaQParams,
                  q: L.QuantConfig) -> torch.Tensor:
    """The paper's ITA schedule: single-head rowwise attention (on every
    backend, as the reference) and a per-head partial output projection,
    accumulated in int32 on the cluster; one requant, then the bias,
    requantized on its own and added after it."""
    hd = cfg.head_dim
    group = cfg.n_heads // cfg.n_kv_heads
    w = wo["w_q"]  # [H*hd, D]
    acc = None
    for head in range(cfg.n_heads):
        kvh = head // group
        a1 = attention_rowwise_i8(qh[:, head: head + 1], kh[:, kvh: kvh + 1],
                                  vh[:, kvh: kvh + 1], p_mha)  # int8 [B, 1, S, hd]
        part = imatmul(a1[:, 0], w[head * hd: (head + 1) * hd])
        acc = part if acc is None else acc + part
    qp_o = make_qparams(q.s_act, q.s_w, q.s_act)
    out = requantize(acc, qp_o.mult, qp_o.shift)
    if "b_q" in wo:
        qb = make_qparams(q.s_act, 1.0, q.s_act)
        out = requantize(i32(out) + i32(requantize(wo["b_q"], qp_o.mult, qp_o.shift)),
                         qb.mult, qb.shift)
    return out


def qlayer_fwd_encoder(
    cfg: ArchConfig,
    lp: dict,
    x_q: torch.Tensor,
    q: L.QuantConfig,
    backend: str = "w8a8",
) -> torch.Tensor:
    """One integer encoder layer (bidirectional).

    On the ``ita`` backend every GEMM — the QKV and O projections too,
    which the JAX package's model path leaves to XLA — goes through the
    ``int8_gemm`` kernel: ``qlinear_i8`` and the kernel are the same
    function, so the ints are unchanged and the layer runs on the card.
    The head-by-head schedule's per-head partials are exact integer
    products on either backend.
    """
    st = L.QLinearSite(q.s_act, q.s_w, q.s_act)
    p_mha = MhaQParams.make(q.s_act, q.s_act, q.s_act, q.s_act, cfg.head_dim)
    res = L.make_iadd_params(q.s_res, q.s_act, q.s_res)

    h_q = L.norm_apply_i8(cfg.norm, lp["norm1"], x_q, _S_GAMMA, q.s_act)
    qkv = _linear(lp["attn"]["wqkv"], h_q, st, backend)
    qh, kh, vh = _split_heads(qkv, cfg)
    if cfg.ita_head_by_head:
        out = _head_by_head(cfg, lp["attn"]["wo"], qh, kh, vh, p_mha, q)
    else:
        a = _attention_i8(cfg, qh, kh, vh, p_mha, backend, q.s_act)
        out = _linear(lp["attn"]["wo"], _merge_heads(a), st, backend)
    x_q = L.iadd_i8(x_q, out, *res)

    h_q = L.norm_apply_i8(cfg.norm, lp["norm2"], x_q, _S_GAMMA, q.s_act)
    up = L.QLinearSite(q.s_act, q.s_w, q.s_act, act=ACT_GELU, s_preact=q.s_act)
    pre = _linear(lp["mlp"]["up"], h_q, up, backend)
    m = _linear(lp["mlp"]["down"], pre, st, backend)
    return L.iadd_i8(x_q, m, *res)


def embed_i8(cfg: ArchConfig, qp: dict, batch: dict) -> torch.Tensor:
    if "tokens" in batch and cfg.vocab:
        return qp["embed"]["table_q"][batch["tokens"].long()]
    if "patches" in batch:
        return batch["patches"].to(torch.int8)
    return batch["frames"].to(torch.int8)


def forward_w8a8(
    cfg: ArchConfig,
    qp: dict,
    batch: dict,
    q: L.QuantConfig = L.QuantConfig(),
    backend: str = "w8a8",
) -> torch.Tensor:
    """Integer forward: MLM logits (tokens) or dequantized features, float32."""
    x_q = embed_i8(cfg, qp, batch)
    s = x_q.shape[1]
    add = L.make_iadd_params(q.s_res, q.s_res, q.s_res)
    x_q = L.iadd_i8(x_q, qp["pos_q"][None, :s], *add)
    for lp in qp["layers"]:
        x_q = qlayer_fwd_encoder(cfg, lp, x_q, q, backend)
    h_q = L.norm_apply_i8(cfg.norm, qp["final_norm"], x_q, _S_GAMMA, q.s_act)
    if cfg.vocab and "tokens" in batch:
        return L.classifier_f32(h_q, qp["embed"]["table_q"], q.s_act * q.s_res)
    return h_q.to(torch.float32) * q.s_act
