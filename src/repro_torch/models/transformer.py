"""Dense decoder-only transformer LM (GQA), float and integer (w8a8) paths — torch port.

The float half (``forward`` / ``loss_fn`` with optional QAT fake-quant,
``prefill`` / ``decode_step`` over a float KV cache) is the accuracy
reference and the calibration model.  The integer half: int8 embedding
table, integer norms, int8 QKV/O/MLP products, flash attention with
streaming ITAMax, integer RoPE, SiLU and residual adds, and float logits
only at the LM head.  Every integer function here runs the plain integer
arithmetic (exact integer products on any device,
``quant.qparams.imatmul``); the deploy flow's plans equal it on both
backends.

Covers the dense decoders (OLMo-1B, StableLM-1.6B, Qwen1.5-110B,
Mistral-Large-123B), the mixture-of-experts decoders (their MLP is
``models.moe``) and the llava-next-34b backbone (``family == "vlm"``:
precomputed patch embeddings, int8 on the integer path, are prepended to
the tokens' embeddings).

Parameters are plain dicts; ``params["layers"]`` is a list with one dict
per layer (the JAX package stacks them and scans).  A KV cache is
``{"k": [L, B, Hkv, max_len, D], "v": ..., "len": int32}`` (int8 on the
integer path, float on the float one), with ``len`` a host (CPU) tensor:
RoPE angles and cache rows are chosen on the host.  The functions here are
pure: a decode step returns a new cache and leaves its argument as it was.
The float path calls ``runtime.activations.constrain`` where the JAX
package does: it returns its argument outside an ``activation_policy``,
and under one (``launch.train.shard_train_fn``'s mesh) redistributes the
DTensor activations as the reference constrains its arrays.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import ilayernorm as iln
from repro_torch.core.attention import (
    MhaQParams,
    attention_f32,
    attention_f32_chunked,
    attention_flash_i8,
)
from repro_torch.core.itamax import ITAMAX_LOGIT_SCALE
from repro_torch.core.quant_linear import ACT_IDENTITY  # noqa: F401  (the reference's name)
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.quant.fake_quant import fake_quant_weight
from repro_torch.quant.qparams import i32, imatmul, make_qparams, requantize
from repro_torch.runtime import activations as A
from repro_torch.runtime.activations import constrain

try:
    from torch.distributed.tensor import DTensor
except ImportError:  # a torch built without distributed support
    DTensor = ()

_S_GAMMA = 1.0 / 64.0  # shape-only norm gain grid (g_q=64 -> gamma=1.0)


def _qkv_dims(cfg: ArchConfig) -> int:
    return (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_layer(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32, device=None) -> dict:
    if cfg.n_experts:
        mlp = moe_mod.init_moe_layer(cfg, gen, dtype, device)
    else:
        mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device, kind=cfg.mlp)
    return {
        "norm1": L.init_norm(cfg.norm, cfg.d_model, dtype, device),
        "attn": {
            "wqkv": L.init_linear(gen, cfg.d_model, _qkv_dims(cfg), cfg.qkv_bias, dtype,
                                  device),
            "wo": L.init_linear(gen, cfg.n_heads * cfg.head_dim, cfg.d_model, False, dtype,
                                device),
        },
        "norm2": L.init_norm(cfg.norm, cfg.d_model, dtype, device),
        "mlp": mlp,
    }


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Random float params from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    layers = [init_layer(cfg, gen, dtype, device) for _ in range(cfg.n_layers)]
    table = torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen, dtype=dtype) * 0.02
    params = {
        "embed": {"table": table.to(device)},
        "layers": layers,
        "final_norm": L.init_norm(cfg.norm, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab_padded, False, dtype,
                                          device)
    return params


# ---------------------------------------------------------------------------
# Float forward / prefill / decode
# ---------------------------------------------------------------------------


def _split_heads(qkv: torch.Tensor, cfg: ArchConfig):
    if isinstance(qkv, DTensor):
        return _heads_local(qkv, lambda t: _split_heads(t, cfg), 3)
    b, s, _ = qkv.shape
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = torch.split(qkv, [h * d, hkv * d, hkv * d], dim=-1)
    q = q.reshape(b, s, h, d).permute(0, 2, 1, 3)
    k = k.reshape(b, s, hkv, d).permute(0, 2, 1, 3)
    v = v.reshape(b, s, hkv, d).permute(0, 2, 1, 3)
    return q, k, v


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    if isinstance(x, DTensor):
        return _heads_local(x, _merge_heads, 1)
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


def _heads_local(x, fn, n_out: int):
    """``fn`` (a split into or a merge of heads) on each rank's batch rows:
    DTensor's views of permuted tensors lose their layout in the backward
    (a gradient whose strides say one layout and whose local tensor has
    another), so no permuted DTensor is made.  Heads and features are
    whole on each rank; the constraints place them after."""
    from repro_torch.runtime.sharding import P, data_axes

    mesh = A.active_mesh() or x.device_mesh
    da = data_axes(mesh)
    b_ax = da if A.fits(x.shape[0], da, mesh) else None
    spec = P(b_ax, *([None] * (x.dim() - 1)))
    out_dim = 4 if x.dim() == 3 else 3
    out = P(b_ax, *([None] * (out_dim - 1)))
    return A.local_shards(fn, (x,), (spec,), [out] * n_out if n_out > 1 else out, mesh=mesh)


_CHUNKED_ATTN_MIN_SEQ = 2048  # float path: Q-blocked attention from here on


def _rope(cfg: ArchConfig, q, k, positions):
    if not cfg.rope:
        return q, k
    cos, sin = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, q.dtype, q.device)
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)


def attn_block(cfg: ArchConfig, lp: dict, x: torch.Tensor, positions, *, qat: bool = False,
               causal: bool = True) -> torch.Tensor:
    """Pre-norm attention with its residual.  ``qat`` puts the projections
    on the int8 weight grid (STE) and clips the logits to the ITAMax range."""
    h = L.norm_apply(cfg.norm, lp["norm1"], x)
    h = constrain(h, "gathered")  # Megatron-SP boundary: keep TP weights sharded
    wqkv, wo = lp["attn"]["wqkv"], lp["attn"]["wo"]
    if qat:
        wqkv = {**wqkv, "w": fake_quant_weight(wqkv["w"])}
        wo = {**wo, "w": fake_quant_weight(wo["w"])}
    q, k, v = _split_heads(L.linear(wqkv, h), cfg)
    q = constrain(q, "heads")  # attention internals are head-parallel
    q, k = _rope(cfg, q, k, positions)
    clip = 127 * ITAMAX_LOGIT_SCALE if qat else None
    if q.shape[2] >= _CHUNKED_ATTN_MIN_SEQ:
        out = attention_f32_chunked(q, k, v, causal=causal, logit_clip=clip)
    else:
        out = attention_f32(q, k, v, causal=causal, logit_clip=clip)
    out = constrain(out, "heads")
    # the sublayer's output on the residual's placements before the add: its
    # gradient then reaches the product gathered, which any DTensor views
    return x + constrain(L.linear(wo, _merge_heads(out)), "residual")


def mlp_block(cfg: ArchConfig, lp: dict, x: torch.Tensor):
    """Returns (x, aux_loss): aux is the MoE load-balance term (0 if dense)."""
    h = L.norm_apply(cfg.norm, lp["norm2"], x)
    h = constrain(h, "gathered")
    if cfg.n_experts:
        out, aux = moe_mod.moe_ffn(cfg, lp["mlp"], h)
        return x + constrain(out, "residual"), aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + constrain(L.mlp_forward(lp["mlp"], h, cfg.mlp), "residual"), aux


def layer_fwd(cfg: ArchConfig, lp: dict, x: torch.Tensor, positions, *, qat: bool = False,
              causal: bool = True):
    x = attn_block(cfg, lp, x, positions, qat=qat, causal=causal)
    return mlp_block(cfg, lp, x)


def embed_input(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    x = L.embed_lookup(params["embed"]["table"], batch["tokens"])
    if cfg.family == "vlm" and "patches" in batch:
        # anyres stub: precomputed patch embeddings prepended to the text
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def lm_head(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.norm_apply(cfg.norm, params["final_norm"], x)
    # gather the sequence before the vocab-parallel product, which runs on
    # each rank's rows (layers.head_logits)
    x = constrain(x, "gathered")
    if cfg.tie_embeddings:
        return L.head_logits(x, params["embed"]["table"], tied=True)
    return L.head_logits(x, params["lm_head"]["w"])


def forward(cfg: ArchConfig, params: dict, batch: dict, *, qat: bool = False,
            return_aux: bool = False, remat: bool = False):
    """Causal LM forward: logits [B, S (+ patches), vocab_padded] (and the
    MoE aux, summed over the layers).
    ``remat`` recomputes each layer's activations in the backward pass."""
    x = embed_input(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, lp):
        x = constrain(x, "residual")
        x, a = layer_fwd(cfg, lp, x, positions, qat=qat)
        return constrain(x, "residual"), a

    for lp in params["layers"]:
        if remat:
            x, a = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x, a = body(x, lp)
        aux = aux + a
    logits = lm_head(cfg, params, x)
    return (logits, aux) if return_aux else logits


MOE_AUX_WEIGHT = 0.01


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *, qat: bool = False,
            remat: bool = False) -> torch.Tensor:
    logits, aux = forward(cfg, params, batch, qat=qat, return_aux=True, remat=remat)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # vlm: drop the patch positions
        logits = logits[:, -labels.shape[1]:]
    return L.token_nll(logits, labels, cfg.vocab) + MOE_AUX_WEIGHT * aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.float32,
               device=None) -> dict:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.tensor(0, dtype=torch.int32),
    }


def prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int):
    """Float prefill: the causal forward of the prompt plus cache capture.
    Returns the last-token logits [B, 1, vocab_padded] and the cache."""
    x = embed_input(cfg, params, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, x.dtype, x.device)
    for l, lp in enumerate(params["layers"]):
        h = L.norm_apply(cfg.norm, lp["norm1"], x)
        q, k, v = _split_heads(L.linear(lp["attn"]["wqkv"], h), cfg)
        q, k = _rope(cfg, q, k, positions)
        cache["k"][l, :, :, :s] = k
        cache["v"][l, :, :, :s] = v
        out = attention_f32(q, k, v, causal=True)
        x = x + L.linear(lp["attn"]["wo"], _merge_heads(out))
        x, _ = mlp_block(cfg, lp, x)
    cache["len"] = torch.tensor(s, dtype=torch.int32)
    return lm_head(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor):
    """One-token float decode (every request at depth ``cache["len"]``).
    token [B, 1] int.  Returns the logits [B, 1, vocab_padded] and a new
    cache."""
    x = L.embed_lookup(params["embed"]["table"], token)
    pos = int(cache["len"])
    smax = cache["k"].shape[3]
    mask = (torch.arange(smax, device=x.device) <= pos)[None, None, None, :]
    new_k, new_v = cache["k"].clone(), cache["v"].clone()
    for l, lp in enumerate(params["layers"]):
        h = L.norm_apply(cfg.norm, lp["norm1"], x)
        q, k, v = _split_heads(L.linear(lp["attn"]["wqkv"], h), cfg)
        q, k = _rope(cfg, q, k, [pos])
        new_k[l, :, :, pos:pos + 1] = k
        new_v[l, :, :, pos:pos + 1] = v
        out = attention_f32(q, new_k[l], new_v[l], mask=mask)
        x = x + L.linear(lp["attn"]["wo"], _merge_heads(out))
        x, _ = mlp_block(cfg, lp, x)
    new_cache = {"k": new_k, "v": new_v, "len": torch.tensor(pos + 1, dtype=torch.int32)}
    return lm_head(cfg, params, x), new_cache


# ---------------------------------------------------------------------------
# Integer parameters
# ---------------------------------------------------------------------------


def _qnorm(cfg: ArchConfig, device=None) -> dict:
    if cfg.norm == "np_layernorm":
        return {}
    p = {"g_q": torch.full((cfg.d_model,), 64, dtype=torch.int8, device=device)}
    if cfg.norm == "layernorm":
        p["beta_q"] = torch.zeros((cfg.d_model,), dtype=torch.int32, device=device)
    return p


def init_qlayer(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Shape-only integer layer (random int8 weights, drawn on ``gen``'s
    device)."""
    d, f = cfg.d_model, cfg.d_ff
    lp = {
        "norm1": _qnorm(cfg, gen.device),
        "attn": {
            "wqkv": L.init_qlinear(gen, d, _qkv_dims(cfg), cfg.qkv_bias),
            "wo": L.init_qlinear(gen, cfg.n_heads * cfg.head_dim, d, False),
        },
        "norm2": _qnorm(cfg, gen.device),
    }
    if cfg.n_experts:
        lp["mlp"] = moe_mod.init_qmoe_layer(cfg, gen)
    elif cfg.mlp == "swiglu":
        lp["mlp"] = {"gate": L.init_qlinear(gen, d, f, False),
                     "up": L.init_qlinear(gen, d, f, False),
                     "down": L.init_qlinear(gen, f, d, False)}
    else:
        lp["mlp"] = {"up": L.init_qlinear(gen, d, f, True),
                     "down": L.init_qlinear(gen, f, d, True)}
    return lp


def init_qparams(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Shape-only integer model (random int8 weights from ``seed``), drawn
    on ``device`` (the CPU by default) by a generator there."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    qp = {
        "layers": [init_qlayer(cfg, gen) for _ in range(cfg.n_layers)],
        "embed": {"table_q": torch.randint(-127, 128, (cfg.vocab_padded, cfg.d_model),
                                           generator=gen, dtype=torch.int8,
                                           device=gen.device)},
        "final_norm": _qnorm(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        qp["lm_head"] = L.init_qlinear(gen, cfg.d_model, cfg.vocab_padded, False)
    return qp


def _q_i8(x: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_params(cfg: ArchConfig, params: dict, q: L.QuantConfig = L.QuantConfig()) -> dict:
    """Per-tensor symmetric weight quantization onto the static ``q.s_w``
    grid (the JAX package's ``quantize_params``, layer by layer)."""

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
        "embed": {"table_q": _q_i8(params["embed"]["table"], q.s_res)},
        "layers": [quant_layer(lp) for lp in params["layers"]],
        "final_norm": quant_norm(params["final_norm"]),
    }
    if not cfg.tie_embeddings:
        qp["lm_head"] = quant_linear(params["lm_head"], q.s_act)
    return qp


# ---------------------------------------------------------------------------
# Integer forward
# ---------------------------------------------------------------------------


def _sites(cfg: ArchConfig, q: L.QuantConfig) -> dict:
    """Static quantized-site table shared by all layers."""
    a, r, w = q.s_act, q.s_res, q.s_w
    mk = L.QLinearSite
    return {
        "wqkv": mk(a, w, a),
        "wo": mk(a, w, a),
        "gate": mk(a, w, a),
        "up": mk(a, w, a),
        "down": mk(a, w, a),
        "mha": MhaQParams.make_flash(a, a, a, a, max(cfg.head_dim, 1)),
        "res_attn": L.make_iadd_params(r, a, r),
        "res_mlp": L.make_iadd_params(r, a, r),
        "silu_prod": make_qparams(a, a, a),
    }


def qlayer_fwd(
    cfg: ArchConfig,
    lp: dict,
    x_q: torch.Tensor,
    positions,
    q: L.QuantConfig,
    *,
    causal: bool = True,
    kv_override=None,
    kv_len=None,
    block_k: int = 512,
) -> torch.Tensor:
    """One integer transformer layer. x_q int8 [B, S, D] on the s_res grid.

    ``kv_override`` may swap in larger K/V tensors (the decode path returns
    the full KV cache); ``kv_len`` then masks the unwritten tail inside the
    flash attention.  Prefill and single-token decode both run this
    function.  ``positions`` are host data (see ``layers.rope_tables_i8``).
    """
    st = _sites(cfg, q)
    h_q = L.norm_apply_i8(cfg.norm, lp["norm1"], x_q, _S_GAMMA, q.s_act)
    qkv = L.qlinear(lp["attn"]["wqkv"], h_q, st["wqkv"])
    qh, kh, vh = _split_heads(qkv, cfg)
    if cfg.rope:
        c_q, s_q = L.rope_tables_i8(positions, cfg.head_dim, cfg.rope_theta, x_q.device)
        qh = L.apply_rope_i8(qh, c_q, s_q)
        kh = L.apply_rope_i8(kh, c_q, s_q)
    if kv_override is not None:
        kh, vh = kv_override(kh, vh)
    bk = min(block_k, kh.shape[2])
    out = attention_flash_i8(qh, kh, vh, st["mha"], causal=causal, block_k=bk, kv_len=kv_len)
    out = L.qlinear(lp["attn"]["wo"], _merge_heads(out), st["wo"])
    x_q = L.iadd_i8(x_q, out, *st["res_attn"])

    h_q = L.norm_apply_i8(cfg.norm, lp["norm2"], x_q, _S_GAMMA, q.s_act)
    if cfg.n_experts:
        m = moe_mod.moe_ffn_w8a8(cfg, lp["mlp"], h_q, q)
    elif cfg.mlp == "swiglu":
        g = L.qlinear(lp["mlp"]["gate"], h_q, st["gate"])
        u = L.qlinear(lp["mlp"]["up"], h_q, st["up"])
        sg = L.isilu_i8(g, q.s_act, q.s_act)
        pq = st["silu_prod"]  # prod scale s_act * s_act -> back to the s_act grid
        m = L.qlinear(lp["mlp"]["down"], requantize(i32(sg) * i32(u), pq.mult, pq.shift),
                      st["down"])
    else:
        pre = L.qlinear(lp["mlp"]["up"], h_q,
                        L.QLinearSite(q.s_act, q.s_w, q.s_act, act=2, s_preact=q.s_act))
        m = L.qlinear(lp["mlp"]["down"], pre, st["down"])
    return L.iadd_i8(x_q, m, *st["res_mlp"])


def embed_input_w8a8(cfg: ArchConfig, qp: dict, batch: dict) -> torch.Tensor:
    x_q = L.embed_lookup(qp["embed"]["table_q"], batch["tokens"])
    if cfg.family == "vlm" and "patches" in batch:
        # the frontend stub delivers pre-quantized int8 patch embeddings
        x_q = torch.cat([batch["patches"].to(torch.int8), x_q], dim=1)
    return x_q


def lm_head_w8a8(cfg: ArchConfig, qp: dict, x_q: torch.Tensor, q: L.QuantConfig):
    """Final norm, then the exact integer LM-head product, dequantized.

    K = d_model is past float32's exact range for int8 operands, so the
    product is the exact integer one (``imatmul``) and only its int32
    accumulator is cast to float32; the tied head reads the embedding
    table transposed, as a view.
    """
    h_q = L.norm_apply_i8(cfg.norm, qp["final_norm"], x_q, _S_GAMMA, q.s_act)
    w_q = qp["embed"]["table_q"].T if cfg.tie_embeddings else qp["lm_head"]["w_q"]
    return imatmul(h_q, w_q).to(torch.float32) * (q.s_act * q.s_w)


def forward_w8a8(cfg: ArchConfig, qp: dict, batch: dict,
                 q: L.QuantConfig = L.QuantConfig()) -> torch.Tensor:
    """Integer causal forward of the whole sequence: dequantized logits
    [B, S, vocab_padded] (the layers of ``prefill_w8a8`` with no cache)."""
    x_q = embed_input_w8a8(cfg, qp, batch)
    positions = np.arange(x_q.shape[1])
    for lp in qp["layers"]:
        x_q = qlayer_fwd(cfg, lp, x_q, positions, q)
    return lm_head_w8a8(cfg, qp, x_q, q)


def init_cache_w8a8(cfg: ArchConfig, batch: int, max_len: int, device=None) -> dict:
    """The int8 KV cache (placed as the cache rules place it when a
    sharded prefill makes it under a policy: ``activations.zeros``)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": A.zeros(shape, torch.int8, device, "kv_cache"),
        "v": A.zeros(shape, torch.int8, device, "kv_cache"),
        "len": torch.tensor(0, dtype=torch.int32),
    }


def prefill_w8a8(cfg: ArchConfig, qp: dict, batch: dict, max_len: int,
                 q: L.QuantConfig = L.QuantConfig(), block_k: int = 512):
    """Causal forward of the prompt plus cache capture.  Returns the
    last-token logits [B, 1, vocab_padded] and the cache."""
    x_q = embed_input_w8a8(cfg, qp, batch)
    b, s, _ = x_q.shape
    positions = np.arange(s)  # host data
    cache = init_cache_w8a8(cfg, b, max_len, x_q.device)
    for l, lp in enumerate(qp["layers"]):

        def grab(kh, vh, l=l):
            cache["k"][l, :, :, :s] = kh
            cache["v"][l, :, :, :s] = vh
            return kh, vh

        x_q = qlayer_fwd(cfg, lp, x_q, positions, q, causal=True, kv_override=grab,
                         block_k=block_k)
    cache["len"] = torch.tensor(s, dtype=torch.int32)
    return lm_head_w8a8(cfg, qp, x_q[:, -1:], q), cache


def decode_step_w8a8(cfg: ArchConfig, qp: dict, cache: dict, token: torch.Tensor,
                     q: L.QuantConfig = L.QuantConfig(), block_k: int = 2048):
    """One-token decode against the int8 KV cache (every request at depth
    ``cache["len"]``).  Runs the same ``qlayer_fwd`` as prefill: the KV
    override appends this step's K/V at row ``len`` of a copy of the
    cache, and ``kv_len`` masks the rows past it."""
    x_q = L.embed_lookup(qp["embed"]["table_q"], token)
    pos = int(cache["len"])
    b = x_q.shape[0]
    new_k, new_v = cache["k"].clone(), cache["v"].clone()
    kv_len = torch.full((b, 1, 1, 1), pos + 1, dtype=torch.int32, device=x_q.device)
    for l, lp in enumerate(qp["layers"]):

        def append(kh, vh, l=l):
            new_k[l, :, :, pos : pos + 1] = kh
            new_v[l, :, :, pos : pos + 1] = vh
            return new_k[l], new_v[l]

        x_q = qlayer_fwd(cfg, lp, x_q, [pos], q, causal=False, kv_override=append,
                         kv_len=kv_len, block_k=block_k)
    new_cache = {"k": new_k, "v": new_v, "len": torch.tensor(pos + 1, dtype=torch.int32)}
    return lm_head_w8a8(cfg, qp, x_q, q), new_cache
