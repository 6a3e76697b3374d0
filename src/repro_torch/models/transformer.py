"""Dense decoder-only transformer LM (GQA), integer (w8a8) path — torch port.

Port of the w8a8 half of the JAX package's ``models/transformer.py``:
int8 embedding table, integer norms, int8 QKV/O/MLP products, flash
attention with streaming ITAMax, integer RoPE, SiLU and residual adds,
and float logits only at the LM head.  Every function here runs the
plain integer arithmetic (exact integer products on any device,
``quant.qparams.imatmul``); the deploy flow's plans equal it on both
backends.

Parameters are plain dicts; ``params["layers"]`` is a list with one dict
per layer.  The KV cache is ``{"k": [L, B, Hkv, max_len, D] int8, "v":
..., "len": int32}``, with ``len`` a host (CPU) tensor: RoPE angles and
cache rows are chosen on the host.  The functions here are pure: a
decode step returns a new cache and leaves its argument as it was.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import ilayernorm as iln
from repro_torch.core.attention import MhaQParams, attention_flash_i8
from repro_torch.models import layers as L
from repro_torch.quant.qparams import i32, imatmul, make_qparams, requantize

_S_GAMMA = 1.0 / 64.0  # shape-only norm gain grid (g_q=64 -> gamma=1.0)


def _qkv_dims(cfg: ArchConfig) -> int:
    return (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: mixture-of-experts layers are not ported")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_layer(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32, device=None) -> dict:
    _dense_only(cfg)
    return {
        "norm1": L.init_norm(cfg.norm, cfg.d_model, dtype, device),
        "attn": {
            "wqkv": L.init_linear(gen, cfg.d_model, _qkv_dims(cfg), cfg.qkv_bias, dtype,
                                  device),
            "wo": L.init_linear(gen, cfg.n_heads * cfg.head_dim, cfg.d_model, False, dtype,
                                device),
        },
        "norm2": L.init_norm(cfg.norm, cfg.d_model, dtype, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device, kind=cfg.mlp),
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


def _qnorm(cfg: ArchConfig) -> dict:
    if cfg.norm == "np_layernorm":
        return {}
    p = {"g_q": torch.full((cfg.d_model,), 64, dtype=torch.int8)}
    if cfg.norm == "layernorm":
        p["beta_q"] = torch.zeros((cfg.d_model,), dtype=torch.int32)
    return p


def init_qlayer(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Shape-only integer layer (random int8 weights)."""
    _dense_only(cfg)
    d, f = cfg.d_model, cfg.d_ff
    lp = {
        "norm1": _qnorm(cfg),
        "attn": {
            "wqkv": L.init_qlinear(gen, d, _qkv_dims(cfg), cfg.qkv_bias),
            "wo": L.init_qlinear(gen, cfg.n_heads * cfg.head_dim, d, False),
        },
        "norm2": _qnorm(cfg),
    }
    if cfg.mlp == "swiglu":
        lp["mlp"] = {"gate": L.init_qlinear(gen, d, f, False),
                     "up": L.init_qlinear(gen, d, f, False),
                     "down": L.init_qlinear(gen, f, d, False)}
    else:
        lp["mlp"] = {"up": L.init_qlinear(gen, d, f, True),
                     "down": L.init_qlinear(gen, f, d, True)}
    return lp


def init_qparams(cfg: ArchConfig, seed: int = 0) -> dict:
    """Shape-only integer model (random int8 weights from ``seed``)."""
    gen = torch.Generator().manual_seed(seed)
    qp = {
        "layers": [init_qlayer(cfg, gen) for _ in range(cfg.n_layers)],
        "embed": {"table_q": torch.randint(-127, 128, (cfg.vocab_padded, cfg.d_model),
                                           generator=gen, dtype=torch.int8)},
        "final_norm": _qnorm(cfg),
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
    _dense_only(cfg)
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
    if cfg.mlp == "swiglu":
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
    return qp["embed"]["table_q"][batch["tokens"].long()]


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


def init_cache_w8a8(cfg: ArchConfig, batch: int, max_len: int, device=None) -> dict:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "len": torch.zeros((), dtype=torch.int32),
    }


def prefill_w8a8(cfg: ArchConfig, qp: dict, batch: dict, max_len: int,
                 q: L.QuantConfig = L.QuantConfig(), block_k: int = 512):
    """Causal forward of the prompt plus cache capture.  Returns the
    last-token logits [B, 1, vocab_padded] and the cache."""
    x_q = embed_input_w8a8(cfg, qp, batch)
    b, s, _ = x_q.shape
    positions = torch.arange(s)
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
    x_q = qp["embed"]["table_q"][token.long()]
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
