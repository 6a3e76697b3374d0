"""Zamba2 hybrid: a Mamba2 trunk and one *shared* attention block every K layers — torch port.

The paper's technique applies to the attention blocks (int8 QKV and O
products, flash attention with streaming ITAMax, an int8 KV cache) while
the SSD trunk runs on the float "cluster" path.  The shared block has ONE
set of weights applied at every site (layer K-1, 2K-1, ...) but a
separate KV cache per site.  Its integer attention is the cluster's
``core.attention`` code, as in the JAX package (no kernel of ours: the
head_dim is 80).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.attention import (
    MhaQParams,
    attention_decode_i8,
    attention_f32,
    attention_flash_i8,
)
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as MB
from repro_torch.models.transformer import _merge_heads, _split_heads
from repro_torch.runtime import activations as A
from repro_torch.runtime.activations import constrain

S_HYB = 0.06  # static activation grid at the float <-> int8 boundary
QSHARED_WSCALE = 0.01  # static weight grid of the shared attention block


def n_sites(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Random params from ``seed``, drawn by a generator on ``device`` (the
    CPU by default)."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    dev = gen.device
    layers = [MB.init_block(cfg, gen, dtype) for _ in range(cfg.n_layers)]
    qkv_dim = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    shared = {
        "norm1": L.init_norm("rmsnorm", cfg.d_model, dtype, dev),
        "wqkv": L.init_linear(gen, cfg.d_model, qkv_dim, False, dtype),
        "wo": L.init_linear(gen, cfg.n_heads * cfg.head_dim, cfg.d_model, False, dtype),
        "norm2": L.init_norm("rmsnorm", cfg.d_model, dtype, dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, dev, kind="gelu"),
    }
    table = torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen, dtype=dtype, device=dev)
    return {
        "embed": {"table": table * 0.02},
        "layers": layers,
        "shared": shared,
        "final_norm": L.init_norm("rmsnorm", cfg.d_model, dtype, dev),
        "lm_head": L.init_linear(gen, cfg.d_model, cfg.vocab_padded, False, dtype),
    }


def quantize_shared(shared: dict, scale: float = QSHARED_WSCALE) -> dict:
    """int8 weights of the shared attention block (the ITA-mapped part) on
    the static ``QSHARED_WSCALE`` grid."""
    out = {}
    for name in ("wqkv", "wo"):
        w = shared[name]["w"].to(torch.float32)
        out[name] = {"w_q": torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)}
    return out


def _shared_attn_f32(cfg: ArchConfig, sp: dict, x: torch.Tensor, positions) -> torch.Tensor:
    h = constrain(L.norm_apply("rmsnorm", sp["norm1"], x), "gathered")
    q, k, v = _split_heads(L.linear(sp["wqkv"], h), cfg)
    cos, sin = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, x.dtype, x.device)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    out = attention_f32(q, k, v, causal=True)
    x = x + constrain(L.linear(sp["wo"], _merge_heads(out)), "residual")
    h = constrain(L.norm_apply("rmsnorm", sp["norm2"], x), "gathered")
    return x + constrain(L.mlp_forward(sp["mlp"], h, "gelu"), "residual")


def _quantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)


def _shared_attn_core_i8(cfg: ArchConfig, sq: dict, h_q: torch.Tensor, positions,
                         kv_cache=None, block_k: int = 512):
    """The integer part of the shared block: int8 ``h_q`` (the normed trunk
    on the :data:`S_HYB` grid) -> QKV, integer RoPE, flash attention
    (prefill) or the cached form (decode), O -> int8 ``o_q``.

    ``kv_cache`` is ``(kc, vc, pos)`` for a decode step: this step's K/V
    are written into ``kc`` / ``vc`` at row ``pos`` (in place) and
    attention reads rows ``< pos + 1``.  Returns (o_q, (K, V))."""
    p = MhaQParams.make_flash(S_HYB, S_HYB, S_HYB, S_HYB, cfg.head_dim)
    site = L.QLinearSite(S_HYB, QSHARED_WSCALE, S_HYB)
    qh, kh, vh = _split_heads(L.qlinear({"w_q": sq["wqkv"]["w_q"]}, h_q, site), cfg)
    c_q, s_q = L.rope_tables_i8(positions, cfg.head_dim, cfg.rope_theta, h_q.device)
    qh, kh = L.apply_rope_i8(qh, c_q, s_q), L.apply_rope_i8(kh, c_q, s_q)
    if kv_cache is None:
        out = attention_flash_i8(qh, kh, vh, p, causal=True, block_k=min(block_k, kh.shape[2]))
        new_kv = (kh, vh)
    else:
        kc, vc, pos = kv_cache
        kc[:, :, pos : pos + 1] = kh
        vc[:, :, pos : pos + 1] = vh
        lens = torch.full((qh.shape[0],), pos + 1, dtype=torch.int32, device=h_q.device)
        out = attention_decode_i8(qh, kc, vc, lens, p, block_k=min(block_k, kc.shape[2]))
        new_kv = (kc, vc)
    return L.qlinear({"w_q": sq["wo"]["w_q"]}, _merge_heads(out), site), new_kv


def _shared_attn_i8(cfg: ArchConfig, sp: dict, sq: dict, x: torch.Tensor, positions,
                    kv_cache=None, block_k: int = 512):
    """The shared block with int8 QKV, attention and O (the paper's
    technique, :func:`_shared_attn_core_i8`); its MLP stays float, as in
    the JAX package.  The float trunk's activations are quantized at the
    boundary onto :data:`S_HYB`.  Returns (x, (K, V))."""
    h_q = _quantize_act(L.norm_apply("rmsnorm", sp["norm1"], x), S_HYB)
    o_q, new_kv = _shared_attn_core_i8(cfg, sq, h_q, positions, kv_cache, block_k)
    x = x + o_q.to(x.dtype) * S_HYB
    h = L.norm_apply("rmsnorm", sp["norm2"], x)
    return x + L.mlp_forward(sp["mlp"], h, "gelu"), new_kv


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = constrain(L.norm_apply("rmsnorm", params["final_norm"], x), "gathered")
    return L.head_logits(x, params["lm_head"]["w"])


def forward(cfg: ArchConfig, params: dict, batch: dict, *, remat: bool = False,
            **_) -> torch.Tensor:
    """Float forward (the training path).  ``remat`` recomputes each trunk
    layer's activations, with its shared-attention site's, in the
    backward pass."""
    x = L.embed_lookup(params["embed"]["table"], batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, bp, shared, site):
        x = constrain(x, "residual")
        x, _, _ = MB.block_forward(cfg, bp, x)
        if site:
            x = _shared_attn_f32(cfg, shared, x, positions)
        return constrain(x, "residual")

    for i, bp in enumerate(params["layers"]):
        args = (x, bp, params["shared"], (i + 1) % cfg.attn_every == 0)
        x = checkpoint(body, *args, use_reentrant=False) if remat else body(*args)
    return _head(params, x)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *, remat: bool = False,
            **_) -> torch.Tensor:
    return L.token_nll(forward(cfg, params, batch, remat=remat), batch["labels"], cfg.vocab)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.float32,
               device=None) -> dict:
    cache = MB.init_cache(cfg, batch, dtype, device)
    shape = (n_sites(cfg), batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    cache["k"] = A.zeros(shape, torch.int8, device, "kv_cache")
    cache["v"] = A.zeros(shape, torch.int8, device, "kv_cache")
    return cache


def prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int, qshared: dict):
    """Serve prefill: the float trunk, the int8 shared attention and its
    int8 KV cache.  Returns the last-token logits and the cache."""
    x = L.embed_lookup(params["embed"]["table"], batch["tokens"])
    b, s, _ = x.shape
    positions = np.arange(s)  # host data
    cache = init_cache(cfg, b, max_len, x.dtype, x.device)
    convs, ssms = [], []
    for i, bp in enumerate(params["layers"]):
        x, conv, ssm = MB.block_forward(cfg, bp, x)
        convs.append(conv)
        ssms.append(ssm)
        if (i + 1) % cfg.attn_every == 0:
            x, (kh, vh) = _shared_attn_i8(cfg, params["shared"], qshared, x, positions)
            site = (i + 1) // cfg.attn_every - 1
            cache["k"][site, :, :, :s] = kh
            cache["v"][site, :, :, :s] = vh
    cache.update(conv=torch.stack(convs), ssm=torch.stack(ssms),
                 len=torch.tensor(s, dtype=torch.int32))
    return _head(params, x[:, -1:]), cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor, qshared: dict):
    """One token [B, 1] against the cache.  Returns the logits and a new cache."""
    x = L.embed_lookup(params["embed"]["table"], token)
    pos = int(cache["len"])
    kcache, vcache = cache["k"].clone(), cache["v"].clone()
    convs, ssms = [], []
    for i, bp in enumerate(params["layers"]):
        x, conv, ssm = MB.block_decode(cfg, bp, x, cache["conv"][i], cache["ssm"][i])
        convs.append(conv)
        ssms.append(ssm)
        if (i + 1) % cfg.attn_every == 0:
            site = (i + 1) // cfg.attn_every - 1
            x, _ = _shared_attn_i8(cfg, params["shared"], qshared, x, [pos],
                                   (kcache[site], vcache[site], pos))
    new_cache = {"conv": torch.stack(convs), "ssm": torch.stack(ssms), "k": kcache,
                 "v": vcache, "len": torch.tensor(pos + 1, dtype=torch.int32)}
    return _head(params, x), new_cache
