"""Encoder-decoder (seamless-m4t style): an audio-stub encoder and a text decoder — torch port.

The float path is the training and accuracy model; the integer (w8a8)
path serves: the encoder is ITA's native case (bidirectional attention),
and the decoder adds causal self-attention over an int8 KV cache and
cross-attention whose K/V are computed once from the encoder's output.
Integer from end to end: the port's ints equal the JAX package's.
Parameters are plain dicts; ``enc_layers`` / ``dec_layers`` are lists of
per-layer dicts.  A cache is ``{"k", "v": [L, B, Hkv, max_len, D], "ck",
"cv": [L, B, Hkv, T, D], "len": int32}`` with ``len`` on the host.
"""

from __future__ import annotations

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
from repro_torch.models.transformer import DTensor, _heads_local, _merge_heads, _split_heads
from repro_torch.quant.qparams import imatmul
from repro_torch.runtime import activations as A
from repro_torch.runtime.activations import constrain

_S_GAMMA = 1.0 / 64.0


def _heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    if isinstance(x, DTensor):  # as transformer._split_heads
        return _heads_local(x, lambda t: _heads(t, n, d), 1)
    b, s, _ = x.shape
    return x.reshape(b, s, n, d).permute(0, 2, 1, 3)


def _init_attn(cfg: ArchConfig, gen: torch.Generator, dtype, device, cross: bool = False) -> dict:
    qkv_dim = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    hd = cfg.n_heads * cfg.head_dim
    if cross:
        return {
            "wq": L.init_linear(gen, cfg.d_model, hd, False, dtype, device),
            "wkv": L.init_linear(gen, cfg.d_model, 2 * cfg.n_kv_heads * cfg.head_dim, False,
                                 dtype, device),
            "wo": L.init_linear(gen, hd, cfg.d_model, False, dtype, device),
        }
    return {
        "wqkv": L.init_linear(gen, cfg.d_model, qkv_dim, False, dtype, device),
        "wo": L.init_linear(gen, hd, cfg.d_model, False, dtype, device),
    }


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Random float params from ``seed``, drawn by a generator on ``device``
    (the CPU by default)."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    dev = gen.device

    def norm():
        return L.init_norm(cfg.norm, cfg.d_model, dtype, dev)

    def mlp():
        return L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, dev, kind=cfg.mlp)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev) * 0.02

    enc = [{"norm1": norm(), "attn": _init_attn(cfg, gen, dtype, dev), "norm2": norm(),
            "mlp": mlp()} for _ in range(cfg.enc_layers)]
    dec = [{"norm1": norm(), "self_attn": _init_attn(cfg, gen, dtype, dev), "norm_x": norm(),
            "cross_attn": _init_attn(cfg, gen, dtype, dev, cross=True), "norm2": norm(),
            "mlp": mlp()} for _ in range(cfg.dec_layers)]
    return {
        "enc_layers": enc,
        "dec_layers": dec,
        "enc_pos": randn(cfg.n_frames, cfg.d_model),
        "dec_embed": {"table": randn(cfg.vocab_padded, cfg.d_model)},
        "dec_pos": randn(cfg.max_seq, cfg.d_model),
        "enc_final": norm(),
        "dec_final": norm(),
        "lm_head": L.init_linear(gen, cfg.d_model, cfg.vocab_padded, False, dtype, dev),
    }


def _attn_f32(cfg: ArchConfig, ap: dict, x: torch.Tensor, kv_src: torch.Tensor,
              causal: bool) -> torch.Tensor:
    if "wqkv" in ap:
        q, k, v = _split_heads(L.linear(ap["wqkv"], x), cfg)
    else:
        q = _heads(L.linear(ap["wq"], x), cfg.n_heads, cfg.head_dim)
        k, v = torch.chunk(L.linear(ap["wkv"], kv_src), 2, dim=-1)
        k, v = (_heads(t, cfg.n_kv_heads, cfg.head_dim) for t in (k, v))
    out = attention_f32(q, k, v, causal=causal)
    return L.linear(ap["wo"], _merge_heads(out))


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor, *, remat: bool = False,
           **_) -> torch.Tensor:
    """The encoder stack.  ``remat`` recomputes each layer's activations in
    the backward pass."""
    x = frames + params["enc_pos"][: frames.shape[1]].to(frames.dtype)

    def body(x, lp):
        x = constrain(x, "residual")
        h = constrain(L.norm_apply(cfg.norm, lp["norm1"], x), "gathered")
        x = x + constrain(_attn_f32(cfg, lp["attn"], h, h, causal=False), "residual")
        h = constrain(L.norm_apply(cfg.norm, lp["norm2"], x), "gathered")
        x = x + constrain(L.mlp_forward(lp["mlp"], h, cfg.mlp), "residual")
        return constrain(x, "residual")

    for lp in params["enc_layers"]:
        x = checkpoint(body, x, lp, use_reentrant=False) if remat else body(x, lp)
    return constrain(L.norm_apply(cfg.norm, params["enc_final"], x), "gathered")


def forward(cfg: ArchConfig, params: dict, batch: dict, *, remat: bool = False,
            **_) -> torch.Tensor:
    """batch: frames [B, T, D], tokens [B, S].  Returns the decoder's logits.
    ``remat`` recomputes each layer of both stacks in the backward pass."""
    memory = encode(cfg, params, batch["frames"], remat=remat)
    tokens = batch["tokens"].long()
    x = L.embed_lookup(params["dec_embed"]["table"], tokens) + \
        params["dec_pos"][: tokens.shape[1]].to(memory.dtype)

    def body(x, lp, memory):
        x = constrain(x, "residual")
        h = constrain(L.norm_apply(cfg.norm, lp["norm1"], x), "gathered")
        x = x + constrain(_attn_f32(cfg, lp["self_attn"], h, h, causal=True), "residual")
        h = constrain(L.norm_apply(cfg.norm, lp["norm_x"], x), "gathered")
        x = x + constrain(_attn_f32(cfg, lp["cross_attn"], h, memory, causal=False),
                          "residual")
        h = constrain(L.norm_apply(cfg.norm, lp["norm2"], x), "gathered")
        x = x + constrain(L.mlp_forward(lp["mlp"], h, cfg.mlp), "residual")
        return constrain(x, "residual")

    for lp in params["dec_layers"]:
        x = checkpoint(body, x, lp, memory, use_reentrant=False) if remat \
            else body(x, lp, memory)
    x = constrain(L.norm_apply(cfg.norm, params["dec_final"], x), "gathered")
    return L.head_logits(x, params["lm_head"]["w"])


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *, remat: bool = False,
            **_) -> torch.Tensor:
    return L.token_nll(forward(cfg, params, batch, remat=remat), batch["labels"], cfg.vocab)


# ---------------------------------------------------------------------------
# Integer serving path
# ---------------------------------------------------------------------------


def init_qparams(cfg: ArchConfig, seed: int = 0, device=None) -> dict:
    """Shape-only integer model (random int8 weights from ``seed``), drawn
    on ``device`` (the CPU by default) by a generator there."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    dev = gen.device
    qkv_dim = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    hd = cfg.n_heads * cfg.head_dim
    d = cfg.d_model

    def qnorm():
        return {"g_q": torch.full((d,), 64, dtype=torch.int8, device=dev),
                "beta_q": torch.zeros((d,), dtype=torch.int32, device=dev)}

    def qlin(d_in, d_out, bias=False):
        return L.init_qlinear(gen, d_in, d_out, bias)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8, device=dev)

    def mlp():
        return {"up": qlin(d, cfg.d_ff, True), "down": qlin(cfg.d_ff, d, True)}

    enc = [{"norm1": qnorm(), "attn": {"wqkv": qlin(d, qkv_dim), "wo": qlin(hd, d)},
            "norm2": qnorm(), "mlp": mlp()} for _ in range(cfg.enc_layers)]
    dec = [{"norm1": qnorm(), "self_attn": {"wqkv": qlin(d, qkv_dim), "wo": qlin(hd, d)},
            "norm_x": qnorm(),
            "cross_attn": {"wq": qlin(d, hd), "wkv": qlin(d, 2 * cfg.n_kv_heads * cfg.head_dim),
                           "wo": qlin(hd, d)},
            "norm2": qnorm(), "mlp": mlp()} for _ in range(cfg.dec_layers)]
    return {
        "enc_layers": enc,
        "dec_layers": dec,
        "enc_pos_q": randint(-64, 64, cfg.n_frames, d),
        "dec_embed": {"table_q": randint(-127, 128, cfg.vocab_padded, d)},
        "dec_pos_q": randint(-64, 64, cfg.max_seq, d),
        "enc_final": qnorm(),
        "dec_final": qnorm(),
        "lm_head": qlin(d, cfg.vocab_padded),
    }


def _sites(q: L.QuantConfig):
    st = L.QLinearSite(q.s_act, q.s_w, q.s_act)
    up = L.QLinearSite(q.s_act, q.s_w, q.s_act, act=2, s_preact=q.s_act)
    return st, up, L.make_iadd_params(q.s_res, q.s_act, q.s_res)


def _mlp_i8(cfg: ArchConfig, lp: dict, x: torch.Tensor, q: L.QuantConfig) -> torch.Tensor:
    st, up, res = _sites(q)
    h = L.norm_apply_i8(cfg.norm, lp["norm2"], x, _S_GAMMA, q.s_act)
    m = L.qlinear(lp["mlp"]["down"], L.qlinear(lp["mlp"]["up"], h, up), st)
    return L.iadd_i8(x, m, *res)


def _qattn(cfg: ArchConfig, ap: dict, h_q: torch.Tensor, kv_q: torch.Tensor,
           q: L.QuantConfig, causal: bool, block_k: int = 512) -> torch.Tensor:
    st = L.QLinearSite(q.s_act, q.s_w, q.s_act)
    p = MhaQParams.make_flash(q.s_act, q.s_act, q.s_act, q.s_act, cfg.head_dim)
    if "wqkv" in ap:
        qh, kh, vh = _split_heads(L.qlinear(ap["wqkv"], h_q, st), cfg)
    else:
        qh = _heads(L.qlinear(ap["wq"], h_q, st), cfg.n_heads, cfg.head_dim)
        kh, vh = torch.chunk(L.qlinear(ap["wkv"], kv_q, st), 2, dim=-1)
        kh, vh = (_heads(t, cfg.n_kv_heads, cfg.head_dim) for t in (kh, vh))
    out = attention_flash_i8(qh, kh, vh, p, causal=causal, block_k=min(block_k, kh.shape[2]))
    return L.qlinear(ap["wo"], _merge_heads(out), st)


def encode_w8a8(cfg: ArchConfig, qp: dict, frames_q: torch.Tensor,
                q: L.QuantConfig) -> torch.Tensor:
    add = L.make_iadd_params(q.s_res, q.s_res, q.s_res)
    x_q = L.iadd_i8(frames_q.to(torch.int8), qp["enc_pos_q"][None, : frames_q.shape[1]], *add)
    _, _, res = _sites(q)
    for lp in qp["enc_layers"]:
        h = L.norm_apply_i8(cfg.norm, lp["norm1"], x_q, _S_GAMMA, q.s_act)
        x_q = L.iadd_i8(x_q, _qattn(cfg, lp["attn"], h, h, q, causal=False), *res)
        x_q = _mlp_i8(cfg, lp, x_q, q)
    return L.norm_apply_i8(cfg.norm, qp["enc_final"], x_q, _S_GAMMA, q.s_res)


def init_cache_w8a8(cfg: ArchConfig, batch: int, max_len: int, device=None) -> dict:
    shape = (cfg.dec_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    cross = (cfg.dec_layers, batch, cfg.n_kv_heads, cfg.n_frames, cfg.head_dim)
    return {
        "k": A.zeros(shape, torch.int8, device, "kv_cache"),
        "v": A.zeros(shape, torch.int8, device, "kv_cache"),
        "ck": A.zeros(cross, torch.int8, device, "kv_cache"),
        "cv": A.zeros(cross, torch.int8, device, "kv_cache"),
        "len": torch.tensor(0, dtype=torch.int32),
    }


def _logits(cfg: ArchConfig, qp: dict, x_q: torch.Tensor, q: L.QuantConfig) -> torch.Tensor:
    h = L.norm_apply_i8(cfg.norm, qp["dec_final"], x_q, _S_GAMMA, q.s_act)
    return imatmul(h, qp["lm_head"]["w_q"]).to(torch.float32) * (q.s_act * q.s_w)


def prefill_w8a8(cfg: ArchConfig, qp: dict, batch: dict, max_len: int,
                 q: L.QuantConfig = L.QuantConfig(), block_k: int = 512):
    """Encode the frames, run the decoder over the prompt and build both
    caches.  Returns the last-token logits [B, 1, vocab_padded] and the cache."""
    memory_q = encode_w8a8(cfg, qp, batch["frames"], q)
    tokens = batch["tokens"].long()
    b, s = tokens.shape
    add = L.make_iadd_params(q.s_res, q.s_res, q.s_res)
    x_q = L.iadd_i8(L.embed_lookup(qp["dec_embed"]["table_q"], tokens), qp["dec_pos_q"][None, :s],
                    *add)
    st, _, res = _sites(q)
    p = MhaQParams.make_flash(q.s_act, q.s_act, q.s_act, q.s_act, cfg.head_dim)
    t = memory_q.shape[1]
    cache = init_cache_w8a8(cfg, b, max_len, x_q.device)
    cks, cvs = [], []
    for l, lp in enumerate(qp["dec_layers"]):
        h = L.norm_apply_i8(cfg.norm, lp["norm1"], x_q, _S_GAMMA, q.s_act)
        qh, kh, vh = _split_heads(L.qlinear(lp["self_attn"]["wqkv"], h, st), cfg)
        out = attention_flash_i8(qh, kh, vh, p, causal=True, block_k=min(block_k, s))
        x_q = L.iadd_i8(x_q, L.qlinear(lp["self_attn"]["wo"], _merge_heads(out), st), *res)
        cache["k"][l, :, :, :s] = kh
        cache["v"][l, :, :, :s] = vh
        # cross attention: its K/V are computed once and kept
        h = L.norm_apply_i8(cfg.norm, lp["norm_x"], x_q, _S_GAMMA, q.s_act)
        qh2 = _heads(L.qlinear(lp["cross_attn"]["wq"], h, st), cfg.n_heads, cfg.head_dim)
        ck, cv = torch.chunk(L.qlinear(lp["cross_attn"]["wkv"], memory_q, st), 2, dim=-1)
        ck, cv = (_heads(t_, cfg.n_kv_heads, cfg.head_dim) for t_ in (ck, cv))
        out = attention_flash_i8(qh2, ck, cv, p, causal=False, block_k=min(block_k, t))
        x_q = L.iadd_i8(x_q, L.qlinear(lp["cross_attn"]["wo"], _merge_heads(out), st), *res)
        x_q = _mlp_i8(cfg, lp, x_q, q)
        cks.append(ck)
        cvs.append(cv)
    cache.update(ck=torch.stack(cks), cv=torch.stack(cvs),
                 len=torch.tensor(s, dtype=torch.int32))
    return _logits(cfg, qp, x_q[:, -1:], q), cache


def decode_step_w8a8(cfg: ArchConfig, qp: dict, cache: dict, token: torch.Tensor,
                     q: L.QuantConfig = L.QuantConfig(), block_k: int = 2048):
    """One token [B, 1] against both caches.  Returns the logits and a new cache."""
    pos = int(cache["len"])
    b = token.shape[0]
    add = L.make_iadd_params(q.s_res, q.s_res, q.s_res)
    x_q = L.iadd_i8(L.embed_lookup(qp["dec_embed"]["table_q"], token),
                    qp["dec_pos_q"][None, pos : pos + 1], *add)
    st, _, res = _sites(q)
    p = MhaQParams.make_flash(q.s_act, q.s_act, q.s_act, q.s_act, cfg.head_dim)
    new_k, new_v = cache["k"].clone(), cache["v"].clone()
    lens = torch.full((b,), pos + 1, dtype=torch.int32, device=x_q.device)
    for l, lp in enumerate(qp["dec_layers"]):
        h = L.norm_apply_i8(cfg.norm, lp["norm1"], x_q, _S_GAMMA, q.s_act)
        qh, kh, vh = _split_heads(L.qlinear(lp["self_attn"]["wqkv"], h, st), cfg)
        new_k[l, :, :, pos : pos + 1] = kh
        new_v[l, :, :, pos : pos + 1] = vh
        out = attention_decode_i8(qh, new_k[l], new_v[l], lens, p,
                                  block_k=min(block_k, new_k.shape[3]))
        x_q = L.iadd_i8(x_q, L.qlinear(lp["self_attn"]["wo"], _merge_heads(out), st), *res)
        h = L.norm_apply_i8(cfg.norm, lp["norm_x"], x_q, _S_GAMMA, q.s_act)
        qh2 = _heads(L.qlinear(lp["cross_attn"]["wq"], h, st), cfg.n_heads, cfg.head_dim)
        ck, cv = cache["ck"][l], cache["cv"][l]
        out = attention_flash_i8(qh2, ck, cv, p, causal=False, block_k=min(block_k, ck.shape[2]))
        x_q = L.iadd_i8(x_q, L.qlinear(lp["cross_attn"]["wo"], _merge_heads(out), st), *res)
        x_q = _mlp_i8(cfg, lp, x_q, q)
    new_cache = dict(cache, k=new_k, v=new_v, len=torch.tensor(pos + 1, dtype=torch.int32))
    return _logits(cfg, qp, x_q, q), new_cache
