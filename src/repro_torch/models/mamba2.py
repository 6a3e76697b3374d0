"""Mamba2 (SSD, state-space duality) blocks and LM, float path — torch port.

The paper's attention technique does not apply to the attention-free SSD
scan; the projections stay float here, as in the JAX package, and the
scan runs on the general ("cluster") float path.

Chunked SSD: a quadratic form within each chunk and a state recurrence
between chunks (a Python loop over the chunks).  Decode is the O(1)
recurrent step on the carried (heads, head_dim, state) tensor.  The
reference's five-operand einsums are contracted pairwise here, in an
order that never builds a (b, chunks, c, c, heads, head_dim) tensor.
Parameters are plain dicts, ``params["layers"]`` a list of per-layer
dicts; a cache is ``{"conv": [L, B, D_CONV - 1, conv_dim], "ssm": [L, B,
H, P, N], "len": int32}``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.runtime.activations import active_mesh, constrain, fits, local_shards
from repro_torch.runtime.sharding import P, axis_names, data_axes

try:
    from torch.distributed.tensor import DTensor
except ImportError:  # a torch built without distributed support
    DTensor = ()

D_CONV = 4  # depthwise causal conv width (Mamba default)
N_GROUPS = 1


def dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * N_GROUPS * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def init_block(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32, device=None) -> dict:
    """One block's params, drawn on ``gen``'s device and kept on ``device``."""
    d_inner, n_heads, conv_dim = dims(cfg)
    d_in_proj = 2 * d_inner + 2 * N_GROUPS * cfg.ssm_state + n_heads
    device = gen.device if device is None else device
    conv_w = torch.randn((D_CONV, conv_dim), generator=gen, dtype=dtype, device=gen.device)
    a_log = np.log(np.linspace(1.0, 16.0, n_heads, dtype=np.float32))
    return {
        "norm": L.init_norm("rmsnorm", cfg.d_model, dtype, device),
        "in_proj": L.init_linear(gen, cfg.d_model, d_in_proj, False, dtype, device),
        "conv_w": (conv_w * 0.2).to(device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.from_numpy(a_log).to(dtype=dtype, device=device),
        "dt_bias": torch.zeros((n_heads,), dtype=dtype, device=device),
        "D": torch.ones((n_heads,), dtype=dtype, device=device),
        "out_norm": L.init_norm("rmsnorm", d_inner, dtype, device),
        "out_proj": L.init_linear(gen, d_inner, cfg.d_model, False, dtype, device),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., c] -> lower-triangular pairwise sums: out[i, j] = sum_{j<k<=i} a_k,
    -inf above the diagonal (set before any ``exp``)."""
    c = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    lower = torch.tril(torch.ones((c, c), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~lower, float("-inf"))


def _conv_state(x: torch.Tensor, state=None):
    """The trailing context [B, D_CONV - 1, C] before ``x`` [B, S, C]:
    ``state`` (decode), or zeros."""
    if state is None:
        state = torch.zeros((x.shape[0], D_CONV - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    return state


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv of width D_CONV. x [B, S, C], w [D_CONV, C].

    ``state`` [B, D_CONV - 1, C] holds the trailing context (decode);
    returns (y, new_state)."""
    xp = torch.cat([_conv_state(x, state), x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, D_CONV):
        y = y + xp[:, i : i + s] * w[i]
    return y + b, xp[:, -(D_CONV - 1):]


def ssd_chunked(x: torch.Tensor, dta: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                chunk: int, init_state=None):
    """Chunked SSD.  x (b, l, h, p) already times dt, dta (b, l, h) the
    log-decay per step (negative), Bm / Cm (b, l, n), init_state (b, h, p,
    n).  Returns (y (b, l, h, p), final_state (b, h, p, n))."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    if l % chunk:
        raise ValueError(f"length {l} is not a multiple of the chunk {chunk}")
    nc = l // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    ac = dta.reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, n)
    Cc = Cm.reshape(b, nc, chunk, n)

    cum = torch.cumsum(ac, dim=2)  # (b, nc, c, h)
    # within each chunk: y_diag[i] = sum_j (C_i . B_j) L[h, i, j] x_j
    Ld = torch.exp(_segsum(ac.movedim(-1, -2)))  # (b, nc, h, c, c)
    cb = torch.einsum("bzin,bzjn->bzij", Cc, Bc)  # (b, nc, c, c)
    y_diag = torch.einsum("bzhij,bzjhp->bzihp", cb[:, :, None] * Ld, xc)

    # each chunk's end state
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b, nc, c, h)
    s_chunk = torch.einsum("bzjhp,bzjn->bzhpn", xc * decay_end[..., None], Bc)

    # the recurrence between chunks: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, h)
    s = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device) if init_state is None \
        else init_state
    s_ins = []
    for z in range(nc):
        s_ins.append(s)
        s = s * chunk_decay[:, z, :, None, None] + s_chunk[:, z]
    s_ins = torch.stack(s_ins, dim=1)  # (b, nc, h, p, n)
    y_off = torch.einsum("bzin,bzhpn->bzihp", Cc, s_ins) * torch.exp(cum)[..., None]
    return (y_diag + y_off).reshape(b, l, h, p), s


def _ssd_local(x, dta, Bm, Cm, chunk: int, init_state=None):
    """``ssd_chunked`` on each rank's shards (``local_shards``): the scan is
    independent across batch rows (the data axes) and heads ("model",
    where it divides them); B and C, shared by the heads, are whole on
    each rank.  (As DTensor ops, its einsums view sharded dims as one,
    which DTensor 2.11 refuses.)"""
    mesh = active_mesh() or x.device_mesh
    b, _, h, _ = x.shape
    da = data_axes(mesh)
    b_ax = da if fits(b, da, mesh) else None
    h_ax = "model" if "model" in axis_names(mesh) and fits(h, "model", mesh) else None
    xs, ss = P(b_ax, None, h_ax, None), P(b_ax, h_ax, None, None)
    args = (x, dta, Bm, Cm) + (() if init_state is None else (init_state,))
    specs = (xs, P(b_ax, None, h_ax), P(b_ax, None, None), P(b_ax, None, None), ss)
    return local_shards(lambda *a: ssd_chunked(*a[:4], chunk, *a[4:]), args,
                        specs[:len(args)], [xs, ss], mesh=mesh)


def _saving_less(fn, *args):
    """``fn(*args)``; where the result is differentiated, ``fn``'s
    intermediates are made again in the backward from ``args`` instead of
    kept (``torch.utils.checkpoint`` of an elementwise stretch: the same
    values bit for bit, and no remat of the layer, which the JAX package
    does not do here either).  Eager autograd keeps each elementwise
    result that XLA fuses away: the SiLUs' sigmoids and products, the
    causal conv's padded input and its partial sums."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                       for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _conv_silu(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state) -> torch.Tensor:
    return L.silu(_conv1d_causal(xbc, w, b, state)[0])


def _in_proj(cfg: ArchConfig, bp: dict, u: torch.Tensor, conv_state):
    d_inner, n_heads, conv_dim = dims(cfg)
    h = L.norm_apply("rmsnorm", bp["norm"], u)
    # gather the sequence before the projection, as at the transformer's
    # Megatron-SP boundary: the product views [B, S] as one dim
    h = constrain(h, "gathered")
    zxbcdt = L.linear(bp["in_proj"], h)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, n_heads], dim=-1)
    xbc_act = _saving_less(_conv_silu, xbc, bp["conv_w"], bp["conv_b"], conv_state)
    # the conv's new state, from the last rows alone: the whole padded
    # input stays inside _conv_silu, made again in the backward
    new_conv = torch.cat([_conv_state(xbc, conv_state), xbc[:, -(D_CONV - 1):]],
                         dim=1)[:, -(D_CONV - 1):]
    x, Bm, Cm = torch.split(xbc_act, [d_inner, N_GROUPS * cfg.ssm_state,
                                      N_GROUPS * cfg.ssm_state], dim=-1)
    return z, x, Bm, Cm, dt_raw, new_conv


def _gate_norm(y: torch.Tensor, z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return L.norm_apply("rmsnorm", {"g": g}, y * L.silu(z))


def _out(bp: dict, u: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    y = _saving_less(_gate_norm, y, z, bp["out_norm"]["g"])
    return u + constrain(L.linear(bp["out_proj"], y), "residual")


def block_forward(cfg: ArchConfig, bp: dict, u: torch.Tensor, conv_state=None, ssm_state=None):
    """One Mamba2 block. u [B, S, D]. Returns (out, conv_state, ssm_state)."""
    d_inner, n_heads, _ = dims(cfg)
    z, x, Bm, Cm, dt_raw, new_conv = _in_proj(cfg, bp, u, conv_state)
    b, s, _ = x.shape
    x = x.reshape(b, s, n_heads, cfg.ssm_head_dim)
    dt = F.softplus(dt_raw + bp["dt_bias"])  # (b, s, h)
    dta = dt * -torch.exp(bp["A_log"])  # (b, s, h) log decay
    # pad to a chunk multiple: zero-decay, zero-input steps leave the state
    chunk = min(cfg.ssm_chunk, s)
    pad = (-s) % chunk
    xd = x * dt[..., None]
    if pad:
        xd = F.pad(xd, (0, 0, 0, 0, 0, pad))
        dta, Bm_p, Cm_p = F.pad(dta, (0, 0, 0, pad)), F.pad(Bm, (0, 0, 0, pad)), \
            F.pad(Cm, (0, 0, 0, pad))
    else:
        Bm_p, Cm_p = Bm, Cm
    if isinstance(xd, DTensor):
        y, new_ssm = _ssd_local(xd, dta, Bm_p, Cm_p, chunk, ssm_state)
    else:
        y, new_ssm = ssd_chunked(xd, dta, Bm_p, Cm_p, chunk, ssm_state)
    y = y[:, :s] + bp["D"][None, None, :, None] * x
    return _out(bp, u, y.reshape(b, s, d_inner), z), new_conv, new_ssm


def block_decode(cfg: ArchConfig, bp: dict, u: torch.Tensor, conv_state, ssm_state):
    """O(1) recurrent step. u [B, 1, D]."""
    d_inner, n_heads, _ = dims(cfg)
    z, x, Bm, Cm, dt_raw, new_conv = _in_proj(cfg, bp, u, conv_state)
    b = x.shape[0]
    x = x.reshape(b, n_heads, cfg.ssm_head_dim)  # one step
    dt = F.softplus(dt_raw[:, 0] + bp["dt_bias"])  # (b, h)
    decay = torch.exp(dt * -torch.exp(bp["A_log"]))  # (b, h)
    # S = S * decay + dt * x (outer) B
    dbx = (dt[:, :, None] * x)[..., None] * Bm[:, 0, None, None, :]
    new_ssm = ssm_state * decay[:, :, None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", new_ssm, Cm[:, 0]) + bp["D"][None, :, None] * x
    return _out(bp, u, y.reshape(b, 1, d_inner), z), new_conv, new_ssm


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Random params from ``seed``, drawn by a generator on ``device`` (the
    CPU by default)."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    dev = gen.device
    layers = [init_block(cfg, gen, dtype) for _ in range(cfg.n_layers)]
    table = torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen, dtype=dtype, device=dev)
    return {
        "embed": {"table": table * 0.02},
        "layers": layers,
        "final_norm": L.init_norm("rmsnorm", cfg.d_model, dtype, dev),
        "lm_head": L.init_linear(gen, cfg.d_model, cfg.vocab_padded, False, dtype),
    }


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = constrain(L.norm_apply("rmsnorm", params["final_norm"], x), "gathered")
    return L.head_logits(x, params["lm_head"]["w"])


def forward(cfg: ArchConfig, params: dict, batch: dict, *, remat: bool = False,
            **_) -> torch.Tensor:
    """Float forward: logits.  ``remat`` recomputes each block's
    activations in the backward pass."""
    x = L.embed_lookup(params["embed"]["table"], batch["tokens"])

    def body(x, bp):
        x = constrain(x, "residual")
        x, _, _ = block_forward(cfg, bp, x)
        return constrain(x, "residual")

    for bp in params["layers"]:
        x = checkpoint(body, x, bp, use_reentrant=False) if remat else body(x, bp)
    return _head(params, x)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *, remat: bool = False,
            **_) -> torch.Tensor:
    return L.token_nll(forward(cfg, params, batch, remat=remat), batch["labels"], cfg.vocab)


def init_cache(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    _, n_heads, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, D_CONV - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=dtype, device=device),
        "len": torch.tensor(0, dtype=torch.int32),
    }


def prefill(cfg: ArchConfig, params: dict, batch: dict, max_len: int = 0):
    """The prompt's forward, capturing each block's states.  Returns the
    last-token logits [B, 1, vocab_padded] and the cache."""
    x = L.embed_lookup(params["embed"]["table"], batch["tokens"])
    convs, ssms = [], []
    for bp in params["layers"]:
        x, conv, ssm = block_forward(cfg, bp, x)
        convs.append(conv)
        ssms.append(ssm)
    cache = {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
             "len": torch.tensor(x.shape[1], dtype=torch.int32)}
    return _head(params, x[:, -1:]), cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict, token: torch.Tensor):
    """One token [B, 1].  Returns the logits [B, 1, vocab_padded] and a new cache."""
    x = L.embed_lookup(params["embed"]["table"], token)
    convs, ssms = [], []
    for l, bp in enumerate(params["layers"]):
        x, conv, ssm = block_decode(cfg, bp, x, cache["conv"][l], cache["ssm"][l])
        convs.append(conv)
        ssms.append(ssm)
    new_cache = {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
                 "len": torch.tensor(int(cache["len"]) + 1, dtype=torch.int32)}
    return _head(params, x), new_cache
