"""Mixture-of-Experts FFN (GShard-style dispatch), float and integer (w8a8) paths — torch port.

Routing and combine run in float32 on the "cluster" path (the paper's
auxiliary-op rule: data-dependent control flow is no ITA op); the expert
products are int8 with int32 accumulation on the integer path.

Dispatch is the capacity-based form of the JAX package, grouped to keep
its cost linear in sequence length, with experts padded to a multiple of
:data:`EP_PAD_TO` (padded experts get -1e9 router logits and no tokens).
Three choices keep the port on the reference's ints:

- the top-k is a stable descending sort, so that equal probabilities
  pick the lower expert first, as ``jax.lax.top_k`` does (``torch.topk``
  promises no order between ties);
- ``dispatch`` and ``combine`` are built by scatter: each (token, k)
  owns one (expert, slot) cell, so every entry is exactly 0, 1 or the
  token's normalised router weight;
- the int8 gather of the dispatched tokens and the combine are computed
  on any device in the same order (:func:`_combine_w8a8`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quant_linear import ACT_IDENTITY  # noqa: F401  (the reference's name)
from repro_torch.models import layers as L
from repro_torch.quant.qparams import i32, imatmul, make_qparams, requantize
from repro_torch.runtime.activations import active_mesh, constrain, fits, local_shards
from repro_torch.runtime.sharding import P, axis_names, data_axes, placements

try:
    from torch.distributed.tensor import DTensor, Partial
except ImportError:  # a torch built without distributed support
    DTensor = ()

EP_PAD_TO = 16  # model-axis size of the reference's production mesh
DISPATCH_GROUP = 1024  # tokens per dispatch group


def n_experts_padded(cfg: ArchConfig) -> int:
    return int(math.ceil(cfg.n_experts / EP_PAD_TO) * EP_PAD_TO)


# ---------------------------------------------------------------------------
# Params (drawn on ``gen``'s device)
# ---------------------------------------------------------------------------


def init_moe_layer(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32,
                   device=None) -> dict:
    e = n_experts_padded(cfg)
    d, f = cfg.d_model, cfg.d_ff_expert
    device = gen.device if device is None else device

    def randn(*shape, scale):
        return (torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
                * scale).to(device)

    p = {
        "router": {"w": randn(d, e, scale=0.02)},
        "experts": {
            "gate": randn(e, d, f, scale=1 / math.sqrt(d)),
            "up": randn(e, d, f, scale=1 / math.sqrt(d)),
            "down": randn(e, f, d, scale=1 / math.sqrt(f)),
        },
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.d_ff_expert
        p["shared"] = L.init_mlp(gen, d, fs, dtype, device, kind="swiglu")
    return p


def init_qmoe_layer(cfg: ArchConfig, gen: torch.Generator) -> dict:
    e = n_experts_padded(cfg)
    d, f = cfg.d_model, cfg.d_ff_expert

    def randint(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8,
                             device=gen.device)

    p = {
        # the router stays float32: a cluster op
        "router": {"w": torch.randn((d, e), generator=gen, dtype=torch.float32,
                                    device=gen.device) * 0.02},
        "experts": {"gate_q": randint(e, d, f), "up_q": randint(e, d, f),
                    "down_q": randint(e, f, d)},
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.d_ff_expert
        p["shared"] = {
            "gate": L.init_qlinear(gen, d, fs, False),
            "up": L.init_qlinear(gen, d, fs, False),
            "down": L.init_qlinear(gen, fs, d, False),
        }
    return p


# ---------------------------------------------------------------------------
# Routing (shared by both paths; float32)
# ---------------------------------------------------------------------------


def capacity(cfg: ArchConfig, g_tokens: int) -> int:
    """Slots per expert in a group of ``g_tokens``: at least ``top_k``."""
    cap = int(math.ceil(g_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(cap, cfg.top_k)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_slots(cfg: ArchConfig, router_w: torch.Tensor, h_f32: torch.Tensor):
    """h [G, g, D] -> each (token, k)'s slot ``cell`` [G, g, K] (expert x C
    + its place in the expert's queue), ``keep`` [G, g, K] (the slot is
    within capacity), ``weight`` [G, g, K] float32 (its normalised router
    weight, 0 where dropped), and the load-balance loss: the routing
    without its dense [G, g, E, C] masks.  On DTensors each rank routes its
    own groups (``local_shards``: routing is independent across groups),
    and the loss averages the groups' terms as DTensor ops."""
    if isinstance(h_f32, DTensor):
        g_ax = _group_axes(h_f32)
        spec = P(g_ax, None, None)
        cell, keep, weight, terms = local_shards(
            lambda w, h: _route_groups(cfg, w, h), (router_w, h_f32),
            (P(None, None), spec), [spec, spec, spec, P(g_ax)])
    else:
        cell, keep, weight, terms = _route_groups(cfg, router_w, h_f32)
    return cell, keep, weight, terms.mean() * cfg.n_experts


def _route(cfg: ArchConfig, router_w: torch.Tensor, h_f32: torch.Tensor):
    """h [G, g, D] -> dispatch [G, g, E, C] (0/1), combine [G, g, E, C]
    float32, and the load-balance loss: the reference's dense form of
    ``_route_slots`` (the integer path's), each (token, k) owning one (expert,
    slot) cell, so every entry is exactly 0, 1 or the token's weight."""
    e, cap = n_experts_padded(cfg), capacity(cfg, h_f32.shape[1])

    def dense(cell, keep, weight):
        return (_slot_mask(cell, keep, e, cap, 0, torch.float32),
                _slot_mask(cell, weight, e, cap, 0, torch.float32))

    cell, keep, weight, aux = _route_slots(cfg, router_w, h_f32)
    if isinstance(cell, DTensor):
        g_ax = _group_axes(cell)
        spec, out = P(g_ax, None, None), P(g_ax, None, None, None)
        dispatch, combine = local_shards(dense, (cell, keep, weight), (spec,) * 3, [out, out])
    else:
        dispatch, combine = dense(cell, keep, weight)
    return dispatch, combine, aux


def _route_groups(cfg: ArchConfig, router_w: torch.Tensor, h_f32: torch.Tensor):
    """``_route_slots`` of plain tensors, with the load-balance loss as its
    [G] per-group terms."""
    e = n_experts_padded(cfg)
    n_g, g_tokens, _ = h_f32.shape
    cap = capacity(cfg, g_tokens)
    logits = torch.einsum("gtd,de->gte", h_f32, router_w.to(torch.float32))
    if e != cfg.n_experts:  # mask the padded experts
        pad = torch.arange(e, device=logits.device) >= cfg.n_experts
        logits = torch.where(pad, torch.full_like(logits, -1e9), logits)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, cfg.top_k)  # [G, g, K]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, k) in its expert's queue, in (t, k) order
    onehot = F.one_hot(topi, e)  # [G, g, K, E] int64
    flat = onehot.reshape(n_g, -1, e)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1).reshape(topi.shape)
    keep = pos < cap
    cell = topi * cap + torch.clamp(pos, max=cap - 1)  # distinct per token
    terms = _load_balance_terms(probs[..., : cfg.n_experts],
                                onehot[..., : cfg.n_experts].to(torch.float32))
    return cell, keep, topv * keep, terms


def _load_balance_terms(probs: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss: its [G] per-group terms
    (the loss is their mean times the experts)."""
    density = onehot.sum(2).mean(1)  # [G, E] fraction routed
    density_proxy = probs.mean(1)  # [G, E] mean router probability
    return (density * density_proxy).sum(-1)


def _group_axes(x):
    """The data axes a DTensor of groups [G, ...] splits its groups over."""
    mesh = active_mesh() or x.device_mesh
    da = data_axes(mesh)
    return da if fits(x.shape[0], da, mesh) else None


def _expert_axis(x, n_experts: int):
    """"model" where it splits the experts of ``x``'s mesh evenly, else None."""
    mesh = active_mesh() or x.device_mesh
    names = axis_names(mesh)
    if "model" not in names or mesh.size(names.index("model")) == 1:
        return None
    return "model" if fits(n_experts, "model", mesh) else None


def _group(x: torch.Tensor, g: int):
    t = x.shape[0]
    if t % g:
        g = t  # one group for token counts that do not divide
    return x.reshape(t // g, g, *x.shape[1:]), g


# ---------------------------------------------------------------------------
# Float path
# ---------------------------------------------------------------------------


def moe_ffn(cfg: ArchConfig, p: dict, h: torch.Tensor):
    """h [B, S, D] -> (out [B, S, D], aux_loss)."""
    b, s, d = h.shape
    grouped, g_tokens = _group(h.reshape(b * s, d), DISPATCH_GROUP)
    cell, keep, weight, aux = _route_slots(cfg, p["router"]["w"], grouped.to(torch.float32))
    ex = p["experts"]
    cap = capacity(cfg, g_tokens)
    args = (cell, keep, weight, grouped, ex["gate"], ex["up"], ex["down"])
    if isinstance(grouped, DTensor):
        # expert parallelism on each rank's shards: a rank runs its own
        # experts ("model") on its groups (the data axes), and the rows of
        # each token are a sum over the experts' ranks still to reduce
        mesh = active_mesh() or grouped.device_mesh
        names = axis_names(mesh)
        g_ax, e_ax = _group_axes(grouped), _expert_axis(grouped, ex["gate"].shape[0])
        first = 0
        if e_ax:  # this rank's first expert
            first = mesh.get_local_rank(names.index("model")) * (
                ex["gate"].shape[0] // mesh.size(names.index("model")))
        slots, w = P(g_ax, None, None), P(e_ax, None, None)
        out_pl = tuple(Partial() if e_ax and n == "model" else pl for n, pl in zip(
            names, placements(mesh, P(g_ax, None, None))))
        out = local_shards(lambda *a: _experts_f32(*a, cap=cap, first=first), args,
                           (slots, slots, slots, slots, w, w, w), out_pl, mesh=mesh)
    else:
        out = _experts_f32(*args, cap=cap)
    out = out.reshape(b, s, d)
    if "shared" in p:
        out = out + L.mlp_forward(p["shared"], h, "swiglu")
    return out, aux


def _slot_mask(cell, vals, n_experts: int, cap: int, first: int, dtype):
    """The [G, g, E, C] mask of ``_route``'s form over the experts ``first ..
    first + n_experts - 1`` alone, made in ``dtype``: ``vals`` [G, g, K] at
    each (token, k)'s slot ``cell``; slots of other experts are left out."""
    n_g, g_tokens, _ = cell.shape
    local = cell - first * cap
    inside = (local >= 0) & (local < n_experts * cap)
    zeros = torch.zeros((n_g, g_tokens, n_experts * cap), dtype=dtype, device=cell.device)
    # a token's slots are distinct: the sum only adds the zeros of the
    # slots left out, sent to slot 0
    mask = zeros.scatter_add(2, torch.where(inside, local, 0),
                             torch.where(inside, vals.to(dtype), 0))
    return mask.reshape(n_g, g_tokens, n_experts, cap)


def _experts_f32(cell, keep, weight, grouped, gate, up, down, *, cap: int, first: int = 0):
    """Dispatch -> the experts' SwiGLU -> combine, of plain tensors: the
    experts ``first ..`` (``gate``'s length of them), their masks made from
    ``_route_slots``' slots in ``grouped``'s dtype (the values the float32
    masks round to) and for these experts alone."""
    e = gate.shape[0]
    dispatch = _slot_mask(cell, keep, e, cap, first, grouped.dtype)
    xe = torch.einsum("gtec,gtd->gecd", dispatch, grouped)
    del dispatch
    xe = constrain(xe, "experts")
    ge = torch.einsum("gecd,edf->gecf", xe, gate)
    ue = torch.einsum("gecd,edf->gecf", xe, up)
    ye = torch.einsum("gecf,efd->gecd", L.silu(ge) * ue, down)
    return torch.einsum("gtec,gecd->gtd", _slot_mask(cell, weight, e, cap, first, ye.dtype), ye)


# ---------------------------------------------------------------------------
# Integer path (expert products int8; routing and combine float32 cluster ops)
# ---------------------------------------------------------------------------


def _expert_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("gecd,edf->gecf")`` of int8 operands with int32
    accumulation: one exact product per expert (``imatmul``; CUDA has no
    batched int32 product)."""
    return torch.stack([imatmul(x[:, e], w[e]) for e in range(w.shape[0])], dim=1)


def _experts_w8a8(experts: dict, grouped: torch.Tensor, dispatch: torch.Tensor,
                  q: L.QuantConfig) -> torch.Tensor:
    """The integer expert path from the routing: int8 tokens [G, g, D] and
    ``dispatch`` [G, g, E, C] -> int8 expert outputs [G, E, C, D]."""
    # the 0/1 dispatch is a gather: at most one token a slot, so the
    # float32 product is exact (every int8 is a float32, also under TF32)
    xe = torch.einsum("gtec,gtd->gecd", dispatch.to(torch.float32),
                      grouped.to(torch.float32)).to(torch.int8)
    xe = constrain(xe, "experts")
    qpa = make_qparams(q.s_act, q.s_w, q.s_act)
    ge = requantize(_expert_mm(xe, experts["gate_q"]), qpa.mult, qpa.shift)
    ue = requantize(_expert_mm(xe, experts["up_q"]), qpa.mult, qpa.shift)
    sg = L.isilu_i8(ge, q.s_act, q.s_act)
    qprod = make_qparams(q.s_act, q.s_act, q.s_act)
    inner = requantize(i32(sg) * ue, qprod.mult, qprod.shift)
    return requantize(_expert_mm(inner, experts["down_q"]), qpa.mult, qpa.shift)


def _combine_w8a8(combine: torch.Tensor, ye: torch.Tensor, q: L.QuantConfig,
                  top_k: int) -> torch.Tensor:
    """``rint(einsum("gtec,gecd->gtd", combine, ye * s_act) / s_act)`` onto
    int8 [G, g, D].

    A token has at most ``top_k`` nonzero weights in ``combine``: their
    products, each rounded to float32, are summed in ascending expert
    order, elementwise, so that the card and the CPU give the same float
    (a library product would pick its own order and fused multiply-adds).
    """
    n_g, g_tokens, e, cap = combine.shape
    w, cell = torch.topk(combine.reshape(n_g, g_tokens, e * cap), top_k, dim=-1)
    cell, order = torch.sort(cell, dim=-1)
    w = torch.gather(w, -1, order)
    ye_f = ye.to(torch.float32) * q.s_act
    rows = ye_f.reshape(n_g, 1, e * cap, -1).expand(n_g, g_tokens, e * cap, ye.shape[-1])
    picked = torch.gather(rows, 2, cell[..., None].expand(-1, -1, -1, ye.shape[-1]))
    out = w[..., 0, None] * picked[:, :, 0]
    for k in range(1, top_k):
        out = out + w[..., k, None] * picked[:, :, k]
    return torch.clamp(torch.round(out / q.s_act), -128, 127).to(torch.int8)


def moe_ffn_w8a8(cfg: ArchConfig, lp: dict, h_q: torch.Tensor, q: L.QuantConfig) -> torch.Tensor:
    """h_q int8 [B, S, D] (s_act grid) -> int8 [B, S, D] (s_act grid)."""
    b, s, d = h_q.shape
    grouped, _ = _group(h_q.reshape(b * s, d), DISPATCH_GROUP)
    h_f32 = grouped.to(torch.float32) * q.s_act
    dispatch, combine, _ = _route(cfg, lp["router"]["w"], h_f32)
    if isinstance(grouped, DTensor):
        # each rank runs its own experts on its groups; the combine then
        # takes every expert's rows, in the unsharded order (bit-exact)
        mesh = active_mesh() or grouped.device_mesh
        ex = lp["experts"]
        g_ax, e_ax = _group_axes(grouped), _expert_axis(grouped, ex["gate_q"].shape[0])
        w = P(e_ax, None, None)
        ye = local_shards(
            lambda gate_q, up_q, down_q, g, dsp: _experts_w8a8(
                {"gate_q": gate_q, "up_q": up_q, "down_q": down_q}, g, dsp, q),
            (ex["gate_q"], ex["up_q"], ex["down_q"], grouped, dispatch),
            (w, w, w, P(g_ax, None, None), P(g_ax, None, e_ax, None)),
            P(g_ax, e_ax, None, None), mesh=mesh)
        whole = P(g_ax, None, None, None)
        out_q = local_shards(lambda c, y: _combine_w8a8(c, y, q, cfg.top_k), (combine, ye),
                             (whole, whole), P(g_ax, None, None), mesh=mesh)
    else:
        ye = _experts_w8a8(lp["experts"], grouped, dispatch, q)
        out_q = _combine_w8a8(combine, ye, q, cfg.top_k)
    out_q = out_q.reshape(b, s, d)
    if "shared" in lp:
        site = L.QLinearSite(q.s_act, q.s_w, q.s_act)
        qprod = make_qparams(q.s_act, q.s_act, q.s_act)
        gq = L.qlinear(lp["shared"]["gate"], h_q, site)
        uq = L.qlinear(lp["shared"]["up"], h_q, site)
        sgq = L.isilu_i8(gq, q.s_act, q.s_act)
        innq = requantize(i32(sgq) * uq, qprod.mult, qprod.shift)
        sh = L.qlinear(lp["shared"]["down"], innq, site)
        out_q = L.iadd_i8(out_q, sh, *L.make_iadd_params(q.s_act, q.s_act, q.s_act))
    return out_q
