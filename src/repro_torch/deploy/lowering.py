"""Lowering: ArchConfig -> operator graph -> passes -> DeploymentPlan (torch port).

:func:`build_runtime_encoder_graph` is the graph of the code the runtime
executes (``repro_torch.models.encoder.forward_w8a8``): embedding +
positional add, per-layer [LN -> QKV -> MHA -> O -> Add -> LN ->
FFN(GELU) -> Add], final LN and the tied MLM classifier.  Every node
carries the quantization scales of its site, so the plan is
self-contained.

``lower()`` runs the pass pipeline (MHA fusion, ita_supports-driven
engine mapping, GELU epilogue fusion), solves the geometric tiling for
every accelerated node, computes the static memory layout and emits a
:class:`~repro_torch.deploy.plan.DeploymentPlan` — node for node, tensor
for tensor the plan the JAX package lowers.  The decoder family's plan
pair is not ported yet: every family but ``encoder`` raises
:class:`UnsupportedFamilyError`.
"""

from __future__ import annotations

import heapq
from dataclasses import asdict

from repro_torch.configs.base import ArchConfig
from repro_torch.core.heterogeneous import ITA_GRANULE
from repro_torch.deploy import memory as memlib
from repro_torch.deploy import patterns, tiler
from repro_torch.deploy.graph import Graph
from repro_torch.deploy.plan import DeploymentPlan, PlanNode, TensorSpec

# mirrors repro_torch.models.encoder / repro_torch.models.layers defaults
_S_GAMMA = 1.0 / 64.0
_DEF_S_ACT = 0.05
_DEF_S_RES = 0.08
_DEF_S_W = 0.01

#: families ``lower()`` can compile today
SUPPORTED_FAMILIES = ("encoder",)


class UnsupportedFamilyError(NotImplementedError):
    """Raised by :func:`lower` for model families the port cannot compile yet."""

    def __init__(self, cfg: ArchConfig, detail: str = ""):
        self.family = cfg.family
        self.arch = cfg.name
        msg = (
            f"plan lowering does not support family {cfg.family!r} "
            f"(config {cfg.name!r}); supported families: {', '.join(SUPPORTED_FAMILIES)}"
        )
        if detail:
            msg += f" — {detail}"
        super().__init__(msg)


def build_runtime_encoder_graph(
    cfg: ArchConfig,
    seq_len: int | None = None,
    *,
    s_act: float = _DEF_S_ACT,
    s_res: float = _DEF_S_RES,
    s_w: float = _DEF_S_W,
    include_head: bool = True,
) -> Graph:
    """Operator graph of the executable int8 encoder path.

    Node-for-node mirror of ``qlayer_fwd_encoder``: the QKV projection is
    emitted as three MatMuls over column slices of the fused ``wqkv``
    weight (bit-identical to one fused GEMM — integer accumulation is
    column-separable), which is exactly the un-fused form the MHA pattern
    matcher expects.
    """
    s = seq_len or cfg.max_seq
    e, h, hkv, p, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    g = Graph()

    sc_q = (s_act, s_w, s_act)  # every qlinear site in the uniform QuantConfig
    sc_res = (s_res, s_act, s_res)  # residual add grid
    norm_kind = cfg.norm

    def add_norm(x, prefix, out_name):
        params = [x]
        if norm_kind != "np_layernorm":
            params.append(g.add_tensor(prefix + "_g", (e,), weight=True))
        if norm_kind == "layernorm":
            params.append(g.add_tensor(prefix + "_b", (e,), dtype="int32", weight=True))
        out = g.add_tensor(out_name, (s, e))
        g.add_node("LayerNorm", params, [out], dims=(s, e), norm=norm_kind,
                   s_gamma=_S_GAMMA, s_out=s_act)
        return out

    def add_linear(x, w_name, dims, out_name, heads=None, **extra):
        m, k, n = dims
        w = g.add_tensor(w_name, (k, n), weight=True)
        b = g.add_tensor(w_name + "_b", (n,), dtype="int32", weight=True)
        out = g.add_tensor(out_name, (m, n) if heads is None else (heads, m, n))
        attrs = dict(dims=dims, scales=sc_q, **extra)
        g.add_node("MatMul", [x, w, b], [out], **attrs)
        return out

    # -- prologue: embedding (tokens) or direct int8 features + positions
    if cfg.vocab:
        tok = g.add_tensor("tokens", (s,), dtype="int32")
        g.inputs.append(tok)
        table = g.add_tensor("embed_table", (cfg.vocab, e), weight=True)
        x0 = g.add_tensor("embed", (s, e))
        g.add_node("Embed", [table, tok], [x0], dims=(s, e))
    else:
        x0 = g.add_tensor("patches" if cfg.n_patches else "frames", (s, e))
        g.inputs.append(x0)
    pos = g.add_tensor("pos", (s, e), weight=True)
    x = g.add_tensor("x0", (s, e))
    g.add_node("Add", [x0, pos], [x], dims=(s, e), scales=(s_res, s_res, s_res))

    # -- encoder stack (the executable model has no bottleneck / FFN stack)
    for l in range(cfg.n_layers):
        pre = f"l{l}_"
        h1 = add_norm(x, pre + "norm1", pre + "ln1")
        q = add_linear(h1, pre + "wq", (s, e, h * p), pre + "q")
        k = add_linear(h1, pre + "wk", (s, e, hkv * p), pre + "k")
        v = add_linear(h1, pre + "wv", (s, e, hkv * p), pre + "v")
        logits = g.add_tensor(pre + "qk", (h, s, s))
        g.add_node("MatMul", [q, k], [logits], dims=(s, p, s), heads=h,
                   transpose_b=True, scales=sc_q)
        a = g.add_tensor(pre + "a", (h, s, s))
        g.add_node("Softmax", [logits], [a], dims=(h, s, s), scales=(s_act, s_act))
        av = g.add_tensor(pre + "av", (s, h * p))
        g.add_node("MatMul", [a, v], [av], dims=(s, s, p), heads=h, scales=sc_q)
        o = add_linear(av, pre + "wo", (s, h * p, e), pre + "o")
        x2 = g.add_tensor(pre + "res1", (s, e))
        g.add_node("Add", [x, o], [x2], dims=(s, e), scales=sc_res)

        h2 = add_norm(x2, pre + "norm2", pre + "ln2")
        up = add_linear(h2, pre + "up", (s, e, f), pre + "up_out")
        gl = g.add_tensor(pre + "gelu", (s, f))
        g.add_node("GELU", [up], [gl], dims=(s, f), scales=(s_act, s_act))
        dn = add_linear(gl, pre + "down", (s, f, e), pre + "down_out")
        x3 = g.add_tensor(pre + "res2", (s, e))
        g.add_node("Add", [x2, dn], [x3], dims=(s, e), scales=sc_res)
        x = x3

    # -- epilogue: final norm, then tied MLM head or dequantized features
    hf = add_norm(x, "final_norm", "hfinal")
    if cfg.vocab and include_head:
        out = g.add_tensor("logits", (s, cfg.vocab), dtype="float32")
        g.add_node("Classifier", [hf, "embed_table"], [out],
                   dims=(s, e, cfg.vocab), scale=s_act * s_res)
    else:
        out = g.add_tensor("features", (s, e), dtype="float32")
        g.add_node("Dequant", [hf], [out], dims=(s, e), scale=s_act)
    g.outputs.append(out)
    return g.validate()


def schedule(g: Graph) -> list:
    """Topological schedule (Kahn, original order as tie-break).

    Graph construction already emits def-before-use order; this recomputes
    it from the dependency structure so rewritten graphs (fusion passes,
    hand-built test graphs) are scheduled correctly, and cycles fail loudly.
    """
    pos = {n.name: i for i, n in enumerate(g.nodes)}
    preds: dict[str, set[str]] = {}
    succs: dict[str, list[str]] = {}
    by_name = {n.name: n for n in g.nodes}
    for n in g.nodes:
        srcs = set()
        for t in n.inputs:
            prod = g.producer_of(t)
            if prod is not None and prod.name != n.name:
                srcs.add(prod.name)
        preds[n.name] = srcs
        for src in srcs:  # deduplicated: one edge per producer, matching indeg
            succs.setdefault(src, []).append(n.name)
    ready = [(pos[name], name) for name, ps in preds.items() if not ps]
    heapq.heapify(ready)
    order = []
    indeg = {name: len(ps) for name, ps in preds.items()}
    while ready:
        _, name = heapq.heappop(ready)
        order.append(by_name[name])
        for nxt in succs.get(name, ()):
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                heapq.heappush(ready, (pos[nxt], nxt))
    if len(order) != len(g.nodes):
        stuck = sorted(set(by_name) - {n.name for n in order})
        raise ValueError(f"graph has a cycle through {stuck[:5]}")
    return order


def _tiling_dict(t) -> dict:
    kind = "gemm" if isinstance(t, tiler.GemmTiling) else "mha"
    return {"type": kind, **asdict(t)}


def _emit_plan(
    cfg: ArchConfig,
    g: Graph,
    *,
    seq_len: int,
    granule: int,
    budget: int,
    quant: dict,
    head_by_head: bool = False,
) -> DeploymentPlan:
    """Engine-mapped graph -> scheduled, tiled, allocated DeploymentPlan."""
    order = schedule(g)
    g.nodes = order  # canonical schedule order for the memory planner

    tilings = {
        name: _tiling_dict(t)
        for name, t in tiler.tile_graph(g, granule=granule, budget=budget).items()
    }
    # .check() raises MemoryPlanError naming the offending tensor pair
    mem = memlib.plan_memory(g).check()

    tensors = {}
    for name, info in g.tensors.items():
        alloc = mem.allocations.get(name)
        tensors[name] = TensorSpec(
            name=name,
            shape=tuple(info.shape),
            dtype=info.dtype,
            weight=name in g.weights,
            offset=None if alloc is None else alloc.offset,
            size=0 if alloc is None else alloc.size,
        )

    nodes = [
        PlanNode(
            name=n.name,
            op=n.op,
            kind=patterns.KIND_BY_OP.get(n.op, n.op.lower()),
            engine=n.engine or "cluster",
            inputs=tuple(n.inputs),
            outputs=tuple(n.outputs),
            attrs={k: tuple(v) if isinstance(v, list) else v for k, v in n.attrs.items()},
        )
        for n in g.nodes
    ]
    return DeploymentPlan(
        arch=cfg.name,
        seq_len=seq_len,
        granule=granule,
        head_by_head=head_by_head,
        quant=quant,
        nodes=nodes,
        tensors=tensors,
        inputs=tuple(g.inputs),
        outputs=tuple(g.outputs),
        schedule=tuple(n.name for n in nodes),
        tilings=tilings,
        memory_peak=mem.peak,
    ).validate()


def lower(
    cfg: ArchConfig,
    seq_len: int | None = None,
    *,
    head_by_head: bool = False,
    include_head: bool = True,
    granule: int = ITA_GRANULE,
    budget: int = tiler.ITA_L1_BYTES,
    s_act: float = _DEF_S_ACT,
    s_res: float = _DEF_S_RES,
    s_w: float = _DEF_S_W,
) -> DeploymentPlan:
    """Compile one encoder config into its forward :class:`DeploymentPlan`."""
    if cfg.family != "encoder":
        raise UnsupportedFamilyError(cfg)
    g = build_runtime_encoder_graph(
        cfg, seq_len, s_act=s_act, s_res=s_res, s_w=s_w, include_head=include_head
    )
    g = patterns.deploy_pipeline(g, head_by_head=head_by_head, granule=granule)
    return _emit_plan(
        cfg, g,
        seq_len=seq_len or cfg.max_seq,
        granule=granule, budget=budget,
        quant={"s_act": s_act, "s_res": s_res, "s_w": s_w},
        head_by_head=head_by_head,
    )
