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
for tensor the plan the JAX package lowers.

:func:`build_runtime_decoder_graph` is the dense decoder's mirror of
``repro_torch.models.transformer.qlayer_fwd``: per-layer [Norm -> sliced
QKV -> RoPE -> cache write -> causal/cached GQA attention -> O -> Add ->
Norm -> SwiGLU or fused-GELU MLP -> Add], final norm and the (tied) LM
head, lowered twice per config into a :class:`DecoderPlanPair` — a
prefill and a single-token decode schedule sharing one persistent KV
region.  The paged KV region (``kv_blocks > 0``) waits for ROADMAP queue
1, item 3; families other than ``encoder`` and dense decoders raise
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
from repro_torch.deploy.plan import DecoderPlanPair, DeploymentPlan, PlanNode, TensorSpec

# mirrors repro_torch.models.encoder / repro_torch.models.layers defaults
_S_GAMMA = 1.0 / 64.0
_DEF_S_ACT = 0.05
_DEF_S_RES = 0.08
_DEF_S_W = 0.01

#: families ``lower()`` can compile today
SUPPORTED_FAMILIES = ("encoder", "dense")


def is_dense_decoder(cfg: ArchConfig) -> bool:
    """Does this config lower to a :class:`DecoderPlanPair`?  The one
    definition of the dense-decoder rule (``lower()``, ``api.compile`` and
    the launcher branch on it)."""
    return cfg.family == "dense" and not cfg.n_experts


class UnsupportedFamilyError(NotImplementedError):
    """Raised by :func:`lower` for model families the port cannot compile yet."""

    def __init__(self, cfg: ArchConfig, detail: str = ""):
        self.family = cfg.family
        self.arch = cfg.name
        msg = (
            f"plan lowering does not support family {cfg.family!r} "
            f"(config {cfg.name!r}); supported families: {', '.join(SUPPORTED_FAMILIES)} "
            "(dense decoders without experts)"
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


#: model-path attention block sizes (``models.transformer`` defaults);
#: baked into the plan so the flash-ITAMax block partitioning — and hence
#: the bit pattern — matches `prefill_w8a8` / `decode_step_w8a8` exactly.
PREFILL_BLOCK_K = 512
DECODE_BLOCK_K = 2048


def build_runtime_decoder_graph(
    cfg: ArchConfig,
    seq_len: int | None = None,
    *,
    phase: str = "prefill",
    max_len: int | None = None,
    kv_block_size: int = 0,
    kv_blocks: int = 0,
    s_act: float = _DEF_S_ACT,
    s_res: float = _DEF_S_RES,
    s_w: float = _DEF_S_W,
) -> tuple[Graph, list[tuple[str | None, str]]]:
    """Operator graph of the executable int8 decoder path, one phase.

    Node-for-node mirror of ``qlayer_fwd`` (the single integer layer both
    ``prefill_w8a8`` and ``decode_step_w8a8`` run): the fused ``wqkv``
    projection is emitted as three column-slice MatMuls (bit-identical,
    integer accumulation is column-separable), RoPE / cache maintenance /
    SiLU are explicit cluster nodes, and attention is one fused node per
    layer (causal flash for prefill, cache-masked for decode).

    Returns ``(graph, kv_state)`` where ``kv_state`` lists the KV-cache
    tensors in layer order, K before V, as ``(cache_in | None,
    cache_out)`` pairs — prefill creates the caches, decode consumes and
    in-place-updates them.

    ``kv_blocks > 0`` (the paged variant of the JAX package) raises
    ``NotImplementedError``: paging is ROADMAP queue 1, item 3.
    """
    if phase not in ("prefill", "decode"):
        raise ValueError(f"unknown decoder phase {phase!r}")
    if not (cfg.vocab and cfg.n_heads):
        raise NotImplementedError(f"decoder lowering needs a token LM; got {cfg.name}")
    if kv_blocks > 0:
        raise NotImplementedError(
            "the paged KV region is not ported yet (ROADMAP queue 1, item 3)")
    s = 1 if phase == "decode" else (seq_len or cfg.max_seq)
    cap = max_len or ((seq_len or cfg.max_seq) + 1)
    e, h, hkv, p, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    pad_m = phase != "decode"  # decode GEMMs are M=1 GEMVs -> cluster
    g = Graph()

    sc_q = (s_act, s_w, s_act)
    sc_res = (s_res, s_act, s_res)
    norm_kind = cfg.norm

    def add_norm(x, prefix, out_name, rows):
        params = [x]
        if norm_kind != "np_layernorm":
            params.append(g.add_tensor(prefix + "_g", (e,), weight=True))
        if norm_kind == "layernorm":
            params.append(g.add_tensor(prefix + "_b", (e,), dtype="int32", weight=True))
        out = g.add_tensor(out_name, (rows, e))
        g.add_node("LayerNorm", params, [out], dims=(rows, e), norm=norm_kind,
                   s_gamma=_S_GAMMA, s_out=s_act)
        return out

    def add_linear(x, w_name, dims, out_name, bias=False, **extra):
        m, k, n = dims
        ins = [x, g.add_tensor(w_name, (k, n), weight=True)]
        if bias:
            ins.append(g.add_tensor(w_name + "_b", (n,), dtype="int32", weight=True))
        out = g.add_tensor(out_name, (m, n))
        g.add_node("MatMul", ins, [out], dims=dims, scales=sc_q, pad_m=pad_m, **extra)
        return out

    # -- prologue: token embedding (the embed table is on the s_res grid)
    tok_name = "tokens" if phase == "prefill" else "token"
    tok = g.add_tensor(tok_name, (s,), dtype="int32")
    g.inputs.append(tok)
    pos_in: list[str] = []
    if phase == "decode":  # per-request depth
        g.inputs.append(g.add_tensor("pos", (), dtype="int32"))
        pos_in = ["pos"]
    table = g.add_tensor("embed_table", (cfg.vocab_padded, e), weight=True)
    x = g.add_tensor("embed", (s, e))
    g.add_node("Embed", [table, tok], [x], dims=(s, e))

    # -- decoder stack
    kv_state: list[tuple[str | None, str]] = []
    cache_shape = (hkv, cap, p)
    for l in range(cfg.n_layers):
        pre = f"l{l}_"
        h1 = add_norm(x, pre + "norm1", pre + "ln1", s)
        qm = add_linear(h1, pre + "wq", (s, e, h * p), pre + "q", bias=cfg.qkv_bias)
        km = add_linear(h1, pre + "wk", (s, e, hkv * p), pre + "k", bias=cfg.qkv_bias)
        vm = add_linear(h1, pre + "wv", (s, e, hkv * p), pre + "v", bias=cfg.qkv_bias)
        if cfg.rope:
            qr = g.add_tensor(pre + "q_rot", (s, h * p))
            g.add_node("Rope", [qm] + pos_in, [qr], dims=(s, h * p), heads=h,
                       head_dim=p, theta=cfg.rope_theta)
            kr = g.add_tensor(pre + "k_rot", (s, hkv * p))
            g.add_node("Rope", [km] + pos_in, [kr], dims=(s, hkv * p), heads=hkv,
                       head_dim=p, theta=cfg.rope_theta)
        else:
            qr, kr = qm, km

        kname, vname = pre + "k_cache", pre + "v_cache"
        cache_attrs = dict(dims=cache_shape, kv_heads=hkv, head_dim=p, max_len=cap)
        blk = PREFILL_BLOCK_K if phase == "prefill" else DECODE_BLOCK_K
        if phase == "prefill":
            kc = g.add_tensor(kname, cache_shape)
            g.add_node("CacheWrite", [kr], [kc], **cache_attrs)
            vc = g.add_tensor(vname, cache_shape)
            g.add_node("CacheWrite", [vm], [vc], **cache_attrs)
            kv_state += [(None, kc), (None, vc)]
            att_in, att_op = [qr, kr, vm], "AttnPrefill"
        else:
            kin = g.add_tensor(kname, cache_shape)
            vin = g.add_tensor(vname, cache_shape)
            g.inputs += [kin, vin]
            kc = g.add_tensor(kname + "_new", cache_shape)
            g.add_node("CacheWrite", [kr, kin, "pos"], [kc], **cache_attrs)
            vc = g.add_tensor(vname + "_new", cache_shape)
            g.add_node("CacheWrite", [vm, vin, "pos"], [vc], **cache_attrs)
            kv_state += [(kin, kc), (vin, vc)]
            att_in, att_op = [qr, kc, vc, "pos"], "AttnDecode"

        av = g.add_tensor(pre + "att", (s, h * p))
        g.add_node(att_op, att_in, [av], dims=(s, h * p), seq=s, heads=h,
                   kv_heads=hkv, head_dim=p, s_act=s_act, s_out=s_act, block_k=blk)
        o = add_linear(av, pre + "wo", (s, h * p, e), pre + "o")
        x2 = g.add_tensor(pre + "res1", (s, e))
        g.add_node("Add", [x, o], [x2], dims=(s, e), scales=sc_res)

        h2 = add_norm(x2, pre + "norm2", pre + "ln2", s)
        if cfg.mlp == "swiglu":
            gt = add_linear(h2, pre + "gate", (s, e, f), pre + "gate_out")
            up = add_linear(h2, pre + "up", (s, e, f), pre + "up_out")
            sm = g.add_tensor(pre + "silu", (s, f))
            g.add_node("SiluMul", [gt, up], [sm], dims=(s, f),
                       scales=(s_act, s_act, s_act))
            dn = add_linear(sm, pre + "down", (s, f, e), pre + "down_out")
        else:  # gelu MLP: activation fused into the up-projection epilogue
            up = add_linear(h2, pre + "up", (s, e, f), pre + "up_out", bias=True,
                            activation="gelu", s_preact=s_act)
            dn = add_linear(up, pre + "down", (s, f, e), pre + "down_out", bias=True)
        x3 = g.add_tensor(pre + "res2", (s, e))
        g.add_node("Add", [x2, dn], [x3], dims=(s, e), scales=sc_res)
        x = x3

    # -- epilogue: last-token slice (prefill), final norm, LM head
    if phase == "prefill":
        xl = g.add_tensor("x_last", (1, e))
        g.add_node("LastTok", [x], [xl], dims=(1, e))
        x = xl
    hf = add_norm(x, "final_norm", "hfinal", 1)
    tied = cfg.tie_embeddings
    w_head = "embed_table" if tied else g.add_tensor(
        "lm_head", (e, cfg.vocab_padded), weight=True)
    out = g.add_tensor("logits", (1, cfg.vocab_padded), dtype="float32")
    g.add_node("LMHead", [hf, w_head], [out], dims=(1, e, cfg.vocab_padded),
               scale=s_act * s_w, tied=tied)
    g.outputs.append(out)
    g.outputs += [cout for _, cout in kv_state]
    return g.validate(), kv_state


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
    phase: str = "forward",
    max_len: int = 0,
    kv_state: tuple = (),
    persistent: tuple = (),
    aliases: dict | None = None,
) -> DeploymentPlan:
    """Engine-mapped graph -> scheduled, tiled, allocated DeploymentPlan."""
    order = schedule(g)
    g.nodes = order  # canonical schedule order for the memory planner

    tilings = {
        name: _tiling_dict(t)
        for name, t in tiler.tile_graph(g, granule=granule, budget=budget).items()
    }
    # .check() raises MemoryPlanError naming the offending tensor pair
    mem = memlib.plan_memory(g, persistent=persistent, aliases=aliases).check()

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
        phase=phase,
        max_len=max_len,
        kv_state=kv_state,
    ).validate()


def lower_decoder(
    cfg: ArchConfig,
    seq_len: int | None = None,
    *,
    max_len: int | None = None,
    kv_block_size: int = 0,
    kv_blocks: int = 0,
    fuse: bool = False,
    fuse_min_nodes: int = 2,
    granule: int = ITA_GRANULE,
    budget: int = tiler.ITA_L1_BYTES,
    s_act: float = _DEF_S_ACT,
    s_res: float = _DEF_S_RES,
    s_w: float = _DEF_S_W,
) -> DecoderPlanPair:
    """Compile one decoder config into a linked prefill/decode plan pair.

    Both schedules are planned against the same persistent KV-cache
    region: the cache tensors carry whole-schedule lifetimes and are
    placed deterministically, so their static offsets agree across the
    two plans (asserted by ``DecoderPlanPair.validate``).  Engine mapping
    runs the same ``ita_supports`` predicate as the encoder flow — the
    prefill GEMMs accelerate, the decode-step M=1 GEMVs fall back to the
    cluster (``pad_m: False``, see ``patterns.node_opdesc``).

    ``kv_blocks > 0`` (the paged KV region) raises
    ``NotImplementedError``: ROADMAP queue 1, item 3.

    ``fuse=True`` runs the region-fusion pass on both schedules after
    tiling/memory planning: contiguous same-engine runs collapse into
    ``FusedRegion`` mega-nodes (:func:`patterns.fuse_regions` — bit-exact
    vs the unfused plans, persistent KV writes stay top-level).
    """
    s = seq_len or cfg.max_seq
    cap = max_len or (s + 1)
    if (kv_blocks > 0) != (kv_block_size > 0):
        raise ValueError(
            "paged lowering needs both kv_block_size and kv_blocks "
            f"(got kv_block_size={kv_block_size}, kv_blocks={kv_blocks})"
        )
    quant = {"s_act": s_act, "s_res": s_res, "s_w": s_w}

    def one(phase: str) -> DeploymentPlan:
        g, kv_state = build_runtime_decoder_graph(
            cfg, s, phase=phase, max_len=cap, kv_block_size=kv_block_size,
            kv_blocks=kv_blocks, s_act=s_act, s_res=s_res, s_w=s_w
        )
        g = patterns.map_engines(g, granule)
        persistent = tuple(cin if cin is not None else cout for cin, cout in kv_state)
        aliases = {cout: cin for cin, cout in kv_state if cin is not None}
        plan = _emit_plan(
            cfg, g,
            seq_len=s if phase == "prefill" else 1,
            granule=granule, budget=budget, quant=quant,
            phase=phase, max_len=cap, kv_state=tuple(kv_state),
            persistent=persistent, aliases=aliases,
        )
        return patterns.fuse_regions(plan, min_nodes=fuse_min_nodes) if fuse else plan

    return DecoderPlanPair(
        arch=cfg.name, seq_len=s, max_len=cap,
        prefill=one("prefill"), decode=one("decode"),
        kv_block_size=kv_block_size, kv_blocks=kv_blocks,
    ).validate()


def lower(
    cfg: ArchConfig,
    seq_len: int | None = None,
    *,
    head_by_head: bool = False,
    include_head: bool = True,
    max_len: int | None = None,
    kv_block_size: int = 0,
    kv_blocks: int = 0,
    fuse: bool = False,
    fuse_min_nodes: int = 2,
    granule: int = ITA_GRANULE,
    budget: int = tiler.ITA_L1_BYTES,
    s_act: float = _DEF_S_ACT,
    s_res: float = _DEF_S_RES,
    s_w: float = _DEF_S_W,
) -> DeploymentPlan | DecoderPlanPair:
    """Compile one config into its executable deployment artifact.

    Encoder family: a forward :class:`DeploymentPlan`.  Dense decoders: a
    :class:`DecoderPlanPair` — prefill and decode-step schedules linked
    through a shared static KV region of ``max_len`` tokens per slot.
    """
    if is_dense_decoder(cfg):
        if head_by_head or not include_head:
            raise NotImplementedError(
                "head_by_head/include_head are encoder-only options; the "
                "decoder pair always emits fused attention + an LM head"
            )
        return lower_decoder(
            cfg, seq_len, max_len=max_len, kv_block_size=kv_block_size,
            kv_blocks=kv_blocks, fuse=fuse, fuse_min_nodes=fuse_min_nodes,
            granule=granule, budget=budget,
            s_act=s_act, s_res=s_res, s_w=s_w,
        )
    if kv_blocks or kv_block_size:
        raise ValueError(
            "kv_block_size/kv_blocks configure the decoder KV region; "
            f"{cfg.name} does not lower to a decoder plan pair"
        )
    if fuse:
        raise NotImplementedError(
            "region fusion targets the decode hot path; encoder plans lower unfused"
        )
    if cfg.family != "encoder":
        detail = ""
        if cfg.family == "dense":  # dense shell around an expert MLP
            detail = f"dense config with n_experts={cfg.n_experts} routes as MoE"
        raise UnsupportedFamilyError(cfg, detail)
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
