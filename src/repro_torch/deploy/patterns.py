"""Graph passes: MHA pattern fusion, engine mapping, GELU epilogue fusion.

Mirrors the paper's §IV-D flow: "Deeploy starts by matching an MHA pattern
and fuses it to form a monolithic node in the graph."  :func:`split_heads`
then maps the fused MHA onto ITA's single-head datapath: one ``MHAHead``
node per head, each giving an int32 partial of the output projection,
and one cluster ``HeadAccum`` that sums them.  :func:`fuse_regions` is the
plan-level pass that
collapses same-engine schedule runs of decoder plans into ``FusedRegion``
mega-nodes.

Engine mapping is driven by :func:`repro_torch.core.heterogeneous.ita_supports`
via :func:`node_opdesc` — the same predicate the runtime dispatch table
uses, so the static plan and the executor agree by construction.
"""

from __future__ import annotations

import math

from repro_torch.core.heterogeneous import ITA_GRANULE, OpDesc, ita_supports
from repro_torch.deploy.graph import Graph, Node

#: graph op -> dispatch kind (the DispatchTable vocabulary)
KIND_BY_OP = {
    "MatMul": "gemm",
    "MHA": "mha",
    "MHAHead": "mha",
    "GELU": "gelu",
    "Softmax": "softmax",
    "LayerNorm": "layernorm",
    "Add": "add",
    "HeadAccum": "headaccum",
    "Embed": "embed",
    "Classifier": "classifier",
    "Dequant": "dequant",
    # decoder / KV-cache ops (cluster kernels; see heterogeneous.py)
    "Rope": "rope",
    "AttnPrefill": "attn_causal",
    "AttnDecode": "attn_cached",
    "AttnPaged": "attn_paged",
    "CacheWrite": "cache_write",
    "CacheWritePaged": "cache_write_paged",
    "SiluMul": "silumul",
    "LastTok": "lasttok",
    "LMHead": "lmhead",
}


def _ceil_to(d: int, g: int) -> int:
    return math.ceil(d / g) * g


def opdesc_from_attrs(kind: str, attrs: dict, granule: int = ITA_GRANULE) -> OpDesc:
    """Shape/type description the support predicate sees for one operator.

    The one derivation of the engine-mapping input: both the lowering
    (:func:`node_opdesc`, over graph nodes) and the static plan verifier
    (:func:`plan_node_opdesc`, over serialized ``PlanNode``s) call it, so
    the compile-time decision and the post-hoc legality audit cannot
    diverge.

    Row (M) dims are padded to the granule — the tiler pads them with
    zero rows, which is exact for every op here — while contracting and
    output dims are reported as-is: weights have fixed compiled layouts,
    so their alignment genuinely gates acceleration.

    Exception: a GEMM carrying ``pad_m: False`` reports its row count
    as-is.  Decode-step GEMMs are really GEMVs (M = 1); padding one row
    to the M=64 vector length would occupy the accelerator at <2%
    utilization, so Deeploy's bottom-up rule sends them to the cluster —
    the predicate must see the degenerate shape to decide that.
    """
    dims = tuple(attrs.get("dims", ()))
    if kind == "gemm":
        m, k, nn = dims
        mm = _ceil_to(m, granule) if attrs.get("pad_m", True) else m
        return OpDesc(kind, shapes=((mm, k), (k, nn)),
                      act=attrs.get("activation", "identity"))
    if kind == "mha":
        return OpDesc(kind, shapes=((_ceil_to(attrs["seq"], granule),
                                     attrs["head_dim"]),))
    if kind == "gelu":
        m = dims[0] if dims else 0
        rest = tuple(dims[1:]) if len(dims) > 1 else ()
        return OpDesc(kind, shapes=((_ceil_to(m, granule), *rest),))
    return OpDesc(kind, shapes=(dims,) if dims else ())


def node_opdesc(n: Node, granule: int = ITA_GRANULE) -> OpDesc:
    """:func:`opdesc_from_attrs` for a graph :class:`Node` (pre-lowering)."""
    return opdesc_from_attrs(KIND_BY_OP.get(n.op, n.op.lower()), n.attrs, granule)


def plan_node_opdesc(n, granule: int = ITA_GRANULE) -> OpDesc:
    """:func:`opdesc_from_attrs` for a serialized ``PlanNode``, keyed on
    its recorded dispatch kind: the verifier audits the artifact as it
    will run, not as it was meant to be lowered."""
    return opdesc_from_attrs(n.kind, n.attrs, granule)



def fuse_mha(g: Graph) -> Graph:
    """Match [Q,K,V MatMuls -> QK^T -> Softmax -> AV -> O] and fuse to MHA.

    The fused node keeps the projection weights (and biases, when the
    source MatMuls carry them) as inputs, plus the quantization scales the
    lowering attached — everything the plan executor needs to run the
    monolithic operator.
    """
    new_nodes: list[Node] = []
    consumed: set[str] = set()
    i = 0
    while i < len(g.nodes):
        n = g.nodes[i]
        if n.name in consumed:
            i += 1
            continue
        window = g.nodes[i : i + 7]
        ops = [w.op for w in window]
        if ops[:7] == ["MatMul"] * 3 + ["MatMul", "Softmax", "MatMul", "MatMul"] and (
            window[3].attrs.get("transpose_b")
        ):
            mq, mk, mv, qk, sm, av, mo = window
            # structural check: qk consumes mq/mk outputs, av consumes sm+mv, mo consumes av
            if (
                qk.inputs[0] in mq.outputs
                and qk.inputs[1] in mk.outputs
                and sm.inputs[0] in qk.outputs
                and av.inputs[0] in sm.outputs
                and av.inputs[1] in mv.outputs
                and mo.inputs[0] in av.outputs
            ):
                heads = qk.attrs.get("heads", 1)
                s, e, hp = mq.attrs["dims"]
                head_dim = hp // heads
                kv_dim = mk.attrs["dims"][2]
                inputs = [mq.inputs[0], mq.inputs[1], mk.inputs[1], mv.inputs[1], mo.inputs[1]]
                has_bias = all(len(m.inputs) > 2 for m in (mq, mk, mv, mo))
                if has_bias:
                    inputs += [mq.inputs[2], mk.inputs[2], mv.inputs[2], mo.inputs[2]]
                attrs = {
                    "heads": heads,
                    "seq": s,
                    "d_model": e,
                    "head_dim": head_dim,
                    "kv_heads": kv_dim // head_dim,
                    "has_bias": has_bias,
                }
                if "scales" in mq.attrs:
                    attrs["proj_scales"] = mq.attrs["scales"]
                if "scales" in mo.attrs:
                    attrs["out_scales"] = mo.attrs["scales"]
                fused = Node(
                    name=f"MHA_{len(new_nodes)}",
                    op="MHA",
                    inputs=inputs,
                    outputs=list(mo.outputs),
                    attrs=attrs,
                )
                new_nodes.append(fused)
                consumed.update(w.name for w in window)
                i += 7
                continue
        new_nodes.append(n)
        i += 1
    g.nodes = new_nodes
    return g


def split_heads(g: Graph) -> Graph:
    """MHA -> per-head MHAHead nodes + cluster HeadAccum (ITA is single-head).

    Partial outputs are int32: each head computes its slice of the output
    projection on ITA and the cluster accumulates the raw accumulators —
    the paper's schedule (requantization happens once, after the
    accumulation).
    """
    new_nodes: list[Node] = []
    for n in g.nodes:
        if n.op != "MHA":
            new_nodes.append(n)
            continue
        h = n.attrs["heads"]
        s, p = n.attrs["seq"], n.attrs["head_dim"]
        e = n.attrs["d_model"]
        partials = []
        for head in range(h):
            out = g.add_tensor(f"{n.name}_part{head}", (s, e), dtype="int32")
            partials.append(out)
            new_nodes.append(
                Node(
                    name=f"{n.name}_h{head}",
                    op="MHAHead",
                    inputs=list(n.inputs),
                    outputs=[out],
                    attrs={**n.attrs, "head": head, "seq": s, "head_dim": p,
                           "d_model": e},
                )
            )
        accum_inputs = list(partials)
        if n.attrs.get("has_bias") and len(n.inputs) >= 9:
            accum_inputs.append(n.inputs[8])  # output-projection bias
        accum_attrs = {"dims": (s, e), "heads": h}
        if "out_scales" in n.attrs:
            accum_attrs["out_scales"] = n.attrs["out_scales"]
        new_nodes.append(
            Node(
                name=f"{n.name}_accum",
                op="HeadAccum",
                inputs=accum_inputs,
                outputs=list(n.outputs),
                attrs=accum_attrs,
            )
        )
    g.nodes = new_nodes
    return g


#: ops the extended ITA accepts (GEMM mode + fused activation + MHA head)
ITA_OPS = {"MatMul", "GELU", "MHAHead", "MHA"}


def map_engines(g: Graph, granule: int = ITA_GRANULE) -> Graph:
    """Per-node accelerator-vs-cluster decision (Deeploy's bottom-up rule:
    accelerated when supported, fallback kernel otherwise).

    The decision is :func:`ita_supports` on :func:`node_opdesc` — shared
    with ``DispatchTable.resolve`` so the plan's static engine column and
    the runtime dispatch can never disagree at equal granule.
    """
    for n in g.nodes:
        n.engine = "ita" if ita_supports(node_opdesc(n, granule), granule) else "cluster"
    return g


def fuse_gelu_epilogue(g: Graph) -> Graph:
    """MatMul -> GELU pairs collapse into the GEMM activation unit."""
    new_nodes = []
    skip: set[str] = set()
    for i, n in enumerate(g.nodes):
        if n.name in skip:
            continue
        if n.op == "MatMul" and i + 1 < len(g.nodes):
            nxt = g.nodes[i + 1]
            if nxt.op == "GELU" and nxt.inputs[0] in n.outputs and n.engine == "ita":
                attrs = {**n.attrs, "activation": "gelu"}
                if "scales" in n.attrs and "scales" in nxt.attrs:
                    # pre-activation grid = the GEMM's requant target;
                    # the i-GeLU output requantizes to the GELU's grid
                    s_in, s_w, s_mid = n.attrs["scales"]
                    attrs["scales"] = (s_in, s_w, nxt.attrs["scales"][1])
                    attrs["s_preact"] = s_mid
                fused = Node(
                    name=n.name + "_gelu",
                    op="MatMul",
                    inputs=list(n.inputs),
                    outputs=list(nxt.outputs),
                    attrs=attrs,
                )
                fused.engine = "ita"
                new_nodes.append(fused)
                skip.add(nxt.name)
                continue
        new_nodes.append(n)
    g.nodes = new_nodes
    return g


def deploy_pipeline(g: Graph, head_by_head: bool = True, granule: int = ITA_GRANULE) -> Graph:
    g = fuse_mha(g)
    if head_by_head:
        g = split_heads(g)
    g = map_engines(g, granule)
    g = fuse_gelu_epilogue(g)
    return g


# ---------------------------------------------------------------------------
# Region fusion (plan-level): decode-step mega-kernels
# ---------------------------------------------------------------------------

#: plan-node kinds that always terminate a fusion region.  Persistent KV
#: writes stay visible at the top of the schedule — the engine's in-place
#: pool/cache update is a cross-dispatch contract, so a region must never
#: hide one (also asserted by ``DeploymentPlan.validate``).
FUSION_BARRIERS = frozenset({"cache_write", "cache_write_paged"})


def fuse_regions(plan, *, min_nodes: int = 2):
    """Collapse maximal same-engine schedule runs into ``FusedRegion`` nodes.

    The Deeploy-style operator-fusion pass, applied *after* tiling and
    memory planning so the interior nodes keep their static solution:
    contiguous schedule runs on one engine (norm -> qkv -> rope,
    attn -> proj -> residual -> MLP chains) become a single mega-node the
    executor dispatches as one closure — collapsing the per-layer decode
    step from ~17 top-level nodes to a handful.  Fusion
    never crosses an engine boundary (a region is single-engine by
    construction) and never swallows a persistent KV write
    (:data:`FUSION_BARRIERS` / kv_state outputs stay top-level).  Runs
    shorter than ``min_nodes`` are left unfused — a one-node region would
    only add indirection.

    Purely structural: the interior nodes execute the identical runners
    in the identical order, so fused plans are bit-exact vs unfused ones
    (tested on both backends).
    """
    from repro_torch.deploy.plan import PlanNode

    kv_writes = {cout for _, cout in plan.kv_state}

    def barrier(n) -> bool:
        return (n.kind in FUSION_BARRIERS or n.fused
                or any(o in kv_writes for o in n.outputs))

    # group the schedule into maximal same-engine barrier-free runs
    groups: list[tuple[str | None, list]] = []
    for n in plan.nodes:
        if barrier(n):
            groups.append((None, [n]))
        elif groups and groups[-1][0] == n.engine:
            groups[-1][1].append(n)
        else:
            groups.append((n.engine, [n]))

    consumers: dict[str, set[str]] = {}
    for n in plan.nodes:
        for t in n.inputs:
            consumers.setdefault(t, set()).add(n.name)
    plan_outs = set(plan.outputs)

    new_nodes: list[PlanNode] = []
    region_idx = 0
    for engine, body in groups:
        if engine is None or len(body) < min_nodes:
            new_nodes.extend(body)
            continue
        body_names = {n.name for n in body}
        produced = {o for n in body for o in n.outputs}
        inputs: list[str] = []
        for n in body:
            for t in n.inputs:
                if t not in produced and t not in inputs:
                    inputs.append(t)
        outputs = [
            o for n in body for o in n.outputs
            if o in plan_outs or (consumers.get(o, set()) - body_names)
        ]
        new_nodes.append(PlanNode(
            name=f"fused{region_idx}_{engine}",
            op="FusedRegion",
            kind="fused_region",
            engine=engine,
            inputs=tuple(inputs),
            outputs=tuple(outputs),
            attrs={"n_body": len(body)},
            body=tuple(body),
        ))
        region_idx += 1

    import dataclasses

    return dataclasses.replace(
        plan, nodes=new_nodes, schedule=tuple(n.name for n in new_nodes)
    ).validate()
