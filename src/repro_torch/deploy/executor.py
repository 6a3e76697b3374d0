"""Plan executor — runs a DeploymentPlan with PyTorch (port).

Every scheduled node resolves through the runtime
:class:`~repro_torch.core.heterogeneous.DispatchTable`: accelerator nodes
hit the CUDA kernels (``Backend.ITA``) or the paper-faithful plain
integer arithmetic (``Backend.W8A8``), cluster nodes the plain integer
operators — as ``ita_supports`` decides.

Contract: ``execute(plan, bind_encoder_weights(...), batch, backend=b)``
equals the JAX package's ``execute`` on the same ints, element for
element, on both backends, and so do ``execute_prefill`` /
``execute_decode`` of a :class:`DecoderPlanPair` (logits, K and V caches
and ``len`` at every step).  PyTorch runs eagerly: the bound program is
a tuple of closures walked in schedule order, and a fused region is its
body's closures run in order inside one call.

Unlike the reference, ``execute_decode`` writes the cache it is given in
place (the plan aliases each ``cache_out`` to its ``cache_in``): it
returns the same tensors, advanced by one row per request.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.heterogeneous import (
    DEFAULT_TABLE,
    Backend,
    DispatchTable,
    OpDesc,
    as_backend,
    backend_granule,
)
from repro_torch.core.quant_linear import ACT_GELU, ACT_IDENTITY, ACT_RELU
from repro_torch.deploy.patterns import opdesc_from_attrs
from repro_torch.deploy.plan import DecoderPlanPair, DeploymentPlan, PlanNode

#: fused-activation vocabulary the GEMM runner can lower
_GEMM_ACTS = {"identity": ACT_IDENTITY, "relu": ACT_RELU, "gelu": ACT_GELU}


def _ceil_to(d: int, g: int) -> int:
    return math.ceil(d / g) * g


def _gemm_desc(
    m: int, k: int, n: int, granule: int, act: str = "identity", pad_m: bool = True
) -> OpDesc:
    mm = _ceil_to(m, granule) if pad_m else m
    return OpDesc("gemm", shapes=((mm, k), (k, n)), act=act)


def _mha_desc(seq: int, head_dim: int, granule: int) -> OpDesc:
    return OpDesc("mha", shapes=((_ceil_to(seq, granule), head_dim),))


def _resolve(table: DispatchTable, desc: OpDesc, backend: Backend) -> Callable:
    return table.resolve(desc, backend)[1]


# ---------------------------------------------------------------------------
# Per-kind node compilers: each node is bound once per (plan, backend,
# table) into a ``run(env) -> out`` closure.
# ---------------------------------------------------------------------------


def _compile_gemm(node: PlanNode, table, backend) -> Callable:
    if "heads" in node.attrs:
        raise NotImplementedError(
            f"{node.name}: un-fused attention MatMul cannot execute; lower with "
            "fuse_mha (deploy_pipeline) so attention runs as an MHA node"
        )
    a = node.attrs
    m, k, n = a["dims"]
    act_name = a.get("activation", "identity")
    if act_name not in _GEMM_ACTS:
        raise NotImplementedError(
            f"{node.name}: no GEMM lowering for fused activation {act_name!r} "
            f"(supported: {sorted(_GEMM_ACTS)})"
        )
    act = _GEMM_ACTS[act_name]
    scales = tuple(a["scales"])
    s_preact = a.get("s_preact")
    if act == ACT_GELU and s_preact is None:
        s_preact = scales[2]
    g = backend_granule(backend)
    fn = _resolve(table, _gemm_desc(m, k, n, g, act_name, pad_m=a.get("pad_m", True)), backend)
    x_t, w_t = node.inputs[0], node.inputs[1]
    b_t = node.inputs[2] if len(node.inputs) > 2 else None

    def run(env):
        b = env[b_t] if b_t is not None else None
        return fn(env[x_t], env[w_t], b, scales=scales, act=act, s_preact=s_preact)

    return run


def _split(x, heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, heads, head_dim).permute(0, 2, 1, 3)


def _mha_weights(node: PlanNode, env):
    wq, wk, wv, wo = (env[t] for t in node.inputs[1:5])
    if node.attrs.get("has_bias"):
        bq, bk, bv, bo = (env[t] for t in node.inputs[5:9])
    else:
        bq = bk = bv = bo = None
    return wq, wk, wv, wo, bq, bk, bv, bo


def _compile_mha(node: PlanNode, table, backend) -> Callable:
    """Fused MHA: QKV projections -> attention core -> output projection."""
    a = node.attrs
    s, e = a["seq"], a["d_model"]
    h, hkv, hd = a["heads"], a["kv_heads"], a["head_dim"]
    proj = tuple(a["proj_scales"])
    outp = tuple(a["out_scales"])
    g = backend_granule(backend)

    gemm_q = _resolve(table, _gemm_desc(s, e, h * hd, g), backend)
    gemm_kv = _resolve(table, _gemm_desc(s, e, hkv * hd, g), backend)
    attn = _resolve(table, _mha_desc(s, hd, g), backend)
    gemm_o = _resolve(table, _gemm_desc(s, h * hd, e, g), backend)

    def run(env):
        x = env[node.inputs[0]]
        wq, wk, wv, wo, bq, bk, bv, bo = _mha_weights(node, env)
        q = gemm_q(x, wq, bq, scales=proj, act=ACT_IDENTITY, s_preact=None)
        k = gemm_kv(x, wk, bk, scales=proj, act=ACT_IDENTITY, s_preact=None)
        v = gemm_kv(x, wv, bv, scales=proj, act=ACT_IDENTITY, s_preact=None)
        at = attn(_split(q, h, hd), _split(k, hkv, hd), _split(v, hkv, hd),
                  s_act=proj[2], s_out=outp[0])
        a_m = at.permute(0, 2, 1, 3).reshape(*x.shape[:2], h * hd)
        return gemm_o(a_m, wo, bo, scales=outp, act=ACT_IDENTITY, s_preact=None)

    return run


def _compile_cluster(node: PlanNode, table, backend) -> Callable:
    """Bind one cluster-engine node (the encoder's kinds and the dense
    decoder's)."""
    kind = node.kind
    a = node.attrs
    # The node's description is the plan's own (rows padded to the granule,
    # patterns.opdesc_from_attrs), not its unpadded dims as in the JAX
    # package's executor: a gelu node that the plan marks ``ita`` then
    # resolves to the igelu kernel at any sequence length.  Both forms
    # compute the same ints, so only the engine can differ.
    fn = _resolve(table, opdesc_from_attrs(kind, a, backend_granule(backend)), backend)
    ins = node.inputs
    if kind == "layernorm":
        norm, s_gamma, s_out = a["norm"], a["s_gamma"], a["s_out"]
        params = list(ins[1:])
        g_t = params[0] if norm != "np_layernorm" and params else None
        b_t = params[1] if norm == "layernorm" and len(params) > 1 else None

        def run(env):
            pq = {}
            if g_t is not None:
                pq["g_q"] = env[g_t]
            if b_t is not None:
                pq["beta_q"] = env[b_t]
            return fn(norm, pq, env[ins[0]], s_gamma, s_out)

        return run
    if kind == "add":
        scales = tuple(a["scales"])
        return lambda env: fn(env[ins[0]], env[ins[1]], scales=scales)
    if kind == "gelu":
        s_in, s_out = a["scales"]
        return lambda env: fn(env[ins[0]], s_in=s_in, s_out=s_out)
    if kind == "embed":
        return lambda env: fn(env[ins[0]], env[ins[1]])
    if kind == "classifier":
        scale = a["scale"]
        return lambda env: fn(env[ins[0]], env[ins[1]], scale=scale)
    if kind == "dequant":
        scale = a["scale"]
        return lambda env: fn(env[ins[0]], scale=scale)
    # decoder / KV-cache kinds
    if kind == "rope":
        kw = dict(heads=a["heads"], head_dim=a["head_dim"], theta=a["theta"])
        if len(ins) <= 1:
            positions = np.arange(a["dims"][0])  # prefill: static 0..S
            return lambda env: fn(env[ins[0]], positions, **kw)
        return lambda env: fn(env[ins[0]], env[ins[1]], **kw)
    if kind == "attn_causal":
        kw = dict(heads=a["heads"], kv_heads=a["kv_heads"], head_dim=a["head_dim"],
                  s_act=a["s_act"], s_out=a["s_out"], block_k=a["block_k"])
        return lambda env: fn(env[ins[0]], env[ins[1]], env[ins[2]], **kw)
    if kind == "attn_cached":
        kw = dict(heads=a["heads"], head_dim=a["head_dim"],
                  s_act=a["s_act"], s_out=a["s_out"], block_k=a["block_k"])
        return lambda env: fn(env[ins[0]], env[ins[1]], env[ins[2]], env[ins[3]], **kw)
    if kind == "cache_write":
        kw = dict(kv_heads=a["kv_heads"], head_dim=a["head_dim"], max_len=a["max_len"])
        cache_t = ins[1] if len(ins) > 1 else None
        pos_t = ins[2] if len(ins) > 2 else None

        def run(env):
            cache = env[cache_t] if cache_t is not None else None
            pos = env[pos_t] if pos_t is not None else None
            return fn(env[ins[0]], cache, pos, **kw)

        return run
    if kind == "silumul":
        scales = tuple(a["scales"])
        return lambda env: fn(env[ins[0]], env[ins[1]], scales=scales)
    if kind == "lasttok":
        return lambda env: fn(env[ins[0]])
    if kind == "lmhead":
        scale, tied = a["scale"], a["tied"]
        return lambda env: fn(env[ins[0]], env[ins[1]], scale=scale, tied=tied)
    raise NotImplementedError(f"no runner for op kind {kind!r} ({node.op})")


def _compile_region(node: PlanNode, table, backend) -> Callable:
    """Bind a FusedRegion: every body node is bound once, and one call runs
    their closures in schedule order (no ``torch.compile``, no CUDA graph:
    the region saves the top-level walk, not the kernels' dispatch)."""
    body = tuple((b.outputs[0], _compile_node(b, table, backend)) for b in node.body)
    in_names, out_names = node.inputs, node.outputs

    def run(env):
        local = {t: env[t] for t in in_names}
        for out, fn in body:
            local[out] = fn(local)
        return tuple(local[t] for t in out_names)

    return run


def _compile_node(node: PlanNode, table, backend) -> Callable:
    if node.fused:
        return _compile_region(node, table, backend)
    if node.kind == "gemm":
        return _compile_gemm(node, table, backend)
    if node.kind == "mha":
        if node.op == "MHAHead":
            raise NotImplementedError(f"{node.name}: the head-by-head schedule is not ported yet")
        return _compile_mha(node, table, backend)
    return _compile_cluster(node, table, backend)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def bind_plan(
    plan: DeploymentPlan,
    *,
    backend: Backend | str = Backend.W8A8,
    table: DispatchTable | None = None,
) -> tuple:
    """Resolve every scheduled node to its runner once, cached on the plan
    keyed by ``(backend, id(table))`` (the table is retained with it)."""
    backend = as_backend(backend)
    table = DEFAULT_TABLE if table is None else table
    cache = plan.__dict__.setdefault("_bound_programs", {})
    key = (backend, id(table))
    hit = cache.get(key)
    if hit is not None:
        return hit[1]
    program = tuple((n, _compile_node(n, table, backend)) for n in plan.nodes)
    cache[key] = (table, program)
    return program


def execute(
    plan: DeploymentPlan,
    weights: dict,
    batch: dict,
    *,
    backend: Backend | str = Backend.W8A8,
    table: DispatchTable | None = None,
):
    """Run one forward pass of the plan.

    ``batch`` maps the plan's input names (``tokens`` / ``patches`` /
    ``frames``) to tensors with a leading batch dim.
    """
    program = bind_plan(plan, backend=backend, table=table)
    check_bindings(plan, batch=batch)
    env = dict(weights)
    for name in plan.inputs:
        env[name] = batch[name]
    for node, run in program:
        if node.fused:
            env.update(zip(node.outputs, run(env)))
        else:
            env[node.outputs[0]] = run(env)
    outs = [env[name] for name in plan.outputs]
    return outs[0] if len(outs) == 1 else tuple(outs)


def _weight_binder(weights: dict):
    """(put, put_norm) closures writing non-None params into ``weights``."""

    def put(name, arr):
        if arr is not None:
            weights[name] = arr

    def put_norm(prefix, pq):
        put(prefix + "_g", pq.get("g_q"))
        put(prefix + "_b", pq.get("beta_q"))

    return put, put_norm


def _bind_attn_layer(put, put_norm, pre: str, cfg: ArchConfig, lp: dict) -> None:
    """Per-layer attention/norm binding: the fused ``wqkv`` weight (and
    bias) is column-sliced into the plan's wq/wk/wv tensors — the same
    ints as one fused GEMM, since integer accumulation is column-separable."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qd, kd = h * hd, hkv * hd
    wqkv, bqkv = lp["attn"]["wqkv"]["w_q"], lp["attn"]["wqkv"].get("b_q")
    put(pre + "wq", wqkv[:, :qd].contiguous())
    put(pre + "wk", wqkv[:, qd : qd + kd].contiguous())
    put(pre + "wv", wqkv[:, qd + kd : qd + 2 * kd].contiguous())
    if bqkv is not None:
        put(pre + "wq_b", bqkv[:qd])
        put(pre + "wk_b", bqkv[qd : qd + kd])
        put(pre + "wv_b", bqkv[qd + kd : qd + 2 * kd])
    put(pre + "wo", lp["attn"]["wo"]["w_q"])
    put(pre + "wo_b", lp["attn"]["wo"].get("b_q"))
    put_norm(pre + "norm1", lp["norm1"])
    put_norm(pre + "norm2", lp["norm2"])


class PlanBindingError(ValueError):
    """Bound tensors contradict the plan's static ``TensorSpec`` contract;
    every mismatch is listed."""

    def __init__(self, mismatches: list[str], *, what: str = "binding"):
        self.mismatches = list(mismatches)
        lines = "; ".join(self.mismatches)
        super().__init__(
            f"plan {what} rejects {len(self.mismatches)} tensor(s): {lines}"
        )


#: spec dtype -> tensor dtypes accepted for it
_BIND_DTYPES = {
    "int8": {"int8"},
    "int32": {"int32", "bool"},
    "float32": {"float32"},
}


def _dtype_name(arr) -> str:
    dt = getattr(arr, "dtype", None)
    return type(arr).__name__ if dt is None else str(dt).removeprefix("torch.")


def _spec_mismatch(spec, arr, *, batched: bool) -> str | None:
    """One mismatch line, or None if ``arr`` satisfies ``spec`` (a batched
    spec also accepts one leading batch dimension)."""
    shape = tuple(getattr(arr, "shape", ()))
    ok_shape = shape == spec.shape or (batched and shape[1:] == spec.shape)
    dt = _dtype_name(arr)
    ok_dtype = dt in _BIND_DTYPES.get(spec.dtype, {spec.dtype})
    if ok_shape and ok_dtype:
        return None
    return f"{spec.name}: spec {spec.dtype}{list(spec.shape)} vs bound {dt}{list(shape)}"


def check_bindings(
    plan: DeploymentPlan,
    *,
    weights: dict | None = None,
    batch: dict | None = None,
) -> None:
    """Pre-flight every provided binding against the plan's ``TensorSpec``s;
    all violations raise together as one :class:`PlanBindingError`."""
    bad: list[str] = []
    what = "binding"
    if weights is not None:
        for name in plan.weight_names:
            if name not in weights:
                bad.append(f"{name}: declared plan weight never bound")
                continue
            m = _spec_mismatch(plan.tensors[name], weights[name], batched=False)
            if m:
                bad.append(m)
        what = "weight binding"
    if batch is not None:
        for name in plan.inputs:
            if name not in batch:
                bad.append(f"{name}: plan input missing from the batch")
                continue
            m = _spec_mismatch(plan.tensors[name], batch[name], batched=True)
            if m:
                bad.append(m)
        what = "input binding"
    if bad:
        raise PlanBindingError(bad, what=what)


def bind_encoder_weights(plan: DeploymentPlan, cfg: ArchConfig, qp: dict) -> dict:
    """Map plan weight names onto the quantized params (``qp["layers"]`` is
    a list of per-layer dicts, as ``encoder.quantize_params`` returns)."""
    weights: dict = {}
    put, put_norm = _weight_binder(weights)
    for l, lp in enumerate(qp["layers"]):
        pre = f"l{l}_"
        _bind_attn_layer(put, put_norm, pre, cfg, lp)
        put(pre + "up", lp["mlp"]["up"]["w_q"])
        put(pre + "up_b", lp["mlp"]["up"].get("b_q"))
        put(pre + "down", lp["mlp"]["down"]["w_q"])
        put(pre + "down_b", lp["mlp"]["down"].get("b_q"))
    put("pos", qp["pos_q"][: plan.seq_len])
    put_norm("final_norm", qp["final_norm"])
    if "embed" in qp:
        put("embed_table", qp["embed"]["table_q"])
    bound = {k: v for k, v in weights.items() if k in plan.tensors and plan.tensors[k].weight}
    check_bindings(plan, weights=bound)
    return bound


# ---------------------------------------------------------------------------
# Decoder plans: weight binding + KV-cache-threading executors
# ---------------------------------------------------------------------------


def bind_decoder_weights(plan: DeploymentPlan, cfg: ArchConfig, qp: dict) -> dict:
    """Map decoder plan weight names onto ``transformer.quantize_params``
    output (``qp["layers"]`` a list of per-layer dicts).  The prefill and
    decode plans declare one weight set, so either plan gives the same
    dict."""
    weights: dict = {}
    put, put_norm = _weight_binder(weights)
    for l, lp in enumerate(qp["layers"]):
        pre = f"l{l}_"
        _bind_attn_layer(put, put_norm, pre, cfg, lp)
        for mname in ("gate", "up", "down"):
            if mname in lp["mlp"]:
                put(pre + mname, lp["mlp"][mname]["w_q"])
                put(pre + mname + "_b", lp["mlp"][mname].get("b_q"))
    put_norm("final_norm", qp["final_norm"])
    put("embed_table", qp["embed"]["table_q"])
    if "lm_head" in qp:
        put("lm_head", qp["lm_head"]["w_q"])
    bound = {k: v for k, v in weights.items() if k in plan.tensors and plan.tensors[k].weight}
    check_bindings(plan, weights=bound)
    return bound


def _stack_cache(plan: DeploymentPlan, outs_by_name: dict, length: int) -> dict:
    """Per-layer cache outputs -> the model-shaped cache
    ``{"k": [L, B, Hkv, M, D], "v": ..., "len": int32 (host)}``."""
    ks = [outs_by_name[out] for _, out in plan.kv_state[0::2]]
    vs = [outs_by_name[out] for _, out in plan.kv_state[1::2]]
    return {"k": torch.stack(ks), "v": torch.stack(vs),
            "len": torch.tensor(length, dtype=torch.int32)}


def execute_prefill(
    pair: DecoderPlanPair,
    weights: dict,
    batch: dict,
    *,
    backend: Backend | str = Backend.W8A8,
    table: DispatchTable | None = None,
):
    """Run the prefill schedule.  Returns ``(logits, cache)``: the last
    token's logits [B, 1, vocab_padded] and the same cache layout as
    ``transformer.prefill_w8a8``."""
    plan = pair.prefill
    outs = execute(plan, weights, batch, backend=backend, table=table)
    outs_by_name = dict(zip(plan.outputs, outs))
    return outs_by_name[plan.outputs[0]], _stack_cache(plan, outs_by_name, plan.seq_len)


def execute_decode(
    pair: DecoderPlanPair,
    weights: dict,
    cache: dict,
    token,
    *,
    pos=None,
    backend: Backend | str = Backend.W8A8,
    table: DispatchTable | None = None,
):
    """Advance one token per request through the decode schedule.

    ``pos`` is the generation depth fed to RoPE, the cache append and the
    attention mask, as host data: a scalar (every request at one depth;
    default ``cache["len"]``) or a [B] vector (each request at its own
    depth).  The cache is written in place; a row at or past ``max_len``
    raises (the reference clamps the write instead — check capacity first,
    as ``InferenceSession.decode`` does).
    """
    plan = pair.decode
    pos = np.asarray(cache["len"] if pos is None else pos, np.int32)
    batch = {"token": token, "pos": torch.from_numpy(pos)}
    for i, (cin, _) in enumerate(plan.kv_state):
        batch[cin] = cache["k" if i % 2 == 0 else "v"][i // 2]
    logits = execute(plan, weights, batch, backend=backend, table=table)[0]
    # every cache_write wrote its layer's view of cache["k"] / cache["v"]
    return logits, {"k": cache["k"], "v": cache["v"], "len": torch.as_tensor(pos + 1)}
