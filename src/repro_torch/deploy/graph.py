"""Deeploy-style operator graph IR.

Deeploy consumes ONNX; we synthesize the equivalent operator graphs from
``ArchConfig`` (same op vocabulary: MatMul/Add/LayerNorm/Softmax/GELU/...).
The graph is the substrate for the paper's deployment flow (port of the
JAX package's ``deploy/graph.py``):

  pattern fusion (MHA) -> head split -> engine mapping -> tiling ->
  lifetime analysis -> static memory layout -> schedule -> cost model

:func:`build_encoder_graph` is the paper's operator graph of an encoder,
the one the cost model (:mod:`repro_torch.deploy.costmodel`) prices.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]
    dtype: str = "int8"  # int8 | int32 | float32

    @property
    def bytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * {"int8": 1, "int32": 4, "float32": 4, "int16": 2}[self.dtype]


@dataclass
class Node:
    name: str
    op: str  # MatMul | Add | LayerNorm | Softmax | GELU | MHA | MHAHead | HeadAccum | ...
    inputs: list[str]
    outputs: list[str]
    attrs: dict = field(default_factory=dict)
    engine: str | None = None  # "ita" | "cluster" (set by the mapper)


class Graph:
    """Operator graph with O(1) producer/consumer lookup.

    ``nodes`` is a property: appending via :meth:`add_node` updates the
    producer/consumer indexes incrementally, and wholesale replacement
    (``g.nodes = new_nodes`` — what the rewrite passes do) rebuilds them.
    The passes call :meth:`producer_of`/:meth:`consumers_of` inside node
    loops, so without the indexes deep graphs go O(n²).
    """

    def __init__(self, nodes=None, tensors=None, inputs=None, outputs=None, weights=None):
        self.tensors = tensors or {}
        self.inputs = inputs or []
        self.outputs = outputs or []
        self.weights = weights or set()
        self._nodes = []
        self._producer = {}
        self._consumers = {}
        if nodes:
            self.nodes = list(nodes)

    @property
    def nodes(self) -> list[Node]:
        return self._nodes

    @nodes.setter
    def nodes(self, new_nodes: list[Node]) -> None:
        self._nodes = list(new_nodes)
        self._producer = {}
        self._consumers = {}
        for n in self._nodes:
            self._index_node(n)

    def _index_node(self, node: Node) -> None:
        for t in node.outputs:
            self._producer[t] = node
        for t in node.inputs:
            self._consumers.setdefault(t, []).append(node)

    def add_tensor(self, name, shape, dtype="int8", weight=False) -> str:
        self.tensors[name] = TensorInfo(name, tuple(shape), dtype)
        if weight:
            self.weights.add(name)
        return name

    def add_node(self, op, inputs, outputs, name=None, **attrs) -> Node:
        node = Node(name or f"{op}_{len(self._nodes)}", op, list(inputs), list(outputs), attrs)
        self._nodes.append(node)
        self._index_node(node)
        return node

    def producer_of(self, tensor: str) -> Node | None:
        return self._producer.get(tensor)

    def consumers_of(self, tensor: str) -> list[Node]:
        return list(self._consumers.get(tensor, ()))

    def validate(self):
        produced = set(self.inputs) | set(self.weights)
        for n in self.nodes:
            for t in n.inputs:
                assert t in produced, f"{n.name} consumes undefined tensor {t}"
            for t in n.outputs:
                assert t not in produced or t in self.weights, f"{t} produced twice"
                produced.add(t)
        for t in self.outputs:
            assert t in produced
        return self


def build_encoder_graph(cfg, seq_len: int | None = None) -> Graph:
    """Operator graph of one paper-style encoder model (all layers).

    This is the ONNX-equivalent stream Deeploy would see: un-fused MatMul
    chains for attention (Q/K/V/QK^T/Softmax/AV/O), LayerNorm, GELU MLP,
    residual Adds.
    """
    s = seq_len or cfg.max_seq
    e, h, p, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    eb = cfg.d_bottleneck  # MobileBERT-style outer width (0 = none)
    g = Graph()
    x = g.add_tensor("input", (s, eb or e))
    g.inputs.append(x)
    for l in range(cfg.n_layers):
        pre = f"l{l}_"
        if eb:
            # bottleneck in: outer width -> intra width
            w_bi = g.add_tensor(pre + "w_bn_in", (eb, e), weight=True)
            xb = g.add_tensor(pre + "bn_in", (s, e))
            g.add_node("MatMul", [x, w_bi], [xb], dims=(s, eb, e))
            outer_x, x = x, xb
        h1 = g.add_tensor(pre + "ln1", (s, e))
        g.add_node("LayerNorm", [x], [h1], dims=(s, e))
        wq = g.add_tensor(pre + "wq", (e, h * p), weight=True)
        wk = g.add_tensor(pre + "wk", (e, h * p), weight=True)
        wv = g.add_tensor(pre + "wv", (e, h * p), weight=True)
        q = g.add_tensor(pre + "q", (s, h * p))
        k = g.add_tensor(pre + "k", (s, h * p))
        v = g.add_tensor(pre + "v", (s, h * p))
        g.add_node("MatMul", [h1, wq], [q], dims=(s, e, h * p))
        g.add_node("MatMul", [h1, wk], [k], dims=(s, e, h * p))
        g.add_node("MatMul", [h1, wv], [v], dims=(s, e, h * p))
        logits = g.add_tensor(pre + "qk", (h, s, s))
        g.add_node("MatMul", [q, k], [logits], dims=(s, p, s), heads=h, transpose_b=True)
        a = g.add_tensor(pre + "a", (h, s, s))
        g.add_node("Softmax", [logits], [a], dims=(h, s, s))
        av = g.add_tensor(pre + "av", (s, h * p))
        g.add_node("MatMul", [a, v], [av], dims=(s, s, p), heads=h)
        wo = g.add_tensor(pre + "wo", (h * p, e), weight=True)
        o = g.add_tensor(pre + "o", (s, e))
        g.add_node("MatMul", [av, wo], [o], dims=(s, h * p, e))
        x2 = g.add_tensor(pre + "res1", (s, e))
        g.add_node("Add", [x, o], [x2], dims=(s, e))
        for ff in range(max(cfg.n_ffn, 1)):
            sfx = f"_f{ff}" if cfg.n_ffn > 1 else ""
            h2 = g.add_tensor(pre + "ln2" + sfx, (s, e))
            g.add_node("LayerNorm", [x2], [h2], dims=(s, e))
            w_up = g.add_tensor(pre + "w_up" + sfx, (e, f), weight=True)
            up = g.add_tensor(pre + "up" + sfx, (s, f))
            g.add_node("MatMul", [h2, w_up], [up], dims=(s, e, f))
            gl = g.add_tensor(pre + "gelu" + sfx, (s, f))
            g.add_node("GELU", [up], [gl], dims=(s, f))
            w_dn = g.add_tensor(pre + "w_dn" + sfx, (f, e), weight=True)
            dn = g.add_tensor(pre + "down" + sfx, (s, e))
            g.add_node("MatMul", [gl, w_dn], [dn], dims=(s, f, e))
            x3 = g.add_tensor(pre + "res2" + sfx, (s, e))
            g.add_node("Add", [x2, dn], [x3], dims=(s, e))
            x2 = x3
        if eb:
            # bottleneck out: intra width -> outer width, residual at outer
            w_bo = g.add_tensor(pre + "w_bn_out", (e, eb), weight=True)
            bo = g.add_tensor(pre + "bn_out", (s, eb))
            g.add_node("MatMul", [x2, w_bo], [bo], dims=(s, e, eb))
            xo = g.add_tensor(pre + "res_out", (s, eb))
            g.add_node("Add", [outer_x, bo], [xo], dims=(s, eb))
            x = xo
        else:
            x = x2
    g.outputs.append(x)
    return g.validate()
