"""Deeploy-style operator graph IR.

Deeploy consumes ONNX; we synthesize the equivalent operator graphs from
``ArchConfig`` (same op vocabulary: MatMul/Add/LayerNorm/Softmax/GELU/...).
The graph is the substrate for the paper's deployment flow (port of the
JAX package's ``deploy/graph.py``; the paper-graph builder used for the
cost model is not ported yet):

  pattern fusion (MHA) -> engine mapping -> tiling -> lifetime analysis
  -> static memory layout -> schedule
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

