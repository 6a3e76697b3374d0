"""DeploymentPlan — the serializable compile artifact of the deploy flow.

The paper's automated flow ends in a *fully static* deployment artifact:
every operator carries its engine assignment, its tiling solution and a
fixed memory offset, and the execution order is decided offline.  This
module is that artifact for the port: the output of
:func:`repro_torch.deploy.lowering.lower`, consumed by
:mod:`repro_torch.deploy.executor`, and round-trippable through JSON.  The
schema is the JAX package's, field for field, so a plan written by one
package loads in the other.  A decoder config lowers to a
:class:`DecoderPlanPair`: a prefill and a decode-step plan linked through
one statically planned KV region: dense per-slot strips, or a shared
paged block pool with per-slot block tables.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _tupleize(obj):
    """Recursively turn lists into tuples (JSON round-trip normalizer)."""
    if isinstance(obj, list):
        return tuple(_tupleize(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _tupleize(v) for k, v in obj.items()}
    return obj


@dataclass(frozen=True)
class TensorSpec:
    """Static description of one plan tensor (activation or weight)."""

    name: str
    shape: tuple[int, ...]
    dtype: str = "int8"
    weight: bool = False
    offset: int | None = None  # static activation offset (None for weights)
    size: int = 0  # allocated bytes (0 for weights: resident in L2)

    @staticmethod
    def from_dict(d: dict) -> "TensorSpec":
        return TensorSpec(
            name=d["name"],
            shape=tuple(d["shape"]),
            dtype=d.get("dtype", "int8"),
            weight=bool(d.get("weight", False)),
            offset=d.get("offset"),
            size=int(d.get("size", 0)),
        )


@dataclass(frozen=True)
class PlanNode:
    """One scheduled operator: engine-assigned, quant-parameterized.

    A node with ``kind == "fused_region"`` is a *mega-node*: ``body``
    holds the original schedule-ordered operators it subsumes, all on
    the same engine.  The region serializes like any node but executes
    as one dispatch (a jitted closure on the cluster, one fused trace
    on ita) — the Deeploy-style operator fusion the decode hot path
    needs.  ``inputs`` are every tensor the body reads that is produced
    outside the region (weights included); ``outputs`` are the body
    products consumed outside it.
    """

    name: str
    op: str  # graph-level op (MatMul / MHA / LayerNorm / ...)
    kind: str  # dispatch-table kind (gemm / mha / layernorm / ...)
    engine: str  # "ita" | "cluster" — the static mapping decision
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    attrs: dict = field(default_factory=dict)
    body: tuple["PlanNode", ...] = ()  # fused_region interior, schedule order

    @property
    def fused(self) -> bool:
        return self.kind == "fused_region"

    @staticmethod
    def from_dict(d: dict) -> "PlanNode":
        return PlanNode(
            name=d["name"],
            op=d["op"],
            kind=d["kind"],
            engine=d["engine"],
            inputs=tuple(d["inputs"]),
            outputs=tuple(d["outputs"]),
            attrs=_tupleize(d.get("attrs", {})),
            body=tuple(PlanNode.from_dict(b) for b in d.get("body", ())),
        )


@dataclass
class DeploymentPlan:
    """Topologically scheduled, engine-mapped, statically allocated plan.

    ``nodes`` are stored in schedule order (``schedule`` lists the same
    names, kept explicit so consumers can verify the invariant after
    deserialization).  ``tilings`` holds the per-node geometric solution
    of the ASIC tiler; ``memory_peak``/per-tensor offsets are the static
    L2 activation layout.  ``quant`` carries the PTQ scale set the
    executor folds into requantization multipliers.
    """

    arch: str
    seq_len: int
    granule: int
    head_by_head: bool
    quant: dict  # {"s_act": float, "s_res": float, "s_w": float}
    nodes: list[PlanNode]
    tensors: dict[str, TensorSpec]
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    schedule: tuple[str, ...]
    tilings: dict[str, dict] = field(default_factory=dict)
    memory_peak: int = 0
    # decoder-family extensions (defaults keep encoder plans / old JSON valid)
    phase: str = "forward"  # "forward" | "prefill" | "decode"
    max_len: int = 0  # KV-cache capacity in tokens (0: no cache)
    # ((cache_in | None, cache_out), ...) in layer order, K before V.
    # prefill creates caches (in = None); decode updates them in place
    # (out aliases in at the same static offset).
    kv_state: tuple = ()
    # paged KV region (0/0: dense per-slot strips).  When kv_blocks > 0
    # the kv_state tensors are shared block *pools* — persistent inputs of
    # BOTH phases, shaped (kv_blocks + 1, Hkv, kv_block_size, D) with
    # physical block 0 reserved as scratch (see repro_torch.deploy.paging)
    # — and the schedule gains `pos`/`block_table` (+ `active` in decode)
    # runtime inputs.
    kv_block_size: int = 0
    kv_blocks: int = 0
    # autotuner record: chosen knobs + predicted cost (empty: not autotuned)
    autotune: dict = field(default_factory=dict)

    @property
    def weight_names(self) -> list[str]:
        return [t.name for t in self.tensors.values() if t.weight]

    @property
    def paged(self) -> bool:
        return self.kv_blocks > 0

    @property
    def fused(self) -> bool:
        return any(n.fused for n in self.nodes)

    def counts(self) -> dict[str, int]:
        ita = sum(n.engine == "ita" for n in self.nodes)
        return {"nodes": len(self.nodes), "ita": ita, "cluster": len(self.nodes) - ita}

    def flat_nodes(self) -> list[PlanNode]:
        """Schedule-ordered operators with fused regions expanded."""
        out: list[PlanNode] = []
        for n in self.nodes:
            out.extend(n.body if n.fused else (n,))
        return out

    def validate(self) -> "DeploymentPlan":
        """Check the schedule's dataflow, the fused regions, the KV
        region's in-place aliases and a paged pool's geometry; raise
        ``ValueError`` on a broken plan."""
        _require(tuple(n.name for n in self.nodes) == self.schedule, "schedule desync")
        _require(self.phase in ("forward", "prefill", "decode"), f"unknown phase {self.phase!r}")
        produced = set(self.inputs) | set(self.weight_names)
        kv_writes = {cout for _, cout in self.kv_state}
        for n in self.nodes:
            for t in n.inputs:
                _require(t in produced, f"{n.name} consumes unscheduled tensor {t}")
            if n.fused:
                self._validate_region(n, kv_writes)
            else:
                _require(not n.body, f"non-fused node {n.name} carries a body")
            produced.update(n.outputs)
        for t in self.outputs:
            _require(t in produced, f"plan output {t} never produced")
        for cin, cout in self.kv_state:
            _require(cout in produced, f"kv-cache tensor {cout} never produced")
            if cin is not None:
                _require(cin in self.inputs, f"kv-cache input {cin} not a plan input")
                a, b = self.tensors[cin], self.tensors[cout]
                _require(a.offset == b.offset and a.size == b.size,
                         f"in-place cache update {cin} -> {cout} not aliased "
                         f"({a.offset}/{a.size} vs {b.offset}/{b.size})")
        if self.paged:
            from repro_torch.deploy.paging import pool_rows

            _require(self.kv_block_size > 0, "paged plan without a block size")
            rows = pool_rows(self.kv_blocks, self.kv_block_size)
            for cin, cout in self.kv_state:
                _require(cin is not None, f"paged pool {cout} must be a persistent plan input")
                shape = self.tensors[cin].shape
                _require(shape[0] * shape[2] == rows,
                         f"pool {cin} shape {shape} does not hold "
                         f"(kv_blocks + 1) * block_size = {rows} rows")
        return self

    def _validate_region(self, n: PlanNode, kv_writes: set) -> None:
        """Fusion invariants: non-empty single-engine body, no persistent
        KV write hidden inside, dataflow closed over the region ports."""
        _require(bool(n.body), f"fused region {n.name} has an empty body")
        local = set(n.inputs)
        for b in n.body:
            _require(not b.fused, f"nested fused region {b.name} in {n.name}")
            _require(b.engine == n.engine,
                     f"fused region {n.name} ({n.engine}) contains {b.name} mapped to "
                     f"{b.engine}: fusion crossed an engine boundary")
            for out in b.outputs:
                _require(out not in kv_writes,
                         f"fused region {n.name} hides persistent KV write {out}")
            for t in b.inputs:
                _require(t in local, f"region {n.name} body node {b.name} reads {t} which "
                         "is neither a region input nor produced earlier in the body")
            local.update(b.outputs)
        for t in n.outputs:
            _require(t in local, f"region output {t} never produced by the body")

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "seq_len": self.seq_len,
            "granule": self.granule,
            "head_by_head": self.head_by_head,
            "quant": dict(self.quant),
            "nodes": [asdict(n) for n in self.nodes],
            "tensors": {k: asdict(v) for k, v in self.tensors.items()},
            "inputs": list(self.inputs),
            "outputs": list(self.outputs),
            "schedule": list(self.schedule),
            "tilings": self.tilings,
            "memory_peak": self.memory_peak,
            "phase": self.phase,
            "max_len": self.max_len,
            "kv_state": [list(p) for p in self.kv_state],
            "kv_block_size": self.kv_block_size,
            "kv_blocks": self.kv_blocks,
            "autotune": self.autotune,
        }

    @staticmethod
    def from_dict(d: dict) -> "DeploymentPlan":
        return DeploymentPlan(
            arch=d["arch"],
            seq_len=int(d["seq_len"]),
            granule=int(d["granule"]),
            head_by_head=bool(d["head_by_head"]),
            quant=dict(d["quant"]),
            nodes=[PlanNode.from_dict(n) for n in d["nodes"]],
            tensors={k: TensorSpec.from_dict(v) for k, v in d["tensors"].items()},
            inputs=tuple(d["inputs"]),
            outputs=tuple(d["outputs"]),
            schedule=tuple(d["schedule"]),
            tilings=_tupleize(d.get("tilings", {})),
            memory_peak=int(d.get("memory_peak", 0)),
            phase=d.get("phase", "forward"),
            max_len=int(d.get("max_len", 0)),
            kv_state=tuple((cin, cout) for cin, cout in d.get("kv_state", ())),
            kv_block_size=int(d.get("kv_block_size", 0)),
            kv_blocks=int(d.get("kv_blocks", 0)),
            autotune=_tupleize(d.get("autotune", {})),
        ).validate()

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_json(s: str) -> "DeploymentPlan":
        return DeploymentPlan.from_dict(json.loads(s))


@dataclass
class DecoderPlanPair:
    """The decoder deployment artifact: two *linked* schedules.

    ``prefill`` processes the whole prompt (causal attention, cache
    capture, last-token LM head); ``decode`` advances one token against
    the cache.  The link is the statically planned KV region: both plans
    allocate the same persistent cache tensors at the same offsets
    (``validate`` checks it), so the decode schedule runs against the
    memory the prefill schedule left behind.
    """

    arch: str
    seq_len: int  # prompt length the prefill schedule was lowered for
    max_len: int  # KV-cache capacity in tokens
    prefill: DeploymentPlan
    decode: DeploymentPlan
    kv_block_size: int = 0  # paged KV region (0/0 = dense)
    kv_blocks: int = 0

    @property
    def paged(self) -> bool:
        return self.kv_blocks > 0

    @property
    def kv_tensors(self) -> tuple[str, ...]:
        """Names of the shared persistent cache tensors, layer order:
        the prefill-produced strips (dense), or the pool inputs both
        phases update in place (paged)."""
        if self.paged:
            return tuple(cin for cin, _ in self.prefill.kv_state)
        return tuple(out for _, out in self.prefill.kv_state)

    def counts(self) -> dict[str, dict[str, int]]:
        return {"prefill": self.prefill.counts(), "decode": self.decode.counts()}

    def validate(self) -> "DecoderPlanPair":
        from repro_torch.deploy.memory import shared_persistent_offsets

        self.prefill.validate()
        self.decode.validate()
        _require(self.prefill.phase == "prefill" and self.decode.phase == "decode",
                 f"phases {self.prefill.phase}/{self.decode.phase}")
        _require(self.prefill.max_len == self.decode.max_len == self.max_len,
                 "max_len desync")
        _require((self.prefill.kv_block_size, self.prefill.kv_blocks)
                 == (self.decode.kv_block_size, self.decode.kv_blocks)
                 == (self.kv_block_size, self.kv_blocks), "paging config desync")
        dec_in = tuple(cin for cin, _ in self.decode.kv_state)
        if self.paged:  # both phases consume and update the same pools in place
            _require(self.kv_tensors == dec_in, f"pool desync: {self.kv_tensors} vs {dec_in}")
        for name in self.kv_tensors:
            _require(name in dec_in, f"prefill cache {name} not consumed by decode plan")
            a, b = self.prefill.tensors[name], self.decode.tensors[name]
            _require(a.shape == b.shape, f"{name}: {a.shape} vs {b.shape}")
        bad = shared_persistent_offsets(self.prefill.tensors, self.decode.tensors,
                                        self.kv_tensors)
        _require(not bad, f"KV region desync: {bad} allocated at different offsets in "
                 "the prefill vs decode schedule")
        return self

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "seq_len": self.seq_len,
            "max_len": self.max_len,
            "prefill": self.prefill.to_dict(),
            "decode": self.decode.to_dict(),
            "kv_block_size": self.kv_block_size,
            "kv_blocks": self.kv_blocks,
        }

    @staticmethod
    def from_dict(d: dict) -> "DecoderPlanPair":
        return DecoderPlanPair(
            arch=d["arch"],
            seq_len=int(d["seq_len"]),
            max_len=int(d["max_len"]),
            prefill=DeploymentPlan.from_dict(d["prefill"]),
            decode=DeploymentPlan.from_dict(d["decode"]),
            kv_block_size=int(d.get("kv_block_size", 0)),
            kv_blocks=int(d.get("kv_blocks", 0)),
        ).validate()

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_json(s: str) -> "DecoderPlanPair":
        return DecoderPlanPair.from_dict(json.loads(s))

