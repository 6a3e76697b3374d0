"""Static plan verification and the KV-sharing audit (torch port).

Every compiled artifact is audited, never trusted.  The paper's
deployment flow ends in a fully static artifact: engine assignments,
tiling solutions, memory offsets and the execution order are decided
offline, so every hazard that would corrupt memory or compute the wrong
function is decidable from the plan alone.  This module is that audit,
a port of the JAX package's ``deploy/verify.py`` rule for rule: a pass
over any :class:`~repro_torch.deploy.plan.DeploymentPlan` or
:class:`~repro_torch.deploy.plan.DecoderPlanPair` (fused and paged plans
included) that emits structured :class:`PlanDiagnostic` records, with
the reference's rule ids, severities, messages and hints in the
reference's order, so that both packages report one artifact alike.

Four analyses:

1. **Dataflow / lifetime** (``DF*``, ``MEM*``) — def-before-use over the
   flattened schedule, dead intermediates, schedule desync, and two
   tensors sharing arena bytes while both live (fused-region bodies are
   expanded by ``flat_nodes()``).
2. **Persistent-KV hazards** (``KV*``, ``PAIR*``) — stale ``cache_in``
   reads after the in-place write, alias offsets in a plan and across the
   prefill/decode pair, fusion legality, and paged-pool hygiene (only
   :data:`~repro_torch.deploy.paging.PAGED_KV_KINDS` may touch a pool).
3. **Quant ranges** (``QNT*``) — the int32 GEMM accumulator bound,
   requantization multiplier representability, scale sanity.
4. **Engine legality** (``ENG*``) — the accelerator-support decision
   re-derived from each node's attrs through the lowering's own
   :func:`~repro_torch.deploy.patterns.plan_node_opdesc` /
   :func:`~repro_torch.core.heterogeneous.ita_supports`, diffed against
   the recorded engine column.

A fifth analysis audits runtime paged-pool state rather than the plan:
**KV sharing** (``KV006``/``KV007``) over a :class:`KVSharingState`
snapshot, which ``InferenceSession.sharing_state()`` returns and
``Engine.audit_sharing`` runs: refcounts against the references slot
tables and the prefix index hold, and copy-on-write before a write.

Entry points: :func:`verify` (diagnostics list), :func:`check` (raise
:class:`PlanVerificationError` on errors; ``strict=True`` promotes
warnings), :func:`verify_sharing` / :func:`check_sharing`, and the CLI::

    python -m repro_torch.deploy.verify plan.json [pair.json ...] [--strict]

which loads artifacts *without* the constructor's validation
(``from_dict(validate=False)``) so a corrupt file still yields the full
report; it exits 0 when clean, 1 on findings and 2 on an unreadable
file.  ``compile(cfg)`` runs :func:`check` by default, on a fresh
lowering and on a cache hit alike, and ``CompiledModel.load`` on every
file it reads.

Rule catalog (severity in parentheses):

====== ========= =========================================================
rule   severity  meaning
====== ========= =========================================================
DF001  error     tensor consumed before (or without) being produced
DF002  warning   dead intermediate: produced, never consumed, not an output
DF003  error     plan output never produced by the schedule
DF004  error     ``nodes`` order and ``schedule`` tuple disagree
MEM001 error     two live tensors overlap in the static arena
MEM002 error     allocation extends beyond the recorded ``memory_peak``
KV001  error     KV WAR hazard: stale ``cache_in`` read after the in-place write
KV002  error     KV alias/offset contract broken (in-plan or across the pair)
KV003  error     illegal fused region (barrier/KV write inside, engine mix,
                 nesting, port-closure violation)
KV004  error     paged block pool touched by a non-paged kind
KV005  error     paged pool geometry broken (block size / pool rows)
KV006  error     refcount inconsistent with table + prefix-index references
KV007  error     write into a shared block without a preceding copy-on-write
PAIR01 error     prefill/decode pair incoherent (phase, max_len, paging)
QNT001 error     requant multiplier unrepresentable (saturated / zero)
QNT002 error     int32 GEMM accumulator can overflow
QNT002 warning   accumulator exceeds the exact-decomposition requant bound
QNT003 error     non-finite or non-positive quantization scale
ENG001 error     engine column contradicts the support predicate
ENG002 error     dispatch kind unknown to the executor vocabulary
====== ========= =========================================================
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

from repro_torch.deploy.memory import shared_persistent_offsets
from repro_torch.deploy.paging import PAGED_KV_KINDS, pool_rows
from repro_torch.deploy.patterns import FUSION_BARRIERS, KIND_BY_OP, plan_node_opdesc
from repro_torch.deploy.plan import DecoderPlanPair, DeploymentPlan, PlanNode

_INT32_LIMIT = 1 << 31
#: relative representation error above which a requant multiplier is
#: considered broken: half an int8 LSB of the full-scale output.
_MULT_REL_TOL = 1.0 / 256.0
#: dispatch kinds the executor can bind (plus the region mega-node).
_KNOWN_KINDS = frozenset(KIND_BY_OP.values()) | {"fused_region"}


@dataclass(frozen=True)
class PlanDiagnostic:
    """One structured finding of the static verifier."""

    rule: str  # catalog id, e.g. "MEM001"
    severity: str  # "error" | "warning"
    message: str
    plan: str = "plan"  # which schedule ("plan" | "prefill" | "decode" | "pair")
    node: str = ""  # offending node name ("" when tensor-level)
    tensor: str = ""  # offending tensor name ("" when node-level)
    hint: str = ""  # how to fix / what the rule protects
    # who produced the finding: "" for plan verification, "audit" for a
    # point-in-time audit_sharing() pass, "sanitizer" when the shadow
    # block sanitizer triggered the check (continuous detection)
    source: str = ""

    def format(self) -> str:
        where = self.plan
        if self.node:
            where += f":{self.node}"
        if self.tensor:
            where += f"[{self.tensor}]"
        out = f"{self.severity.upper():7s} {self.rule} {where}: {self.message}"
        if self.hint:
            out += f"  ({self.hint})"
        if self.source:
            out += f" [source={self.source}]"
        return out

    def __str__(self) -> str:
        return self.format()


class PlanVerificationError(ValueError):
    """The static verifier found hazard(s) in a plan artifact.

    Carries the *full* diagnostics list (warnings included) so callers
    see every defect of a corrupt artifact in one raise.
    """

    def __init__(self, diagnostics, *, context: str = ""):
        self.diagnostics = tuple(diagnostics)
        errors = [d for d in self.diagnostics if d.severity == "error"]
        head = "static plan verification failed"
        if context:
            head += f" ({context})"
        head += (
            f": {len(errors)} error(s), "
            f"{len(self.diagnostics) - len(errors)} warning(s)"
        )
        lines = "\n  ".join(d.format() for d in self.diagnostics)
        super().__init__(f"{head}\n  {lines}")


@dataclass
class _Ctx:
    """Per-plan verification context: shared lookups + the sink."""

    plan: DeploymentPlan
    label: str
    diags: list = field(default_factory=list)

    def __post_init__(self):
        self.flat: list[PlanNode] = self.plan.flat_nodes()
        self.weights = {t.name for t in self.plan.tensors.values() if t.weight}
        self.kv_in = {cin for cin, _ in self.plan.kv_state if cin is not None}
        self.kv_out = {cout for _, cout in self.plan.kv_state}

    def emit(self, rule: str, severity: str, message: str, *,
             node: str = "", tensor: str = "", hint: str = "") -> None:
        self.diags.append(PlanDiagnostic(
            rule=rule, severity=severity, message=message,
            plan=self.label, node=node, tensor=tensor, hint=hint,
        ))


# ---------------------------------------------------------------------------
# Analysis 1: dataflow + lifetimes + arena overlap
# ---------------------------------------------------------------------------

def _check_dataflow(ctx: _Ctx) -> None:
    plan = ctx.plan
    if tuple(n.name for n in plan.nodes) != tuple(plan.schedule):
        ctx.emit(
            "DF004", "error",
            "nodes order and schedule tuple disagree",
            hint="the executor walks nodes; the schedule is the audited order",
        )
    produced = set(plan.inputs) | ctx.weights
    for n in ctx.flat:
        for t in n.inputs:
            if t not in produced:
                ctx.emit(
                    "DF001", "error",
                    f"consumes {t!r} before it is produced",
                    node=n.name, tensor=t,
                    hint="schedule order violates dataflow; the executor "
                         "would read garbage (or KeyError at dispatch)",
                )
        produced.update(n.outputs)
    for t in plan.outputs:
        if t not in produced:
            ctx.emit(
                "DF003", "error",
                f"plan output {t!r} never produced by the schedule",
                tensor=t,
            )
    consumed = {t for n in ctx.flat for t in n.inputs}
    keep = set(plan.outputs) | ctx.kv_out
    for n in ctx.flat:
        for t in n.outputs:
            if t not in consumed and t not in keep:
                ctx.emit(
                    "DF002", "warning",
                    f"dead intermediate: {t!r} is produced but never "
                    f"consumed and is not a plan output",
                    node=n.name, tensor=t,
                    hint="dead code in the schedule wastes dispatches and "
                         "arena bytes",
                )


def _lifetimes(ctx: _Ctx) -> dict[str, tuple[int, int]]:
    """{tensor: (first touch, last touch)} over the *flattened* schedule.

    Robust to broken schedules (a consumer before the producer widens the
    interval instead of crashing) — the verifier must keep analyzing a
    plan that already failed DF001.  Persistent KV tensors span the whole
    schedule: they must survive across plan invocations.
    """
    last = max(len(ctx.flat) - 1, 0)
    lt: dict[str, list[int]] = {}

    def touch(t: str, i: int) -> None:
        iv = lt.setdefault(t, [i, i])
        iv[0] = min(iv[0], i)
        iv[1] = max(iv[1], i)

    for t in ctx.plan.inputs:
        touch(t, 0)
    for i, n in enumerate(ctx.flat):
        for t in n.inputs:
            touch(t, i)
        for t in n.outputs:
            touch(t, i)
    for t in ctx.plan.outputs:
        if t in lt:
            touch(t, last)
    for t in ctx.kv_in | ctx.kv_out:
        if t in lt:
            lt[t] = [0, last]
    return {t: (iv[0], iv[1]) for t, iv in lt.items()}


def _check_memory(ctx: _Ctx) -> None:
    plan = ctx.plan
    lt = _lifetimes(ctx)
    # the in-place alias pairs deliberately share bytes: treat each
    # (cache_in, cache_out) pair as one allocation record
    group: dict[str, int] = {}
    for gid, (cin, cout) in enumerate(plan.kv_state):
        group[cout] = gid
        if cin is not None:
            group[cin] = gid
    records = []
    for name, spec in plan.tensors.items():
        if spec.weight or spec.offset is None or spec.size <= 0:
            continue
        if name not in lt:
            continue  # never scheduled: DF002/DF003 territory, not MEM
        start, end = lt[name]
        records.append((name, spec.offset, spec.size, start, end,
                        group.get(name, -1 - len(records))))
        if plan.memory_peak and spec.offset + spec.size > plan.memory_peak:
            ctx.emit(
                "MEM002", "error",
                f"allocation [{spec.offset}, {spec.offset + spec.size}) "
                f"extends beyond memory_peak {plan.memory_peak}",
                tensor=name,
                hint="the target arena is sized to memory_peak; this "
                     "write lands outside it",
            )
    for i, (na, oa, sa, ta0, ta1, ga) in enumerate(records):
        for nb, ob, sb, tb0, tb1, gb in records[i + 1:]:
            if ga == gb:
                continue  # same in-place alias pair: overlap is the contract
            time_overlap = not (ta1 < tb0 or tb1 < ta0)
            mem_overlap = not (oa + sa <= ob or ob + sb <= oa)
            if time_overlap and mem_overlap:
                ctx.emit(
                    "MEM001", "error",
                    f"{na!r} [{oa}, {oa + sa}) live [{ta0}, {ta1}] overlaps "
                    f"{nb!r} [{ob}, {ob + sb}) live [{tb0}, {tb1}]",
                    tensor=na,
                    hint="two live tensors share arena bytes: one dispatch "
                         "silently corrupts the other's data",
                )


# ---------------------------------------------------------------------------
# Analysis 2: persistent-KV hazards + fusion legality + paged hygiene
# ---------------------------------------------------------------------------

def _check_kv(ctx: _Ctx) -> None:
    plan = ctx.plan
    for cin, cout in plan.kv_state:
        spec_out = plan.tensors.get(cout)
        if spec_out is None:
            ctx.emit("KV002", "error",
                     f"kv tensor {cout!r} has no TensorSpec", tensor=cout)
            continue
        writer = next(
            (i for i, n in enumerate(ctx.flat) if cout in n.outputs), None
        )
        if writer is None:
            ctx.emit(
                "KV001", "error",
                f"in-place cache write {cout!r} is never scheduled",
                tensor=cout,
                hint="the persistent KV region would go stale this step",
            )
        if cin is None:
            continue
        spec_in = plan.tensors.get(cin)
        if spec_in is None:
            ctx.emit("KV002", "error",
                     f"kv tensor {cin!r} has no TensorSpec", tensor=cin)
            continue
        if cin not in plan.inputs:
            ctx.emit(
                "KV002", "error",
                f"cache input {cin!r} is not a plan input",
                tensor=cin,
                hint="the in-place update contract needs the cache to "
                     "enter the schedule as an input",
            )
        if (spec_in.offset, spec_in.size) != (spec_out.offset, spec_out.size):
            ctx.emit(
                "KV002", "error",
                f"in-place pair {cin!r} -> {cout!r} not aliased: "
                f"{spec_in.offset}/{spec_in.size} vs "
                f"{spec_out.offset}/{spec_out.size}",
                tensor=cout,
                hint="decode must update the exact bytes prefill wrote; "
                     "a moved alias splits the KV region",
            )
        if writer is not None:
            for i, n in enumerate(ctx.flat):
                if i > writer and cin in n.inputs:
                    ctx.emit(
                        "KV001", "error",
                        f"reads stale cache {cin!r} after the in-place "
                        f"write {cout!r} at schedule index {writer}",
                        node=n.name, tensor=cin,
                        hint="WAR hazard on the in-place cache update: "
                             "on-target this reads the NEW rows, not the "
                             "snapshot the schedule assumed",
                    )

    for n in plan.nodes:
        if n.fused:
            _check_region(ctx, n)
        elif n.body:
            ctx.emit(
                "KV003", "error",
                f"non-fused node carries a {len(n.body)}-node body",
                node=n.name,
            )

    if plan.paged:
        _check_paged(ctx)
    elif plan.kv_block_size:
        ctx.emit(
            "KV005", "error",
            f"kv_block_size {plan.kv_block_size} without kv_blocks",
            hint="paging options come as a pair",
        )


def _check_region(ctx: _Ctx, n: PlanNode) -> None:
    if not n.body:
        ctx.emit("KV003", "error", "fused region has an empty body", node=n.name)
        return
    local = set(n.inputs)
    for b in n.body:
        if b.fused:
            ctx.emit("KV003", "error",
                     f"nested fused region {b.name!r}", node=n.name)
        if b.engine != n.engine:
            ctx.emit(
                "KV003", "error",
                f"region on {n.engine!r} contains {b.name!r} mapped to "
                f"{b.engine!r}",
                node=n.name,
                hint="fusion crossed an engine boundary: one dispatch "
                     "cannot span two engines",
            )
        if b.kind in FUSION_BARRIERS:
            ctx.emit(
                "KV003", "error",
                f"region swallows fusion barrier {b.name!r} ({b.kind})",
                node=n.name,
                hint="persistent KV writes are cross-dispatch contracts; "
                     "they must stay top-level",
            )
        for out in b.outputs:
            if out in ctx.kv_out:
                ctx.emit(
                    "KV003", "error",
                    f"region hides persistent KV write {out!r} "
                    f"(body node {b.name!r})",
                    node=n.name, tensor=out,
                )
        for t in b.inputs:
            if t not in local:
                ctx.emit(
                    "KV003", "error",
                    f"body node {b.name!r} reads {t!r}: neither a region "
                    f"input nor produced earlier in the body",
                    node=n.name, tensor=t,
                    hint="region ports must close over the body dataflow",
                )
        local.update(b.outputs)
    for t in n.outputs:
        if t not in local:
            ctx.emit(
                "KV003", "error",
                f"region output {t!r} never produced by the body",
                node=n.name, tensor=t,
            )


def _check_paged(ctx: _Ctx) -> None:
    plan = ctx.plan
    if plan.kv_block_size <= 0:
        ctx.emit("KV005", "error",
                 f"paged plan with kv_block_size {plan.kv_block_size}")
        return
    rows = pool_rows(plan.kv_blocks, plan.kv_block_size)
    pool_names = set()
    for cin, cout in plan.kv_state:
        pool_names.update(x for x in (cin, cout) if x is not None)
        if cin is None:
            ctx.emit(
                "KV005", "error",
                f"paged pool {cout!r} is not a persistent plan input",
                tensor=cout,
                hint="both phases update the shared pool in place",
            )
            continue
        spec = plan.tensors.get(cin)
        if spec is None:
            continue  # KV002 already fired
        shape = spec.shape
        if len(shape) != 4 or shape[0] * shape[2] != rows or \
                shape[2] != plan.kv_block_size:
            ctx.emit(
                "KV005", "error",
                f"pool {cin!r} shape {shape} does not hold "
                f"(kv_blocks + 1) * block_size = {rows} rows of "
                f"block_size {plan.kv_block_size}",
                tensor=cin,
                hint="block-table row arithmetic indexes out of the pool",
            )
    for n in ctx.flat:
        if n.kind in PAGED_KV_KINDS or n.kind == "fused_region":
            continue
        touched = (set(n.inputs) | set(n.outputs)) & pool_names
        for t in sorted(touched):
            ctx.emit(
                "KV004", "error",
                f"{n.kind!r} node touches paged pool {t!r}",
                node=n.name, tensor=t,
                hint="only cache_write_paged/attn_paged route through the "
                     "block table; a direct access reads the scratch "
                     "block or another slot's live rows",
            )


# ---------------------------------------------------------------------------
# Analysis 3: quant-range propagation
# ---------------------------------------------------------------------------

def _scale_entries(n: PlanNode):
    """(attr path, value) for every quantization scale the node carries."""
    for key in ("scales", "proj_scales", "out_scales"):
        vals = n.attrs.get(key)
        if isinstance(vals, (tuple, list)):
            for i, v in enumerate(vals):
                yield f"{key}[{i}]", v
    for key in ("s_act", "s_out", "s_gamma", "s_preact", "scale"):
        if key in n.attrs:
            yield key, n.attrs[key]


def _check_quant(ctx: _Ctx) -> None:
    from repro_torch.quant.qparams import quantize_multiplier

    for n in ctx.flat:
        bad_scale = False
        for path, v in _scale_entries(n):
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not math.isfinite(v) or v <= 0:
                bad_scale = True
                ctx.emit(
                    "QNT003", "error",
                    f"scale {path} = {v!r} is not a finite positive number",
                    node=n.name,
                    hint="requantization folds scales into fixed-point "
                         "multipliers; this one cannot be folded",
                )
        if n.kind != "gemm" or bad_scale:
            continue
        scales = n.attrs.get("scales")
        dims = n.attrs.get("dims")
        if not (isinstance(scales, (tuple, list)) and len(scales) == 3):
            continue
        if not (isinstance(dims, (tuple, list)) and len(dims) == 3):
            continue
        s_in, s_w, s_out = (float(s) for s in scales)
        real = s_in * s_w / s_out
        mult, shift = quantize_multiplier(real)
        if mult == 0:
            ctx.emit(
                "QNT001", "error",
                f"requant multiplier {real:.3e} underflows to zero "
                f"(mult=0 at shift={shift})",
                node=n.name,
                hint="every output of this GEMM requantizes to 0; the "
                     "scale ratio s_in*s_w/s_out is too small to represent",
            )
            continue
        represented = mult * 2.0 ** -shift
        rel = abs(represented - real) / real
        if rel > _MULT_REL_TOL:
            ctx.emit(
                "QNT001", "error",
                f"requant multiplier {real:.3e} is unrepresentable: "
                f"mult={mult}, shift={shift} realizes {represented:.3e} "
                f"(relative error {rel:.2%})",
                node=n.name,
                hint="the 15-bit multiplier grid saturated — the scale "
                     "ratio s_in*s_w/s_out is out of range (broken "
                     "calibration?)",
            )
            continue
        k = int(dims[1])
        # worst-case |acc| for a k-deep int8 dot: 127 (activation) x 127
        # (symmetric weight grid) per term.  Bias adds int32 headroom the
        # lowering bounds separately; the k-term product dominates.
        acc_bound = k * 127 * 127
        if acc_bound >= _INT32_LIMIT:
            ctx.emit(
                "QNT002", "error",
                f"int32 accumulator can overflow: k={k} gives worst-case "
                f"|acc| = {acc_bound} >= 2^31",
                node=n.name,
                hint="the integer GEMM accumulates in int32; this "
                     "contraction depth wraps around",
            )
            continue
        # the exact base-1024 requant decomposition needs hi*mult to stay
        # in int32 (see repro_torch.quant.qparams.requantize)
        hi_bound = (acc_bound >> 10) + 1
        if hi_bound * mult >= _INT32_LIMIT:
            ctx.emit(
                "QNT002", "warning",
                f"worst-case accumulator {acc_bound} (k={k}) with "
                f"mult={mult} exceeds the exact requant decomposition "
                f"bound (hi*mult = {hi_bound * mult} >= 2^31)",
                node=n.name,
                hint="exactness holds for the value range actually "
                     "reached at calibration, not the adversarial bound; "
                     "review if outputs saturate",
            )


# ---------------------------------------------------------------------------
# Analysis 4: engine legality
# ---------------------------------------------------------------------------

def _check_engines(ctx: _Ctx) -> None:
    from repro_torch.core.heterogeneous import ita_supports

    granule = ctx.plan.granule
    for n in ctx.flat + [m for m in ctx.plan.nodes if m.fused]:
        if n.engine not in ("ita", "cluster"):
            ctx.emit(
                "ENG001", "error",
                f"unknown engine {n.engine!r}",
                node=n.name,
                hint="the dispatch table only resolves ita/cluster",
            )
            continue
        if n.kind not in _KNOWN_KINDS:
            ctx.emit(
                "ENG002", "error",
                f"dispatch kind {n.kind!r} is not in the executor "
                f"vocabulary",
                node=n.name,
                hint=f"known kinds: {sorted(_KNOWN_KINDS)}",
            )
            continue
        if n.fused:
            continue  # region engine vs body engines is KV003's job
        try:
            expected = (
                "ita" if ita_supports(plan_node_opdesc(n, granule), granule)
                else "cluster"
            )
        except (KeyError, ValueError, TypeError, IndexError):
            continue  # malformed attrs: structural rules cover it
        if n.engine != expected:
            ctx.emit(
                "ENG001", "error",
                f"mapped to {n.engine!r} but the support predicate at "
                f"granule {granule} says {expected!r}",
                node=n.name,
                hint="the static engine column must match what "
                     "DispatchTable.resolve does at run time — this node "
                     "would execute on the wrong engine (or not at all)",
            )


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def verify_plan(plan: DeploymentPlan, label: str = "plan") -> list[PlanDiagnostic]:
    """All four analyses over one plan; returns structured diagnostics."""
    ctx = _Ctx(plan, label)
    _check_dataflow(ctx)
    _check_memory(ctx)
    _check_kv(ctx)
    _check_quant(ctx)
    _check_engines(ctx)
    return ctx.diags


def verify_pair(pair: DecoderPlanPair) -> list[PlanDiagnostic]:
    """Member-plan analyses plus the cross-plan KV-region contract."""
    diags = verify_plan(pair.prefill, "prefill")
    diags += verify_plan(pair.decode, "decode")

    def emit(rule, message, *, tensor="", hint=""):
        diags.append(PlanDiagnostic(
            rule=rule, severity="error", message=message,
            plan="pair", tensor=tensor, hint=hint,
        ))

    if pair.prefill.phase != "prefill" or pair.decode.phase != "decode":
        emit("PAIR01",
             f"member phases are {pair.prefill.phase!r}/{pair.decode.phase!r}, "
             f"expected prefill/decode")
    if not (pair.prefill.max_len == pair.decode.max_len == pair.max_len):
        emit("PAIR01",
             f"max_len desync: pair {pair.max_len}, prefill "
             f"{pair.prefill.max_len}, decode {pair.decode.max_len}")
    for p in (pair.prefill, pair.decode):
        if (p.kv_block_size, p.kv_blocks) != (pair.kv_block_size, pair.kv_blocks):
            emit("PAIR01",
                 f"paging desync: pair {pair.kv_block_size}/{pair.kv_blocks}, "
                 f"{p.phase} {p.kv_block_size}/{p.kv_blocks}")

    if pair.paged:
        pre = tuple(cin for cin, _ in pair.prefill.kv_state)
        dec = tuple(cin for cin, _ in pair.decode.kv_state)
        if pre != dec:
            emit("PAIR01", f"paged pool sets disagree: {pre} vs {dec}")
        shared = pre
    else:
        dec_in = {cin for cin, _ in pair.decode.kv_state}
        shared = tuple(out for _, out in pair.prefill.kv_state)
        for name in shared:
            if name not in dec_in:
                emit("KV002",
                     f"prefill cache {name!r} is not consumed by the "
                     f"decode plan", tensor=name,
                     hint="decode would attend a cache that was never "
                          "linked to prefill's")
    for name in shared:
        a = pair.prefill.tensors.get(name)
        b = pair.decode.tensors.get(name)
        if a is None or b is None:
            continue  # member-plan KV002 already fired
        if a.shape != b.shape:
            emit("KV002",
                 f"shared KV tensor {name!r} shapes disagree: "
                 f"{a.shape} vs {b.shape}", tensor=name)
    bad = shared_persistent_offsets(
        pair.prefill.tensors, pair.decode.tensors,
        [t for t in shared if t in pair.prefill.tensors
         and t in pair.decode.tensors],
    )
    for name in bad:
        a = pair.prefill.tensors[name]
        b = pair.decode.tensors[name]
        emit("KV002",
             f"shared KV tensor {name!r} allocated at prefill "
             f"{a.offset}/{a.size} vs decode {b.offset}/{b.size}",
             tensor=name,
             hint="the linked schedules share ONE static KV region; a "
                  "moved offset means decode attends bytes prefill never "
                  "wrote")
    return diags


def verify(artifact: DeploymentPlan | DecoderPlanPair) -> list[PlanDiagnostic]:
    """Dispatch on the artifact family."""
    if isinstance(artifact, DecoderPlanPair):
        return verify_pair(artifact)
    if isinstance(artifact, DeploymentPlan):
        return verify_plan(artifact)
    raise TypeError(
        f"verify() takes a DeploymentPlan or DecoderPlanPair, got "
        f"{type(artifact).__name__}"
    )


def check(
    artifact: DeploymentPlan | DecoderPlanPair,
    *,
    strict: bool = False,
    context: str = "",
) -> list[PlanDiagnostic]:
    """Verify and *raise* :class:`PlanVerificationError` on any error
    (``strict=True``: on any diagnostic at all).  Returns the full
    diagnostics list — warnings only, unless strict never raised."""
    diags = verify(artifact)
    offending = diags if strict else [d for d in diags if d.severity == "error"]
    if offending:
        raise PlanVerificationError(diags, context=context)
    return diags


# ---------------------------------------------------------------------------
# KV sharing audit (KV006 / KV007) — runtime pool state, not the static plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KVWrite:
    """One planned write into the paged pool, for the COW-legality audit.

    ``slot`` is the writing request slot, ``block`` the physical target,
    ``cow`` whether a copy-on-write was performed for this write (the
    target must then be exclusively owned by the writer).
    """

    slot: int
    block: int
    cow: bool = False


@dataclass(frozen=True)
class KVSharingState:
    """Snapshot of the paged pool's sharing structure.

    ``refcounts`` maps every *live* physical block to
    its allocator refcount, ``tables`` maps each occupied slot to its
    block chain in logical order (scratch entries excluded),
    ``index_blocks`` lists the prefix index's pins — one entry per
    reference, so a block pinned by both a trie node and a terminal
    appears twice.  ``writes`` optionally carries planned writes for a
    copy-on-write audit.
    """

    n_blocks: int
    refcounts: dict
    tables: dict
    index_blocks: tuple = ()
    writes: tuple = ()


def verify_sharing(state: KVSharingState,
                   label: str = "kv-pool", *,
                   source: str = "audit") -> list[PlanDiagnostic]:
    """Audit a :class:`KVSharingState` snapshot.

    **KV006 — refcount consistency.**  Every block a slot table or the
    prefix index references must be live (refcount >= 1) and in range,
    and every live block's refcount must equal exactly the number of
    references actually held (table entries + index pins).  A refcount
    above the held references leaks pool capacity forever; below, the
    block returns to the free list while still reachable — another
    request's writes then land in a live trajectory's rows.

    **KV007 — COW-before-write legality.**  A planned write must target
    a block in the writer's own table; a non-COW write may only hit a
    block with refcount 1 (exclusively owned); a COW write's fresh
    target must likewise end up exclusively owned.  Writing a shared
    block in place would silently corrupt every sibling sharing it.
    """
    diags: list[PlanDiagnostic] = []

    def emit(rule, message, *, node="", tensor="", hint=""):
        diags.append(PlanDiagnostic(
            rule=rule, severity="error", message=message,
            plan=label, node=node, tensor=tensor, hint=hint,
            source=source,
        ))

    refs = {int(b): int(c) for b, c in state.refcounts.items()}
    held: dict[int, int] = {}

    def reference(block, holder):
        b = int(block)
        held[b] = held.get(b, 0) + 1
        if b < 1 or b > state.n_blocks:
            emit("KV006",
                 f"{holder} references block {b}, outside the pool's "
                 f"1..{state.n_blocks} (0 is scratch)",
                 node=holder, tensor=f"block{b}",
                 hint="tables and the index may only hold allocator-issued "
                      "ids — scratch is a write sink, never referenced")
        elif refs.get(b, 0) < 1:
            emit("KV006",
                 f"{holder} references block {b} which is dead "
                 f"(refcount 0 / on the free list)",
                 node=holder, tensor=f"block{b}",
                 hint="a freed-but-referenced block will be handed to the "
                      "next allocation and overwritten under this holder")

    for slot, chain in sorted(state.tables.items()):
        for b in chain:
            reference(b, f"slot{int(slot)}")
    for b in state.index_blocks:
        reference(b, "prefix-index")

    for b in sorted(refs):
        have = held.get(b, 0)
        if refs[b] != have:
            emit("KV006",
                 f"block {b} refcount is {refs[b]} but {have} reference(s) "
                 f"are actually held",
                 tensor=f"block{b}",
                 hint="refcount > references leaks the block forever; "
                      "refcount < references frees it while reachable")

    for w in state.writes:
        slot, b = int(w.slot), int(w.block)
        chain = tuple(int(x) for x in state.tables.get(slot, ()))
        where = f"slot{slot}"
        if b not in chain:
            emit("KV007",
                 f"write targets block {b} which is not in slot {slot}'s "
                 f"table {chain}",
                 node=where, tensor=f"block{b}",
                 hint="a slot may only write rows its own table maps")
            continue
        if refs.get(b, 0) > 1 and not w.cow:
            emit("KV007",
                 f"write into block {b} (refcount {refs[b]}) without a "
                 f"preceding copy-on-write",
                 node=where, tensor=f"block{b}",
                 hint="cow() the block first — an in-place write would "
                      "corrupt every sibling sharing it")
        elif w.cow and refs.get(b, 0) != 1:
            emit("KV007",
                 f"copy-on-write produced block {b} with refcount "
                 f"{refs.get(b, 0)}, expected exclusive ownership (1)",
                 node=where, tensor=f"block{b}",
                 hint="a COW target shared again before the write defeats "
                      "the copy")
    return diags


def check_sharing(
    state: KVSharingState,
    *,
    strict: bool = False,
    context: str = "",
    source: str = "audit",
) -> list[PlanDiagnostic]:
    """:func:`verify_sharing` and raise :class:`PlanVerificationError` on
    any error (KV006/KV007 are all errors, so ``strict`` only matters if
    warning-severity sharing rules are added later).  ``source`` tags
    each diagnostic with who triggered the audit — ``"audit"`` for a
    point-in-time :meth:`Engine.audit_sharing` pass, ``"sanitizer"``
    when the shadow block sanitizer escalated to a full-state audit."""
    diags = verify_sharing(state, source=source)
    offending = diags if strict else [d for d in diags if d.severity == "error"]
    if offending:
        raise PlanVerificationError(diags, context=context)
    return diags


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.deploy.verify plan.json [--strict]
# ---------------------------------------------------------------------------

def load_artifact(path: str) -> DeploymentPlan | DecoderPlanPair:
    """Deserialize a plan/pair/CompiledModel JSON *without* the
    constructor's assert-based validation — the whole point of the CLI is
    auditing artifacts too broken to construct normally."""
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict):
        raise ValueError(f"{path}: not a JSON object")
    if isinstance(payload.get("format"), str) and "artifact" in payload:
        payload = payload["artifact"]  # CompiledModel / cache envelope
    if "prefill" in payload and "decode" in payload:
        return DecoderPlanPair.from_dict(payload, validate=False)
    return DeploymentPlan.from_dict(payload, validate=False)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.deploy.verify",
        description="Static plan verification: memory hazards, KV "
                    "ordering, quant ranges, engine legality.",
    )
    ap.add_argument("paths", nargs="+", metavar="plan.json",
                    help="DeploymentPlan / DecoderPlanPair / CompiledModel "
                         "JSON artifacts")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on warnings too")
    args = ap.parse_args(argv)

    rc = 0
    for path in args.paths:
        try:
            artifact = load_artifact(path)
        except Exception as e:  # noqa: BLE001 — CLI surface
            print(f"{path}: cannot load artifact: {e}")
            rc = max(rc, 2)
            continue
        diags = verify(artifact)
        errors = sum(d.severity == "error" for d in diags)
        warnings = len(diags) - errors
        for d in diags:
            print(f"{path}: {d.format()}")
        verdict = "FAIL" if errors or (args.strict and warnings) else "OK"
        print(f"{path}: {verdict} — {errors} error(s), {warnings} warning(s)")
        if verdict == "FAIL":
            rc = max(rc, 1)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
