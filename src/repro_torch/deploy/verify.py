"""Audits of the deployment flow (torch port, the KV-sharing part).

Ported: the structured :class:`PlanDiagnostic` record and
:class:`PlanVerificationError`, and the runtime audit of a paged pool's
sharing structure, :func:`verify_sharing` / :func:`check_sharing` (rules
KV006, refcount consistency, and KV007, copy-on-write before a write)
over the :class:`KVSharingState` snapshot that
``InferenceSession.sharing_state()`` returns.  Fields and rules are the
JAX package's, so a port session's snapshot audits as the reference's.
``Engine.audit_sharing`` runs the audit over a live pool.  The static
plan verifier (``verify_plan``, ``verify_pair``, ``compile(verify=)``)
waits for ROADMAP queue 1, item 3.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PlanDiagnostic:
    """One structured finding of an audit (the JAX package's record)."""

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

    ``refcounts`` maps every *live* physical block to its allocator
    refcount, ``tables`` maps each occupied slot to its block chain in
    logical order (scratch entries excluded), ``index_blocks`` lists the
    prefix index's pins — one entry per reference, so a block pinned by
    both a trie node and a terminal appears twice.  ``writes`` optionally
    carries planned writes for a copy-on-write audit.
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
