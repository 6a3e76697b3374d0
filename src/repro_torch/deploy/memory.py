"""Static memory planner — lifetime analysis + offset assignment.

The paper: "co-optimize operator tiling and static memory allocation ...
fully static offline memory layout generation" — tinyML targets have no
MMU, so every activation gets a fixed address at compile time.  Attention
graphs branch heavily (Q/K/V/logits/A live simultaneously), which is the
paper's motivation for proper lifetime analysis over the schedule.

Algorithm: tensors live from producer index to last-consumer index; a
greedy best-fit over the address space assigns offsets so that tensors
with overlapping lifetimes never overlap in memory (``MemoryPlan.check``
asserts this invariant).

Decoder plans add two notions on top (Deeploy's KV-cache handling for
small language models, arXiv 2408.04413):

* **persistent** tensors — KV-cache buffers whose lifetime spans the
  whole schedule instead of def→last-use.  They are allocated first, in
  sorted-name order, stacked contiguously from offset 0, so that two
  plans sharing the same persistent tensor set (the prefill and the
  decode-step schedule) place them at *identical* offsets — the linked
  plans share one static KV region.
* **aliases** — the decode plan's ``cache_new`` outputs update the cache
  in place; the planner maps an alias onto the exact allocation record
  of its source tensor (same offset, same size).

The paged KV region's pool allocations wait for the paging slice.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.deploy.graph import Graph


@dataclass(frozen=True)
class Allocation:
    tensor: str
    offset: int
    size: int
    start: int  # schedule index of first def
    end: int  # schedule index of last use


class MemoryPlanError(ValueError):
    """The static allocator produced (or was handed) an illegal layout.

    Raised by the lowering's post-allocation check with the *offending
    tensor pairs and their byte ranges* attached — a silent ``False``
    from an unchecked boolean would surface later as data corruption on
    the target, which is exactly what static planning must rule out.
    """

    def __init__(self, violations: list[tuple["Allocation", "Allocation"]]):
        self.violations = list(violations)
        lines = [
            f"{a.tensor} [{a.offset}, {a.offset + a.size}) live "
            f"[{a.start}, {a.end}] overlaps {b.tensor} "
            f"[{b.offset}, {b.offset + b.size}) live [{b.start}, {b.end}]"
            for a, b in self.violations
        ]
        super().__init__(
            "static memory plan has overlapping live tensors: "
            + "; ".join(lines)
        )


@dataclass
class MemoryPlan:
    allocations: dict[str, Allocation]
    peak: int

    def overlap_violations(self) -> list[tuple[Allocation, Allocation]]:
        """All pairs of allocations that share bytes while both live.

        The structured form of :meth:`check_no_overlap`: an empty list is
        the invariant; a non-empty one names exactly which tensors race
        over which byte ranges (consumed by :class:`MemoryPlanError` and
        the plan verifier).
        """
        # dedupe alias entries (several names -> one allocation record):
        # an allocation trivially "overlaps" itself in time and space.
        allocs = list(dict.fromkeys(self.allocations.values()))
        bad: list[tuple[Allocation, Allocation]] = []
        for i, a in enumerate(allocs):
            for b in allocs[i + 1 :]:
                time_overlap = not (a.end < b.start or b.end < a.start)
                mem_overlap = not (a.offset + a.size <= b.offset or b.offset + b.size <= a.offset)
                if time_overlap and mem_overlap:
                    bad.append((a, b))
        return bad

    def check_no_overlap(self) -> bool:
        return not self.overlap_violations()

    def check(self) -> "MemoryPlan":
        """Raise :class:`MemoryPlanError` (naming tensors + byte ranges)
        on any live overlap; return self for chaining."""
        bad = self.overlap_violations()
        if bad:
            raise MemoryPlanError(bad)
        return self


def lifetimes(g: Graph, persistent: set | frozenset | tuple = ()) -> dict[str, tuple[int, int]]:
    """{activation tensor: (def index, last-use index)} over the schedule.

    Tensors named in ``persistent`` get the whole-schedule lifetime
    ``(0, len(nodes) - 1)`` — they must survive across plan invocations
    (KV caches), so no transient may ever reuse their addresses.
    """
    out: dict[str, tuple[int, int]] = {}
    for t in g.inputs:
        out[t] = (0, 0)
    for i, n in enumerate(g.nodes):
        for t in n.outputs:
            if t not in g.weights:
                out[t] = (i, i)
        for t in n.inputs:
            if t in out:
                out[t] = (out[t][0], i)
    last = len(g.nodes) - 1
    for t in g.outputs:
        if t in out:
            out[t] = (out[t][0], last)
    for t in persistent:
        if t in out:
            out[t] = (0, last)
    return out


def _aligned_size(g: Graph, t: str, alignment: int) -> int:
    size = max(g.tensors[t].bytes, 1)
    return (size + alignment - 1) // alignment * alignment


def plan_memory(
    g: Graph,
    alignment: int = 16,
    *,
    persistent: tuple | set | frozenset = (),
    aliases: dict[str, str] | None = None,
) -> MemoryPlan:
    """Greedy best-fit static allocation for all activation tensors.

    ``persistent`` tensors live for the whole schedule and are stacked
    deterministically at the bottom of the arena (see module docstring);
    each ``aliases[out] = src`` entry shares ``src``'s allocation record.
    """
    aliases = dict(aliases or {})
    persistent = set(persistent)
    lt = lifetimes(g, persistent=persistent)
    for out_name in aliases:
        lt.pop(out_name, None)  # placed with its alias source below
    last = max(len(g.nodes) - 1, 0)
    allocs: dict[str, Allocation] = {}
    cursor = 0
    for t in sorted(persistent & set(lt)):
        size = _aligned_size(g, t, alignment)
        allocs[t] = Allocation(t, cursor, size, 0, last)
        cursor += size
    # transients: allocate in order of definition, largest-first within a
    # timestep, best-fit into the gaps above/around the persistent region
    order = sorted(
        (t for t in lt if t not in allocs),
        key=lambda t: (lt[t][0], -g.tensors[t].bytes),
    )
    for t in order:
        size = _aligned_size(g, t, alignment)
        start, end = lt[t]
        # collect live intervals overlapping [start, end]
        blocked = sorted(
            (a.offset, a.offset + a.size)
            for a in allocs.values()
            if not (a.end < start or end < a.start)
        )
        # best-fit gap
        best_off, best_gap = None, None
        cursor = 0
        for off, top in blocked + [(1 << 62, 1 << 62)]:
            gap = off - cursor
            if gap >= size and (best_gap is None or gap < best_gap):
                best_off, best_gap = cursor, gap
            cursor = max(cursor, top)
        allocs[t] = Allocation(t, best_off, size, start, end)
    for out_name, src in aliases.items():
        if src in allocs:
            allocs[out_name] = allocs[src]
    peak = max((a.offset + a.size for a in allocs.values()), default=0)
    return MemoryPlan(allocs, peak)


def shared_persistent_offsets(
    a: "MemoryPlan | dict", b: "MemoryPlan | dict", names
) -> list[str]:
    """Names whose allocation (offset, size) DISAGREES between two plans.

    The linked prefill/decode schedules literally share one static KV
    region (dense strips or paged pools); an empty return is the
    planner-level guarantee that the decode schedule runs against the
    exact memory the prefill schedule wrote.
    """
    al = a.allocations if isinstance(a, MemoryPlan) else a
    bl = b.allocations if isinstance(b, MemoryPlan) else b
    bad = []
    for t in names:
        ra, rb = al.get(t), bl.get(t)
        if ra is None or rb is None:
            bad.append(t)
        elif (ra.offset, ra.size) != (rb.offset, rb.size):
            bad.append(t)
    return bad
