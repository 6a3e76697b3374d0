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

The decoder family's persistent KV tensors and in-place aliases wait
for the decoder slice.
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
        allocs = list(self.allocations.values())
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


def lifetimes(g: Graph) -> dict[str, tuple[int, int]]:
    """{activation tensor: (def index, last-use index)} over the schedule."""
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
    return out


def _aligned_size(g: Graph, t: str, alignment: int) -> int:
    size = max(g.tensors[t].bytes, 1)
    return (size + alignment - 1) // alignment * alignment


def plan_memory(g: Graph, alignment: int = 16) -> MemoryPlan:
    """Greedy best-fit static allocation for all activation tensors."""
    lt = lifetimes(g)
    allocs: dict[str, Allocation] = {}
    # allocate in order of definition, largest-first within a timestep,
    # best-fit into the gaps between live allocations
    order = sorted(lt, key=lambda t: (lt[t][0], -g.tensors[t].bytes))
    for t in order:
        size = _aligned_size(g, t, alignment)
        start, end = lt[t]
        blocked = sorted(
            (a.offset, a.offset + a.size)
            for a in allocs.values()
            if not (a.end < start or end < a.start)
        )
        best_off, best_gap = None, None
        cursor = 0
        for off, top in blocked + [(1 << 62, 1 << 62)]:
            gap = off - cursor
            if gap >= size and (best_gap is None or gap < best_gap):
                best_off, best_gap = cursor, gap
            cursor = max(cursor, top)
        allocs[t] = Allocation(t, best_off, size, start, end)
    peak = max((a.offset + a.size for a in allocs.values()), default=0)
    return MemoryPlan(allocs, peak)
