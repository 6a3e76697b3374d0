"""Radix prefix cache over the paged KV block pool (torch port: a copy of
the JAX package's module, which is pure Python and numpy).

Shared-prompt traffic (system prompts, few-shot preambles) re-prefills
and re-stores identical KV blocks once per request.  The paged KV region
already indirects every cache row through a per-slot block table,
so sharing is a *bookkeeping* change: point two tables at the same
physical block and refcount it.  This module owns the index that makes
the match:

* :class:`PrefixIndex` — a radix trie keyed on **block-sized token
  groups**.  Each trie node pins one resident pool block (the index holds
  its own reference via :meth:`~repro_torch.deploy.paging.BlockAllocator.fork`)
  whose rows hold exactly that node's token group's K/V.  A *terminal*
  entry at a node records a complete prompt: its sub-block tail rows (a
  pinned partial block, when the prompt length is not a block multiple)
  plus the prompt's cached last-token logits row — so an exact-prompt
  repeat attaches the whole chain and samples its first token with
  **zero** prefill dispatches.
* :meth:`PrefixIndex.match` — longest-prefix lookup: walks full token
  groups, returns the resident block chain covering the matched rows and
  whether the match is *full* (exact prompt, cached logits available).
  The caller (:class:`~repro_torch.deploy.engine.Engine`) forks the
  matched blocks into the new request's table
  (:meth:`~repro_torch.deploy.api.InferenceSession.attach_prefix`) and
  prefills only the novel suffix.
* :meth:`PrefixIndex.insert` — called when a request finishes prefilling:
  pins the slot's block chain under the prompt's token path.  Already
  indexed groups keep their incumbent block (no duplicate pins).
* **LRU reclaim** — blocks whose only reference is the index itself
  (refcount 1: no live request shares them) are *parked*, not freed;
  :meth:`reclaim` frees them least-recently-matched-first when the pool
  runs dry, removing terminals before the (leaf-first) nodes that fed
  them.  A block any live request still shares (refcount > 1) is never
  reclaimed — dropping the index's reference would not return it to the
  pool anyway, and keeping it indexed keeps the hot prefix matchable.

Writes into shared blocks are the session's problem, not the index's:
``InferenceSession`` copy-on-writes any block with refcount > 1 before
the first write lands (see ``api.InferenceSession._cow_range``), so a
pinned block's rows are immutable while indexed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.deploy.paging import BlockAllocator, blocks_for_rows


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of one :meth:`PrefixIndex.match` lookup.

    ``blocks`` is the resident chain covering cache rows ``[0, rows)`` in
    logical order; ``full`` means the *entire* prompt matched (``rows ==
    len(tokens)``, sub-block tail included) and ``logits`` carries the
    prompt's cached last-token logits row — the caller can skip prefill
    altogether and sample immediately.  A miss is ``rows == 0``.
    """

    blocks: tuple[int, ...]
    rows: int
    full: bool = False
    logits: np.ndarray | None = None

    @property
    def hit(self) -> bool:
        return self.rows > 0


class _Terminal:
    """One complete indexed prompt ending at a trie node: the pinned
    sub-block tail (None when the prompt length is a block multiple),
    total prompt rows, and the cached last-token logits row."""

    __slots__ = ("block", "rows", "logits", "tick")

    def __init__(self, block: int | None, rows: int, logits, tick: int):
        self.block = block
        self.rows = rows
        self.logits = logits
        self.tick = tick


class _Node:
    """One full token group of the radix trie, pinning one pool block."""

    __slots__ = ("key", "block", "children", "terminals", "tick")

    def __init__(self, key: tuple, block: int | None, tick: int):
        self.key = key
        self.block = block  # None only for the root
        self.children: dict[tuple, _Node] = {}
        self.terminals: dict[tuple, _Terminal] = {}
        self.tick = tick


class PrefixIndex:
    """Radix trie mapping prompt token prefixes to resident pool blocks.

    The index owns one :meth:`~repro_torch.deploy.paging.BlockAllocator.fork`
    reference per pinned block, so indexed blocks survive their inserting
    request's eviction (parked, LRU-reclaimable) and can never be handed
    out to another allocation while matchable.
    """

    def __init__(self, alloc: BlockAllocator, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self._alloc = alloc
        self._bs = int(block_size)
        self._root = _Node((), None, 0)
        self._tick = 0
        self._pinned = 0

    @property
    def block_size(self) -> int:
        return self._bs

    @property
    def n_blocks(self) -> int:
        """Pool blocks currently pinned by the index."""
        return self._pinned

    # -- lookup ------------------------------------------------------------

    def match(self, tokens) -> PrefixMatch:
        """Longest resident prefix of ``tokens`` (LRU ticks refresh)."""
        toks = tuple(int(t) for t in tokens)
        self._tick += 1
        node, blocks, i = self._root, [], 0
        while i + self._bs <= len(toks):
            child = node.children.get(toks[i : i + self._bs])
            if child is None:
                break
            child.tick = self._tick
            blocks.append(child.block)
            node, i = child, i + self._bs
        if i == (len(toks) // self._bs) * self._bs:
            term = node.terminals.get(toks[i:])
            if term is not None:
                term.tick = self._tick
                chain = blocks + ([] if term.block is None else [term.block])
                return PrefixMatch(tuple(chain), len(toks), full=True,
                                   logits=term.logits)
        return PrefixMatch(tuple(blocks), i)

    # -- insertion ---------------------------------------------------------

    def insert(self, tokens, blocks, logits) -> int:
        """Index a freshly prefilled prompt; returns newly pinned blocks.

        ``blocks`` is the inserting slot's block chain in logical order
        (exactly ``blocks_for_rows(len(tokens), block_size)`` of them);
        ``logits`` is the prompt's last-token logits row (host array) —
        cached so an exact repeat needs zero prefill dispatches.  Token
        groups already indexed keep their incumbent block: the newcomer's
        duplicate rows stay owned by its slot and free with it.
        """
        toks = tuple(int(t) for t in tokens)
        chain = [int(b) for b in blocks]
        if len(toks) < 1:
            raise ValueError("cannot index an empty prompt")
        need = blocks_for_rows(len(toks), self._bs)
        if len(chain) != need:
            raise ValueError(
                f"prompt of {len(toks)} tokens covers {need} blocks, got a "
                f"chain of {len(chain)}")
        if logits is None:
            raise ValueError(
                "insert needs the prompt's last-token logits row (cached "
                "for zero-prefill full hits)")
        self._tick += 1
        node, pinned = self._root, 0
        full = len(toks) // self._bs
        for g in range(full):
            key = toks[g * self._bs : (g + 1) * self._bs]
            child = node.children.get(key)
            if child is None:
                self._alloc.fork([chain[g]])
                child = _Node(key, chain[g], self._tick)
                node.children[key] = child
                pinned += 1
            child.tick = self._tick
            node = child
        tail = toks[full * self._bs :]
        term = node.terminals.get(tail)
        if term is None:
            tail_block = None
            if tail:
                tail_block = chain[full]
                self._alloc.fork([tail_block])
                pinned += 1
            node.terminals[tail] = _Terminal(
                tail_block, len(toks), np.array(logits, copy=True), self._tick)
        else:
            term.tick = self._tick
        self._pinned += pinned
        return pinned

    # -- reclaim -----------------------------------------------------------

    def _walk(self, node=None, depth=0):
        """Yield ``(node, depth)`` over the whole trie (root included)."""
        node = self._root if node is None else node
        yield node, depth
        for child in node.children.values():
            yield from self._walk(child, depth + 1)

    def reclaimable(self) -> int:
        """Blocks a full :meth:`reclaim` could return to the pool *now*:
        pinned blocks with refcount 1 (index-only) whose removal is
        structurally legal (terminals always; nodes only once their whole
        subtree is removable — an orphaned descendant would be
        unmatchable but still pinned)."""
        return self._removable(self._root)[1]

    def _removable(self, node: _Node) -> tuple[bool, int]:
        removable, freed = True, 0
        for child in node.children.values():
            r, f = self._removable(child)
            removable, freed = removable and r, freed + f
        for term in node.terminals.values():
            if term.block is None:
                continue
            if self._alloc.refcount(term.block) == 1:
                freed += 1
            else:
                removable = False
        if node is self._root:
            return removable, freed
        if removable and self._alloc.refcount(node.block) == 1:
            return True, freed + 1
        return False, freed

    def reclaim(self, need: int | None = None, *, protect=()) -> int:
        """Free up to ``need`` parked blocks back to the pool (all of
        them when ``need`` is None), least-recently-matched first.

        Only index-only blocks (refcount 1) are freed — a block any live
        request shares is skipped, so reclaim can never pull rows out
        from under a resident trajectory.  ``protect`` names blocks that
        must stay indexed even if cold (e.g. the chain a match about to
        be attached depends on).  Returns the number of blocks actually
        returned to the pool.
        """
        guard = {int(b) for b in protect}
        freed = 0
        while need is None or freed < need:
            victim = None  # (tick, seq, kind, remove_fn, frees_block)
            seq = 0
            for node, _ in self._walk():
                for tail, term in list(node.terminals.items()):
                    seq += 1
                    ok = term.block is None or (
                        self._alloc.refcount(term.block) == 1
                        and term.block not in guard)
                    if ok and (victim is None
                               or (term.tick, seq) < victim[:2]):
                        victim = (term.tick, seq, "terminal", (node, tail),
                                  term.block is not None)
                for key, child in node.children.items():
                    seq += 1
                    if child.children or child.terminals:
                        continue  # interior: children must go first
                    if (self._alloc.refcount(child.block) == 1
                            and child.block not in guard
                            and (victim is None
                                 or (child.tick, seq) < victim[:2])):
                        victim = (child.tick, seq, "node", (node, key), True)
            if victim is None:
                return freed
            _, _, kind, where, frees = victim
            if kind == "terminal":
                node, tail = where
                term = node.terminals.pop(tail)
                if term.block is not None:
                    self._alloc.free([term.block])
                    self._pinned -= 1
                    freed += 1
            else:
                parent, key = where
                child = parent.children.pop(key)
                self._alloc.free([child.block])
                self._pinned -= 1
                freed += 1
        return freed

    def drop_all(self) -> int:
        """Release every index reference (shared blocks included) and
        reset the trie — engine teardown.  Returns references dropped;
        blocks still shared by live requests stay allocated (their other
        holders keep them)."""
        dropped = 0
        for node, _ in self._walk():
            for term in node.terminals.values():
                if term.block is not None:
                    self._alloc.free([term.block])
                    dropped += 1
            if node is not self._root and node.block is not None:
                self._alloc.free([node.block])
                dropped += 1
        self._root = _Node((), None, 0)
        self._pinned = 0
        return dropped

    def pinned_blocks(self) -> tuple[int, ...]:
        """Every block the index currently holds a reference on (one
        entry per pin — feeds the KV-sharing audit)."""
        out = []
        for node, _ in self._walk():
            if node is not self._root and node.block is not None:
                out.append(node.block)
            for term in node.terminals.values():
                if term.block is not None:
                    out.append(term.block)
        return tuple(sorted(out))
