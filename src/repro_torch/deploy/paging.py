"""Paged KV-cache bookkeeping: block pool geometry + the block allocator (torch port).

The dense decoder artifact reserves ``max_len`` KV rows for *every*
request slot — one long-context request inflates the whole batch's
statically planned arena.  The paged artifact (``compile(cfg, ...,
kv_block_size=, kv_blocks=)``) replaces the per-slot strips with one
shared **block pool** per layer plus a per-slot **block table**: slot
``b``'s logical cache row ``r`` lives at physical pool row
``(table[b, r // block_size], r % block_size)``.  Capacity is then
pooled: the compile-time budget is ``kv_blocks`` blocks *total*, not
``max_batch * max_len`` rows, which is exactly the static cache
management Deeploy applies to KV caches on MMU-less targets
(arXiv 2408.04413) transplanted to the batched serving arena.

This module owns the host-side arithmetic all layers share:

* :class:`BlockAllocator` — the free list.  ``InferenceSession`` holds
  one per paged session: blocks are allocated the moment a slot's depth
  crosses into a new block (cache append / prefill chunk) and returned
  when the slot is freed (request finished or evicted).  Physical block
  0 is the **scratch block** — unallocated table entries point at it, so
  parked/inactive lanes of a batched dispatch scatter harmlessly into
  scratch instead of into anyone's live rows.
* geometry helpers (:func:`blocks_per_slot`, :func:`blocks_for_rows`,
  :func:`pool_rows`) — one definition of the table width / pool row
  count used by the lowering, the memory planner, the session and the
  benchmarks.
* :func:`chunk_starts` — the chunked-prefill schedule: a prompt of ``T``
  tokens runs the *static* ``S``-token prefill schedule at offsets
  ``0, S, 2S, ...`` with a final chunk pinned to ``T - S`` (chunks may
  overlap; re-writing a row with identical ints is bit-neutral because
  every token's K/V is a pure function of its prefix), so any prompt
  prefills in ``<= ceil(T / S)`` dispatches instead of ``T - S``
  teacher-forced decode dispatches.
"""

from __future__ import annotations

from repro_torch.deploy import sanitize as _sanitize

#: physical pool index of the scratch block (see module docstring).  The
#: pool is allocated with ``kv_blocks + 1`` physical blocks; the
#: allocator only ever hands out ids ``1 .. kv_blocks``.
SCRATCH_BLOCK = 0

#: the only dispatch kinds allowed to touch a paged block pool.  Pool
#: tensors are indirect — every access goes through the block table, and
#: only these kernels route through it (everything else would read the
#: scratch block or, worse, another slot's live rows).  The plan verifier
#: flags any other consumer/producer of a pool tensor (rule KV004).
PAGED_KV_KINDS = frozenset({"cache_write_paged", "attn_paged"})


def blocks_for_rows(rows: int, block_size: int) -> int:
    """Blocks needed to hold cache rows ``[0, rows)``."""
    return -(-rows // block_size)


def blocks_per_slot(max_len: int, block_size: int) -> int:
    """Block-table width: logical blocks covering one slot's ``max_len``."""
    return blocks_for_rows(max_len, block_size)


def pool_rows(kv_blocks: int, block_size: int) -> int:
    """Physical pool rows per (layer, kv-head): scratch block included."""
    return (kv_blocks + 1) * block_size


def chunk_starts(prompt_len: int, seq_len: int) -> list[int]:
    """Chunk offsets that cover a ``prompt_len`` prompt with the static
    ``seq_len`` prefill schedule (final chunk pinned to the prompt tail).

    ``len(result) <= ceil(prompt_len / seq_len)`` and every chunk is
    exactly ``seq_len`` tokens — no padding, no teacher forcing.
    """
    if prompt_len < seq_len:
        raise ValueError(
            f"prompt of {prompt_len} tokens is shorter than the static "
            f"prefill schedule seq_len={seq_len}"
        )
    starts = list(range(0, prompt_len - seq_len + 1, seq_len))
    if starts[-1] != prompt_len - seq_len:
        starts.append(prompt_len - seq_len)
    return starts


class PoolExhausted(Exception):
    """Internal allocator signal: not enough free blocks for a request.

    The session translates this into a structured
    :class:`~repro_torch.deploy.api.KVCapacityError` naming the slots that
    could not grow (what the engine evicts) and the slots currently
    holding blocks (the evictable candidates).
    """

    def __init__(self, requested: int, free: int):
        self.requested = int(requested)
        self.free = int(free)
        super().__init__(f"requested {requested} KV blocks, {free} free")


class BlockAllocator:
    """Refcounted free-list allocator over the shared KV block pool.

    Hands out physical block ids ``1 .. n_blocks`` (0 is the scratch
    block).  Allocation order is deterministic — lowest free id first —
    so identical request schedules produce identical block tables (and
    hence bit-identical dispatch inputs) run after run.

    Every live block carries a **refcount** (1 at :meth:`allocate`).  A
    prefix-cache hit shares an existing full block via :meth:`fork`
    (refcount + 1, no copy); :meth:`free` decrements and only returns the
    block to the free list when the count reaches 0; :meth:`cow` is the
    copy-on-write step a holder takes *before the first write* into a
    shared block — it hands back a private replacement block and drops one
    share of the original.  Invariant maintained throughout::

        n_free + len(live blocks) == n_blocks      (conservation)
        refcount(b) >= 1 for every live block      (no zombie entries)
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"kv_blocks must be >= 1, got {n_blocks}")
        self.n_blocks = int(n_blocks)
        # min-heap behavior via sorted list popped from the front; sizes
        # are small (a pool has tens to thousands of blocks)
        self._free = list(range(1, self.n_blocks + 1))
        self._owner: dict[int, int | None] = {}
        self._ref: dict[int, int] = {}
        # shadow block-lifecycle sanitizer (REPRO_SANITIZE=1): mirrors
        # every transition and fails with a structured BLK* diagnostic
        # at the offending call instead of a generic ValueError later
        self.shadow = (_sanitize.ShadowPool(self.n_blocks)
                       if _sanitize.enabled() else None)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def n_shared(self) -> int:
        """Blocks currently referenced by more than one holder."""
        return sum(1 for c in self._ref.values() if c > 1)

    def owners(self) -> set:
        """Distinct owners currently holding at least one block (for a
        shared block, the owner recorded at :meth:`allocate` time)."""
        return set(self._owner.values())

    def refcount(self, block: int) -> int:
        """Current reference count of ``block`` (0 if free/unallocated)."""
        return self._ref.get(int(block), 0)

    def allocate(self, n: int = 1, *, owner=None) -> list[int]:
        """Take ``n`` blocks (all or nothing).  Raises :class:`PoolExhausted`
        without mutating state when fewer than ``n`` are free."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise PoolExhausted(n, len(self._free))
        taken, self._free = self._free[:n], self._free[n:]
        if self.shadow is not None:
            self.shadow.allocate(taken, self)
        for b in taken:
            self._owner[b] = owner
            self._ref[b] = 1
        return taken

    def fork(self, blocks, *, owner=None) -> list[int]:
        """Share already-live blocks: refcount + 1 each, no data movement.

        All-or-nothing — forking a free/unallocated id fails loudly
        without mutating state.  ``owner`` is accepted for call-site
        symmetry with :meth:`allocate` but the residency owner recorded
        at allocation time is kept (the pool rows are still theirs).
        """
        ids = [int(b) for b in blocks]
        for b in ids:  # caller-misuse contract first: same ValueError
            if b not in self._ref:  # with or without the sanitizer
                raise ValueError(f"cannot fork block {b}: not allocated")
        if self.shadow is not None:
            self.shadow.fork(ids, self)  # BLK001/BLK004 before mutation
        for b in ids:
            self._ref[b] += 1
        return ids

    def cow(self, block: int, *, owner=None) -> tuple[int, bool]:
        """Copy-on-write: make ``block`` privately writable by its caller.

        Returns ``(block, False)`` when the caller already holds the only
        reference (write in place).  Otherwise allocates a fresh block
        (``PoolExhausted`` propagates *before* any state changes),
        releases one share of the original, and returns
        ``(new_block, True)`` — the caller must copy the pool rows and
        patch its block table before writing.
        """
        b = int(block)
        if b not in self._ref:
            raise ValueError(f"cannot cow block {b}: not allocated")
        if self.shadow is not None:
            self.shadow.pre_cow(b, self)  # BLK001/BLK004 before mutation
        if self._ref[b] == 1:
            return b, False
        (fresh,) = self.allocate(1, owner=owner)
        self._ref[b] -= 1
        if self.shadow is not None:
            self.shadow.cow(b, fresh)
        return fresh, True

    def free(self, blocks) -> None:
        """Drop one reference per block; a block returns to the pool only
        when its last reference is dropped (freeing an unowned or scratch
        id fails loudly — idempotence is a caller bug)."""
        ids = [int(b) for b in blocks]
        drops: dict[int, int] = {}  # caller-misuse contract first: same
        for b in ids:               # ValueError with or without the
            drops[b] = drops.get(b, 0) + 1  # sanitizer, before any mutation
            if self._ref.get(b, 0) < drops[b]:
                raise ValueError(f"block {b} is not allocated (double free?)")
        if self.shadow is not None:
            self.shadow.free(ids, self)  # BLK002/BLK004 before mutation
        for b in ids:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                del self._owner[b]
                self._free.append(b)
        self._free.sort()
