"""Audit records of the deployment flow (torch port, a first part).

Only :class:`KVSharingState`, the snapshot that
``InferenceSession.sharing_state()`` returns, is ported: its fields are
the JAX package's, so a port session's snapshot can be compared with the
reference's.  The audits themselves (``verify_sharing``, the static plan
verifier) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass


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
