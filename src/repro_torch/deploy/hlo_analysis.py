"""Per-rank analysis of a step's op stream — the dry run's "profiler".

The JAX package re-derives its roofline inputs from the partitioned HLO
text of a compiled step.  Eager torch has no HLO: what one rank runs is
the stream of local ``aten`` ops that DTensor issues for it, with the
``_c10d_functional`` collectives of its redistributions among them.
:class:`OpRecorder` (a ``TorchDispatchMode``) records that stream: for an
op on DTensors it steps aside (``NotImplemented``), so DTensor runs the op
and the recorder sees the local ops and collectives it turns into, on
this rank's shards (not the ops DTensor runs on fake global-shape tensors
to infer an output's shape: no rank runs those).  Under ``FakeTensorMode``
in a fake process group (the dry run's fake world) the same stream is
recorded with no data: shapes, ops and bytes per rank.

The numbers follow the JAX package's conventions where they carry over:

 * **flops**: ``2 x result elements x contraction`` for every product
   (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``_int_mm``), forward and
   backward alike.  Eager torch runs each op of the stream once, so every
   op counts once: there is no loop multiplicity to weigh.
 * **mem_bytes** (HBM-traffic proxy): result bytes of every op except
   views and collective waits (an in-place op counts the bytes it
   writes).  Eager torch fuses nothing, so every elementwise op writes
   its result where XLA keeps a fusion's internals on chip: this counts
   more than the JAX package does for the same step.
 * **collective bytes**, by the JAX package's five kinds: ``all-reduce``
   and ``all-to-all`` at their result, ``all-gather`` at its result (the
   gathered tensor: the bytes a rank receives), ``reduce-scatter`` at its
   operand (the bytes a rank sends), point-to-point sends and receives as
   ``collective-permute``.  Any other c10d op (the scatter and broadcast
   that place a plain tensor) is kept apart in ``other_collectives``.
 * **n_computations**: the number of local op calls in the stream (eager
   torch runs each as one computation; an HLO module's count of
   computations has no eager counterpart).
 * **peak_bytes**: the most live storage bytes on the rank during the
   recording, on the recorder's device type, counting the storages that
   :meth:`OpRecorder.track` registered (the step's arguments) and every
   storage an op made, each until it is freed.
 * **largest_bytes**: the bytes of the largest single storage of those
   (the witness of one tensor too large for a rank, such as a product
   held at its global shape).
 * **live_at_peak** (``OpRecorder(at_peak=True)``, :func:`live_at_peak`):
   the storages live at the peak, grouped by the source, shape and dtype
   of the op that made them: what holds a rank's memory.

``analyze_hlo``, ``top_dots`` and ``top_collectives`` take a recorder
where the JAX package takes HLO text; a source is the innermost frame of
the port's own code (``models/transformer.py:178 lm_head``), or
``<autograd>`` for an op the autograd engine ran with no model frame
above it.
"""

from __future__ import annotations

import sys
import weakref
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

try:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import ShardingPropagator as _PROPAGATOR
except ImportError:  # a torch built without distributed support
    DTensor = _PROPAGATOR = None

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

#: local op name (namespace-free) -> the JAX package's collective kind
_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "c10d_functional")
_WAITS = ("wait_tensor", "wait")
_DOTS = ("mm", "bmm", "addmm", "baddbmm", "_int_mm")
#: source files that are plumbing, not a model's own op site
_PLUMBING = ("/deploy/hlo_analysis.py", "/runtime/activations.py", "/runtime/sharding.py")


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args) -> tuple[float, int]:
    """(flops, contraction) of a product: 2 x result elements x contraction."""
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else (args[0], args[1])
    k = a.shape[-1]
    res = a.shape[:-1].numel() * b.shape[-1]
    return 2.0 * res * k, k


def _source() -> str:
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/" in fn and not fn.endswith(_PLUMBING):
            rel = fn.split("/repro_torch/", 1)[1]
            return f"{rel}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return "<autograd>"


class OpRecorder(TorchDispatchMode):
    """Records one rank's local op stream while it is entered.

    ``device``: the device type whose storages count toward ``peak_bytes``
    (default: every device).  Aggregates as it goes, so a step of a
    million ops costs a few counters, not a list.  ``at_peak``: also keep
    the source, shape and dtype of each live storage, and the live set at
    the peak (:func:`live_at_peak`; a copy of it at every new peak).
    """

    def __init__(self, device: str | None = None, *, at_peak: bool = False):
        super().__init__()
        self.device = device
        self.at_peak = at_peak
        self.peak_live: list = []  # (bytes, (source, shape, dtype)) at the peak (at_peak)
        self._meta: dict = {}  # live storage -> (source, shape, dtype) (at_peak)
        self._tracking = False
        self.flops = 0.0
        self.mem_bytes = 0.0
        self.n_computations = 0
        self.op_counts: Counter = Counter()
        self.coll_bytes = {k: 0.0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.other_collectives: Counter = Counter()
        self.dots: dict = defaultdict(lambda: [0, 0.0])  # (source, shapes) -> [n, flops each]
        self.colls: dict = defaultdict(lambda: [0, 0.0])  # (kind, op, source) -> [n, bytes]
        self.live_bytes = 0
        self.peak_bytes = 0
        self.largest_bytes = 0
        self._live: dict = {}
        self._inferring = 0
        self._restore = None

    # -- live storage ---------------------------------------------------------

    def _hold(self, t: torch.Tensor) -> None:
        if self.device is not None and t.device.type != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.largest_bytes = max(self.largest_bytes, n)
        if self.at_peak:
            self._meta[key] = ("<argument>" if self._tracking else _source(),
                               tuple(t.shape), str(t.dtype).replace("torch.", ""))
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            if self.at_peak:
                self.peak_live = [(b, self._meta[k]) for k, b in self._live.items()]
        weakref.finalize(st, self._drop, key)

    def _drop(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)
        self._meta.pop(key, None)

    @staticmethod
    def _local(t):
        return t.to_local() if DTensor is not None and isinstance(t, DTensor) else t

    def track(self, tree) -> int:
        """Registers the storages of every tensor of ``tree`` (a DTensor by
        its local shard) as live; returns their distinct bytes."""
        before = self.live_bytes
        self._tracking = True
        try:
            for t in tree_leaves(tree):
                if isinstance(t, torch.Tensor):
                    self._hold(self._local(t))
        finally:
            self._tracking = False
        return self.live_bytes - before

    @classmethod
    def local_bytes(cls, tree, device: str | None = None) -> int:
        """Distinct storage bytes of the tensors of ``tree`` on this rank."""
        seen, n = set(), 0
        for t in tree_leaves(tree):
            if not isinstance(t, torch.Tensor):
                continue
            t = cls._local(t)
            if device is not None and t.device.type != device:
                continue
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                n += st.nbytes()
        return n

    # -- the stream -----------------------------------------------------------

    def __enter__(self):
        # DTensor infers each op's global output shape by running the op on
        # fake tensors of the global shapes: no rank runs those
        if DTensor is not None and _PROPAGATOR is not None:
            orig = _PROPAGATOR._propagate_tensor_meta_non_cached
            rec = self

            def shapes_only(prop, op_schema):
                rec._inferring += 1
                try:
                    return orig(prop, op_schema)
                finally:
                    rec._inferring -= 1

            self._restore = orig
            _PROPAGATOR._propagate_tensor_meta_non_cached = shapes_only
        return super().__enter__()

    def __exit__(self, *exc):
        if self._restore is not None:
            _PROPAGATOR._propagate_tensor_meta_non_cached = self._restore
            self._restore = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if DTensor is not None and any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it, and we see its local ops
        out = func(*args, **(kwargs or {}))
        if self._inferring:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ns, name = func.namespace, func._opname
        if not outs or (ns in _COLLECTIVE_NS and name in _WAITS):
            return out  # metadata queries and collective waits
        self.n_computations += 1
        self.op_counts[str(func)] += 1
        rets = func._schema.returns
        view = bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                                  for r in rets)
        written = sum(_bytes(t) for t in outs)
        if not view:
            self.mem_bytes += written
        for t in outs:
            self._hold(t)
        if ns == "aten" and name in _DOTS:
            f, _ = _dot_flops(name, args)
            self.flops += f
            shapes = tuple(tuple(a.shape) for a in args[:3] if isinstance(a, torch.Tensor))
            d = self.dots[(_source(), name, shapes)]
            d[0] += 1
            d[1] = f
        elif ns in _COLLECTIVE_NS:
            kind = _COLLECTIVE_KIND.get(name)
            b = _bytes(args[0]) if kind == "reduce-scatter" else written
            if kind is None:
                self.other_collectives[str(func)] += b
                return out
            self.coll_bytes[kind] += b
            self.coll_counts[kind] += 1
            c = self.colls[(kind, str(func), _source())]
            c[0] += 1
            c[1] += b
        return out


def analyze_hlo(rec: OpRecorder) -> dict:
    """The roofline inputs of a recorded stream, under the JAX package's
    keys (plus the port's own: ``op_counts``, ``peak_bytes``,
    ``largest_bytes``, ``other_collectives``)."""
    return {
        "flops": rec.flops,
        "mem_bytes": rec.mem_bytes,
        "collective_bytes": sum(rec.coll_bytes.values()),
        "collective_by_op": dict(rec.coll_bytes),
        "collective_counts": dict(rec.coll_counts),
        "n_computations": rec.n_computations,
        "op_counts": dict(rec.op_counts),
        "peak_bytes": rec.peak_bytes,
        "largest_bytes": rec.largest_bytes,
        "other_collectives": dict(rec.other_collectives),
    }


def analyze_compiled(fn, *args, device: str | None = None, **kwargs) -> tuple[dict, object]:
    """Runs ``fn(*args, **kwargs)`` under a fresh recorder (its arguments
    tracked as live) and returns ``(analyze_hlo(recorder), fn's result)``."""
    rec = OpRecorder(device)
    rec.track((args, kwargs))
    with rec:
        out = fn(*args, **kwargs)
    return analyze_hlo(rec), out


def top_dots(rec: OpRecorder, n: int = 12) -> list[dict]:
    """The n largest products by total flops, with their source."""
    found = [{"flops_total": k * f, "flops_each": f, "mult": k, "source": src,
              "op": op, "shapes": shapes}
             for (src, op, shapes), (k, f) in rec.dots.items()]
    found.sort(key=lambda r: -r["flops_total"])
    return found[:n]


def live_at_peak(rec: OpRecorder, n: int = 12) -> list[dict]:
    """The n largest groups of the storages live at the recording's peak
    (a recorder made with ``at_peak=True``), by total bytes: storages made
    at one source with one shape and dtype form a group (``<argument>``:
    the tracked arguments)."""
    groups: dict = defaultdict(lambda: [0, 0])
    for nbytes, meta in rec.peak_live:
        g = groups[meta]
        g[0] += 1
        g[1] += nbytes
    found = [{"bytes_total": b, "count": k, "source": src, "shape": list(shape), "dtype": dt}
             for (src, shape, dt), (k, b) in groups.items()]
    found.sort(key=lambda r: -r["bytes_total"])
    return found[:n]


def top_collectives(rec: OpRecorder, n: int = 12) -> list[dict]:
    """The n largest collectives by total bytes, with their source — the
    diagnosis tool for what a sharding moves."""
    found = [{"op": kind, "bytes_total": b, "bytes_each": b / k, "mult": k, "source": src,
              "computation": op}
             for (kind, op, src), (k, b) in rec.colls.items()]
    found.sort(key=lambda r: -r["bytes_total"])
    return found[:n]
