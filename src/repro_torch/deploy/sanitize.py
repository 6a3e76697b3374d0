"""Concurrency & KV-lifetime sanitizers for the serving runtime (torch port).

The JAX package's ``deploy/sanitize.py``, standard library only, with the
same rule catalogue, messages and lattice: the lints default to the
port's own ``deploy/`` package and its ``InferenceSession``.

``repro_torch.deploy.verify`` gives every compiled *plan* a static,
rule-cataloged audit.  This module gives the *concurrent runtime* the
same treatment, in four layers:

1. **Static lock-order lint** (:func:`lint_lock_order`) — an AST pass
   over ``src/repro_torch/deploy`` that registers every
   ``threading.Lock/RLock/Condition`` (and :func:`make_lock` /
   :func:`make_condition`) creation, extracts every acquisition site
   (``with``, ``.acquire()``, ``.wait()``/``.wait_for()``), resolves
   method and property calls through a name-based call graph, and fails
   on acquisition cycles or violations of the declared lock lattice.
   An affinity lint (:func:`lint_affinity`) proves every state-mutating
   public ``InferenceSession`` method asserts thread affinity via
   ``self._affine(...)``.
2. **Lockdep-style runtime checker** — opt-in via ``REPRO_SANITIZE=1``.
   :func:`make_lock` / :func:`make_condition` then return instrumented
   wrappers that record per-thread held-lock stacks and flag order
   inversions (against both the declared lattice and the order observed
   so far this process) and condition waits while holding another lock,
   raising :class:`SanitizerError` at the offending call.
3. **Shadow-state block sanitizer** (:class:`ShadowPool`) — a host-side
   mirror of every KV pool block's lifecycle
   (``free/exclusive/shared/cow-pending``; block 0 is the scratch
   block and never tracked), updated on each
   :class:`~repro_torch.deploy.paging.BlockAllocator` transition and on every
   KV write the session dispatches.  It upgrades the KV006/KV007
   point-in-time audit to continuous detection of use-after-free,
   double-free, lost copy-on-write and refcount drift at the exact
   offending call site.
4. **Small-scope exhaustive interleaving check** (:func:`model_check`,
   :func:`check_block_interleavings`,
   :func:`check_scheduler_interleavings`) — model-checks the
   fork/cow/free block state machine and the async submit/cancel/
   preempt/requeue protocol over *all* 2–3-thread schedules up to a
   bounded depth (state-deduplicated BFS, not schedule enumeration).

Rule catalog (mirrors ``verify.PlanDiagnostic``):

=========  ========  ====================================================
rule       severity  meaning
=========  ========  ====================================================
LOCK001    error     cycle in the static lock acquisition graph
                     (includes self-deadlock on a non-reentrant lock)
LOCK002    error     static acquisition violates the declared lattice,
                     or nests a lock with no declared rank (warning)
LOCK003    error     runtime lock-order inversion (lockdep)
LOCK004    error     ``Condition.wait`` while holding another lock
LOCK005    error     non-reentrant lock re-acquired by its holder
LOCK006    error     serialized structure mutated without its lock held
AFF001     error     state-mutating public ``InferenceSession`` method
                     does not call ``self._affine``
BLK001     error     use-after-free: operation on a free block
BLK002     error     double free
BLK003     error     write into a shared block without copy-on-write
BLK004     error     refcount drift between allocator and shadow state
BLK005     error     conservation violation: free + live != pool blocks
SCHED001   error     interleaving check: protocol invariant violated in
                     a reachable schedule
=========  ========  ====================================================

Declared lock lattice (outermost first)::

    serving.cv  ->  engine.lock  ->  frontend.hlock

i.e. while holding a lock, only locks strictly *later* in the lattice
may be acquired.  ``engine.lock`` is reentrant (the submit path re-takes
it in ``_note_queue``); ``serving.cv`` is a condition (reentrant by
construction); ``frontend.hlock`` is a leaf.

CLI (same rc contract as ``repro_torch.deploy.verify``)::

    python -m repro_torch.deploy.sanitize [--strict] [--interleavings] [PATH...]

rc 0 = clean, 1 = FAIL (any error, or any warning with ``--strict``),
2 = a path could not be read/parsed.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
import threading
from collections import deque
from dataclasses import dataclass, field


# --------------------------------------------------------------------------
# diagnostics
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class SanitizerDiagnostic:
    """One sanitizer finding (same shape/format idiom as PlanDiagnostic)."""

    rule: str           # "LOCK001", "AFF001", "BLK003", "SCHED001", ...
    severity: str       # "error" | "warning"
    message: str
    where: str = ""     # "module:qualname", "kv-pool", "lockdep", ...
    obj: str = ""       # offending lock / block / method name
    hint: str = ""
    source: str = "sanitizer"  # "static-lint"|"lockdep"|"shadow"|"model-check"

    def format(self) -> str:
        loc = f" {self.where}" if self.where else ""
        what = f" [{self.obj}]" if self.obj else ""
        tail = f" ({self.hint})" if self.hint else ""
        return (f"{self.severity.upper()} {self.rule}{loc}{what}: "
                f"{self.message}{tail}")

    def __str__(self) -> str:  # pragma: no cover - convenience
        return self.format()


class SanitizerError(RuntimeError):
    """Raised on sanitizer findings; carries the structured diagnostics."""

    def __init__(self, diagnostics, *, context: str = ""):
        diags = tuple(diagnostics)
        head = f"{context}: " if context else ""
        lines = [f"{head}{len(diags)} sanitizer finding(s)"]
        lines += [f"  {d.format()}" for d in diags]
        super().__init__("\n".join(lines))
        self.diagnostics = diags


# --------------------------------------------------------------------------
# enabling + declared lattice
# --------------------------------------------------------------------------

#: declared lock order, outermost first.  While holding a lock, only
#: locks strictly LATER in this tuple may be acquired.
LOCK_LATTICE = ("serving.cv", "engine.lock", "frontend.hlock")


def enabled() -> bool:
    """True when the opt-in runtime sanitizers are on (REPRO_SANITIZE=1)."""
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() in (
        "1", "true", "yes", "on")


def _rank(name: str, lattice=None):
    lattice = LOCK_LATTICE if lattice is None else lattice
    try:
        return lattice.index(name)
    except ValueError:
        return None


# --------------------------------------------------------------------------
# lockdep runtime: tracked lock / condition wrappers
# --------------------------------------------------------------------------

_tls = threading.local()

#: observed acquisition edges across the whole process, keyed by lock
#: NAME (not instance) so two engines' locks share one order graph.
#: dict/set ops are GIL-atomic enough for a test-time checker.
_ORDER: dict[str, set] = {}
_RUNTIME_FINDINGS: list = []


def _held_stack() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def runtime_findings() -> tuple:
    """All lockdep findings recorded so far in this process."""
    return tuple(_RUNTIME_FINDINGS)


def reset_runtime() -> None:
    """Clear the observed-order graph and recorded findings (tests)."""
    _ORDER.clear()
    _RUNTIME_FINDINGS.clear()


def _order_reachable(src: str, dst: str) -> bool:
    seen, todo = set(), [src]
    while todo:
        n = todo.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        todo.extend(list(_ORDER.get(n, ())))
    return False


def _runtime_fail(rule: str, message: str, *, obj: str = "",
                  hint: str = "") -> None:
    d = SanitizerDiagnostic(rule=rule, severity="error", message=message,
                            where="lockdep", obj=obj, hint=hint,
                            source="lockdep")
    _RUNTIME_FINDINGS.append(d)
    raise SanitizerError([d], context="lockdep runtime checker")


def _new_primitive(reentrant: bool):
    factory = threading.RLock if reentrant else threading.Lock
    return factory()


def _new_condition_primitive():
    return threading.Condition()


class _TrackedLock:
    """Lockdep wrapper: per-thread held stack + order checking."""

    def __init__(self, name: str, inner, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._inner = inner

    # -- order checking ------------------------------------------------------

    def _check_acquire(self) -> None:
        held = _held_stack()
        held_names = [l.name for l in held]
        if self.name in held_names:
            if not self.reentrant:
                _runtime_fail(
                    "LOCK005",
                    f"non-reentrant lock {self.name!r} re-acquired by the "
                    f"thread already holding it (self-deadlock)",
                    obj=self.name)
            return  # reentrant re-acquire: no new ordering edge
        for hn in dict.fromkeys(held_names):  # distinct, outermost first
            ra, rb = _rank(hn), _rank(self.name)
            if ra is not None and rb is not None and rb <= ra:
                _runtime_fail(
                    "LOCK003",
                    f"acquiring {self.name!r} while holding {hn!r} inverts "
                    f"the declared lattice {' -> '.join(LOCK_LATTICE)}",
                    obj=self.name,
                    hint="release the outer lock first, or re-rank the "
                         "lattice in sanitize.LOCK_LATTICE")
            if _order_reachable(self.name, hn):
                _runtime_fail(
                    "LOCK003",
                    f"acquiring {self.name!r} while holding {hn!r} inverts "
                    f"the lock order observed earlier in this process "
                    f"({self.name!r} -> ... -> {hn!r})",
                    obj=self.name,
                    hint="two call paths take these locks in opposite "
                         "orders: a deadlock is reachable")
            _ORDER.setdefault(hn, set()).add(self.name)

    def held_by_current_thread(self) -> bool:
        return any(l is self for l in _held_stack())

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_acquire()
        got = self._inner.acquire(blocking, timeout)
        if got:
            _held_stack().append(self)
        return got

    def release(self) -> None:
        self._inner.release()
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()


class _TrackedCondition(_TrackedLock):
    """Lockdep wrapper over threading.Condition (adds wait checking)."""

    def _check_wait(self) -> None:
        others = sorted({l.name for l in _held_stack()
                         if l.name != self.name})
        if others:
            _runtime_fail(
                "LOCK004",
                f"Condition {self.name!r}.wait() while holding "
                f"{', '.join(repr(o) for o in others)}: the held lock stays "
                f"locked for the whole wait",
                obj=self.name,
                hint="waiting releases only the condition's own lock; any "
                     "other held lock blocks the thread that should notify")

    def wait(self, timeout: float | None = None) -> bool:
        self._check_wait()
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: float | None = None):
        self._check_wait()
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


def make_lock(name: str, *, reentrant: bool = False):
    """A named lock: plain ``Lock``/``RLock`` normally, a lockdep-tracked
    wrapper when ``REPRO_SANITIZE=1``.  ``name`` is the lock's identity in
    the declared lattice and in diagnostics."""
    inner = _new_primitive(reentrant)
    if not enabled():
        return inner
    return _TrackedLock(name, inner, reentrant)


def make_condition(name: str):
    """A named condition variable (reentrant for lockdep purposes)."""
    inner = _new_condition_primitive()
    if not enabled():
        return inner
    return _TrackedCondition(name, inner, True)


def require_held(lock, where: str) -> None:
    """Assert the calling thread holds ``lock`` (LOCK006).

    No-op for untracked (plain threading) locks and when the sanitizer
    is off — callers can invoke it unconditionally on hot paths."""
    if isinstance(lock, _TrackedLock) and not lock.held_by_current_thread():
        _runtime_fail(
            "LOCK006",
            f"{where} mutated without holding its serializing lock "
            f"{lock.name!r}",
            obj=where,
            hint="every scheduler mutation must run under the engine's "
                 "submission lock")


# --------------------------------------------------------------------------
# shadow-state block sanitizer
# --------------------------------------------------------------------------

#: block 0 is the write-discard scratch block (paging.SCRATCH_BLOCK);
#: it is never allocated, shared or freed, and the shadow ignores it.
_SCRATCH = 0

FREE = "free"
EXCLUSIVE = "exclusive"
SHARED = "shared"
COW_PENDING = "cow-pending"


class ShadowPool:
    """Host-side mirror of every pool block's lifecycle.

    The :class:`~repro_torch.deploy.paging.BlockAllocator` calls the
    transition hooks (``allocate``/``fork``/``pre_cow``/``cow``/
    ``free``) after its own caller-misuse validation (so API misuse
    keeps its documented ``ValueError`` with or without the sanitizer)
    but *before* mutating its state — divergence the allocator cannot
    see (free-list corruption, refcount tampering) is reported as a
    structured BLK* diagnostic at the offending call instead of silent
    corruption or a confusing error later.  The session calls
    :meth:`write` for every block a prefill/decode dispatch is about
    to write, which is what turns a skipped copy-on-write into an
    immediate BLK003 instead of silent cross-request corruption.
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = int(n_blocks)
        self._state: dict[int, str] = {}   # absent -> FREE
        self._ref: dict[int, int] = {}
        self.findings: list[SanitizerDiagnostic] = []

    # -- reporting -----------------------------------------------------------

    def state_of(self, block: int) -> str:
        return self._state.get(int(block), FREE)

    def snapshot(self) -> dict:
        counts = {FREE: self.n_blocks, EXCLUSIVE: 0, SHARED: 0,
                  COW_PENDING: 0}
        for st in self._state.values():
            counts[st] += 1
            counts[FREE] -= 1
        counts["findings"] = len(self.findings)
        return counts

    def _fail(self, rule: str, message: str, block: int,
              hint: str = "") -> None:
        d = SanitizerDiagnostic(rule=rule, severity="error", message=message,
                                where="kv-pool", obj=f"block {block}",
                                hint=hint, source="shadow")
        self.findings.append(d)
        raise SanitizerError([d], context="shadow block sanitizer")

    def _check_drift(self, alloc, blocks, op: str) -> None:
        for b in blocks:
            have, want = self._ref.get(b, 0), alloc._ref.get(b, 0)
            if have != want:
                self._fail(
                    "BLK004",
                    f"refcount drift on block {b} at {op}: allocator says "
                    f"{want}, shadow says {have}", b,
                    hint="a code path changed the refcount outside the "
                         "allocator's allocate/fork/cow/free transitions")

    # -- transitions (called by BlockAllocator BEFORE its own mutation) ------

    def allocate(self, blocks, alloc) -> None:
        ids = [int(b) for b in blocks]
        self._check_drift(alloc, ids, "allocate")
        for b in ids:  # validate all before mirroring (all-or-nothing)
            st = self.state_of(b)
            if st != FREE:
                self._fail(
                    "BLK001",
                    f"allocator handed out block {b} already in state "
                    f"{st!r}", b,
                    hint="free-list corruption: a live block re-entered "
                         "the free list")
        for b in ids:
            self._state[b] = EXCLUSIVE
            self._ref[b] = 1

    def fork(self, blocks, alloc) -> None:
        ids = [int(b) for b in blocks]
        self._check_drift(alloc, ids, "fork")
        for b in ids:  # validate all before mirroring (all-or-nothing)
            if self.state_of(b) == FREE:
                self._fail(
                    "BLK001",
                    f"fork of block {b} which is free (use-after-free)", b,
                    hint="a block table or prefix chain still references a "
                         "freed block")
        for b in ids:
            self._ref[b] += 1
            self._state[b] = SHARED

    def pre_cow(self, block: int, alloc) -> None:
        b = int(block)
        self._check_drift(alloc, [b], "cow")
        if self.state_of(b) == FREE:
            self._fail(
                "BLK001",
                f"copy-on-write requested for block {b} which is free "
                f"(use-after-free)", b)

    def cow(self, orig: int, fresh: int) -> None:
        """After the allocator split ``orig`` -> ``fresh`` (ref moved)."""
        o, f = int(orig), int(fresh)
        self._ref[o] -= 1
        if self._ref[o] == 1:
            self._state[o] = EXCLUSIVE
        # ``fresh`` was just allocated EXCLUSIVE; it holds no data until
        # the device copy + first write land.
        self._state[f] = COW_PENDING

    def free(self, blocks, alloc) -> None:
        ids = [int(b) for b in blocks]
        self._check_drift(alloc, ids, "free")
        for b in ids:
            if self.state_of(b) == FREE:
                self._fail(
                    "BLK002",
                    f"double free of block {b}", b,
                    hint="the block was already returned to the pool; two "
                         "owners released the same reference")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                del self._state[b]
            elif self._ref[b] == 1:
                self._state[b] = EXCLUSIVE

    # -- write events (called by InferenceSession before dispatch) -----------

    def write(self, slot: int, block: int, alloc) -> None:
        b = int(block)
        if b == _SCRATCH:
            return
        self._check_drift(alloc, [b], "write")
        st = self.state_of(b)
        if st == FREE:
            self._fail(
                "BLK001",
                f"slot {slot} writes into block {b} which is free "
                f"(use-after-free)", b,
                hint="the slot's block table references a freed block")
        if st == SHARED:
            self._fail(
                "BLK003",
                f"slot {slot} writes into shared block {b} (refcount "
                f"{self._ref.get(b)}) without copy-on-write", b,
                hint="_cow_range must split the block before the first "
                     "write; other holders would see this slot's KV rows")
        if st == COW_PENDING:
            self._state[b] = EXCLUSIVE

    # -- full audit -----------------------------------------------------------

    def audit(self, alloc) -> list:
        """Full-pool consistency check; returns diagnostics, never raises."""
        diags: list[SanitizerDiagnostic] = []
        for b in range(1, self.n_blocks + 1):
            have, want = self._ref.get(b, 0), alloc._ref.get(b, 0)
            if have != want:
                diags.append(SanitizerDiagnostic(
                    rule="BLK004", severity="error",
                    message=f"refcount drift on block {b}: allocator says "
                            f"{want}, shadow says {have}",
                    where="kv-pool", obj=f"block {b}", source="shadow"))
        live = len(alloc._ref)
        if alloc.n_free + live != self.n_blocks:
            diags.append(SanitizerDiagnostic(
                rule="BLK005", severity="error",
                message=f"conservation violated: {alloc.n_free} free + "
                        f"{live} live != {self.n_blocks} pool blocks",
                where="kv-pool", source="shadow",
                hint="a block leaked: neither on the free list nor "
                     "refcounted"))
        self.findings.extend(diags)
        return diags


# --------------------------------------------------------------------------
# static lock-order lint
# --------------------------------------------------------------------------


def _default_paths() -> list:
    return [os.path.dirname(os.path.abspath(__file__))]


def _iter_sources(paths):
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        else:
            yield p


@dataclass
class _LockDecl:
    logical: str        # name used in the lattice / diagnostics
    reentrant: bool
    kind: str           # "lock" | "condition"
    where: str


@dataclass
class _FuncInfo:
    qualname: str       # "module:Class.method"
    name: str           # bare method/function name (call-graph key)
    node: object        # ast.FunctionDef
    module: str
    is_property: bool = False
    # filled by the body pass:
    acquires: list = field(default_factory=list)  # (held tuple, lock, line)
    waits: list = field(default_factory=list)     # (held tuple, lock, line)
    calls: list = field(default_factory=list)     # (held tuple, name, line)


_THREADING_CTORS = {"Lock": ("lock", False), "RLock": ("lock", True),
                    "Condition": ("condition", True)}
_FACTORY_CTORS = {"make_lock": ("lock", False), "make_rlock": ("lock", True),
                  "make_condition": ("condition", True)}


def _call_name(func) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _lock_decl_from_call(node):
    """(kind, reentrant, explicit_name) if ``node`` creates a lock."""
    if not isinstance(node, ast.Call):
        return None
    name = _call_name(node.func)
    if name in _THREADING_CTORS:
        kind, reent = _THREADING_CTORS[name]
        return kind, reent, None
    if name in _FACTORY_CTORS:
        kind, reent = _FACTORY_CTORS[name]
        logical = None
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            logical = node.args[0].value
        for kw in node.keywords:
            if kw.arg == "reentrant" and isinstance(kw.value, ast.Constant):
                reent = bool(kw.value.value)
        return kind, reent, logical
    return None


class _Collector(ast.NodeVisitor):
    """Pass 1: lock registrations, function defs, property names."""

    def __init__(self, module: str, locks: dict, funcs: dict,
                 properties: set):
        self.module = module
        self.locks = locks            # attr name -> _LockDecl
        self.funcs = funcs            # bare name -> [_FuncInfo]
        self.properties = properties
        self._class_stack: list[str] = []

    def visit_ClassDef(self, node) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _register_assign(self, target, value, lineno: int) -> None:
        decl = _lock_decl_from_call(value)
        if decl is None:
            return
        kind, reent, logical = decl
        attr = None
        if isinstance(target, ast.Attribute):
            attr = target.attr
        elif isinstance(target, ast.Name):
            attr = target.id
        if attr is None:
            return
        cls = self._class_stack[-1] if self._class_stack else ""
        default = f"{cls}.{attr}" if cls else attr
        self.locks[attr] = _LockDecl(
            logical=logical or default, reentrant=reent, kind=kind,
            where=f"{self.module}:{lineno}")

    def visit_Assign(self, node) -> None:
        for t in node.targets:
            self._register_assign(t, node.value, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node) -> None:
        if node.value is not None:
            self._register_assign(node.target, node.value, node.lineno)
        self.generic_visit(node)

    def _visit_func(self, node) -> None:
        cls = ".".join(self._class_stack)
        qual = f"{self.module}:{cls + '.' if cls else ''}{node.name}"
        is_prop = any(isinstance(d, ast.Name) and d.id == "property"
                      for d in node.decorator_list)
        info = _FuncInfo(qualname=qual, name=node.name, node=node,
                         module=self.module, is_property=is_prop)
        self.funcs.setdefault(node.name, []).append(info)
        if is_prop:
            self.properties.add(node.name)
        # nested defs still collected (generic_visit), class stack kept
        self.generic_visit(node)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


class _BodyPass(ast.NodeVisitor):
    """Pass 2: acquisition/wait/call events per function body."""

    def __init__(self, info: _FuncInfo, locks: dict, properties: set):
        self.info = info
        self.locks = locks
        self.properties = properties
        self.held: list[str] = []
        self.aliases: dict[str, str] = {}  # local name -> logical lock

    # -- helpers ---------------------------------------------------------

    def _lock_of(self, expr):
        """Logical lock name an expression denotes, else None."""
        if isinstance(expr, ast.Attribute) and expr.attr in self.locks:
            return self.locks[expr.attr].logical
        if isinstance(expr, ast.Name) and expr.id in self.aliases:
            return self.aliases[expr.id]
        return None

    def _decl_of(self, logical: str):
        for d in self.locks.values():
            if d.logical == logical:
                return d
        return None

    # -- events ------------------------------------------------------------

    def visit_FunctionDef(self, node) -> None:
        # a nested def's body runs later, not under the current held
        # set — it is collected and analyzed as its own _FuncInfo.
        # (Lambdas, e.g. wait_for predicates, DO run inline and are
        # walked by generic_visit with the current held set.)
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node) -> None:
        lock = self._lock_of(node.value)
        if lock is not None:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.aliases[t.id] = lock
        self.generic_visit(node)

    def visit_With(self, node) -> None:
        acquired = []
        for item in node.items:
            lock = self._lock_of(item.context_expr)
            if lock is not None:
                self.info.acquires.append(
                    (tuple(self.held), lock, item.context_expr.lineno))
                self.held.append(lock)
                acquired.append(lock)
            else:
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_Call(self, node) -> None:
        func = node.func
        handled = False
        if isinstance(func, ast.Attribute):
            recv_lock = self._lock_of(func.value)
            if recv_lock is not None:
                if func.attr == "acquire":
                    self.info.acquires.append(
                        (tuple(self.held), recv_lock, node.lineno))
                    handled = True
                elif func.attr in ("wait", "wait_for"):
                    decl = self._decl_of(recv_lock)
                    if decl is not None and decl.kind == "condition":
                        self.info.waits.append(
                            (tuple(self.held), recv_lock, node.lineno))
                        handled = True
            if not handled:
                self.info.calls.append(
                    (tuple(self.held), func.attr, node.lineno))
        elif isinstance(func, ast.Name):
            self.info.calls.append((tuple(self.held), func.id, node.lineno))
        self.generic_visit(node)

    def visit_Attribute(self, node) -> None:
        # property accesses are calls: `engine.idle` takes the engine lock
        if isinstance(node.ctx, ast.Load) and node.attr in self.properties \
                and node.attr not in self.locks:
            self.info.calls.append((tuple(self.held), node.attr, node.lineno))
        self.generic_visit(node)


def _closure(funcs: dict):
    """Fixpoint: locks acquired / conditions waited transitively by NAME."""
    acq: dict[str, set] = {}
    wts: dict[str, set] = {}
    for name, infos in funcs.items():
        acq[name] = {l for i in infos for _h, l, _ln in i.acquires}
        wts[name] = {l for i in infos for _h, l, _ln in i.waits}
    changed = True
    while changed:
        changed = False
        for name, infos in funcs.items():
            for i in infos:
                for _held, callee, _ln in i.calls:
                    if callee not in funcs:
                        continue
                    if not acq[callee] <= acq[name]:
                        acq[name] |= acq[callee]
                        changed = True
                    if not wts[callee] <= wts[name]:
                        wts[name] |= wts[callee]
                        changed = True
    return acq, wts


def lint_lock_order(paths=None, *, lattice=None) -> list:
    """Static lock-order lint over ``paths`` (default: this package).

    Returns a list of :class:`SanitizerDiagnostic` (LOCK001/002/004);
    raises ``SyntaxError``/``OSError`` if a source cannot be parsed/read.
    """
    lattice = LOCK_LATTICE if lattice is None else tuple(lattice)
    paths = _default_paths() if paths is None else list(paths)

    locks: dict[str, _LockDecl] = {}
    funcs: dict[str, list] = {}
    properties: set = set()
    trees = []
    for src in _iter_sources(paths):
        with open(src, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=src)
        module = os.path.splitext(os.path.basename(src))[0]
        trees.append((module, tree))
    for module, tree in trees:
        _Collector(module, locks, funcs, properties).visit(tree)
    for infos in funcs.values():
        for info in infos:
            body = _BodyPass(info, locks, properties)
            for stmt in info.node.body:
                body.visit(stmt)

    acq, _wts = _closure(funcs)

    # -- acquisition edges: direct nesting + through the call graph -------
    #    edges[(a, b)] = representative "module:qual:line" site
    edges: dict[tuple, str] = {}

    def _edge(a: str, b: str, site: str) -> None:
        edges.setdefault((a, b), site)

    diags: list[SanitizerDiagnostic] = []
    reentrant = {d.logical: d.reentrant for d in locks.values()}

    for infos in funcs.values():
        for info in infos:
            for held, lock, line in info.acquires:
                site = f"{info.qualname}:{line}"
                for h in held:
                    _edge(h, lock, site)
            for held, callee, line in info.calls:
                if not held or callee not in acq:
                    continue
                site = f"{info.qualname}:{line} (via {callee}())"
                for target in acq[callee]:
                    for h in held:
                        _edge(h, target, site)
            for held, cv, line in info.waits:
                others = [h for h in held if h != cv]
                if others:
                    diags.append(SanitizerDiagnostic(
                        rule="LOCK004", severity="error",
                        message=f"waits on condition {cv!r} while holding "
                                f"{', '.join(repr(o) for o in others)}",
                        where=f"{info.qualname}:{line}", obj=cv,
                        source="static-lint",
                        hint="the held lock stays locked for the whole "
                             "wait and blocks the notifier"))

    # -- self-deadlock + cycles -------------------------------------------
    graph: dict[str, set] = {}
    for (a, b), site in sorted(edges.items()):
        if a == b:
            if not reentrant.get(a, True):
                diags.append(SanitizerDiagnostic(
                    rule="LOCK001", severity="error",
                    message=f"non-reentrant lock {a!r} acquired while "
                            f"already held (self-deadlock)",
                    where=site, obj=a, source="static-lint"))
            continue
        graph.setdefault(a, set()).add(b)

    def _cycle_from(start: str):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    return path + [start]
                if nxt not in path:
                    stack.append((nxt, path + [nxt]))
        return None

    reported_cycles = set()
    for start in sorted(graph):
        cyc = _cycle_from(start)
        if cyc is None:
            continue
        key = frozenset(cyc)
        if key in reported_cycles:
            continue
        reported_cycles.add(key)
        sites = [edges.get((cyc[i], cyc[i + 1]), "?")
                 for i in range(len(cyc) - 1)]
        diags.append(SanitizerDiagnostic(
            rule="LOCK001", severity="error",
            message=f"cycle in the lock acquisition graph: "
                    f"{' -> '.join(cyc)}",
            where="; ".join(sites), obj=cyc[0], source="static-lint",
            hint="two call paths can each hold one lock and wait for the "
                 "other: deadlock"))

    # -- declared lattice ---------------------------------------------------
    for (a, b), site in sorted(edges.items()):
        if a == b:
            continue
        ra, rb = _rank(a, lattice), _rank(b, lattice)
        if ra is not None and rb is not None:
            if rb <= ra:
                diags.append(SanitizerDiagnostic(
                    rule="LOCK002", severity="error",
                    message=f"acquires {b!r} while holding {a!r}, against "
                            f"the declared lattice "
                            f"{' -> '.join(lattice)}",
                    where=site, obj=b, source="static-lint"))
        elif ra is not None or rb is not None:
            undeclared = a if ra is None else b
            diags.append(SanitizerDiagnostic(
                rule="LOCK002", severity="warning",
                message=f"nesting of {a!r} -> {b!r} involves "
                        f"{undeclared!r}, which has no declared rank in "
                        f"the lattice",
                where=site, obj=undeclared, source="static-lint",
                hint="add the lock to sanitize.LOCK_LATTICE so its order "
                     "is checked"))
    return diags


# --------------------------------------------------------------------------
# affinity lint
# --------------------------------------------------------------------------

#: list/dict/set method calls on self-rooted receivers that mutate state
_MUTATING_METHODS = {"append", "extend", "insert", "pop", "remove", "clear",
                     "sort", "update", "setdefault", "fill"}
#: allocator transitions reached through a self-rooted receiver
_ALLOCATOR_TRANSITIONS = {"allocate", "fork", "cow", "free"}
#: methods exempt from the must-call-_affine requirement
_AFFINITY_EXEMPT = {"rebind_thread", "_affine"}


def _rooted_in_self(expr) -> bool:
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        expr = expr.value
    return isinstance(expr, ast.Name) and expr.id == "self"


class _MethodScan(ast.NodeVisitor):
    def __init__(self):
        self.mutates = False
        self.calls_affine = False
        self.intra_calls: set = set()   # self.method(...) names

    def visit_Assign(self, node) -> None:
        if any(_rooted_in_self(t) for t in node.targets):
            self.mutates = True
        self.generic_visit(node)

    def visit_AugAssign(self, node) -> None:
        if _rooted_in_self(node.target):
            self.mutates = True
        self.generic_visit(node)

    def visit_Call(self, node) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            if isinstance(func.value, ast.Name) and func.value.id == "self":
                if func.attr == "_affine":
                    self.calls_affine = True
                self.intra_calls.add(func.attr)
            elif _rooted_in_self(func.value):
                if func.attr in _MUTATING_METHODS \
                        or func.attr in _ALLOCATOR_TRANSITIONS:
                    self.mutates = True
        self.generic_visit(node)


def affinity_report(path=None, *, class_name: str = "InferenceSession"):
    """Per-method mutation/guard classification for the session class.

    Returns ``{method: {"mutating": bool, "guarded": bool,
    "public": bool}}`` — the raw data behind :func:`lint_affinity`,
    exposed so tests can assert the known mutators are actually seen."""
    if path is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "api.py")
    with open(path, "r", encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    cls = next((n for n in ast.walk(tree)
                if isinstance(n, ast.ClassDef) and n.name == class_name),
               None)
    if cls is None:
        raise ValueError(f"no class {class_name!r} in {path}")
    scans: dict[str, _MethodScan] = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan = _MethodScan()
            for stmt in node.body:
                scan.visit(stmt)
            scans[node.name] = scan
    # transitive mutation through intra-class calls
    changed = True
    while changed:
        changed = False
        for name, scan in scans.items():
            if scan.mutates:
                continue
            if any(scans[c].mutates for c in scan.intra_calls
                   if c in scans):
                scan.mutates = True
                changed = True
    report = {}
    for name, scan in scans.items():
        report[name] = {
            "mutating": scan.mutates,
            "guarded": scan.calls_affine,
            "public": not name.startswith("_"),
        }
    return report


def lint_affinity(path=None, *, class_name: str = "InferenceSession") -> list:
    """AFF001 for every public state-mutating method without ``_affine``."""
    diags: list[SanitizerDiagnostic] = []
    report = affinity_report(path, class_name=class_name)
    for name, info in sorted(report.items()):
        if name.startswith("__") or name in _AFFINITY_EXEMPT:
            continue
        if info["public"] and info["mutating"] and not info["guarded"]:
            diags.append(SanitizerDiagnostic(
                rule="AFF001", severity="error",
                message=f"state-mutating method {class_name}.{name} does "
                        f"not call self._affine(...)",
                where=f"{class_name}.{name}", obj=name,
                source="static-lint",
                hint="every public mutator must assert thread affinity "
                     "before touching session state"))
    return diags


# --------------------------------------------------------------------------
# small-scope exhaustive interleaving check
# --------------------------------------------------------------------------


def model_check(initial, threads, invariant, *, name: str,
                max_states: int = 200_000) -> list:
    """Explore every interleaving of the thread programs exhaustively.

    ``threads`` is a list of programs; each program is a list of
    ``(label, fn)`` ops where ``fn(state) -> new_state`` (pure, over
    hashable states) or ``None`` when the op is not yet enabled (the
    thread blocks at that op until another thread changes the state).
    ``invariant(state) -> str | None`` returns an error description for
    a bad state.  States are deduplicated on ``(state, pcs)`` — BFS over
    the product automaton, not naive schedule enumeration.

    Returns SCHED001 diagnostics (with the violating schedule as the
    hint), empty when every reachable state satisfies the invariant.
    """
    diags: list[SanitizerDiagnostic] = []
    start = (initial, tuple(0 for _ in threads))
    seen = {start}
    todo = deque([(initial, tuple(0 for _ in threads), ())])
    explored = 0
    while todo:
        state, pcs, trace = todo.popleft()
        explored += 1
        if explored > max_states:
            diags.append(SanitizerDiagnostic(
                rule="SCHED001", severity="warning",
                message=f"{name}: state space exceeded {max_states} "
                        f"states; check truncated",
                where="model-check", source="model-check"))
            break
        for t, pc in enumerate(pcs):
            if pc >= len(threads[t]):
                continue
            label, fn = threads[t][pc]
            nxt = fn(state)
            if nxt is None:
                continue  # op not enabled under this state
            step = f"T{t}:{label}"
            err = invariant(nxt)
            if err is not None:
                diags.append(SanitizerDiagnostic(
                    rule="SCHED001", severity="error",
                    message=f"{name}: {err}",
                    where="model-check", obj=step, source="model-check",
                    hint="schedule " + " ; ".join(trace + (step,))))
                continue  # don't explore past a violation
            key = (nxt, pcs[:t] + (pc + 1,) + pcs[t + 1:])
            if key not in seen:
                seen.add(key)
                todo.append((nxt, key[1], trace + (step,)))
    return diags


def check_block_interleavings(*, bug: str | None = None) -> list:
    """Model-check the fork/cow/free block state machine.

    Two requests share one prefix block: A allocates and parks it, B
    forks it, both write (copy-on-write on the shared block) and free.
    The state is a pure mirror of :class:`ShadowPool` semantics; the
    invariant is exactly the shadow's rules (conservation, refcount
    consistency, no write into a shared block).  ``bug=`` seeds a
    defect so tests can prove the checker catches it:
    ``"skip_cow"`` (write without splitting), ``"double_free"`` and
    ``"drop_ref"`` (fork without the refcount increment).
    """
    n_blocks = 3
    # state: (free: frozenset, ref: tuple[block -> count],
    #         owners: tuple[thread -> frozenset of blocks],
    #         writes: tuple of (block, refcount_at_write))
    initial = (frozenset(range(1, n_blocks + 1)),
               (0,) * (n_blocks + 1),
               (frozenset(), frozenset()),
               ())

    def alloc(t):
        def fn(state):
            free, ref, owners, writes = state
            if not free:
                return None
            b = min(free)
            ref = ref[:b] + (1,) + ref[b + 1:]
            own = owners[t] | {b}
            return (free - {b}, ref,
                    owners[:t] + (own,) + owners[t + 1:], writes)
        return fn

    def fork_from(t, src):
        def fn(state):
            free, ref, owners, writes = state
            avail = [b for b in owners[src] if ref[b] >= 1]
            if not avail:
                return None
            b = min(avail)
            if bug != "drop_ref":
                ref = ref[:b] + (ref[b] + 1,) + ref[b + 1:]
            own = owners[t] | {b}
            return (free, ref, owners[:t] + (own,) + owners[t + 1:],
                    writes)
        return fn

    def write(t):
        def fn(state):
            free, ref, owners, writes = state
            if not owners[t]:
                return None
            b = min(owners[t])
            if ref[b] > 1 and bug != "skip_cow":
                # copy-on-write: split off a fresh exclusive block
                if not free:
                    return None
                f = min(free)
                ref = ref[:b] + (ref[b] - 1,) + ref[b + 1:]
                ref = ref[:f] + (1,) + ref[f + 1:]
                own = (owners[t] - {b}) | {f}
                return (free - {f}, ref,
                        owners[:t] + (own,) + owners[t + 1:],
                        writes + ((f, 1),))
            # exclusive write (or the seeded lost-COW write)
            return (free, ref, owners, writes + ((b, ref[b]),))
        return fn

    def release(t):
        def fn(state):
            free, ref, owners, writes = state
            if not owners[t]:
                return None
            b = min(owners[t])
            newref = ref[b] - 1
            if bug == "double_free" and newref == 0:
                newref -= 1  # seeded: the same reference returned twice
            ref = ref[:b] + (newref,) + ref[b + 1:]
            own = owners[t] - {b}
            newfree = free | {b} if newref <= 0 else free
            return (newfree, ref,
                    owners[:t] + (own,) + owners[t + 1:], writes)
        return fn

    threads = [
        [("alloc", alloc(0)), ("write", write(0)), ("free", release(0))],
        [("fork", fork_from(1, 0)), ("write", write(1)),
         ("free", release(1))],
    ]

    def invariant(state):
        free, ref, owners, writes = state
        held = [0] * (n_blocks + 1)
        for own in owners:
            for b in own:
                held[b] += 1
        for b in range(1, n_blocks + 1):
            if ref[b] < 0:
                return f"block {b} refcount went negative (double free)"
            if b in free and ref[b] != 0:
                return f"block {b} on the free list with refcount {ref[b]}"
            if ref[b] != held[b]:
                return (f"block {b} refcount {ref[b]} != {held[b]} held "
                        f"references (refcount drift)")
        for b, ref_at_write in writes:
            if ref_at_write > 1:
                return (f"write into block {b} while shared (refcount "
                        f"{ref_at_write}) without copy-on-write")
        return None

    return model_check(initial, threads, invariant,
                       name="block fork/cow/free protocol")


def check_scheduler_interleavings(*, bug: str | None = None) -> list:
    """Model-check the async submit/cancel/admit/preempt/requeue protocol.

    Two client threads submit (one also cancels: a resident cancel is
    routed through the mailbox the way ``AsyncEngine.cancel`` does it),
    the loop thread drains the mailbox, admits into a single slot,
    preempts/requeues and finishes.  Invariant: every request is in at
    most one of queued/resident/done, and the slot is never
    double-assigned.  ``bug="admit_keeps_queued"`` seeds the classic
    race (admit without removing from the queue);
    ``bug="cancel_direct"`` lets the client thread finish a *resident*
    request itself — check then act without the loop's serialization —
    which collides with a concurrent preempt/requeue.
    """
    # state: (queued, resident, done, mailbox, cancel_pending: bool)
    initial = (frozenset(), frozenset(), frozenset(), frozenset(), False)
    R0, R1 = 0, 1

    def submit(rid):
        def fn(state):
            q, r, d, mb, cp = state
            if rid in q | r | d:
                return None
            return (q | {rid}, r, d, mb, cp)
        return fn

    def request_cancel(rid):
        def fn(state):
            q, r, d, mb, cp = state
            if rid in d or rid in mb:
                return None
            if rid in q:
                # queued cancel is safe from any thread: engine.cancel
                # removes it under the lock, no slot is involved
                return (q - {rid}, r, d | {rid}, mb, cp)
            if rid in r:
                if bug == "cancel_direct":
                    # seeded defect, step 1/2: the client thread saw the
                    # request resident and decides to finish it itself
                    return (q, r, d, mb, True)
                return (q, r, d, mb | {rid}, cp)
            return None
        return fn

    def cancel_direct_finish(rid):
        def fn(state):
            q, r, d, mb, cp = state
            if not cp:
                return None
            # seeded defect, step 2/2: finish without rechecking — by
            # now the loop may have preempted the request back into the
            # queue, leaving it queued AND done at once
            return (q, r - {rid}, d | {rid}, mb, False)
        return fn

    def drain_mailbox(state):
        q, r, d, mb, cp = state
        if not mb:
            return state  # loop iterates on: drain is a no-op
        rid = min(mb)
        return (q - {rid}, r - {rid}, d | {rid}, mb - {rid}, cp)

    def admit(state):
        q, r, d, mb, cp = state
        if not q or r:
            return state  # nothing to admit / slot busy: loop iterates on
        rid = min(q)
        newq = q if bug == "admit_keeps_queued" else q - {rid}
        return (newq, r | {rid}, d, mb, cp)

    def preempt_requeue(state):
        q, r, d, mb, cp = state
        if not r:
            return None
        rid = min(r)
        return (q | {rid}, r - {rid}, d, mb, cp)

    def finish(state):
        q, r, d, mb, cp = state
        if not r:
            return None
        rid = min(r)
        return (q, r - {rid}, d | {rid}, mb, cp)

    cancel_ops = [("cancel", request_cancel(R0))]
    if bug == "cancel_direct":
        cancel_ops.append(("cancel-finish", cancel_direct_finish(R0)))
    threads = [
        [("submit", submit(R0))] + cancel_ops,
        [("submit", submit(R1))],
        [("admit", admit), ("drain", drain_mailbox), ("admit", admit),
         ("preempt", preempt_requeue), ("admit", admit),
         ("drain", drain_mailbox), ("finish", finish), ("admit", admit),
         ("finish", finish)],
    ]

    def invariant(state):
        q, r, d, mb, cp = state
        for rid in (R0, R1):
            places = (rid in q) + (rid in r) + (rid in d)
            if places > 1:
                names = [n for n, s in
                         (("queued", q), ("resident", r), ("done", d))
                         if rid in s]
                return (f"request {rid} in {places} states at once: "
                        f"{' + '.join(names)}")
        if len(r) > 1:
            return f"single slot double-assigned: residents {sorted(r)}"
        return None

    return model_check(initial, threads, invariant,
                       name="scheduler submit/cancel/preempt protocol")


def check_interleavings() -> list:
    """Both bounded interleaving checks; [] = all schedules verified."""
    return check_block_interleavings() + check_scheduler_interleavings()


# --------------------------------------------------------------------------
# CLI — same rc contract as repro_torch.deploy.verify
# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.deploy.sanitize",
        description="Static concurrency lint (lock order + thread "
                    "affinity) and bounded interleaving checks.")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "repro_torch.deploy package)")
    ap.add_argument("--strict", action="store_true",
                    help="treat warnings as failures")
    ap.add_argument("--interleavings", action="store_true",
                    help="also run the bounded interleaving model checks")
    args = ap.parse_args(argv)

    paths = args.paths or _default_paths()
    label = ", ".join(paths)
    try:
        diags = list(lint_lock_order(paths))
        if not args.paths:  # default run covers the session class too
            diags += lint_affinity()
    except (OSError, SyntaxError) as e:
        print(f"{label}: cannot analyze: {e}", file=sys.stderr)
        return 2
    if args.interleavings:
        diags += check_interleavings()

    errors = [d for d in diags if d.severity == "error"]
    warnings = [d for d in diags if d.severity != "error"]
    for d in diags:
        print(f"{label}: {d.format()}")
    failed = bool(errors) or (args.strict and bool(warnings))
    verdict = "FAIL" if failed else "OK"
    print(f"{label}: {verdict} — {len(errors)} error(s), "
          f"{len(warnings)} warning(s)")
    return 1 if failed else 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
