"""Named locks of the serving layer (torch port, the lock half).

The JAX package's ``deploy/sanitize.py`` hands out plain ``threading``
primitives normally and lockdep-tracked wrappers under
``REPRO_SANITIZE=1``.  Only the plain half is ported: ``make_lock``,
``make_condition``, ``require_held`` and ``enabled``.  The lockdep
wrapper, the static lock-order lint and the shadow block sanitizer wait
for ROADMAP queue 1, item 3.  A process that asks for them with
``REPRO_SANITIZE`` gets ``NotImplementedError``, never a silently
unsanitized run.
"""

from __future__ import annotations

import os
import threading

#: where the missing half is queued (named in the refusal)
_NOT_PORTED = ("the concurrency sanitizer (lockdep locks, shadow block tracking) is not "
               "ported yet (ROADMAP queue 1, item 3); unset REPRO_SANITIZE to run unsanitized")


def enabled() -> bool:
    """False: the port runs unsanitized.  Raises ``NotImplementedError``
    when ``REPRO_SANITIZE`` asks for the sanitizer (``1``, ``true``,
    ``yes`` or ``on``, as the JAX package reads it)."""
    if os.environ.get("REPRO_SANITIZE", "").strip().lower() in ("1", "true", "yes", "on"):
        raise NotImplementedError(_NOT_PORTED)
    return False


def make_lock(name: str, *, reentrant: bool = False):
    """A plain ``Lock`` (``RLock`` when ``reentrant``); ``name`` is the
    lock's identity in the JAX package's declared lattice."""
    enabled()
    return threading.RLock() if reentrant else threading.Lock()


def make_condition(name: str):
    """A plain condition variable."""
    enabled()
    return threading.Condition()


def require_held(lock, where: str) -> None:
    """The JAX package's LOCK006 check; a no-op on plain locks, which are
    the only kind the port makes."""


def runtime_findings() -> tuple:
    """Lockdep findings so far: none, since the port tracks no lock."""
    return ()
