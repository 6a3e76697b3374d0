"""Fault tolerance + straggler mitigation for the training loop.

The supervisor wraps the step: on failure it restores the latest
checkpoint and replays (the data pipeline is a pure function of step, so
replay is exact).  Straggler detection watches per-step wall time against
a rolling median; a flagged step triggers the configured action (log /
re-shard / abort) — the hook is injectable for tests.

On the card a step returns when its kernels are queued, before the device
finishes them, so the detector sees the host's time per step, as the JAX
package's detector sees its asynchronous dispatch.  No step is synced for
it: a sync per step would stall the queue that hides the host's time.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

log = logging.getLogger("repro_torch.fault")


@dataclass
class StragglerDetector:
    window: int = 32
    threshold: float = 2.5  # x median
    history: deque = field(default_factory=lambda: deque(maxlen=32))
    flags: int = 0

    def observe(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.history) >= max(8, self.window // 4):
            med = sorted(self.history)[len(self.history) // 2]
            if dt > self.threshold * med:
                is_straggler = True
                self.flags += 1
        self.history.append(dt)
        return is_straggler


@dataclass
class Supervisor:
    """Checkpoint-restart supervision around a step function."""

    checkpointer: "object"
    save_every: int = 100
    max_retries: int = 3
    on_straggler: Callable[[int, float], None] | None = None
    detector: StragglerDetector = field(default_factory=StragglerDetector)

    def run(
        self,
        step_fn: Callable,  # (state, batch) -> (state, metrics)
        state,
        batch_fn: Callable,  # step -> batch
        start_step: int,
        num_steps: int,
        inject_failure: Callable[[int], None] | None = None,
    ):
        """Run ``num_steps`` with checkpoint/restart. Returns (state, history)."""
        step = start_step
        history = []
        retries = 0
        while step < start_step + num_steps:
            t0 = time.monotonic()
            try:
                if inject_failure is not None:
                    inject_failure(step)
                state, metrics = step_fn(state, batch_fn(step))
            except Exception as e:  # noqa: BLE001 — any step failure
                retries += 1
                log.warning("step %d failed (%s); restoring latest checkpoint", step, e)
                if retries > self.max_retries:
                    raise
                # join any in-flight async save before reading LATEST —
                # a failure can race the background writer
                self.checkpointer.wait()
                restored = self.checkpointer.restore_latest(state)
                if restored[0] is None:
                    raise RuntimeError("no checkpoint to restore from") from e
                ck_step, state = restored
                step = ck_step  # replay from the checkpointed step
                continue
            retries = 0
            dt = time.monotonic() - t0
            if self.detector.observe(dt) and self.on_straggler:
                self.on_straggler(step, dt)
            history.append((step, metrics))
            step += 1
            if step % self.save_every == 0:
                self.checkpointer.save_async(step, state)
        self.checkpointer.wait()
        return state, history
