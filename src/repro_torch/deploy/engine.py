"""Request-level serving engine: ``Engine.submit() -> RequestHandle`` (torch port).

The JAX package's ``deploy/engine.py`` on the port's session; the
scheduling, admission, preemption, prefix-cache and eviction logic is
the same line for line, so greedy streams equal the reference's bit for
bit.  What touches the device: the token vector of a decode dispatch is
built on the host and copied once; each dispatch (a decode step, a dense
``prefill_slot``, a batched ``prefill_chunks``) is followed by ONE
device-to-host fetch of its last-token logits rows (``.cpu().numpy()``),
which also ends the dispatch's timer (CUDA returns before the work is
done, so a timer that stopped earlier would time only the host).
Sampling, depths and block tables stay on the host.  :class:`Temperature`
takes an integer seed in place of a ``jax.random`` key.

The layer above :class:`~repro_torch.deploy.api.InferenceSession`.  The session
is slot-indexed — callers hand-manage which request lives in which KV
row and feed per-request ``pos`` vectors by hand.  The engine owns all of
that: callers ``submit(prompt_tokens, max_new_tokens)`` and get back a
:class:`RequestHandle`; ``step()`` / ``run_until_idle()`` run the
continuous-batching scheduler loop on top of the one statically planned
artifact:

* **pluggable admission** — queued requests enter free (or newly
  recycled) slots via ``session.prefill_slot`` while resident requests
  keep decoding mid-flight.  The *order* is a policy value
  (:mod:`repro_torch.deploy.serving.scheduler`): ``FIFO`` (the default,
  byte-compatible with the historical behavior) or ``PriorityDeadline``
  (per-request ``priority`` / ``ttft_slo_ms`` / ``deadline_ms``,
  aging, deadline-driven preemption, bounded-queue load shedding with
  a structured ``QueueFullError``);
* **preemption + requeue** — when the policy demands it, an over-budget
  resident is evicted *back to the queue* (paged KV frees its blocks
  immediately); on re-admission its prefix — prompt plus every token it
  already generated — is re-prefilled/teacher-forced and generation
  resumes at the same sampling index, so a requeued request's final
  stream is bit-exact vs an uninterrupted run;
* **one batched decode dispatch per step** — every resident request
  advances one token at its own depth (the session's per-request ``pos``
  vector), so the batch dimension stays as full as the traffic allows
  (the throughput lever on many-core targets, cf. arXiv 2405.19284);
* **completion detection** — EOS, ``max_new_tokens``, or KV capacity
  (via the structured :class:`~repro_torch.deploy.api.KVCapacityError`, which
  names exactly the slots that ran out — the engine evicts precisely
  those and re-dispatches the rest);
* **slot eviction + recycling** — a finished request's slot goes
  straight back to the admission queue's disposal;
* **streaming** — an optional per-token callback on each handle fires
  the moment a token is sampled;
* **prefix cache** (``compile(..., prefix_cache=True)``, paged only) —
  finished prompt prefills are indexed in a radix trie
  (:class:`~repro_torch.deploy.prefix.PrefixIndex`); a new submission whose
  prompt matches a resident chain forks those blocks into its table
  (refcount + 1, zero data movement), prefills only the novel suffix
  (an exact repeat skips prefill entirely — the cached last-token
  logits row is sampled directly), and admission pledges pool blocks
  for the *suffix only*.  Writes into still-shared blocks copy-on-write
  first (the session's invariant), eviction never reports all-shared
  slots evictable, and blocks referenced only by the index park in an
  LRU reclaim list the engine drains before evicting anyone.

Prompt lengths are *at least* the compiled prompt length ``S`` (the
prefill schedule is static).  Dense KV region: the first ``S`` tokens go
through ``prefill_slot``, any remaining prompt tokens are teacher-forced
through the same batched decode dispatches (status ``PREFILLING``)
before generation starts (status ``DECODING``) — so mixed prompt lengths
share one plan.  **Paged** KV region (``compile(...,
kv_block_size=, kv_blocks=)``): the whole prompt prefills in ``S``-sized
chunks through the slot's block table — ``<= ceil(len / S)`` prefill
dispatches instead of ``len - S`` teacher-forced decode dispatches, one
chunk per scheduler step interleaved with the residents' batched decodes
— and admission/eviction are pool-occupancy-aware: a prompt is admitted
only when the pool has unpledged blocks for all of it, and a finished or
evicted request's blocks return to the pool immediately.

Every stream equals the JAX package's engine on the same ints (tested on
both backends, dense and paged, with and without the prefix cache, in
``tests/test_torch_engine*.py`` and ``tests/test_torch_serving.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import math
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.deploy import spans
from repro_torch.deploy.api import CompiledModel, InferenceSession, KVCapacityError
from repro_torch.deploy.paging import blocks_for_rows, chunk_starts
from repro_torch.deploy.sanitize import make_lock
from repro_torch.deploy.serving.scheduler import (
    FIFO,
    QueueFullError,
    Scheduler,
    effective_deadline,
)


# ---------------------------------------------------------------------------
# Sampling policies
# ---------------------------------------------------------------------------

class Greedy:
    """Deterministic argmax over the real-vocab slice of the logits row
    (a host ``np.ndarray``; ties go to the first index, as ``jnp.argmax``
    breaks them).

    ``vocab`` masks the LM head's padding lanes (zero-weight columns
    whose logit 0 would beat an all-negative real row and emit an
    out-of-vocab id); the engine fills it from the model config when
    left ``None`` — the same binding rule as :class:`Temperature`."""

    name = "greedy"

    def __init__(self, vocab: int | None = None):
        self.vocab = vocab

    def __call__(self, logits_row, rid: int, index: int) -> int:
        row = logits_row[: self.vocab] if self.vocab else logits_row
        return int(np.argmax(row))


class Temperature:
    """Temperature sampling from a caller-supplied integer seed.

    Each draw has a CPU ``torch.Generator`` of its own, seeded from
    ``(seed, rid, index)`` — the request's submit-order id and the token
    index, never the slot the scheduler happened to place the request in
    — and samples by Gumbel-max over ``row[:vocab] / temperature``
    (float64), so sampled streams are deterministic across batch
    orderings, admission order, and ``max_batch``.  The JAX package folds
    a ``jax.random`` key instead: the two packages draw different
    streams for the same logits.  ``vocab`` restricts sampling to real
    tokens (the LM head is padded to a multiple of 256); the engine fills
    it from the model config when left ``None``.
    """

    name = "temperature"

    def __init__(self, temperature: float, seed: int, vocab: int | None = None):
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.vocab = vocab

    def generator(self, rid: int, index: int) -> torch.Generator:
        """The draw's own generator: a function of (seed, rid, index) only."""
        words = np.random.SeedSequence([self.seed, int(rid), int(index)]).generate_state(2)
        return torch.Generator().manual_seed(int(words[0]) << 32 | int(words[1]))

    def __call__(self, logits_row, rid: int, index: int) -> int:
        row = logits_row[: self.vocab] if self.vocab else logits_row
        scaled = torch.as_tensor(np.asarray(row, np.float64)) / self.temperature
        u = torch.rand(scaled.shape, dtype=torch.float64, generator=self.generator(rid, index))
        return int(torch.argmax(scaled - torch.log(-torch.log(u))))


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

class RequestStatus(enum.Enum):
    QUEUED = "queued"          # submitted, waiting for a slot
    PREFILLING = "prefilling"  # resident; prompt tokens still being consumed
    DECODING = "decoding"      # resident; generating
    DONE = "done"              # finished: eos / length / kv_capacity
    EVICTED = "evicted"        # cancelled or displacement-shed; slot recycled


class RequestHandle:
    """One submitted request: status, generated tokens, streaming hook.

    ``tokens`` grows as the scheduler samples; ``finish_reason`` is one
    of ``"eos"``, ``"length"`` (hit ``max_new_tokens``),
    ``"kv_capacity"`` (evicted by the static KV region's capacity, with
    whatever it generated so far), ``"cancelled"``, ``"shed"`` (displaced
    from a bounded queue) or ``"error"`` (the async loop died).  ``on_token(tok)``
    fires synchronously the moment each token is sampled (streaming).

    SLO fields (consumed by :class:`~repro_torch.deploy.serving.scheduler.
    PriorityDeadline`; ignored by FIFO): ``priority`` (lower = more
    urgent), ``ttft_slo_ms`` (time-to-first-token target) and
    ``deadline_ms`` (completion budget — past it the request is
    preemptible).  ``arrival_t`` / ``admit_t`` (first admission into a
    slot) / ``first_token_t`` / ``finish_t`` are engine-clock timestamps;
    ``preemptions`` counts how many times this
    request was evicted-to-queue and re-admitted.
    """

    def __init__(self, engine: "Engine", rid: int, prompt: tuple[int, ...],
                 max_new_tokens: int, eos_id: int | None,
                 on_token: Callable[[int], None] | None,
                 *, priority: int = 0, ttft_slo_ms: float | None = None,
                 deadline_ms: float | None = None, arrival_t: float = 0.0):
        self._engine = engine
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.on_token = on_token
        self.status = RequestStatus.QUEUED
        self.tokens: list[int] = []
        self.finish_reason: str | None = None
        self.slot: int | None = None  # scheduler-internal residency
        # SLO contract (absolute times on the engine's injected clock)
        self.priority = int(priority)
        self.ttft_slo_ms = ttft_slo_ms
        self.deadline_ms = deadline_ms
        self.arrival_t = float(arrival_t)
        self.deadline_t = (None if deadline_ms is None
                           else self.arrival_t + float(deadline_ms) / 1e3)
        self.admit_deadline_t = effective_deadline(
            self.arrival_t, ttft_slo_ms, deadline_ms)
        self.admit_t: float | None = None
        self.first_token_t: float | None = None
        self._last_token_t: float | None = None
        self.finish_t: float | None = None
        self.preemptions = 0
        # tokens already generated before the last preemption: on
        # re-admission the engine teacher-forces tokens[:resumed] (they
        # are part of the request's prefix now) and resumes sampling at
        # index ``resumed`` — identical fold-in indices, identical stream
        self.resumed = 0

    @property
    def done(self) -> bool:
        return self.status in (RequestStatus.DONE, RequestStatus.EVICTED)

    @property
    def ttft_s(self) -> float | None:
        """Observed time-to-first-token (None before the first token)."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    def prefix(self) -> tuple[int, ...]:
        """The token prefix an admission must (re-)establish in the KV
        region: the prompt plus every token generated before a
        preemption.  Fresh requests have no tokens yet, so this is just
        the prompt."""
        return self.prompt + tuple(self.tokens[: self.resumed])

    def cancel(self) -> None:
        """Withdraw the request (queued or mid-flight) and free its slot."""
        self._engine.cancel(self)

    def __repr__(self) -> str:
        return (f"RequestHandle(rid={self.rid}, status={self.status.value}, "
                f"prompt_len={len(self.prompt)}, generated={len(self.tokens)}, "
                f"finish_reason={self.finish_reason!r})")


def _nearest_rank(xs: list, pct: float) -> float:
    """Nearest-rank percentile of a sample list (0.0 when empty)."""
    if not xs:
        return 0.0
    ordered = sorted(xs)
    rank = max(1, math.ceil(pct / 100.0 * len(ordered)))
    return ordered[rank - 1]


@dataclasses.dataclass
class EngineStats:
    """Live scheduler counters (one record per engine, updated in place)."""

    max_batch: int
    requests_submitted: int = 0
    requests_completed: int = 0
    requests_evicted: int = 0      # cancellations
    preemptions: int = 0           # residents evicted-to-queue by the policy
    requeues: int = 0              # preempted requests re-entering the queue
    shed_requests: int = 0         # refused (429) or displaced by the bounded queue
    slots_recycled: int = 0        # admissions into a previously used slot
    prefill_dispatches: int = 0
    decode_dispatches: int = 0
    tokens_generated: int = 0
    prompt_tokens_forced: int = 0  # prompt tail consumed through decode
    prompt_tokens_prefilled: int = 0  # prompt tokens consumed by prefill/chunk
    slot_steps_busy: int = 0       # sum over dispatches of resident requests
    queue_depth: int = 0
    peak_queue_depth: int = 0
    slots_busy: int = 0
    # a dispatch's host clock, from the session call to the end of its one
    # logits fetch: the enqueue (the session call, which returns once the
    # kernels are queued) plus the fetch (which waits for the device)
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    prefill_enqueue_s: float = 0.0
    prefill_fetch_s: float = 0.0
    decode_enqueue_s: float = 0.0
    decode_fetch_s: float = 0.0
    # lanes named in the successful chunk dispatches, summed (each dispatch
    # runs all max_batch lanes; the others are parked on the scratch block)
    prefill_lanes: int = 0
    # prefix cache (zero everywhere unless compile(prefix_cache=True)):
    # lookups/hits count admissions, hit_blocks counts KV blocks served
    # from the cache instead of re-prefilled, full_prefix_hits are
    # zero-prefill admissions (exact prompt repeat, cached logits)
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_hit_blocks: int = 0
    full_prefix_hits: int = 0
    # peak number of pool blocks simultaneously referenced by >1 holder
    blocks_shared: int = 0
    # copy-on-write block copies materialized by the session (this
    # engine's share since the last reset_stats)
    cow_copies: int = 0
    # parked (index-only) blocks LRU-reclaimed back to the pool
    prefix_reclaimed_blocks: int = 0
    # top-level plan dispatches per decode step (len(decode.nodes)) — the
    # metric region fusion collapses (~5x on the reference decoders)
    dispatches_per_step: int = 0
    # one-time static-verification cost of the artifact this engine runs
    # (CompiledModel.verify_ms; 0.0 when compiled with verify=False)
    verify_ms: float = 0.0
    # findings recorded by point-in-time audit_sharing() calls
    audit_findings: int = 0
    step_times_s: list = dataclasses.field(default_factory=list)
    # request-level latency samples (engine clock): TTFT is submit ->
    # first *generated* token (queue wait + prefill + any preemption
    # included — the number an SLO is written against); TPOT is the gap
    # between consecutive generated tokens of one request
    ttft_s: list = dataclasses.field(default_factory=list)
    tpot_s: list = dataclasses.field(default_factory=list)
    # submit -> first admission into a slot, one sample a request
    queue_wait_s: list = dataclasses.field(default_factory=list)
    # the step's host work outside the dispatches, by phase (the engine's
    # ``engine/*`` spans, each its self time) and its calls
    host_s: dict = dataclasses.field(default_factory=dict)
    host_calls: dict = dataclasses.field(default_factory=dict)

    def snapshot(self) -> "EngineStats":
        """One consistent copy: scalar counters plus fresh copies of the
        sample lists, so a reader on another thread never sees a
        half-updated record or a list the loop is appending to.  Take it
        under the engine lock — :meth:`Engine.stats_snapshot` does."""
        out = dataclasses.replace(self)
        out.step_times_s = list(self.step_times_s)
        out.ttft_s = list(self.ttft_s)
        out.tpot_s = list(self.tpot_s)
        out.queue_wait_s = list(self.queue_wait_s)
        out.host_s = dict(self.host_s)
        out.host_calls = dict(self.host_calls)
        out._slo_outcomes = list(self._slo_outcomes)
        return out

    def add_phases(self, phases: spans.Phases) -> None:
        """Fold one step's phases into ``host_s`` / ``host_calls``."""
        for name, s in phases.seconds.items():
            self.host_s[name] = self.host_s.get(name, 0.0) + s
            self.host_calls[name] = self.host_calls.get(name, 0) + phases.calls[name]

    def step_latency_s(self, pct: float) -> float:
        """Nearest-rank percentile of recorded scheduler-step wall times."""
        return _nearest_rank(self.step_times_s, pct)

    def step_latency_p50(self) -> float:
        return self.step_latency_s(50.0)

    def step_latency_p99(self) -> float:
        return self.step_latency_s(99.0)

    def ttft(self, pct: float) -> float:
        """Nearest-rank percentile of observed TTFT samples (seconds)."""
        return _nearest_rank(self.ttft_s, pct)

    def tpot(self, pct: float) -> float:
        """Nearest-rank percentile of observed per-output-token gaps."""
        return _nearest_rank(self.tpot_s, pct)

    def queue_wait(self, pct: float) -> float:
        """Nearest-rank percentile of the queue-wait samples (seconds)."""
        return _nearest_rank(self.queue_wait_s, pct)

    def host_per_step(self) -> dict:
        """Per engine step, by phase: ``{"ms": ..., "calls": ...}``."""
        n = max(1, len(self.step_times_s))
        return {k: {"ms": 1e3 * s / n, "calls": self.host_calls[k] / n}
                for k, s in sorted(self.host_s.items())}

    def chunk_lane_use(self) -> float:
        """Fraction of a chunk dispatch's lanes that carried a chunk."""
        return self.prefill_lanes / max(1, self.prefill_dispatches * self.max_batch)

    def goodput_under_slo(self) -> float:
        """Fraction of *finished* SLO-carrying requests whose TTFT met
        their ``ttft_slo_ms`` (shed requests never produce a sample, so
        callers measuring end-to-end goodput add them to the
        denominator themselves — see ``benchmarks/engine_throughput``).
        1.0 when no request carried an SLO."""
        if not self._slo_outcomes:
            return 1.0
        return sum(self._slo_outcomes) / len(self._slo_outcomes)

    _slo_outcomes: list = dataclasses.field(default_factory=list)

    def prefix_hit_rate(self) -> float:
        """Fraction of prefix-cache lookups that matched at least one
        resident block (0.0 when the cache is off or never consulted)."""
        return self.prefix_hits / max(1, self.prefix_lookups)

    def occupancy(self) -> float:
        """Mean fraction of slots doing real work per decode dispatch."""
        return self.slot_steps_busy / max(1, self.decode_dispatches * self.max_batch)

    def tokens_per_s(self) -> float:
        """*Generated* tokens over total dispatch time (prefill + decode).

        Prompt processing is reported separately
        (:meth:`prompt_tokens_per_s`): teacher-forced prompt tails and
        prefill chunks consume dispatches but generate nothing, so
        folding them in here would understate long-prompt serving."""
        return self.tokens_generated / max(self.prefill_time_s + self.decode_time_s,
                                           1e-9)

    def prompt_tokens_per_s(self) -> float:
        """Prompt tokens processed (prefill/chunk dispatches +
        teacher-forced tail) over total dispatch time."""
        done = self.prompt_tokens_prefilled + self.prompt_tokens_forced
        return done / max(self.prefill_time_s + self.decode_time_s, 1e-9)

    def summary(self) -> str:
        slo = ""
        if self.ttft_s:
            slo = (f", ttft p50/p99 {self.ttft(50) * 1e3:.1f}/"
                   f"{self.ttft(99) * 1e3:.1f} ms"
                   f", tpot p50/p99 {self.tpot(50) * 1e3:.1f}/"
                   f"{self.tpot(99) * 1e3:.1f} ms")
        if self.preemptions or self.shed_requests:
            slo += (f", {self.preemptions} preemptions / "
                    f"{self.requeues} requeues / "
                    f"{self.shed_requests} shed")
        if self.prefix_lookups:
            slo += (f", prefix cache {self.prefix_hits}/"
                    f"{self.prefix_lookups} hits "
                    f"({self.prefix_hit_blocks} blocks, "
                    f"{self.full_prefix_hits} full, "
                    f"{self.blocks_shared} peak shared, "
                    f"{self.cow_copies} cow, "
                    f"{self.prefix_reclaimed_blocks} reclaimed)")
        return (
            f"{self.requests_completed}/{self.requests_submitted} requests done "
            f"({self.requests_evicted} cancelled{slo}), "
            f"{self.tokens_generated} tokens "
            f"in {self.decode_dispatches} decode dispatches "
            f"({self.occupancy():.0%} slot occupancy, "
            f"{self.slots_recycled} slots recycled, "
            f"{self.tokens_per_s():.1f} gen tok/s, "
            f"{self.prompt_tokens_per_s():.1f} prompt tok/s, "
            f"{self.dispatches_per_step} dispatches/step, "
            f"step p50/p99 {self.step_latency_p50() * 1e3:.1f}/"
            f"{self.step_latency_p99() * 1e3:.1f} ms, "
            f"plan verified in {self.verify_ms:.1f} ms)"
        )


def _host_rows(logits: torch.Tensor) -> np.ndarray:
    """Every lane's last-token logits row, ``[B, vocab_padded]``, in host
    memory: the one device-to-host copy of a dispatch (it waits for the
    dispatch to finish)."""
    return logits[:, -1].cpu().numpy()


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class Engine:
    """Continuous-batching scheduler over one compiled decoder artifact.

    ``Engine(compiled_model, max_batch)`` builds the underlying
    ``InferenceSession`` (``max_batch`` request slots against one
    statically planned KV region) with ``CompiledModel.session``'s
    ``params`` / ``qp`` / ``seed`` / ``device`` / ``table`` — on the card
    unless ``device`` says otherwise; passing an existing decoder
    ``InferenceSession`` as the first argument adopts it instead.
    ``sampling`` is a policy callable ``(logits_row, rid, index) -> int``
    over a host ``np.ndarray`` row — :class:`Greedy` (default) or
    :class:`Temperature` with a caller-supplied seed.

    ``scheduler`` is the admission policy
    (:mod:`repro_torch.deploy.serving.scheduler`): :class:`FIFO` by default —
    byte-compatible with the historical behavior — or
    :class:`PriorityDeadline` for SLO-aware ordering, preemption and
    load shedding.  ``clock`` is the monotonic time source for arrival
    stamps, TTFT/TPOT samples and deadline checks (injectable so
    scheduling is deterministic under a fake clock in tests; defaults to
    :func:`time.monotonic`).

    Thread contract: the *step loop* (``step`` / ``run_until_idle``)
    belongs to exactly one thread — the caller's here, a dedicated
    background thread under :class:`~repro_torch.deploy.serving.async_engine.
    AsyncEngine`.  ``submit`` and queued-``cancel`` are safe from any
    thread (the queue frontier is lock-protected); cancelling a
    *resident* request must happen on the loop thread (AsyncEngine
    routes it there).  So the loop thread is the only one that launches
    work on the session's device.
    """

    def __init__(
        self,
        model: CompiledModel | InferenceSession,
        max_batch: int | None = None,
        *,
        sampling=None,
        scheduler: Scheduler | None = None,
        clock: Callable[[], float] | None = None,
        params: dict | None = None,
        qp: dict | None = None,
        seed: int | None = None,
        device: str | torch.device | None = None,
        table=None,
    ):
        if isinstance(model, InferenceSession):
            if max_batch not in (None, model.batch_size):
                raise ValueError(
                    f"max_batch {max_batch} != adopted session batch_size "
                    f"{model.batch_size}")
            if any(v is not None for v in (params, qp, seed, device, table)):
                raise ValueError(
                    "params/qp/seed/device/table apply when the engine builds "
                    "its own session; an adopted InferenceSession already "
                    "carries bound weights, a device and a dispatch table")
            if model.model.kind == "decoder" and model.pos is not None:
                raise ValueError(
                    "adopted session already holds live KV state (prefilled "
                    "requests); the engine owns slots exclusively and would "
                    "clobber them — hand it a fresh session")
            self.session = model
        else:
            if max_batch is None or max_batch < 1:
                raise ValueError(f"max_batch must be >= 1, got {max_batch}")
            self.session = model.session(
                max_batch, params=params, qp=qp,
                seed=0 if seed is None else seed, device=device, table=table)
        if self.session.model.kind != "decoder":
            raise ValueError(
                "Engine serves decoder artifacts (prefill/decode); "
                f"{self.session.cfg.name} compiled to an encoder plan — "
                "use InferenceSession.forward for encoders")
        self.cfg = self.session.cfg
        self.max_batch = self.session.batch_size
        self.seq_len = self.session.seq_len
        self.max_len = self.session.max_len
        self.paged = self.session.paged
        # radix prefix cache: opted in at compile time (the knob is part
        # of the artifact's fingerprint), active only over a paged pool
        self.prefix_index = None
        opts = getattr(self.session.model, "options", None) or {}
        if self.paged and opts.get("prefix_cache"):
            from repro_torch.deploy.prefix import PrefixIndex

            self.prefix_index = PrefixIndex(self.session.allocator,
                                            self.session.kv_block_size)
        self._cow_base = 0  # session cow counter at the last reset_stats
        sampling = sampling if sampling is not None else Greedy()
        if getattr(sampling, "vocab", 0) is None:
            # bind an engine-local copy: a caller-shared policy must not be
            # mutated, or a second engine over a different vocab would
            # inherit (and sample past) the first model's range
            sampling = copy.copy(sampling)
            sampling.vocab = self.cfg.vocab
        self.sampling = sampling
        if scheduler is not None and len(scheduler) != 0:
            raise ValueError(
                "scheduler already holds queued requests; each Engine "
                "needs its own (fresh) policy instance")
        self.scheduler = scheduler if scheduler is not None else FIFO()
        self.clock = clock if clock is not None else time.monotonic
        # guards the queue frontier — scheduler contents, rid assignment,
        # queue-depth stats — so submit()/queued-cancel() are safe from
        # any thread while the loop thread admits.  Slot/device state is
        # loop-thread-only and never touched under this lock's waiters.
        # Reentrant: submit() holds it across _note_queue().  Under
        # REPRO_SANITIZE=1 it is lockdep-tracked (sanitize.LOCK_LATTICE).
        self._lock = make_lock("engine.lock", reentrant=True)
        # the scheduler has no lock of its own — the engine serializes
        # every mutation under _lock; the sanitizer proves it per call
        self.scheduler.guard_lock = self._lock
        self.stats = EngineStats(
            max_batch=self.max_batch,
            dispatches_per_step=self.session.decode_dispatch_count,
            verify_ms=getattr(self.session.model, "verify_ms", 0.0))
        self._slots: list[RequestHandle | None] = [None] * self.max_batch
        # engine-owned per-slot depth; free slots are pinned at 0 so their
        # placeholder lane in a batched dispatch never trips KV capacity
        self._pos: list[int] = [0] * self.max_batch
        self._next_input: list[int] = [0] * self.max_batch
        self._used_slots: set[int] = set()
        # paged chunked prefill: slot -> remaining chunk starts.  A slot
        # in here is resident but NOT part of the decode lanes yet — its
        # chunks interleave with the residents' batched decode dispatches.
        self._chunks: dict[int, list[int]] = {}
        # blocks an admitted-but-still-chunking prompt will still claim;
        # admission subtracts these pledges from the free count so two
        # long prompts cannot both be admitted into blocks only one of
        # them can have (decode-phase growth stays unpledged: that path
        # finishes the overflowing request via KVCapacityError, exactly
        # like dense max_len)
        self._pledged: dict[int, int] = {}
        self._next_rid = 0
        # the current step's phases (loop thread only; a fresh one a step)
        self._phases = spans.Phases()

    # -- submission --------------------------------------------------------

    def validate_request(self, prompt: tuple[int, ...],
                         max_new_tokens: int) -> None:
        """Every submit-time admission check, raised as structured errors
        *before* any engine state changes — a bad request must fail at
        the submission boundary, never mid-loop with a slot half-built.

        Raises ``ValueError`` for empty/short/over-``max_len`` prompts
        and non-positive budgets, :class:`KVCapacityError`
        (``reason="pool"``) when a prompt can never fit the paged pool.
        """
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) == 0:
            raise ValueError(
                "empty prompt: a request needs at least seq_len="
                f"{self.seq_len} prompt tokens (the prefill schedule is "
                "static)")
        if len(prompt) < self.seq_len:
            raise ValueError(
                f"prompt has {len(prompt)} tokens but the compiled prefill "
                f"schedule is static at seq_len={self.seq_len}; pad or "
                f"recompile with a smaller seq_len")
        if len(prompt) > self.max_len:
            raise ValueError(
                f"prompt has {len(prompt)} tokens but the KV region holds "
                f"max_len={self.max_len}; recompile with a larger max_len")
        if self.paged:
            need = blocks_for_rows(len(prompt), self.session.kv_block_size)
            if need > self.session.kv_blocks:
                raise KVCapacityError(
                    (), (), self.max_len, reason="pool",
                    message=(
                        f"prompt needs {need} KV blocks but the pool holds "
                        f"{self.session.kv_blocks} total; recompile with "
                        f"more kv_blocks"))

    def submit(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: int,
        *,
        eos_id: int | None = None,
        on_token: Callable[[int], None] | None = None,
        priority: int = 0,
        ttft_slo_ms: float | None = None,
        deadline_ms: float | None = None,
    ) -> RequestHandle:
        """Enqueue one request; the scheduler policy admits it on a
        later :meth:`step`.

        ``prompt_tokens`` must be at least the compiled prompt length
        (``seq_len``) and at most the KV capacity (``max_len``); tokens
        past ``seq_len`` are teacher-forced through batched decode
        (dense) or prefilled in ``seq_len``-sized chunks (paged).
        Generation stops at ``eos_id`` (recorded as the final token),
        after ``max_new_tokens``, or when the KV region fills.

        ``priority`` / ``ttft_slo_ms`` / ``deadline_ms`` are the
        request's SLO contract (see
        :class:`~repro_torch.deploy.serving.scheduler.PriorityDeadline`; FIFO
        ignores them).  A bounded-queue policy may refuse the submission
        with :class:`~repro_torch.deploy.serving.scheduler.QueueFullError`
        (counted in ``stats.shed_requests``; no handle is created), or
        accept it by *displacement* — a strictly lower-ranked queued
        request is finished with reason ``"shed"`` to make room (also
        counted in ``stats.shed_requests``).  Safe to call from any
        thread.
        """
        prompt = tuple(int(t) for t in prompt_tokens)
        self.validate_request(prompt, max_new_tokens)
        if ttft_slo_ms is not None and ttft_slo_ms < 0:
            raise ValueError(f"ttft_slo_ms must be >= 0, got {ttft_slo_ms}")
        if deadline_ms is not None and deadline_ms < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {deadline_ms}")
        with self._lock:
            now = self.clock()
            handle = RequestHandle(
                self, self._next_rid, prompt, int(max_new_tokens),
                eos_id, on_token, priority=priority,
                ttft_slo_ms=ttft_slo_ms, deadline_ms=deadline_ms,
                arrival_t=now)
            try:
                displaced = self.scheduler.add(handle, now)
            except QueueFullError:
                self.stats.shed_requests += 1
                raise
            if displaced is not None:
                self.stats.shed_requests += 1
            self._next_rid += 1
            self.stats.requests_submitted += 1
            self._note_queue()
        if displaced is not None:
            # outside the lock, like cancel(): the displaced request was
            # queued (no slot/device state), its waiters see "shed"
            self._finish(displaced, "shed", status=RequestStatus.EVICTED)
        return handle

    def cancel(self, handle: RequestHandle) -> None:
        with self._lock:
            if handle.done:
                return
            if handle.status is RequestStatus.QUEUED:
                self.scheduler.remove(handle)
                self._note_queue()
        self._finish(handle, "cancelled", status=RequestStatus.EVICTED)

    # -- introspection -----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self.scheduler)

    @property
    def slots_busy(self) -> int:
        return sum(1 for h in self._slots if h is not None)

    @property
    def idle(self) -> bool:
        return self.queue_depth == 0 and self.slots_busy == 0

    def stats_snapshot(self) -> EngineStats:
        """One consistent :class:`EngineStats` copy, taken under the
        engine lock.  Cross-thread readers (``/v1/stats``, benchmark
        CSVs) must use this instead of field-by-field reads of
        ``self.stats``, which race the loop thread's updates."""
        with self._lock:
            return self.stats.snapshot()

    def scheduler_snapshot(self) -> dict:
        """The admission policy's snapshot, taken under the engine lock
        (scheduler state is mutated under it on every submit/admit)."""
        with self._lock:
            return self.scheduler.snapshot()

    def reset_stats(self) -> EngineStats:
        """Zero the counters *and* the slot-reuse bookkeeping — e.g. after
        a warm-up pass, so a timed trace starts from a clean record."""
        self._used_slots = {b for b, h in enumerate(self._slots)
                            if h is not None}
        self._cow_base = self.session.cow_copies if self.paged else 0
        self.stats = EngineStats(
            max_batch=self.max_batch,
            dispatches_per_step=self.session.decode_dispatch_count,
            verify_ms=getattr(self.session.model, "verify_ms", 0.0))
        self._note_queue()
        return self.stats

    # -- scheduler loop ----------------------------------------------------

    def step(self) -> bool:
        """One scheduler step: apply the policy's preemptions, admit
        queued requests into free slots, advance every
        mid-chunking slot by one prefill chunk in a single batched
        dispatch (paged), then advance every decoding resident by one
        token in a single batched decode dispatch.  Returns False when
        the engine is idle."""
        t_step = time.perf_counter()
        self._phases = phases = spans.Phases()
        try:
            return self._step()
        finally:
            with self._lock:  # stats mutate under the lock: see snapshot()
                self.stats.step_times_s.append(time.perf_counter() - t_step)
                self.stats.add_phases(phases)

    def _finish_in_step(self, handle: RequestHandle, reason: str) -> None:
        """:meth:`_finish` from the step loop, timed as ``engine/finish``."""
        with self._phases.span("engine/finish", (handle.rid,)):
            self._finish(handle, reason)

    def _dispatch(self, kind: str, rids: list, call) -> np.ndarray:
        """One ``kind`` dispatch (``"prefill"`` / ``"decode"``): ``call()``
        enqueues it, then ONE device->host fetch of every lane's last-token
        logits row waits for the device (per-lane ``logits[b, -1]`` pulls
        would sync once per lane), so the dispatch's host clock ends with
        the fetch; it is kept as the enqueue and the fetch.  A dispatch the
        session refuses with :class:`KVCapacityError` (before any launch)
        still counts its enqueue: dropping it would make capacity-churny
        traces look faster than the wall clock."""
        try:
            with self._phases.span(f"engine/{kind}_dispatch", rids, phase=False) as enq:
                logits = call()
        except KVCapacityError:
            self._add_dispatch(kind, enq.seconds, 0.0, 0)
            raise
        with self._phases.span(f"engine/{kind}_fetch", phase=False) as fetch:
            rows = _host_rows(logits)
        self._add_dispatch(kind, enq.seconds, fetch.seconds, 1)
        return rows

    def _add_dispatch(self, kind: str, enqueue_s: float, fetch_s: float, n: int) -> None:
        with self._lock:
            for field, v in (("time_s", enqueue_s + fetch_s), ("enqueue_s", enqueue_s),
                             ("fetch_s", fetch_s), ("dispatches", n)):
                name = f"{kind}_{field}"
                setattr(self.stats, name, getattr(self.stats, name) + v)

    def _step(self) -> bool:
        with self._phases.span("engine/preempt"):
            worked = self._preempt()
        with self._phases.span("engine/admit"):
            admitted = self._admit()
        worked = bool(admitted) or worked
        worked = self._advance_chunks() or worked

        def decode_lanes():
            return [b for b, h in enumerate(self._slots)
                    if h is not None and b not in self._chunks]

        active = decode_lanes()
        if not active:
            self._note_queue()
            return worked

        # capacity evictions re-dispatch within the same step: the error
        # names exactly the slots past max_len (or, paged, the slots the
        # exhausted pool cannot grow), so only those requests finish
        # (reason "kv_capacity") and the survivors still advance.
        while active:
            # built on the host; the session copies it to the device once
            tokens = torch.from_numpy(np.asarray(self._next_input, np.int32))
            # pos stays host-side: the session's capacity checks and +1
            # advance are numpy, so uploading a device tensor here would
            # just be pulled straight back (one wasted round-trip/token)
            pos = np.asarray(self._pos, np.int32)
            mask = None
            if self.paged:
                mask = np.zeros((self.max_batch,), bool)
                mask[active] = True
            try:
                step_rows = self._dispatch(
                    "decode", [self._slots[b].rid for b in active],
                    lambda: self.session.decode(tokens, pos, active=mask))
            except KVCapacityError as e:
                if self._reclaim_parked(e, len(e.slots)):
                    continue  # parked prefix blocks funded a retry
                for b in e.slots:
                    if self._slots[b] is not None:
                        self._finish_in_step(self._slots[b], "kv_capacity")
                active = decode_lanes()
                continue
            with self._lock:
                self.stats.slot_steps_busy += len(active)
            for b in active:
                if self._slots[b] is None:
                    continue  # evicted mid-loop by a streaming callback
                self._pos[b] += 1
                self._consume_logits(b, step_rows[b])
            break
        self._note_queue()
        return True

    def run_until_idle(self, max_steps: int | None = None) -> EngineStats:
        """Drive :meth:`step` until every submitted request is finished."""
        steps = 0
        while not self.idle:
            if not self.step():
                raise RuntimeError("scheduler made no progress with work pending")
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"engine not idle after {max_steps} steps "
                    f"(queue={self.queue_depth}, busy={self.slots_busy})")
        return self.stats

    # -- internals ---------------------------------------------------------

    def _note_queue(self) -> None:
        with self._lock:
            self.stats.queue_depth = len(self.scheduler)
            self.stats.peak_queue_depth = max(self.stats.peak_queue_depth,
                                              self.stats.queue_depth)
            self.stats.slots_busy = self.slots_busy
            if self.paged:
                self.stats.blocks_shared = max(
                    self.stats.blocks_shared,
                    self.session.allocator.n_shared)
                self.stats.cow_copies = (self.session.cow_copies
                                         - self._cow_base)

    def _preempt(self) -> bool:
        """Ask the policy which residents lose their slot this step and
        evict them back to the queue (loop thread only).  FIFO never
        names victims, so this is a no-op on the default path."""
        with self._lock:
            now = self.clock()
            residents = [h for h in self._slots if h is not None]
            victims = self.scheduler.victims(residents, now)
        for handle in victims:
            self._requeue(handle)
        return bool(victims)

    def _requeue(self, handle: RequestHandle) -> None:
        """Evict a resident back to the admission queue (preemption).

        The slot and its KV blocks free immediately; the handle records
        how many tokens were already generated (``resumed``) so
        re-admission teacher-forces them as part of the prefix and
        sampling resumes at the same fold-in index — the final stream is
        bit-exact vs an uninterrupted run."""
        b, handle.slot = handle.slot, None
        self._slots[b] = None
        self._chunks.pop(b, None)
        self._pledged.pop(b, None)
        self._pos[b] = 0
        self._next_input[b] = 0
        if self.paged:
            self.session.free_slot(b)
        handle.status = RequestStatus.QUEUED
        handle.resumed = len(handle.tokens)
        handle.preemptions += 1
        with self._lock:
            self.stats.preemptions += 1
            self.stats.requeues += 1
            self.scheduler.requeue(handle, self.clock())
            self._note_queue()

    def _admit(self) -> set[int]:
        """Policy-ordered admission: prefill queued requests into free
        slots.  Returns the slot indices admitted this call.

        Paged engines are pool-occupancy-aware: the policy's next pick
        is admitted only when the pool currently has blocks for its
        *whole* prefix, so admissions do not immediately die of pool
        exhaustion mid-chunk (resident decodes can still exhaust the
        pool later — that path finishes the growing request with
        ``kv_capacity``).  Ordering is preserved: a too-big head blocks
        the queue until completions free blocks, rather than being
        overtaken.
        """
        admitted: set[int] = set()
        while True:
            free = next((b for b, h in enumerate(self._slots) if h is None), None)
            if free is None:
                break
            with self._lock:
                now = self.clock()
                cand = self.scheduler.peek(now)
                if cand is None:
                    break
                match, starts, need = None, None, 0
                if self.paged:
                    prefix = cand.prefix()
                    if blocks_for_rows(len(prefix),
                                       self.session.kv_block_size) \
                            > self.session.kv_blocks:
                        # a requeued prefix grew past what the whole pool
                        # can ever hold — finish it (kv_capacity) instead
                        # of blocking the queue forever
                        self.scheduler.remove(cand)
                        self._finish_in_step(cand, "kv_capacity")
                        continue
                    match, starts, need = self._plan_admission(prefix)
                    if (self.prefix_index is not None
                            and not (match is not None and match.full)
                            and self._inflight_covers(
                                prefix, match.rows if match else 0)):
                        # an identical/longer prompt is mid-prefill in a
                        # resident slot: admitting now would duplicate its
                        # work block for block, while waiting one step
                        # turns this admission into a (possibly full)
                        # prefix hit.  Ordering is preserved — the head
                        # waits, nobody overtakes.
                        break
                    unclaimed = sum(
                        max(0, pledge - self.session.blocks_held(b))
                        for b, pledge in self._pledged.items()
                    )
                    short = need - (self.session.blocks_free - unclaimed)
                    if short > 0:
                        # drain the LRU parking lot before refusing: blocks
                        # only the index references are capacity in waiting
                        freed = 0
                        if self.prefix_index is not None:
                            with self._phases.span("engine/prefix_reclaim"):
                                freed = self.prefix_index.reclaim(
                                    short,
                                    protect=match.blocks if match else ())
                            self.stats.prefix_reclaimed_blocks += freed
                        if freed < short:
                            break
                handle = self.scheduler.pop(now)
                if handle.admit_t is None:
                    handle.admit_t = now
                    self.stats.queue_wait_s.append(now - handle.arrival_t)
            handle.slot = free
            handle.status = RequestStatus.PREFILLING
            self._slots[free] = handle
            if free in self._used_slots:
                with self._lock:
                    self.stats.slots_recycled += 1
            self._used_slots.add(free)
            prefix = handle.prefix()
            if self.paged:
                if self.prefix_index is not None:
                    with self._lock:
                        self.stats.prefix_lookups += 1
                if match is not None and match.hit:
                    self.session.attach_prefix(free, match.blocks, match.rows)
                    with self._lock:
                        self.stats.prefix_hits += 1
                        self.stats.prefix_hit_blocks += len(match.blocks)
                if match is not None and match.full:
                    # zero-prefill admission: the whole prompt is resident
                    # and the cached last-token logits row feeds sampling
                    # directly — the slot enters the decode lanes this step
                    with self._lock:
                        self.stats.full_prefix_hits += 1
                    self._pos[free] = match.rows
                    self._consume_logits(free, match.logits)
                else:
                    # parked out of the decode lanes; the first (suffix)
                    # chunk rides this step's batched _advance_chunks
                    # dispatch.  The pledge covers the novel suffix only.
                    self._chunks[free] = starts
                    self._pledged[free] = need
                    self._pos[free] = 0
            else:
                head = torch.tensor(prefix[: self.seq_len], dtype=torch.int32)[None]
                row = self._dispatch("prefill", [handle.rid],
                                     lambda: self.session.prefill_slot(free, head))[0]
                with self._lock:
                    self.stats.prompt_tokens_prefilled += self.seq_len
                self._pos[free] = self.seq_len
                self._consume_logits(free, row)
            admitted.add(free)
        return admitted

    def _plan_admission(self, prefix: tuple[int, ...]):
        """Paged admission plan for one candidate: ``(match, chunk
        starts, blocks to pledge)``.

        Without a prefix index this is the historical plan — full chunk
        schedule, whole-prefix pledge.  With one, the pledge covers the
        *novel suffix only*: total blocks minus the matched chain, plus
        one block per shared block the first suffix chunk re-writes (a
        near-full match pins its final chunk to ``T - seq_len``, which
        overlaps the shared region — those blocks copy-on-write at
        dispatch, and the copies are real pool demand).  A full match
        pledges nothing.
        """
        bsz = self.session.kv_block_size
        T, S = len(prefix), self.seq_len
        total = blocks_for_rows(T, bsz)
        if self.prefix_index is None:
            return None, chunk_starts(T, S), total
        with self._phases.span("engine/prefix_match"):
            match = self.prefix_index.match(prefix)
        if match.full:
            return match, [], 0
        start0 = min(match.rows, T - S)
        if start0 < 1:
            # nothing matched, or the suffix schedule would restart at
            # offset 0 anyway (prompt barely longer than one chunk):
            # plain admission, no attach
            return None, chunk_starts(T, S), total
        starts = list(range(start0, T - S + 1, S))
        if starts[-1] != T - S:
            starts.append(T - S)
        overlap_cows = match.rows // bsz - start0 // bsz
        return match, starts, (total - len(match.blocks)) + overlap_cows

    def _inflight_covers(self, prefix: tuple[int, ...], matched: int) -> bool:
        """Is a resident mid-chunking prompt about to index a strictly
        longer prefix of ``prefix`` than the ``matched`` rows the trie
        already holds?  (Loop thread only; drives admission deferral.)"""
        bsz = self.session.kv_block_size
        for b in self._chunks:
            h = self._slots[b]
            if h is None:
                continue
            other = h.prefix()
            lcp = 0
            for a, c in zip(prefix, other):
                if a != c:
                    break
                lcp += 1
            covered = (len(prefix) if lcp == len(prefix) == len(other)
                       else (lcp // bsz) * bsz)
            if covered > matched:
                return True
        return False

    def _reclaim_parked(self, e: KVCapacityError, want: int) -> int:
        """On pool exhaustion mid-flight, try to fund a retry from the
        index's LRU parking lot before evicting anyone.  Returns blocks
        freed (0 when the cache is off, the error is not pool-shaped, or
        nothing is reclaimable — caller falls through to eviction)."""
        if self.prefix_index is None or e.reason != "pool":
            return 0
        with self._phases.span("engine/prefix_reclaim"):
            freed = self.prefix_index.reclaim(max(1, want))
        with self._lock:
            self.stats.prefix_reclaimed_blocks += freed
        return freed

    def audit_sharing(self, *, strict: bool = True, source: str = "audit"):
        """Run the KV-sharing audit (rules KV006/KV007 state half) over
        the live pool: every table/index block reference must be backed
        by a matching refcount.  Raises
        :class:`~repro_torch.deploy.verify.PlanVerificationError` on any
        inconsistency; returns the (empty) diagnostics list otherwise.
        Paged engines only.

        ``source`` tags every emitted diagnostic
        (``PlanDiagnostic.source``) so point-in-time audit findings stay
        distinguishable from the shadow sanitizer's continuous findings
        (``source="sanitizer"``) in logs and ``/v1/stats``."""
        if not self.paged:
            raise RuntimeError("audit_sharing needs a paged engine")
        from repro_torch.deploy.verify import PlanVerificationError, check_sharing

        idx = (self.prefix_index.pinned_blocks()
               if self.prefix_index is not None else ())
        try:
            diags = check_sharing(self.session.sharing_state(idx),
                                  strict=strict,
                                  context=f"engine.audit_sharing[{source}]",
                                  source=source)
        except PlanVerificationError as e:
            with self._lock:
                self.stats.audit_findings += len(e.diagnostics)
            raise
        with self._lock:
            self.stats.audit_findings += len(diags)
        return diags

    def _advance_chunks(self) -> bool:
        """Paged chunked prefill: advance EVERY mid-chunking slot by one
        chunk in a single batched multi-slot dispatch per step
        (:meth:`InferenceSession.prefill_chunks`), interleaved with the
        residents' batched decodes.  The per-slot loop this replaces
        cost one full prefill dispatch per mid-chunking neighbor per
        step."""
        progressed = False
        while True:
            pending: dict[int, tuple] = {}
            prev_rows: dict[int, int] = {}
            with self._phases.span("engine/chunk_build"):
                for b in sorted(self._chunks):
                    if self._slots[b] is None:  # cancelled mid-chunking
                        self._chunks.pop(b, None)
                        continue
                    start = self._chunks[b][0]
                    # tokens this chunk NEWLY covers: the pinned tail chunk
                    # overlaps the previous one, and crediting seq_len per
                    # dispatch would inflate prompt throughput for
                    # non-multiple prompt lengths
                    prev_rows[b] = 0 if start == 0 else int(self.session.pos[b])
                    chunk = torch.tensor(
                        self._slots[b].prefix()[start : start + self.seq_len],
                        dtype=torch.int32)[None]
                    pending[b] = (chunk, start)
            if not pending:
                return progressed
            try:
                final_rows = self._dispatch(
                    "prefill", [self._slots[b].rid for b in pending],
                    lambda: self.session.prefill_chunks(pending))
            except KVCapacityError as e:
                # requester-pays, like decode capacity: the pool cannot
                # hold the named slots' prompts right now, so those
                # requests finish (nothing generated), their blocks go
                # back to the pool, and the survivors retry within the
                # same step — the host-side checks raise BEFORE the
                # dispatch, so no device state needs unwinding
                if self._reclaim_parked(e, len(e.slots)):
                    continue  # parked prefix blocks funded a retry
                for b in e.slots:
                    if self._slots[b] is not None:
                        self._finish_in_step(self._slots[b], "kv_capacity")
                progressed = True  # the finishes ARE scheduler progress
                continue
            # the one fetch serves each slot that finishes chunking this step
            with self._lock:
                self.stats.prefill_lanes += len(pending)
            for b in pending:
                if self._slots[b] is None:
                    continue  # evicted mid-loop by a streaming callback
                start = self._chunks[b].pop(0)
                with self._lock:
                    self.stats.prompt_tokens_prefilled += (
                        start + self.seq_len - prev_rows[b])
                if self._chunks[b]:
                    continue
                del self._chunks[b]
                self._pledged.pop(b, None)
                self._pos[b] = len(self._slots[b].prefix())
                if self.prefix_index is not None:
                    # index the finished prefix NOW, before the consume
                    # below can finish the request and free its chain:
                    # the trie pins its own references, so the blocks
                    # (and the cached logits row) outlive the slot
                    with self._phases.span("engine/prefix_insert", (self._slots[b].rid,)):
                        self.prefix_index.insert(
                            self._slots[b].prefix(),
                            self.session.block_chain(b), final_rows[b])
                self._consume_logits(b, final_rows[b])
            return True

    def _consume_logits(self, b: int, logits_row) -> None:
        """Turn slot ``b``'s fresh logits (predicting token index
        ``self._pos[b]``) into its next decode input: the next prefix
        token while prefilling, a sampled token once generating.

        The *prefix* is the prompt plus any tokens generated before a
        preemption (``handle.resumed``): those are teacher-forced, never
        re-sampled and never re-streamed, and sampling resumes at the
        same ``len(tokens)`` fold-in index — bit-exact vs an
        uninterrupted run."""
        handle = self._slots[b]
        with self._phases.span("engine/sample", (handle.rid,)):
            depth = self._pos[b]
            forced_len = len(handle.prompt) + handle.resumed
            if depth < forced_len:
                # teacher-force the prefix tail through the batched decode path
                if depth < len(handle.prompt):
                    self._next_input[b] = handle.prompt[depth]
                else:
                    self._next_input[b] = handle.tokens[depth - len(handle.prompt)]
                with self._lock:
                    self.stats.prompt_tokens_forced += 1
                return
            tok = int(self.sampling(logits_row, handle.rid, len(handle.tokens)))
            handle.status = RequestStatus.DECODING
            handle.tokens.append(tok)
            now = self.clock()
            with self._lock:
                self.stats.tokens_generated += 1
                if handle.first_token_t is None:
                    handle.first_token_t = now
                    self.stats.ttft_s.append(handle.ttft_s)
                    if handle.ttft_slo_ms is not None:
                        self.stats._slo_outcomes.append(
                            handle.ttft_s <= handle.ttft_slo_ms / 1e3)
                else:
                    self.stats.tpot_s.append(now - handle._last_token_t)
                handle._last_token_t = now
            if handle.on_token is not None:
                handle.on_token(tok)
                if handle.done:  # the callback cancelled this very request
                    return
            if handle.eos_id is not None and tok == handle.eos_id:
                self._finish_in_step(handle, "eos")
            elif len(handle.tokens) >= handle.max_new_tokens:
                self._finish_in_step(handle, "length")
            else:
                self._next_input[b] = tok

    def _finish(self, handle: RequestHandle, reason: str,
                status: RequestStatus = RequestStatus.DONE) -> None:
        if handle.done:  # reentrancy guard: callbacks may cancel mid-consume
            return
        handle.finish_reason = reason
        handle.status = status
        handle.finish_t = self.clock()
        if handle.slot is not None:
            b, handle.slot = handle.slot, None
            self._slots[b] = None
            self._chunks.pop(b, None)
            self._pledged.pop(b, None)
            self._pos[b] = 0  # park the freed lane where it can never overflow
            self._next_input[b] = 0
            if self.paged:
                # pool-occupancy-aware eviction: the blocks return to the
                # pool NOW, so survivors/queued requests can grow into them
                self.session.free_slot(b)
        with self._lock:
            if status is RequestStatus.DONE:
                self.stats.requests_completed += 1
            else:
                self.stats.requests_evicted += 1
        self._note_queue()
