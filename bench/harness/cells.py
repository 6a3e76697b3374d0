"""The driver of one run of a cell: set-up, warm-up, the measured window,
the traced sub-window, and what the checks and the metric readers need.

A dense decoder served by the program's ``Engine`` (``submit`` / ``step``)
over ``compile(cfg, ...paged...)``, under a closed or an open mix.

The window opens when set-up ends and closes ``seconds`` later on the host
clock.  No shape is first run inside it: set-up runs each shape the
window uses.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from bench.harness import counts, traffic as T
from bench.harness.trace import profiled, reduce_events
from bench.harness.weights import make_qp

#: engine steps in the traced sub-window
TRACED_UNITS = 4


@dataclasses.dataclass
class Run:
    """One run's record: what the metric readers and the checks read."""

    t0: float                    # host clock when the window opened
    window_s: float
    e2e: dict                    # end-to-end metrics by name
    model_ops: float             # the model's products done in the window
    attempted: int
    failed: int
    stats: object = None         # EngineStats over the window
    trace: object = None         # trace.Reduction of the traced sub-window
    answers: dict = dataclasses.field(default_factory=dict)  # what the check compares
    extra: dict = dataclasses.field(default_factory=dict)    # reported, never judged
    memory_peak_bytes: int = 0
    setup_s: float = 0.0


def arch_config(arch: dict):
    """The program's ``ArchConfig`` of a configuration file's ``arch``."""
    from repro_torch.configs.base import ArchConfig

    names = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in arch.items() if k in names})


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


class _Dispatches:
    """Wraps the session's two dispatches (the way ``DispatchCounter`` does):
    a span around each, their count, and the products the model needed for
    the rows each one computed (a prefill chunk's rows not computed before,
    its head row; a decode step's active lanes)."""

    def __init__(self, session, arch: dict):
        self.reset()
        chunk, decode = session.prefill_chunks, session.decode
        seq = session.seq_len
        head = counts.decoder_head_ops(arch)

        def prefill_chunks(chunks):
            ops = 0
            for slot, (_, start) in chunks.items():
                prev = 0 if start == 0 else int(session.pos[slot])
                ops += counts.decoder_rows_ops(arch, max(prev, start), start + seq) + head
            with record_function("session.prefill_chunks"):
                out = chunk(chunks)
            self.chunks += 1
            self.ops += ops
            return out

        def decode_step(tokens, pos=None, *, active=None):
            p = np.asarray(session.pos if pos is None else pos)
            act = np.ones(p.shape, bool) if active is None else np.asarray(active, bool)
            with record_function("session.decode"):
                out = decode(tokens, pos, active=active)
            self.decodes += 1
            self.ops += sum(counts.decoder_rows_ops(arch, int(r), int(r) + 1) + head for r in p[act])
            return out

        session.prefill_chunks = prefill_chunks
        session.decode = decode_step

    def reset(self) -> None:
        self.chunks = self.decodes = 0
        self.ops = 0


class _Served:
    """The engine's sampling policy: the program's ``Greedy``, and beside it
    the logits row each token was sampled from, by (request id, token
    index).  The row is the engine's own host array, kept, not copied."""

    def __init__(self, vocab: int):
        from repro_torch.deploy.engine import Greedy

        self.greedy = Greedy(vocab)
        self.vocab = vocab
        self.rows: dict = {}

    def __call__(self, logits_row, rid: int, index: int) -> int:
        self.rows[(rid, index)] = logits_row
        return self.greedy(logits_row, rid, index)

    def of(self, rid: int, n: int):
        """float32 [n, vocab]: the rows of a request's first ``n`` tokens (None
        where one is missing)."""
        got = [self.rows.get((rid, i)) for i in range(n)]
        if any(r is None for r in got):
            return None
        return np.stack([np.asarray(r[: self.vocab], np.float32) for r in got])


FAILED = ("kv_capacity", "error", "shed", "cancelled")


class EngineCell:
    """The ``Engine`` over a closed loop (``outstanding`` requests kept in it)
    or an open one (requests submitted when due, TTFT timed from the due
    time).  Set-up builds the engine and runs the window's shapes: a chunk
    dispatch at every prompt depth the mix reaches, and a decode step where
    the mix decodes.  A closed loop is then run until ``warm_finished`` of
    its requests have finished, so that the window opens on the loop's
    steady state rather than on the burst of its first admissions."""

    def __init__(self, config: dict, mix: dict, seed: int, dev: torch.device):
        marks = [("start", time.perf_counter())]
        from repro_torch.deploy.api import compile as compile_model
        from repro_torch.deploy.engine import Engine

        marks.append(("program_import", time.perf_counter()))
        self.config, self.mix, self.seed, self.dev = config, mix, seed, dev
        arch = config["arch"]
        cfg = arch_config(arch)
        self.vocab = cfg.vocab
        model = compile_model(cfg, **config["compile"])
        marks.append(("compile", time.perf_counter()))
        self.qp = make_qp(arch, config["weights"], seed, dev)
        _sync(dev)
        marks.append(("weights", time.perf_counter()))
        self.served = _Served(cfg.vocab)
        self.engine = Engine(model, config["slots"], qp=self.qp, device=dev,
                             sampling=self.served)
        self.disp = _Dispatches(self.engine.session, arch)
        marks.append(("engine", time.perf_counter()))
        warm = T.rng(seed, 9).integers(0, cfg.vocab, size=mix["prompt_len"][1], dtype=np.int32)
        self.engine.submit(warm, min(2, mix["max_new_tokens"][1]))
        self.engine.run_until_idle()
        _sync(dev)
        marks.append(("shapes", time.perf_counter()))
        self.setup_phases = {n: b - a for (_, a), (n, b) in zip(marks, marks[1:])}

    def window(self, seconds: float, trace: bool, mix: dict | None = None) -> Run:
        mix = mix or self.mix
        engine, disp, arch = self.engine, self.disp, self.config["arch"]
        loop = mix["loop"]
        if loop == "open":
            reqs = T.requests_due(mix, self.vocab, self.seed, seconds)
        else:
            reqs = T.requests(mix, self.vocab, self.seed, mix["requests_drawn"])
        handles: list = []       # (request index, handle)
        first: dict = {}         # request index -> host time of its first token
        late: list = []          # seconds the generator ran behind each due time
        live: list = []
        nxt = 0

        def submit(j: int):
            r = reqs[j]
            h = engine.submit(r["prompt"], r["max_new_tokens"],
                              on_token=lambda tok, j=j: first.setdefault(j, time.perf_counter()))
            handles.append((j, h))
            live.append(h)

        def offer(now: float) -> None:
            """Submit what the mix offers by ``now`` (seconds after t0)."""
            nonlocal nxt, live
            live = [h for h in live if not h.done]
            if loop == "closed":
                while len(live) < mix["outstanding"]:
                    if nxt >= len(reqs):
                        raise RuntimeError("the mix ran out of drawn requests")
                    submit(nxt)
                    nxt += 1
            else:
                while nxt < len(reqs) and reqs[nxt]["due_s"] <= now:
                    late.append(now - reqs[nxt]["due_s"])
                    submit(nxt)
                    nxt += 1

        def step() -> None:
            with record_function("engine.step"):
                engine.step()

        t_warm = time.perf_counter()
        if loop == "closed":  # set-up: the loop's first generation of requests
            while sum(1 for _, h in handles if h.done) < mix.get("warm_finished", 0):
                offer(0.0)
                step()
        warm_done = {j for j, h in handles if h.done}
        engine.reset_stats()
        disp.reset()
        t0 = time.perf_counter()
        t_end = t0 + seconds
        t_last = t0
        while True:
            now = time.perf_counter()
            if loop == "open" or now < t_end:  # what falls due by the close counts
                offer(now - t0)
            if now >= t_end:
                break
            if engine.idle:  # an open loop waits for the next arrival
                wake = min(reqs[nxt]["due_s"] if nxt < len(reqs) else seconds, seconds)
                time.sleep(max(0.0, wake - (time.perf_counter() - t0)))
                continue
            step()
            t_last = time.perf_counter()
        stats = engine.stats_snapshot()
        # a closed loop's window ends with the last step it began, so the
        # work and the time it is divided by end together
        window_s = seconds if loop == "open" else t_last - t0
        in_window = [(j, h) for j, h in handles if j not in warm_done
                     and (loop == "closed" or reqs[j]["due_s"] < seconds)]
        e2e, waits = {}, []
        if loop == "closed":
            e2e["tok_per_s"] = (stats.prompt_tokens_prefilled + stats.tokens_generated) / window_s
        else:  # a request with no token by the close counts with its wait so far
            waits = [min(first.get(j, t_end), t_end) - (t0 + reqs[j]["due_s"])
                     for j, _ in in_window]
            e2e["ttft_p95_ms"] = 1e3 * T.nearest_rank(waits, 95)
        run = Run(t0=t0, window_s=window_s, e2e=e2e, model_ops=disp.ops,
                  attempted=len(in_window),
                  failed=sum(1 for _, h in in_window if h.done and h.finish_reason in FAILED),
                  stats=stats)
        steps = stats.step_times_s
        run.extra["setup_phases_s"] = dict(self.setup_phases, warm_loop=t0 - t_warm)
        run.extra["step_ms"] = {"p50": 1e3 * T.nearest_rank(steps, 50),
                                "max": 1e3 * max(steps, default=0.0), "steps": len(steps)}
        if loop == "open":
            run.extra["generator_late_ms"] = {"p50": 1e3 * T.nearest_rank(late, 50),
                                              "max": 1e3 * max(late, default=0.0),
                                              "requests": len(late)}
            run.extra["ttft_p50_ms"] = 1e3 * T.nearest_rank(waits, 50)
            run.extra["first_tokens_in_window"] = sum(
                1 for j, _ in in_window if first.get(j, t_end) < t_end)
            run.extra["queued_at_close"] = engine.queue_depth
        if trace:  # k more steps of the same loop; each step ends in a fetch
            sink: list = []
            disp.reset()
            with profiled(sink):
                for _ in range(TRACED_UNITS):
                    offer(time.perf_counter() - t0)
                    if not engine.idle:
                        step()
            calls = {"int8_gemm": counts.decoder_chunk_calls(
                arch, self.config["slots"], self.config["compile"]["seq_len"]) * disp.chunks}
            run.trace = reduce_events(sink, calls)
        run.memory_peak_bytes = _peak(self.dev)
        finished = [(j, h) for j, h in in_window
                    if h.done and h.finish_reason in ("length", "eos")]
        run.answers = {"finished": [(reqs[j]["prompt"], list(h.tokens),
                                     self.served.of(h.rid, len(h.tokens)))
                                    for j, h in finished],
                       "qp": self.qp, "waits_s": waits}
        return run

    def drain(self) -> None:
        """Finish every request still in the engine (between sweep windows)."""
        self.engine.run_until_idle()

    def close(self) -> None:
        del self.engine, self.disp, self.served
