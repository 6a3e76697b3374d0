"""Repeat ``chip_smoke.py``'s ``[engine]`` HTTP check until a time budget
is spent: OLMo-1B's ``ita`` engine with the prefix cache serves the first 8
of the phase's 12 prompts as concurrent HTTP streams, and every run must
stream what the synchronous engine streamed.

    PYTHONPATH=src python ci/torch_engine_http_repeat.py [--budget 420] \
        [--device cpu] [--reduced] [--out DIR] [--replay-first]

Runs on the card at full width unless ``--device cpu`` / ``--reduced``.
Each HTTP run records its schedule: the engine step that admitted each
request and the lanes of every prefill and decode dispatch.  A run whose
streams differ is replayed synchronously, each request submitted just
before the step that admitted it: a replay that streams what the HTTP run
streamed points at the schedule, one that streams the synchronous engine's
tokens at a fault that does not repeat.  Such runs are written as JSON
under ``--out``.  ``--replay-first`` also replays the first run (the
replay must give the same dispatches and streams).  Exit 1 if any run
differed.
"""

import argparse
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path

import torch

from repro_torch import kernels
from repro_torch.configs import get_config, reduced
from repro_torch.deploy import api
from repro_torch.deploy.serving import AsyncEngine, ServingFrontend
from repro_torch.launch.cli import http_generate

ROOT = Path(__file__).resolve().parents[1]


def load_smoke():
    """``chip_smoke.py`` as a module: the phase's options, prompts and
    synchronous serving loop."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def instrument(engine, book: dict):
    """Log each admission's step and each dispatch's lanes into ``book``;
    returns the function that removes the hooks."""
    sess = engine.session
    step0, admit0 = engine.step, engine._admit
    chunks0, decode0 = sess.prefill_chunks, sess.decode
    state = {"step": 0}

    def step():
        try:
            return step0()
        finally:
            state["step"] += 1

    def admit():
        got = admit0()
        for b in sorted(got):
            h = engine._slots[b]
            if h is not None:
                book["admit"].append((state["step"], b, h.rid, list(h.prompt)))
        return got

    def prefill_chunks(pending):
        book["dispatch"].append(
            ("prefill", state["step"], sorted((int(b), int(s)) for b, (_, s) in pending.items())))
        return chunks0(pending)

    def decode(tokens, pos=None, *, active=None):
        lanes = [] if active is None else [int(b) for b in active.nonzero()[0]]
        book["dispatch"].append(
            ("decode", state["step"], lanes, None if pos is None else [int(p) for p in pos]))
        return decode0(tokens, pos, active=active)

    engine.step, engine._admit = step, admit
    sess.prefill_chunks, sess.decode = prefill_chunks, decode

    def undo():
        engine.step, engine._admit = step0, admit0
        sess.prefill_chunks, sess.decode = chunks0, decode0
    return undo


def http_run(engine, prompts: list, gen: int) -> tuple[list, list, dict, str]:
    """One run of the HTTP streams over ``engine`` (its prefix cache
    emptied first): (streams, client errors, schedule, stats summary)."""
    engine.prefix_index.drop_all()
    engine.reset_stats()
    book = {"admit": [], "dispatch": []}
    undo = instrument(engine, book)
    got, errors = [None] * len(prompts), []
    frontend = ServingFrontend(AsyncEngine(engine), port=0)
    host, port = frontend.start()

    def client(i):
        try:
            events = list(http_generate(host, port, prompts[i], gen, timeout=900))
            got[i] = ([ev["token"] for ev in events if "token" in ev],
                      events[-1]["finish_reason"])
        except Exception as exc:  # noqa: BLE001 - reported with the run
            errors.append((i, repr(exc)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    frontend.shutdown(drain=True, timeout=300)
    undo()
    engine.session.rebind_thread()  # the loop thread owned it
    return got, errors, book, engine.stats_snapshot().summary()


def replay(engine, admits: list, gen: int) -> tuple[dict, dict]:
    """Drive ``engine`` synchronously, submitting each request just before
    the step that admitted it in ``admits``; returns ({rid: stream},
    schedule)."""
    engine.prefix_index.drop_all()
    engine.reset_stats()
    book = {"admit": [], "dispatch": []}
    undo = instrument(engine, book)
    by_step: dict[int, list] = {}
    for step, _, rid, prompt in admits:
        by_step.setdefault(step, []).append((rid, prompt))
    handles, k = {}, 0
    while True:
        for rid, prompt in by_step.get(k, []):
            handles[rid] = engine.submit(prompt, gen)
        if engine.idle:  # the loop does not step an idle engine
            later = [s for s in by_step if s > k]
            if not later:
                break
            k = min(later)
            continue
        engine.step()
        k += 1
    undo()
    return {rid: (h.tokens, h.finish_reason) for rid, h in handles.items()}, book


def first_difference(got, want) -> str:
    if got is None:
        return "no stream"
    toks, reason = got
    at = next((j for j, (a, b) in enumerate(zip(toks, want[0])) if a != b), None)
    return (f"{reason} after {len(toks)} tokens (sync: {want[1]} after {len(want[0])}), "
            f"first differing token at {at}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true", help="OLMo-1B's reduced config")
    ap.add_argument("--budget", type=float, default=420.0, help="seconds of HTTP runs")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "http_repeat"))
    ap.add_argument("--replay-first", action="store_true")
    args = ap.parse_args(argv)

    smoke = load_smoke()
    dev = torch.device(args.device or "cuda")
    cfg = get_config("olmo-1b")
    if args.reduced:
        cfg = reduced(cfg)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build(*_build.KERNELS)
        card = smoke.card_line()
    else:
        card = "cpu"
    e = smoke.ENGINE
    model = api.compile(cfg, backend="ita", seq_len=e["seq_len"], max_len=e["max_len"],
                        kv_block_size=e["block"], kv_blocks=e["kv_blocks"], prefix_cache=True,
                        use_cache=False)
    _, qp = model.bind(seed=smoke.SEED)
    prompts = smoke.engine_prompts(cfg.vocab)
    launches = dict.fromkeys(kernels.wrappers(), 0)
    engine, want, _, _ = smoke.serve_engine(torch, card, dev, model, qp, prompts,
                                            "ita, prefix cache", launches)
    n = e["http"]
    index = {}  # prompt -> its first index among the HTTP requests
    for i in reversed(range(n)):
        index[tuple(prompts[i])] = i
    out = Path(args.out)
    runs = bad = 0
    t0 = time.perf_counter()
    while runs == 0 or time.perf_counter() - t0 < args.budget:
        got, errors, book, summary = http_run(engine, prompts[:n], e["gen"])
        diff = [i for i in range(n) if got[i] != want[i]]
        print(f"run {runs}: {len(diff)} of {n} streams differ {diff}, errors {errors}; "
              f"{summary}", flush=True)
        if diff or errors or (args.replay_first and runs == 0):
            for i in diff:
                print(f"  request {i}: {first_difference(got[i], want[i])}", flush=True)
            streams, rbook = replay(engine, book["admit"], e["gen"])
            by_rid = {rid: index[tuple(p)] for _, _, rid, p in book["admit"]}
            rdiff = sorted({by_rid[rid] for rid, s in streams.items() if s != want[by_rid[rid]]})
            same = rbook["dispatch"] == book["dispatch"]
            print(f"  replayed from its admissions: streams differing {rdiff}, the same "
                  f"dispatches {same}", flush=True)
            if diff or errors:
                bad += 1
                out.mkdir(parents=True, exist_ok=True)
                (out / f"run_{runs}.json").write_text(json.dumps(dict(
                    diff=diff, errors=errors, summary=summary, got=got, want=want[:n],
                    schedule=book, replay_diff=rdiff, replay_same_dispatches=same,
                    replay_schedule=rbook)))
            elif rdiff or not same:
                print("  the replay of an equal run differs", flush=True)
                bad += 1
        runs += 1
    print(f"http repeat on {card}: {runs} runs, {bad} differed", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
