"""Shared CLI plumbing of the port's serving entry points.

``add_engine_args`` / ``add_serving_args`` install the argument blocks of
the request-level engine (``repro_torch.deploy.engine.Engine``) and of its
admission policy, so ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.deploy.serving`` present one surface, the JAX
package's; ``add_plan_args`` installs the port's compile and bind block
that both share, and ``add_sanitize_args`` / ``apply_sanitize_args`` the
``--sanitize`` switch.  ``synthesize_prompts`` draws the engine's traffic
from a seeded ``numpy.random.Generator``; ``http_generate`` /
``http_get_json`` are stdlib clients of the serving frontend.
"""

from __future__ import annotations

import argparse
import json
import urllib.request

import numpy as np


def add_plan_args(ap: argparse.ArgumentParser) -> None:
    """Install the shared compile-and-bind block: ``--backend``, the paged
    KV region (``--kv-block-size`` / ``--kv-blocks``), the plan cache,
    the seed of the random weights and ``--device`` (the card unless
    ``cpu``).  The JAX package's block has ``--via-plan`` and no device:
    every port entry point serves from the plan."""
    ap.add_argument("--backend", default="ita", choices=("ita", "w8a8"))
    ap.add_argument("--kv-block-size", type=int, default=None,
                    help="decoder: a paged KV region of blocks of this many rows")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="decoder: the paged pool's blocks (default: every slot's whole "
                         "region)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--plan-cache", default=None, help="plan cache directory")
    ap.add_argument("--no-plan-cache", action="store_true")


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    """Install the shared serving-engine argument block.

    ``--batch`` is the engine's ``max_batch`` (KV-region slots);
    ``--requests`` how many to submit (default: a multiple of the batch
    via :func:`resolve_requests`, so the scheduler genuinely evicts and
    recycles slots); ``--sampling`` / ``--temperature`` /
    ``--sample-seed`` pick the token policy.
    """
    ap.add_argument("--batch", type=int, default=4,
                    help="engine max_batch: concurrent request slots (encoders: the batch)")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to submit (default: twice --batch, so slot eviction "
                         "and recycling genuinely happen)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=8,
                    help="max_new_tokens per request (encoders: batches to answer)")
    ap.add_argument("--sampling", choices=("greedy", "temperature"), default="greedy")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="seed of --sampling temperature")


def add_serving_args(ap: argparse.ArgumentParser) -> None:
    """Install the shared scheduler-policy argument block: ``--scheduler``
    names a policy of :data:`repro_torch.deploy.serving.scheduler.POLICIES`,
    ``--max-queue`` bounds admission (shed with 429 / ``QueueFullError``
    past it), ``--aging-s`` tunes priority aging (priority-deadline only).
    """
    from repro_torch.deploy.serving.scheduler import POLICIES

    ap.add_argument("--scheduler", choices=tuple(POLICIES), default="fifo",
                    help="admission policy (fifo = submission order; priority-deadline = "
                         "SLO-aware ordering, preemption and load shedding)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue; submissions past it are shed with "
                         "retry-after backpressure (default: unbounded)")
    ap.add_argument("--aging-s", type=float, default=None,
                    help="priority-deadline aging interval: a queued request gains one "
                         "priority level per this many seconds waited")


def add_sanitize_args(ap: argparse.ArgumentParser) -> None:
    """Install the shared concurrency-sanitizer flag.

    ``--sanitize`` turns on the lockdep runtime checker and the shadow
    block-lifecycle tracker (:mod:`repro_torch.deploy.sanitize`) for this
    process — equivalent to running with ``REPRO_SANITIZE=1``.
    """
    ap.add_argument(
        "--sanitize", action="store_true",
        help="enable the concurrency & KV-lifetime sanitizer (lockdep "
             "lock-order checking + shadow block tracking; same as "
             "REPRO_SANITIZE=1)")


def apply_sanitize_args(args) -> None:
    """Flip the sanitizer env switch from the parsed ``--sanitize`` flag.

    Must run *before* any engine/allocator is constructed — the lock
    wrappers and the shadow pool are chosen at construction time."""
    if getattr(args, "sanitize", False):
        import os

        os.environ["REPRO_SANITIZE"] = "1"


def make_scheduler_from_args(args):
    """Build the engine scheduler policy from the shared argument block."""
    from repro_torch.deploy.serving.scheduler import make_scheduler

    return make_scheduler(args.scheduler, max_queue=args.max_queue, aging_s=args.aging_s)


def make_sampling(args):
    """Build the engine sampling policy from the shared argument block."""
    from repro_torch.deploy.engine import Greedy, Temperature

    if args.sampling == "temperature":
        return Temperature(args.temperature, args.sample_seed)
    return Greedy()


def resolve_requests(args, *, factor: int = 2) -> int:
    """The ``--requests`` default: ``factor * batch`` keeps admissions
    outrunning the slot count so eviction and recycling genuinely happen."""
    return args.requests if args.requests is not None else factor * args.batch


def synthesize_prompts(vocab: int, *, n: int, prompt_len: int, extra: int = 0,
                       seed: int = 0) -> list[list[int]]:
    """``n`` random prompts from a ``numpy.random.Generator`` seeded with
    ``seed``, their lengths staggered across ``[prompt_len, prompt_len +
    extra]`` (prompt ``i`` has ``prompt_len + i % (extra + 1)`` tokens), so
    resident requests sit at genuinely mixed depths.  The JAX package
    draws its prompts from ``jax.random`` keys: the shape of the traffic
    is the same, the tokens are not."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, prompt_len + i % (extra + 1))]
            for i in range(n)]


def http_generate(host: str, port: int, prompt, max_new_tokens: int, *,
                  stream: bool = True, timeout: float = 60.0, **slo):
    """Stdlib client for the serving frontend's ``POST /v1/generate``.

    Streaming (default) returns an iterator of decoded JSON-lines events
    — ``{"token": t, "index": i}`` per sampled token, then the final
    ``{"done": true, ...}`` summary.  Unary returns the summary dict.
    Extra keyword args (``priority``, ``ttft_slo_ms``, ``deadline_ms``,
    ``eos_id``) pass straight through to the request body.  HTTP errors
    surface as ``urllib.error.HTTPError`` — a shed request is ``429``
    with a ``Retry-After`` header and a structured JSON body.
    """
    body = {"prompt": list(prompt), "max_new_tokens": int(max_new_tokens),
            "stream": stream, **{k: v for k, v in slo.items() if v is not None}}
    req = urllib.request.Request(
        f"http://{host}:{port}/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=timeout)
    if not stream:
        with resp:
            return json.loads(resp.read().decode())

    def events():
        with resp:
            for line in resp:
                if line.strip():
                    yield json.loads(line.decode())

    return events()


def http_get_json(host: str, port: int, path: str, *, timeout: float = 10.0) -> dict:
    """Fetch one JSON endpoint (``/v1/stats``, ``/v1/status/<rid>``,
    ``/healthz``) from the serving frontend."""
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=timeout) as resp:
        return json.loads(resp.read().decode())
