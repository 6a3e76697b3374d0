"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference in ``bench/reference`` on the same inputs and
weights, run once the window has closed and the program's state is freed.

A sample, drawn from the seed, of the requests finished in the window,
with the longest among them.  For each, the reference's full forward over
the prompt and its served tokens, and at the row of each served token:

* ``max_abs_logit_diff``: the largest absolute difference between the
  logits row the engine sampled the token from and the reference's row;
* ``max_served_logit_gap``: the widest gap by which the served token's
  logit lies below the reference's best.

The program is integer-exact, and so is the reference: both limits are 0.
A control (``prec=Prec(4)``) computes the reference at int4 and reads
both numbers with it in the program's place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench.harness import traffic as T
from bench.reference import intops as I


def compare(config: dict, qp: dict, prompt, served: list, rows,
            control: I.Prec | None = None) -> tuple[float, float]:
    """(max |logits - reference|, max served-token gap) over one request's
    served tokens.  ``rows`` are the program's logits rows [n, vocab];
    ``control`` puts the reference at that precision in the program's
    place: its rows, and its first-ranked tokens."""
    from bench.reference import olmo

    vocab = config["arch"]["vocab"]
    p = len(prompt)
    seq = list(np.asarray(prompt)) + list(served[:-1])
    at = range(p - 1, p - 1 + len(served))
    ref = olmo.logits_at(config["arch"], config["scales"], qp, seq, p, at)[:, :vocab]
    if control is not None:
        got = olmo.logits_at(config["arch"], config["scales"], qp, seq, p, at,
                             prec=control)[:, :vocab]
        pick = got.argmax(dim=1)
    else:
        tok = torch.as_tensor(served, dtype=torch.long, device=ref.device)
        if rows is None or bool(((tok < 0) | (tok >= vocab)).any()):
            return math.inf, math.inf
        got = torch.as_tensor(rows, device=ref.device)
        pick = tok
    diff = (got - ref).abs().max().item()
    gap = (ref.max(dim=1).values - ref[torch.arange(len(served), device=ref.device), pick])
    return (math.inf if math.isnan(diff) else diff), gap.max().item()


def pick_requests(finished: list, seed: int, k: int) -> list:
    """The longest finished request and ``k - 1`` others drawn from the seed."""
    if not finished:
        return []
    order = sorted(range(len(finished)),
                   key=lambda i: len(finished[i][0]) + len(finished[i][1]))
    longest, rest = order[-1], order[:-1]
    n = min(k - 1, len(rest))
    others = T.rng(seed, 7).choice(len(rest), size=n, replace=False) if n else []
    return [finished[longest]] + [finished[rest[i]] for i in others]


def _worst(config: dict, mix: dict, run, seed: int, control: I.Prec | None):
    picked = pick_requests(run.answers["finished"], seed, mix["check_requests"])
    read = [compare(config, run.answers["qp"], p, s, r, control) for p, s, r in picked]
    worst = [max((x[i] for x in read), default=math.inf) for i in (0, 1)]
    return picked, worst


def check(config: dict, mix: dict, run, seed: int) -> list:
    """[(name, value, limit)]: the numbers compared, each with its limit."""
    limits = config["limits"]
    picked, (diff, gap) = _worst(config, mix, run, seed, None)
    return [("max_abs_logit_diff", diff, limits["max_abs_logit_diff"]),
            ("max_served_logit_gap", gap, limits["max_served_logit_gap"]),
            ("requests_compared", len(picked), limits["min_answers"]),
            ("tokens_compared", int(sum(len(s) for _, s, _ in picked)), limits["min_answers"])]


def passes(name: str, value: float, limit: float) -> bool:
    """A count of answers has to reach its limit; any other number has to
    stay at or under it (a NaN fails)."""
    if name.endswith("_compared"):
        return value >= limit
    return value <= limit


def control(config: dict, mix: dict, run, seed: int) -> dict:
    """The numbers ``check`` compares, for the int4 reference put in the
    program's place on the window's answers (the control's readings)."""
    _, (diff, gap) = _worst(config, mix, run, seed, I.Prec(4))
    return {"max_abs_logit_diff": diff, "max_served_logit_gap": gap}
