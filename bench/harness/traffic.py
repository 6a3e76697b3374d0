"""The one traffic generator: every mix is a data file of parameters in
``bench/traffic/`` that this module reads.

``loop`` selects how load is offered:

* ``closed``: ``outstanding`` requests kept in the engine (a finished one is
  replaced at once), from a list of ``requests_drawn``;
* ``open``: requests due on a Poisson schedule at ``rate_per_s``, sent
  whether or not earlier ones have finished: the ``ceil(rate * seconds)``
  requests of the window.

Requests draw ``prompt_len`` and ``max_new_tokens`` uniformly from their
[lo, hi] ranges, and an open loop's gaps between arrivals are
exponential.  Each of these is the distribution's quantiles at ``(i +
0.5) / n`` for the ``n`` requests of the list, in an order drawn from the
seed: every seed offers the same sizes and the same gaps, long ones and
bursts included, in another order, so that the window's work and its
offered load do not change with the seed.  Token ids are uniform over the
vocabulary.
"""

from __future__ import annotations

import math

import numpy as np


def seed64(seed: int) -> int:
    """A ``--seed`` as the unsigned 64-bit value generators take."""
    return int(seed) & ((1 << 64) - 1)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed64(seed), stream])


def shuffled_quantiles(r: np.random.Generator, n: int, quantile) -> np.ndarray:
    """``quantile(u)`` at ``u = (i + 0.5) / n`` for ``i < n``, in an order of ``r``'s."""
    base = np.asarray([quantile((i + 0.5) / n) for i in range(n)])
    return base[r.permutation(n)]


def uniform_int(lo: int, hi: int):
    """Quantile function of the uniform integers in [lo, hi]."""
    return lambda u: lo + min(int(u * (hi - lo + 1)), hi - lo)


def requests(traffic: dict, vocab: int, seed: int, n: int) -> list[dict]:
    """``n`` requests of a closed or open mix: ``prompt`` (int32 token ids),
    ``max_new_tokens`` and, in an open loop, ``due_s`` (seconds after the
    window opens)."""
    lens = shuffled_quantiles(rng(seed, 1), n, uniform_int(*traffic["prompt_len"]))
    outs = shuffled_quantiles(rng(seed, 2), n, uniform_int(*traffic["max_new_tokens"]))
    toks = rng(seed, 3)
    out = [{"prompt": toks.integers(0, vocab, size=int(l), dtype=np.int32),
            "max_new_tokens": int(m)} for l, m in zip(lens, outs)]
    if traffic["loop"] == "open":
        rate = float(traffic["rate_per_s"])
        gaps = shuffled_quantiles(rng(seed, 4), n, lambda u: -math.log(1.0 - u) / rate)
        for req, due in zip(out, np.cumsum(gaps)):
            req["due_s"] = float(due)
    return out


def requests_due(traffic: dict, vocab: int, seed: int, seconds: float) -> list[dict]:
    """An open loop's requests of a window of ``seconds``: ``ceil(rate *
    seconds)`` of them, every one due inside it (the quantiles' gaps add
    up to about ``(n - 0.3) / rate``)."""
    n = max(1, math.ceil(float(traffic["rate_per_s"]) * seconds))
    return [q for q in requests(traffic, vocab, seed, n) if q["due_s"] < seconds]


def nearest_rank(xs, pct: float) -> float:
    """Nearest-rank percentile (0.0 of an empty sample)."""
    if len(xs) == 0:
        return 0.0
    ordered = sorted(xs)
    rank = max(1, math.ceil(pct / 100.0 * len(ordered)))
    return float(ordered[rank - 1])
