"""Geometric operator tiling — Deeploy's per-accelerator constraint solver.

ITA's geometry (paper §IV-B): 64-granule tiles (vector length M=64, N=16
dot units), per-tile matrix dims <= 512, three input streamers + one
output streamer, data staged in the 128 KiB L1 TCDM with double buffering
(so 2x every tile buffer is resident).

The kernel backend (``Backend.ITA``) solves at a 128 granule against the
same budget, as the reference does, so both packages record the same
tilings in their plans.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

ITA_GRANULE = 64
ITA_MAX_TILE = 512
ITA_L1_BYTES = 128 * 1024  # 32 banks x 4 KiB


@dataclass(frozen=True)
class GemmTiling:
    """Tiling of C[M,N] = A[M,K] @ B[K,N] (int8, int32 accum)."""

    m: int
    n: int
    k: int
    tile_m: int
    tile_n: int
    tile_k: int

    @property
    def n_tiles(self) -> int:
        return (
            math.ceil(self.m / self.tile_m)
            * math.ceil(self.n / self.tile_n)
            * math.ceil(self.k / self.tile_k)
        )

    @property
    def tile_bytes(self) -> int:
        """L1-resident bytes per in-flight tile (A + B + bias + C)."""
        return (
            self.tile_m * self.tile_k  # A int8
            + self.tile_k * self.tile_n  # B int8
            + 4 * self.tile_n  # bias int32
            + self.tile_m * self.tile_n  # C int8
        )

    @property
    def l1_bytes(self) -> int:
        return 2 * self.tile_bytes  # double buffered

    @property
    def dma_bytes(self) -> int:
        """Total L2<->L1 traffic for the whole GEMM."""
        mt = math.ceil(self.m / self.tile_m)
        nt = math.ceil(self.n / self.tile_n)
        kt = math.ceil(self.k / self.tile_k)
        a = mt * kt * self.tile_m * self.tile_k * nt  # A refetched per N tile
        b = kt * nt * self.tile_k * self.tile_n * mt  # B refetched per M tile
        c = mt * nt * self.tile_m * self.tile_n
        bias = nt * 4 * self.tile_n * mt
        return a + b + c + bias


@functools.lru_cache(maxsize=4096)
def solve_gemm_tiling(
    m: int,
    n: int,
    k: int,
    *,
    granule: int = ITA_GRANULE,
    max_tile: int = ITA_MAX_TILE,
    budget: int = ITA_L1_BYTES,
) -> GemmTiling:
    """Granule-aligned double-buffered tiling minimizing L2<->L1 traffic
    (Deeploy's objective: DMA time must hide under compute), then tile
    count (per-tile dispatch overhead).

    Memoized: encoder graphs repeat the same ``(m, n, k)`` per layer, so
    each distinct GEMM geometry is brute-forced once per process.  The
    candidate cube is pruned on the A/B-bytes lower bound — a ``(tm, tk,
    tn)`` whose double-buffered A+B tiles alone exceed the L1 budget can
    never be feasible, so the inner loop is skipped entirely.
    """
    def candidates(dim):
        top = min(max_tile, math.ceil(dim / granule) * granule)
        return list(range(granule, top + 1, granule))

    best = None
    for tk in candidates(k):
        for tn in candidates(n):
            # A/B-only lower bound with the smallest tm (== granule):
            # 2 * (tm*tk [A] + tk*tn [B]) already over budget -> no tm fits.
            if 2 * (granule * tk + tk * tn) > budget:
                continue
            for tm in candidates(m):
                if 2 * (tm * tk + tk * tn) > budget:
                    break  # tm only grows; A bytes are monotone in tm
                t = GemmTiling(m, n, k, tm, tn, tk)
                if t.l1_bytes <= budget:
                    score = (t.dma_bytes, t.n_tiles)
                    if best is None or score < best[0]:
                        best = (score, t)
    if best is None:
        raise ValueError(f"no feasible tiling for {(m, n, k)} within {budget}B")
    return best[1]


@dataclass(frozen=True)
class MhaTiling:
    """Per-head attention tiling (S x P Q/K/V tiles; ITA runs head-by-head)."""

    seq: int
    head_dim: int
    tile_s: int

    @property
    def l1_bytes(self) -> int:
        # Q tile + K tile + V tile + logits tile + A tile + out tile, x2
        t, p = self.tile_s, self.head_dim
        return 2 * (3 * t * p + 2 * t * t + t * p)


@functools.lru_cache(maxsize=1024)
def solve_mha_tiling(
    seq: int, head_dim: int, *, granule: int = ITA_GRANULE, budget: int = ITA_L1_BYTES
) -> MhaTiling:
    top = min(ITA_MAX_TILE, math.ceil(seq / granule) * granule)
    for ts in range(top, granule - 1, -granule):
        t = MhaTiling(seq, head_dim, ts)
        if t.l1_bytes <= budget:
            return t
    raise ValueError(f"no feasible MHA tiling for seq={seq}, P={head_dim}")


def tile_graph(g, *, granule: int = ITA_GRANULE, budget: int = ITA_L1_BYTES) -> dict:
    """Tiling solutions for every accelerated node. Returns {node: tiling}."""
    out = {}
    for n in g.nodes:
        if n.engine != "ita":
            continue
        if n.op == "MatMul":
            m, k, nn = n.attrs["dims"]
            out[n.name] = solve_gemm_tiling(m, nn, k, granule=granule, budget=budget)
        elif n.op in ("MHAHead", "MHA"):
            out[n.name] = solve_mha_tiling(
                n.attrs["seq"], n.attrs["head_dim"], granule=granule, budget=budget
            )
    return out
