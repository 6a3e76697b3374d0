"""Cost-model-driven autotuning of decode-step plan knobs (torch port).

``compile(..., autotune=True)`` enumerates the *bit-neutral* knobs of a
decoder artifact and picks the combination the analytical cost model
(:func:`repro_torch.deploy.costmodel.plan_step_cost`, the ITA ASIC's
model, not the card's) predicts fastest for one decode step:

* ``kv_block_size`` (paged plans): the paged pool is re-blocked while
  preserving at least the configured pool capacity in ROWS
  (``kv_blocks`` rescales with the block size), trading block-table
  gather overhead against allocation granularity.
* fusion boundary (``fuse_min_nodes``): the minimum contiguous
  same-engine run :func:`repro_torch.deploy.patterns.fuse_regions`
  collapses into one dispatch — small regions amortize launches, but a region of
  two trivial nodes can cost more to close over than it saves.
* decode GEMM macro-tilings: recorded per distinct ITA GEMM shape from
  the L1 tiler (:func:`solve_gemm_tiling`) — advisory, like
  ``DeploymentPlan.tilings``; the executor never reads them.

None of these change computed values: flash-attention blocking
(``PREFILL_BLOCK_K``/``DECODE_BLOCK_K``) is deliberately NOT tunable
because int8 accumulation order is part of the bit-exactness contract.

The tuner is deterministic — same (config, inputs) always yields the
same knobs — so the resolved knobs can be folded into the compile
fingerprint and a second ``compile(autotune=True)`` is a plain on-disk
cache hit (no re-tuning, no re-lowering).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig
from repro_torch.deploy import patterns
from repro_torch.deploy.costmodel import HW, HwConfig, plan_step_cost
from repro_torch.deploy.lowering import lower_decoder
from repro_torch.deploy.tiler import ITA_GRANULE, solve_gemm_tiling

#: fusion-boundary candidates: 2 fuses every pair, larger values keep
#: short runs unfused (launch cost amortizes worse than closure cost)
FUSE_MIN_NODES_CANDIDATES = (2, 3, 4, 8)

#: paged block-size candidates, merged with the caller's configured size
KV_BLOCK_CANDIDATES = (8, 16, 32, 64)


@dataclass(frozen=True)
class TuneResult:
    """Outcome of one :func:`tune_decoder` run.

    ``knobs`` is JSON-canonical (str keys, int/list values) so
    ``compile`` can fold it straight into the fingerprint payload.
    """

    knobs: dict
    predicted_cost_s: float
    n_dispatches: int
    considered: int  # candidate plans scored

    def payload(self) -> dict:
        """The record stored on ``DeploymentPlan.autotune`` (round-trips
        through plan JSON)."""
        return {
            "knobs": dict(self.knobs),
            "predicted_cost_s": self.predicted_cost_s,
            "n_dispatches": self.n_dispatches,
            "considered": self.considered,
        }


def _block_candidates(kv_block_size: int, kv_blocks: int, max_len: int):
    """(block_size, n_blocks) candidates preserving pool capacity in rows.

    The configured pool holds ``kv_block_size * kv_blocks`` rows; every
    candidate re-blocking keeps at least that many rows so admission
    behavior (how many prompts fit) can only improve, never silently
    shrink."""
    if kv_block_size <= 0:
        return [(0, 0)]  # dense KV region: nothing to re-block
    rows = kv_block_size * kv_blocks
    sizes = sorted({kv_block_size, *KV_BLOCK_CANDIDATES})
    out = []
    for bs in sizes:
        if bs > max(max_len, 1):
            continue  # a block bigger than the whole extent is pure waste
        nb = -(-rows // bs)
        out.append((bs, nb))
    return out


def _gemm_tiles(plan) -> dict:
    """Advisory L1 macro-tilings, one entry per distinct ITA GEMM shape."""
    tiles: dict[str, list[int]] = {}
    for n in plan.flat_nodes():
        if n.kind != "gemm" or n.engine != "ita":
            continue
        m, k, nn = n.attrs["dims"]
        key = f"{m}x{k}x{nn}"
        if key in tiles:
            continue
        t = solve_gemm_tiling(m, nn, k)
        tiles[key] = [int(t.tile_m), int(t.tile_n), int(t.tile_k)]
    return tiles


def tune_decoder(
    cfg: ArchConfig,
    *,
    seq_len: int,
    max_len: int,
    granule: int = ITA_GRANULE,
    kv_block_size: int = 0,
    kv_blocks: int = 0,
    fuse: bool = True,
    hw: HwConfig = HW,
) -> TuneResult:
    """Pick decode-step knobs by cost-model argmin (no execution).

    Lowers the decoder once per block-size candidate (``fuse=False``),
    then scores every fusion boundary on the *decode* plan — the hot
    path; prefill runs once per request and keeps the configured
    geometry.  Ties break toward the smaller candidate tuple, so the
    result is deterministic and cacheable.
    """
    best = None  # (t_s, n_dispatches, bs, mn, decode_plan, nb)
    considered = 0
    for bs, nb in _block_candidates(kv_block_size, kv_blocks, max_len):
        pair = lower_decoder(
            cfg, seq_len, max_len=max_len, kv_block_size=bs,
            kv_blocks=nb, granule=granule, fuse=False,
        )
        boundaries = FUSE_MIN_NODES_CANDIDATES if fuse else (2,)
        for mn in boundaries:
            plan = (
                patterns.fuse_regions(pair.decode, min_nodes=mn)
                if fuse else pair.decode
            )
            cost = plan_step_cost(plan, hw)
            considered += 1
            key = (cost.t_s, cost.n_dispatches, bs, mn)
            if best is None or key < best[:4]:
                best = (cost.t_s, cost.n_dispatches, bs, mn, plan, nb)
    t_s, n_disp, bs, mn, plan, nb = best
    knobs = {
        "kv_block_size": int(bs),
        "kv_blocks": int(nb),
        "fuse_min_nodes": int(mn),
        "gemm_tiles": _gemm_tiles(plan),
    }
    return TuneResult(
        knobs=knobs,
        predicted_cost_s=float(t_s),
        n_dispatches=int(n_disp),
        considered=considered,
    )
