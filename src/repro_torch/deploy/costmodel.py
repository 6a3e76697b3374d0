"""Calibrated analytical cost/energy model of the Snitch+ITA cluster (torch port).

Every constant here is the paper's 22 nm ITA ASIC's, not the H100's: a
time this module predicts is the ASIC's time, never the card's.

Anchored constants (paper §IV/§V):
  * ITA datapath: N=16 dot units x M=64 MACs -> 2048 Op/cycle peak;
    425 MHz at the 0.65 V efficiency corner -> 870.4 GOp/s peak.
  * One 64x64x64 output tile = 256 cycles.
  * Per-granule overhead calibrated on the microbenchmarks: +45 cycles
    reproduces the 85.1 % GEMM utilization (741 GOp/s); +167 cycles on the
    QK^T/AV granules (ITAMax row synchronization) reproduces 74.9 % on the
    full single-head MHA kernel (663 GOp/s); the standalone accelerator
    (no TCDM contention) is 8 cycles/granule better (79.6 %).
  * Cluster-only int8 GEMM software: 0.74 GOp/s (1.74 Op/cycle across the
    octacore) — Table I "Multi-Core" rows.
  * DMA: 512-bit wide AXI, worst-case 48.75 B/cycle sustained toward L2;
    per-op time = max(compute, DMA) under double buffering.
  * Power: cluster active 26.0 mW; ITA GEMM mode 136.7 mW total
    (741 GOp/s / 5.42 TOp/J); ITA attention mode 104.4 mW total
    (663 GOp/s / 6.35 TOp/J).  E2E energy = sum of per-phase P x t — this
    two-power model reproduces the paper's mJ/Inf within ~6 %.
  * Cluster-side per-element costs for fallback ops and the per-tile
    dispatch overhead are fit once, globally, on the three E2E networks
    (least squares; residuals reported, not hidden).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.deploy.graph import Graph
from repro_torch.deploy.tiler import (
    GemmTiling,
    ITA_GRANULE,
    ITA_L1_BYTES,
    MhaTiling,
    solve_gemm_tiling,
    solve_mha_tiling,
)


@dataclass(frozen=True)
class HwConfig:
    freq_hz: float = 425e6
    ita_ops_per_cyc: int = 2048
    tile_cycles: int = 256
    tile_ovh_gemm: int = 45  # calibrated: 85.1 % GEMM utilization
    tile_ovh_attn: int = 167  # calibrated: 74.9 % single-head MHA utilization
    tile_ovh_standalone_delta: int = -8  # 79.6 % standalone
    cluster_gemm_ops_per_cyc: float = 1.74  # 0.74 GOp/s
    dma_bytes_per_cyc: float = 48.75
    p_cluster_w: float = 26.0e-3
    p_ita_gemm_w: float = 136.7e-3
    p_ita_attn_w: float = 104.4e-3
    # globally-fit cluster-side constants (see fit_cluster_constants):
    # per-granule orchestration cost on the cluster (task programming,
    # requant parameter staging, DMA descriptor setup) + per-element cost
    # of the fallback ops (LN / residual / head-accumulation)
    dispatch_cyc_per_granule: float = 2900.0
    aux_cyc_per_elem: float = 1.0
    # decode-step plan costs (see plan_step_cost): per top-level plan-node
    # launch (runner call + task programming) — the term region fusion
    # collapses — and per KV-block table indirection on the paged gather
    node_launch_cyc: float = 400.0
    gather_cyc_per_block: float = 24.0


HW = HwConfig()


# -- accelerated op costs -----------------------------------------------------

def gemm_cycles(t: GemmTiling, hw: HwConfig = HW, *, standalone: bool = False) -> float:
    """Compute cycles of one int8 GEMM on ITA (double-buffered DMA overlap).

    Compute is counted per 64^3 granule pass (256 cycles + the calibrated
    per-granule overhead for weight swap/config); the macro tiling (L1
    residency) determines DMA traffic, overlapped by double buffering.
    """
    ovh = hw.tile_ovh_gemm + (hw.tile_ovh_standalone_delta if standalone else 0)
    granules = (
        math.ceil(t.m / ITA_GRANULE)
        * math.ceil(t.n / ITA_GRANULE)
        * math.ceil(t.k / ITA_GRANULE)
    )
    compute = granules * (hw.tile_cycles + ovh)
    dma = t.dma_bytes / hw.dma_bytes_per_cyc
    return max(compute, dma)


def mha_head_cycles(
    t: MhaTiling, d_model: int, hw: HwConfig = HW, *, standalone: bool = False
) -> float:
    """One attention head on ITA: Q/K/V projections + QK^T + (streaming
    ITAMax: free) + AV + partial output projection (the head-by-head
    schedule computes O_h on ITA; the accumulation runs on the cluster)."""
    ovh_a = hw.tile_ovh_attn + (hw.tile_ovh_standalone_delta if standalone else 0)
    ovh_g = hw.tile_ovh_gemm + (hw.tile_ovh_standalone_delta if standalone else 0)
    s64 = math.ceil(t.seq / ITA_GRANULE)
    p64 = max(math.ceil(t.head_dim / ITA_GRANULE), 1)
    e64 = max(math.ceil(d_model / ITA_GRANULE), 1)
    attn_granules = 2 * s64 * s64 * p64  # QK^T + AV
    proj_granules = 3 * s64 * e64 * p64 + s64 * p64 * e64  # QKV + O_h
    return attn_granules * (hw.tile_cycles + ovh_a) + proj_granules * (
        hw.tile_cycles + ovh_g
    )


def mha_head_ops(seq: int, head_dim: int, d_model: int) -> float:
    return 2.0 * (
        3 * seq * d_model * head_dim  # QKV projections
        + 2 * seq * seq * head_dim  # QK^T + AV
        + seq * head_dim * d_model  # partial O projection
    )


def gemm_util(m: int, n: int, k: int, hw: HwConfig = HW, *, standalone: bool = False) -> float:
    t = solve_gemm_tiling(m, n, k)
    cyc = gemm_cycles(t, hw, standalone=standalone)
    return (2 * m * n * k) / (cyc * hw.ita_ops_per_cyc)


# -- network-level cost -------------------------------------------------------

@dataclass
class NetworkCost:
    gop: float
    t_ita_s: float
    t_cluster_s: float
    e_j: float
    n_tiles: int

    @property
    def t_total_s(self) -> float:
        return self.t_ita_s + self.t_cluster_s

    @property
    def inf_per_s(self) -> float:
        return 1.0 / self.t_total_s

    @property
    def gop_per_s(self) -> float:
        return self.gop / self.t_total_s

    @property
    def gop_per_j(self) -> float:
        return self.gop / self.e_j

    @property
    def mj_per_inf(self) -> float:
        return self.e_j * 1e3


def _node_ops(n) -> float:
    if n.op == "MatMul":
        m, k, nn = n.attrs["dims"]
        return 2.0 * m * k * nn * n.attrs.get("heads", 1)
    if n.op == "MHAHead":
        return mha_head_ops(n.attrs["seq"], n.attrs["head_dim"], n.attrs["d_model"])
    if n.op == "MHA":
        return n.attrs["heads"] * mha_head_ops(
            n.attrs["seq"], n.attrs["head_dim"], n.attrs["d_model"]
        )
    if n.op == "Classifier":  # runtime-graph MLM head: int8 matmul, cluster
        m, k, nn = n.attrs["dims"]
        return 2.0 * m * k * nn
    if n.op in ("LayerNorm", "Softmax", "GELU", "Add", "HeadAccum"):
        dims = n.attrs["dims"]
        e = 1
        for d in dims:
            e *= d
        mult = {"LayerNorm": 8, "Softmax": 10, "GELU": 12, "Add": 1, "HeadAccum": 1}[n.op]
        return float(e * mult)
    return 0.0


def _aux_elems(n) -> float:
    dims = n.attrs.get("dims", ())
    if n.op == "Classifier":  # per-output-element orchestration, not per-MAC
        return float(dims[0] * dims[2])
    e = 1
    for d in dims:
        e *= d
    if n.op == "HeadAccum":
        e *= n.attrs.get("heads", 1)
    return float(e)


def _node_granules(n) -> int:
    """64^3 granule passes of an accelerated node (dispatch unit)."""
    if n.op == "MatMul":
        m, k, nn = n.attrs["dims"]
        g = (
            math.ceil(m / ITA_GRANULE)
            * math.ceil(nn / ITA_GRANULE)
            * math.ceil(k / ITA_GRANULE)
        )
        return g * n.attrs.get("heads", 1)
    if n.op in ("MHAHead", "MHA"):
        heads = 1 if n.op == "MHAHead" else n.attrs["heads"]
        s64 = math.ceil(n.attrs["seq"] / ITA_GRANULE)
        p64 = max(math.ceil(n.attrs["head_dim"] / ITA_GRANULE), 1)
        e64 = max(math.ceil(n.attrs["d_model"] / ITA_GRANULE), 1)
        return heads * (2 * s64 * s64 * p64 + 4 * s64 * e64 * p64)
    return 0


def network_cost(g: Graph, hw: HwConfig = HW) -> NetworkCost:
    """E2E cost of a deployed (fused/mapped) graph: ITA + cluster phases."""
    t_ita_gemm = 0.0
    t_ita_attn = 0.0
    cluster_cyc = 0.0
    gop = 0.0
    n_tiles = 0
    granules = 0
    for n in g.nodes:
        gop += _node_ops(n)
        if n.engine == "ita":
            granules += _node_granules(n)
            if n.op == "MatMul":
                m, k, nn = n.attrs["dims"]
                heads = n.attrs.get("heads", 1)
                t = solve_gemm_tiling(m, nn, k)
                t_ita_gemm += heads * gemm_cycles(t, hw) / hw.freq_hz
                n_tiles += heads * t.n_tiles
            elif n.op in ("MHAHead", "MHA"):
                heads = 1 if n.op == "MHAHead" else n.attrs["heads"]
                t = solve_mha_tiling(n.attrs["seq"], n.attrs["head_dim"])
                t_ita_attn += heads * mha_head_cycles(t, n.attrs["d_model"], hw) / hw.freq_hz
                n_tiles += heads * t.n_tiles
        else:
            cluster_cyc += _aux_elems(n) * hw.aux_cyc_per_elem
    cluster_cyc += granules * hw.dispatch_cyc_per_granule
    t_cluster = cluster_cyc / hw.freq_hz
    e = (
        t_ita_gemm * hw.p_ita_gemm_w
        + t_ita_attn * hw.p_ita_attn_w
        + t_cluster * hw.p_cluster_w
    )
    return NetworkCost(
        gop=gop / 1e9,
        t_ita_s=t_ita_gemm + t_ita_attn,
        t_cluster_s=t_cluster,
        e_j=e,
        n_tiles=n_tiles,
    )


def network_cost_cluster_only(g: Graph, hw: HwConfig = HW) -> NetworkCost:
    """Table I "Multi-Core" rows: everything in software at 0.74 GOp/s."""
    gop = sum(_node_ops(n) for n in g.nodes) / 1e9
    t = gop * 1e9 / (hw.cluster_gemm_ops_per_cyc * hw.freq_hz)
    e = t * hw.p_cluster_w
    return NetworkCost(gop=gop, t_ita_s=0.0, t_cluster_s=t, e_j=e, n_tiles=0)


# -- decode-step plan cost ----------------------------------------------------
#
# ``network_cost`` prices runtime *graphs* (encoder forward / prefill, M =
# seq_len).  The decode hot path is different: every GEMM has M = 1 (a
# weight-streaming-bound GEMV), attention reads the whole KV extent
# (``max_len`` rows, plus a block-table gather per KV block when paged),
# and per-step latency is dominated by dispatch count — exactly the term
# region fusion removes.  ``plan_step_cost`` prices a lowered
# DeploymentPlan directly, so the autotuner can argmin over kv_block_size
# / fusion boundaries / GEMM tilings without running anything.

def plan_node_cycles(
    n,
    hw: HwConfig = HW,
    *,
    max_len: int = 0,
    kv_block_size: int = 0,
) -> float:
    """Compute cycles of one decode-step plan node (launch cost excluded;
    that is per *top-level* dispatch — see :func:`plan_step_cost`).  A
    fused region prices as the sum of its body: fusion changes how many
    launches a step pays, never how much arithmetic it does."""
    if n.fused:
        return sum(
            plan_node_cycles(b, hw, max_len=max_len, kv_block_size=kv_block_size)
            for b in n.body
        )
    a = n.attrs
    dims = tuple(a.get("dims", ()))
    if n.kind == "gemm":
        m, k, nn = dims
        heads = a.get("heads", 1)
        if n.engine == "ita":
            return heads * gemm_cycles(solve_gemm_tiling(m, nn, k), hw)
        # cluster GEMV (decode M=1): compute vs int8 weight streaming
        compute = 2.0 * m * k * nn * heads / hw.cluster_gemm_ops_per_cyc
        stream = float(k * nn * heads) / hw.dma_bytes_per_cyc
        return max(compute, stream)
    if n.kind == "mha":
        heads = a.get("heads", 1) if n.op == "MHA" else 1
        t = solve_mha_tiling(a["seq"], a["head_dim"])
        return heads * mha_head_cycles(t, a["d_model"], hw)
    if n.kind == "lmhead":
        _, e, v = dims
        compute = 2.0 * e * v / hw.cluster_gemm_ops_per_cyc
        stream = float(e * v) / hw.dma_bytes_per_cyc
        return max(compute, stream)
    if n.kind in ("attn_cached", "attn_paged"):
        heads = a.get("heads", 1)
        kv_heads = a.get("kv_heads", heads)
        head_dim = a.get("head_dim", dims[-1] if dims else ITA_GRANULE)
        rows = max(int(max_len or a.get("seq", 1)), 1)
        # QK^T + AV against the full cached extent, K and V rows streamed
        compute = 4.0 * rows * head_dim * heads / hw.cluster_gemm_ops_per_cyc
        stream = 2.0 * rows * head_dim * kv_heads / hw.dma_bytes_per_cyc
        cyc = max(compute, stream)
        if n.kind == "attn_paged":
            bs = max(int(kv_block_size or 0), 1)
            cyc += math.ceil(rows / bs) * hw.gather_cyc_per_block
        return cyc
    if n.kind in ("cache_write", "cache_write_paged"):
        kv_heads = a.get("kv_heads", 1)
        head_dim = a.get("head_dim", dims[-1] if dims else ITA_GRANULE)
        cyc = 2.0 * kv_heads * head_dim * hw.aux_cyc_per_elem  # one K + one V row
        if n.kind == "cache_write_paged":
            cyc += hw.gather_cyc_per_block  # block-table indirection
        return cyc
    elems = 1
    for d in dims:
        elems *= d
    return float(elems) * hw.aux_cyc_per_elem


@dataclass(frozen=True)
class PlanStepCost:
    """Predicted wall time of ONE decode step of a DeploymentPlan."""

    n_dispatches: int  # top-level schedule entries (what fusion shrinks)
    t_dispatch_s: float  # n_dispatches x node_launch_cyc
    t_compute_s: float

    @property
    def t_s(self) -> float:
        return self.t_dispatch_s + self.t_compute_s


def plan_step_cost(plan, hw: HwConfig = HW) -> PlanStepCost:
    """Price one step of a lowered plan: per-dispatch launch overhead
    (fused regions count ONCE) plus the body compute of every node."""
    compute = sum(
        plan_node_cycles(
            n, hw, max_len=plan.max_len, kv_block_size=plan.kv_block_size
        )
        for n in plan.nodes
    )
    n_disp = len(plan.nodes)
    return PlanStepCost(
        n_dispatches=n_disp,
        t_dispatch_s=n_disp * hw.node_launch_cyc / hw.freq_hz,
        t_compute_s=compute / hw.freq_hz,
    )


# -- roofline hardware targets ------------------------------------------------

@dataclass(frozen=True)
class HwTarget:
    """Roofline corner of one deployment target."""

    name: str
    peak_flops: float  # peak Op/s (int8 MACs count as 2 Op)
    hbm_bw: float  # bytes/s main-memory bandwidth
    ici_bw: float = 0.0  # bytes/s interconnect (0: single device)


# derived from the calibrated HwConfig so the two never drift
ITA_HET = HwTarget(
    name="ita",
    peak_flops=HW.ita_ops_per_cyc * HW.freq_hz,  # 870.4 GOp/s
    hbm_bw=HW.dma_bytes_per_cyc * HW.freq_hz,  # ~20.7 GB/s toward L2
)


def hw_target(name: str) -> HwTarget:
    targets = {t.name: t for t in (ITA_HET,)}
    try:
        return targets[name]
    except KeyError:
        raise ValueError(
            f"unknown hw target {name!r}; choose from {sorted(targets)}"
        ) from None


def fit_cluster_constants(measured: dict[str, tuple[float, "Graph"]], hw: HwConfig = HW):
    """Least-squares fit of (dispatch_cyc_per_granule, aux_cyc_per_elem) to
    the paper's measured E2E times.  Residuals are reported, never hidden:
    no single linear model reproduces all three networks, so the fit is a
    documented compromise.
    """
    import numpy as np

    rows, rhs = [], []
    feats = {}
    for name, (t_meas, g) in measured.items():
        t_ita = 0.0
        granules = 0
        aux = 0.0
        for n in g.nodes:
            if n.engine == "ita":
                granules += _node_granules(n)
                if n.op == "MatMul":
                    m, k, nn = n.attrs["dims"]
                    heads = n.attrs.get("heads", 1)
                    t = solve_gemm_tiling(m, nn, k)
                    t_ita += heads * gemm_cycles(t, hw) / hw.freq_hz
                elif n.op in ("MHAHead", "MHA"):
                    heads = 1 if n.op == "MHAHead" else n.attrs["heads"]
                    t = solve_mha_tiling(n.attrs["seq"], n.attrs["head_dim"])
                    t_ita += heads * mha_head_cycles(t, n.attrs["d_model"], hw) / hw.freq_hz
            else:
                aux += _aux_elems(n)
        cyc_budget = (t_meas - t_ita) * hw.freq_hz
        rows.append([granules, aux])
        rhs.append(max(cyc_budget, 0.0))
        feats[name] = (t_ita, granules, aux)
    a = np.asarray(rows, dtype=np.float64)
    b = np.asarray(rhs, dtype=np.float64)
    sol, *_ = np.linalg.lstsq(a, b, rcond=None)
    d, c = float(sol[0]), float(sol[1])
    if d < 0 or c < 0:  # degenerate: fall back to granule-only model
        d = float((a[:, 0] @ b) / (a[:, 0] @ a[:, 0]))
        c = 0.0
    residuals = {}
    for name, (t_meas, g) in measured.items():
        t_ita, granules, aux = feats[name]
        t_pred = t_ita + (granules * d + aux * c) / hw.freq_hz
        residuals[name] = {"t_meas": t_meas, "t_pred": t_pred, "ratio": t_pred / t_meas}
    return d, c, residuals
