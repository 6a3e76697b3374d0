"""Heterogeneous dispatch — the "ITA or cluster" decision, per operator (torch port).

Each operator runs either on the accelerator (GEMM / MHA, when shapes
satisfy the geometric constraints) or on the cluster's fallback kernels.
Here the accelerator slot of ``Backend.ITA`` holds the CUDA kernels
(``int8_gemm``, ``ita_attention``, ``igelu``), the accelerator slot of
``Backend.W8A8`` the paper-faithful plain integer arithmetic (whose
rowwise softmax is the ``itamax`` kernel on the card), and the cluster
the plain PyTorch integer operators.

``DEFAULT_TABLE`` holds the encoder's kinds (gemm, mha, softmax, gelu,
layernorm, add, embed, headaccum, classifier, dequant), the dense
decoder's cluster kinds (rope, attn_causal, attn_cached, cache_write,
silumul, lasttok, lmhead) and the paged KV region's (cache_write_paged,
attn_paged).  A plan node of any other kind fails at bind time.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable


class Backend(enum.Enum):
    W8A8 = "w8a8"  # plain integer path (paper-faithful arithmetic)
    ITA = "ita"  # hand-written CUDA kernels in the accelerator slot


class Engine(enum.Enum):
    ACCELERATOR = "ita"
    CLUSTER = "cluster"


# ITA geometric constraints (Section IV-B): vector length 64, dimensions
# up to 512, 64-granule tiles.  The kernel backend aligns to 128, as the
# reference's TPU kernels did, so that plans, tilings and paddings are the
# reference's.
ITA_GRANULE = 64
ITA_MAX_DIM = 512
TPU_GRANULE = 128

PALLAS_GRANULE = TPU_GRANULE
ASIC_GRANULE = ITA_GRANULE


@dataclasses.dataclass(frozen=True)
class OpDesc:
    """Shape/type description of one operator instance."""

    kind: str
    shapes: tuple[tuple[int, ...], ...]
    dtype: str = "int8"
    act: str = "identity"


#: ops the accelerator datapath supports at all
ACCEL_KINDS = {"gemm", "mha", "relu", "gelu", "identity"}


def backend_granule(backend: "Backend") -> int:
    """Alignment granule at which ``resolve`` judges ``ita_supports``."""
    return PALLAS_GRANULE if backend is Backend.ITA else ASIC_GRANULE


def as_backend(backend: "Backend | str") -> "Backend":
    """Normalize a backend given as enum or name string."""
    if isinstance(backend, Backend):
        return backend
    if isinstance(backend, str):
        try:
            return Backend(backend.lower())
        except ValueError:
            raise ValueError(
                f"unknown backend {backend!r}; expected one of "
                f"{sorted(b.value for b in Backend)}"
            ) from None
    raise TypeError(f"backend must be a Backend or name string, got {type(backend)!r}")


def ita_supports(op: OpDesc, granule: int = ITA_GRANULE) -> bool:
    """Would the accelerator accept this op?  int8 operands, aligned dims;
    MHA is gated by the head dim alone (the runner pads the sequence)."""
    if op.kind not in ACCEL_KINDS:
        return False
    if op.dtype != "int8":
        return False
    if op.kind == "mha":
        return all(s[-1] % ITA_GRANULE == 0 for s in op.shapes)
    for shape in op.shapes:
        for d in shape[-2:]:
            if d % granule != 0:
                return False
    return True


@dataclasses.dataclass
class DispatchTable:
    """Runtime registry: op kind -> {engine -> callable}, plus per-backend
    overrides of an engine slot."""

    table: dict[str, dict[Engine, Callable]] = dataclasses.field(default_factory=dict)
    overrides: dict[tuple[str, Engine, Backend], Callable] = dataclasses.field(
        default_factory=dict
    )

    def register(
        self, kind: str, engine: Engine, fn: Callable, backend: Backend | None = None
    ) -> None:
        if backend is None:
            self.table.setdefault(kind, {})[engine] = fn
        else:
            self.table.setdefault(kind, {})
            self.overrides[(kind, engine, backend)] = fn

    def kinds(self) -> set[str]:
        return set(self.table)

    def _lookup(self, kind: str, engine: Engine, backend: Backend) -> Callable:
        fn = self.overrides.get((kind, engine, backend))
        if fn is None:
            fn = self.table[kind][engine]
        return fn

    def _has_accelerator(self, kind: str, backend: Backend) -> bool:
        return Engine.ACCELERATOR in self.table.get(kind, {}) or (
            (kind, Engine.ACCELERATOR, backend) in self.overrides
        )

    def resolve(self, op: OpDesc, backend: Backend) -> tuple[Engine, Callable]:
        if op.kind not in self.table:
            raise NotImplementedError(f"no runner registered for op kind {op.kind!r}")
        granule = backend_granule(backend)
        if ita_supports(op, granule) and self._has_accelerator(op.kind, backend):
            return Engine.ACCELERATOR, self._lookup(op.kind, Engine.ACCELERATOR, backend)
        return Engine.CLUSTER, self._lookup(op.kind, Engine.CLUSTER, backend)


DEFAULT_TABLE = DispatchTable()


def populate_default_table(table: DispatchTable | None = None) -> DispatchTable:
    """Fill a dispatch table with the encoder's runners.

    One signature per kind (the executor prepares arguments once):

      gemm:       fn(x, w, b, *, scales, act, s_preact) -> int8
      mha:        fn(qh, kh, vh, *, s_act, s_out) -> int8  [B, H, S, D]
      softmax:    fn(logits, mask=None) -> int8  (rowwise ITAMax, last axis)
      gelu:       fn(x_q, *, s_in, s_out) -> int8
      layernorm:  fn(kind, pq, x_q, s_gamma, s_out) -> int8
      add:        fn(a_q, b_q, *, scales) -> int8
      embed:      fn(table_q, tokens) -> int8
      headaccum:  fn(parts, bias_q | None, *, scales) -> int8  (int32 partials)
      classifier: fn(h_q, table_q, *, scale) -> float32
      dequant:    fn(h_q, *, scale) -> float32

    Decoder / KV-cache kinds (all cluster, as in the reference: integer
    RoPE, SiLU and cache maintenance are the cluster's software kernels,
    and the ITA attention datapath has no causal or cache-mask mode; on
    the card ``attn_paged`` launches the paged flash-ITAMax kernel,
    ``ita_attention_paged``):

      rope:        fn(x_q, positions, *, heads, head_dim, theta) -> int8
      attn_causal: fn(q, k, v, *, heads, kv_heads, head_dim, s_act, s_out,
                      block_k) -> int8  [B, S, H*D] merged layout
      attn_cached: fn(q, k_cache, v_cache, pos, *, heads, head_dim, s_act,
                      s_out, block_k) -> int8  [B, 1, H*D]
      cache_write: fn(kv, cache | None, pos | None, *, kv_heads, head_dim,
                      max_len) -> int8  [B, Hkv, max_len, D]
      silumul:     fn(gate_q, up_q, *, scales) -> int8
      lasttok:     fn(x_q) -> int8 (last sequence position)
      lmhead:      fn(h_q, w_q, *, scale, tied) -> float32

    Paged KV region (one shared block pool per layer, ``[P+1, Hkv,
    block_size, D]``, physical block 0 the scratch block, and a block
    table per request slot):

      cache_write_paged: fn(kv, pool, pos, table, active | None, *,
                            kv_heads, head_dim, block_size) -> int8 pool
      attn_paged:  fn(q, k_pool, v_pool, pos, table, *, heads, kv_heads,
                      head_dim, s_act, s_out, block_k) -> int8 [B, S, H*D]

    Positions (``positions``, ``pos``) and the ``active`` lane mask are
    host data: an int, a numpy array or a CPU tensor; a block table may
    lie on the pool's device (the session copies it there once a step).
    ``cache_write`` on decode and ``cache_write_paged`` write the
    session's cache or pool in place (the plan aliases each output to its
    input) and return it; a dense row past ``max_len`` raises, where the
    reference's ``dynamic_update_slice`` would clamp the start.
    """
    table = DEFAULT_TABLE if table is None else table

    import torch

    import numpy as np

    from repro_torch.core.attention import (
        MhaQParams,
        attention_decode_i8,
        attention_flash_i8,
        attention_rowwise_i8,
    )
    from repro_torch.core.quant_linear import ACT_IDENTITY, make_qlinear_params, qlinear_i8
    from repro_torch.kernels.igelu import igelu, igelu_ref
    from repro_torch.kernels.int8_gemm import int8_gemm
    from repro_torch.kernels.ita_attention.ops import ita_attention_paged
    from repro_torch.kernels.itamax import itamax
    from repro_torch.models import layers as L
    from repro_torch.models.encoder import attention_ita
    from repro_torch.quant.qparams import i32, imatmul, make_qparams, requantize

    # -- gemm: ITA's GEMM mode (int8 matmul + bias + requant + activation)
    def _gemm_plain(x_q, w_q, b_q, *, scales, act=ACT_IDENTITY, s_preact=None):
        s_in, s_w, s_out = scales
        return qlinear_i8(x_q, w_q, b_q, make_qlinear_params(s_in, s_w, s_out, act, s_preact))

    def _gemm_ita(x_q, w_q, b_q, *, scales, act=ACT_IDENTITY, s_preact=None):
        s_in, s_w, s_out = scales
        *lead, k = x_q.shape
        m = 1
        for d in lead:
            m *= d
        n = w_q.shape[1]
        # rows padded to the 128 granule with zero rows, as the reference's
        # runner does (exact: they are sliced away after the requant)
        pad = (-m) % TPU_GRANULE
        x2 = x_q.reshape(m, k)
        if pad:
            x2 = torch.cat([x2, torch.zeros((pad, k), dtype=x_q.dtype, device=x_q.device)])
        out = int8_gemm(x2, w_q, b_q, s_in=s_in, s_w=s_w, s_out=s_out, act=act,
                        s_preact=s_preact)
        if pad:
            out = out[:m]
        return out.reshape(*lead, n)

    table.register("gemm", Engine.CLUSTER, _gemm_plain)
    table.register("gemm", Engine.ACCELERATOR, _gemm_plain, backend=Backend.W8A8)
    table.register("gemm", Engine.ACCELERATOR, _gemm_ita, backend=Backend.ITA)

    # -- mha: the fused attention core (projections dispatch as gemm)
    def _mha_plain(qh, kh, vh, *, s_act, s_out):
        p = MhaQParams.make(s_act, s_act, s_act, s_out, qh.shape[-1])
        return attention_rowwise_i8(qh, kh, vh, p)

    def _mha_ita(qh, kh, vh, *, s_act, s_out):
        return attention_ita(qh, kh, vh, s_act, s_out)

    table.register("mha", Engine.CLUSTER, _mha_plain)
    table.register("mha", Engine.ACCELERATOR, _mha_plain, backend=Backend.W8A8)
    table.register("mha", Engine.ACCELERATOR, _mha_ita, backend=Backend.ITA)

    # -- softmax: standalone rowwise ITAMax, cluster only — like the ASIC,
    # the ITAMax unit accelerates softmax only inside the MHA datapath
    # ("softmax" is deliberately absent from ACCEL_KINDS); on the card the
    # wrapper launches the itamax kernel
    table.register("softmax", Engine.CLUSTER, itamax)

    # -- gelu: standalone i-GeLU (survives only when the producing GEMM
    # went to the cluster, so the epilogue fusion could not fold it)
    def _igelu_plain(x_q, *, s_in, s_out):
        return igelu_ref(x_q, in_scale=s_in, out_scale=s_out)

    def _igelu_ita(x_q, *, s_in, s_out):
        return igelu(x_q, in_scale=s_in, out_scale=s_out)

    table.register("gelu", Engine.CLUSTER, _igelu_plain)
    table.register("gelu", Engine.ACCELERATOR, _igelu_plain, backend=Backend.W8A8)
    table.register("gelu", Engine.ACCELERATOR, _igelu_ita, backend=Backend.ITA)

    # -- cluster-only auxiliaries (the paper's Snitch fallback kernels)
    table.register("layernorm", Engine.CLUSTER, L.norm_apply_i8)

    def _iadd(a_q, b_q, *, scales):
        return L.iadd_i8(a_q, b_q, *L.make_iadd_params(*scales))

    table.register("add", Engine.CLUSTER, _iadd)
    table.register("embed", Engine.CLUSTER, lambda table_q, tokens: table_q[tokens.long()])

    def _head_accum(parts, bias_q, *, scales):
        # the model path's arithmetic: int32 sum of the per-head partial
        # output projections, one requant, then the bias, requantized on
        # its own and added after the first requant
        s_in, s_w, s_out = scales
        acc = i32(parts[0])
        for p in parts[1:]:
            acc = acc + i32(p)
        qp_o = make_qparams(s_in, s_w, s_out)
        out = requantize(acc, qp_o.mult, qp_o.shift)
        if bias_q is not None:
            qb = make_qparams(s_in, 1.0, s_out)
            out = requantize(i32(out) + i32(requantize(bias_q, qp_o.mult, qp_o.shift)),
                             qb.mult, qb.shift)
        return out

    table.register("headaccum", Engine.CLUSTER, _head_accum)
    table.register("classifier", Engine.CLUSTER,
                   lambda h_q, table_q, *, scale: L.classifier_f32(h_q, table_q, scale))
    table.register("dequant", Engine.CLUSTER,
                   lambda h_q, *, scale: h_q.to(torch.float32) * scale)

    # -- decoder / KV-cache cluster kinds.  Plan tensors keep the merged
    # [S, H*D] layout between nodes; the runners split and merge heads
    def _split(x_q, heads, head_dim):
        b, s, _ = x_q.shape
        return x_q.reshape(b, s, heads, head_dim).permute(0, 2, 1, 3)

    def _merge(x_q):
        b, h, s, d = x_q.shape
        return x_q.permute(0, 2, 1, 3).reshape(b, s, h * d)

    def _host(pos) -> np.ndarray:
        return np.asarray(pos.cpu() if isinstance(pos, torch.Tensor) else pos, np.int64)

    def _rope(x_q, positions, *, heads, head_dim, theta):
        positions = _host(positions)
        c_q, s_q = L.rope_tables_i8(positions.reshape(-1), head_dim, theta, x_q.device)
        if positions.ndim == 2:
            # per-lane window positions [B, S]: tables [B, 1, S, D/2]
            # broadcast over heads
            half = head_dim // 2
            c_q = c_q.reshape(*positions.shape, half)[:, None]
            s_q = s_q.reshape(*positions.shape, half)[:, None]
        elif x_q.shape[1] == 1 and positions.size == x_q.shape[0]:
            # per-request decode positions: row b rotates by its own angle,
            # tables [B, 1, 1, D/2] (for B = 1 the scalar path's broadcast)
            c_q, s_q = c_q[:, None, None, :], s_q[:, None, None, :]
        return _merge(L.apply_rope_i8(_split(x_q, heads, head_dim), c_q, s_q))

    table.register("rope", Engine.CLUSTER, _rope)

    def _attn_causal(q_m, k_m, v_m, *, heads, kv_heads, head_dim, s_act, s_out, block_k):
        p = MhaQParams.make_flash(s_act, s_act, s_act, s_out, max(head_dim, 1))
        kh = _split(k_m, kv_heads, head_dim)
        out = attention_flash_i8(
            _split(q_m, heads, head_dim), kh, _split(v_m, kv_heads, head_dim),
            p, causal=True, block_k=min(block_k, kh.shape[2]),
        )
        return _merge(out)

    table.register("attn_causal", Engine.CLUSTER, _attn_causal)

    def _attn_cached(q_m, k_cache, v_cache, pos, *, heads, head_dim, s_act, s_out, block_k):
        p = MhaQParams.make_flash(s_act, s_act, s_act, s_out, max(head_dim, 1))
        qh = _split(q_m, heads, head_dim)
        # a scalar pos (every request at one depth) or a [B] vector: either
        # way request b attends exactly its first pos_b + 1 cache rows
        kv_len = np.broadcast_to(_host(pos).reshape(-1) + 1, (qh.shape[0],))
        out = attention_decode_i8(
            qh, k_cache, v_cache, torch.from_numpy(kv_len.astype(np.int32)), p,
            block_k=min(block_k, k_cache.shape[2]),
        )
        return _merge(out)

    table.register("attn_cached", Engine.CLUSTER, _attn_cached)

    def _cache_write(kv_m, cache, pos, *, kv_heads, head_dim, max_len):
        kh = _split(kv_m, kv_heads, head_dim)
        if cache is None:  # prefill: a fresh cache, rows [0, S) written
            cache = kh.new_zeros((kh.shape[0], kv_heads, max_len, head_dim))
            cache[:, :, : kh.shape[2]] = kh
            return cache
        pos = _host(pos)
        if pos.size and int(pos.max()) + kh.shape[2] > cache.shape[2]:
            # the reference's dynamic_update_slice would clamp the start
            # onto the last rows; a slice past the end would write nothing
            raise IndexError(f"cache write at row {int(pos.max())} past max_len "
                             f"{cache.shape[2]}")
        if pos.ndim == 1:  # per-request rows: slot b appends at its own depth
            rows = torch.from_numpy(pos).to(cache.device)
            lanes = torch.arange(kh.shape[0], device=cache.device)
            cache[lanes, :, rows] = kh[:, :, 0]
        else:
            p0 = int(pos)
            cache[:, :, p0 : p0 + kh.shape[2]] = kh
        return cache

    table.register("cache_write", Engine.CLUSTER, _cache_write)

    # -- paged KV region: a shared block pool per layer [P+1, Hkv,
    # block_size, D] and a block table per slot.  Physical block 0 is the
    # scratch block (deploy.paging.SCRATCH_BLOCK): unallocated table
    # entries and inactive lanes route there, so a batched dispatch can
    # carry parked lanes without touching any live slot's rows.
    def _table(table_q, b, device):
        t = torch.as_tensor(table_q).to(device=device, dtype=torch.long)
        if t.dim() == 1:
            t = t[None]
        return t.expand(b, t.shape[-1])

    def _lane_rows(pos, b, s):
        """Host [B, S] global rows ``pos + i`` of each lane's queries."""
        pos = np.broadcast_to(_host(pos).reshape(-1), (b,))
        return pos[:, None] + np.arange(s)[None]

    def _cache_write_paged(kv_m, pool, pos, table_q, active=None, *,
                           kv_heads, head_dim, block_size):
        from repro_torch.deploy.paging import SCRATCH_BLOCK

        kh = _split(kv_m, kv_heads, head_dim)  # [B, Hkv, S, D]
        b, _, s, _ = kh.shape
        table = _table(table_q, b, pool.device)
        rows = _lane_rows(pos, b, s)
        live = np.ones((b, 1), bool) if active is None else \
            _host(active).astype(bool).reshape(-1, 1)
        # a parked lane's rows may lie past its table (any depth is legal
        # there): its logical block is clipped before the gather, and the
        # lane writes to scratch whatever the gather gives
        logical = np.clip(rows // block_size, 0, table.shape[1] - 1)
        idx = torch.from_numpy(np.stack([logical, rows % block_size,
                                         np.broadcast_to(live, rows.shape)]))
        idx = idx.to(pool.device)  # one copy to the device
        phys = torch.where(idx[2].bool(), table.gather(1, idx[0]), SCRATCH_BLOCK)
        # one scatter; live lanes' (block, row) targets are unique (the
        # allocator never maps one block to two writers), repeated
        # targets fall only in the scratch block, whose rows are don't-care
        vals = kh.permute(0, 2, 1, 3).reshape(b * s, kv_heads, head_dim)
        pool[phys.reshape(-1), :, idx[1].reshape(-1), :] = vals
        return pool

    table.register("cache_write_paged", Engine.CLUSTER, _cache_write_paged)

    def _attn_paged(q_m, k_pool, v_pool, pos, table_q, *, heads, kv_heads,
                    head_dim, s_act, s_out, block_k):
        # on the card the paged kernel reads K/V through the table; on the
        # CPU its plain version gathers each lane's blocks
        return ita_attention_paged(q_m, k_pool, v_pool, pos, table_q, heads=heads,
                                   kv_heads=kv_heads, head_dim=head_dim, s_q=s_act, s_k=s_act,
                                   s_v=s_act, s_out=s_out, block_k=block_k)

    table.register("attn_paged", Engine.CLUSTER, _attn_paged)

    def _silu_mul(g_q, u_q, *, scales):
        s_g, s_u, s_out = scales
        sg = L.isilu_i8(g_q, s_g, s_g)
        qp = make_qparams(s_g, s_u, s_out)
        return requantize(i32(sg) * i32(u_q), qp.mult, qp.shift)

    table.register("silumul", Engine.CLUSTER, _silu_mul)
    table.register("lasttok", Engine.CLUSTER, lambda x_q: x_q[:, -1:])

    def _lm_head(h_q, w_q, *, scale, tied):
        # exact integer product (K = d_model is past float32's exact range);
        # the tied head reads the embedding table transposed, as a view
        return imatmul(h_q, w_q.T if tied else w_q).to(torch.float32) * scale

    table.register("lmhead", Engine.CLUSTER, _lm_head)
    return table


populate_default_table(DEFAULT_TABLE)
