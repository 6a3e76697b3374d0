// Fused int8 multi-head attention with streaming flash-ITAMax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ita_attention/kernel.py
// (ita_attention_pallas, body _attn_kernel).  Per query row it computes
// int8 Q K^T over one KV block, requantizes onto the ITAMax logit grid,
// applies the causal and kv_valid masks, runs flash_block_update (7-bit
// exp LUT, 10-bit renormalization LUT, int32 val·V accumulation, the 2^21
// guard on the denominator) and, after the last block,
// flash_finalize_q77 (exact floor division) and the output requant.  GQA:
// query head bh reads KV head bh / group.
//
// The result depends on the KV block partition (renormalization rounding
// and the guard follow the block boundaries), so each thread block walks
// ALL KV blocks of its rows in order, block_k keys at a time, exactly as
// the TPU grid's sequential KV axis did; KV is never split across thread
// blocks.  The query tiling is free: rows are independent, and a KV block
// that is fully masked for a row leaves that row's state unchanged (so
// blocks past kv_valid or above the causal diagonal are skipped).  So are
// the output columns: each block computes the softmax state of its rows
// and accumulates P V for DV = 64 of the D output columns (grid.y).
//
// What bounds it on an H100: at the encoder shapes (BH = 32..48, S =
// 128..512, D = 64) one call is 0.07-1.6 GOP on 0.8-4.7 MB, about a
// microsecond at the int8 tensor-core rate or the memory rate.  What is
// left is latency and integer work on the CUDA cores: the serial walk over
// KV blocks, the load-to-use chain of each block, and per logit a requant,
// a mask and an exponential; on MobileBERT's small grid (256 tiles of 16
// query rows) one warp per tile would leave most schedulers idle.
//
// Design (csrc/mma_s8.cuh): blocks of four warps; a row group of 16 query
// rows belongs to one warp, or, when the grid has under eight such tiles
// per SM, to two warps that split its keys (logits and exponentials) and
// its output columns (P V), sharing P, the row max and the row sum through
// shared memory (ops.attn_grid picks the shape per call).
// - K and V arrive in sub-tiles of 128 keys through a cp.async ring of up
//   to four slots (16-byte copies, swizzled; masked 4-byte loads when D is
//   not a multiple of 16), in the order they are used: a KV block's K
//   sub-tiles, then its V sub-tiles, then the next block's, so the next
//   sub-tiles load while the current one is used.
// - Q K^T: mma.sync m16n8k32 s8, Q's fragments held in registers for the
//   whole walk (D <= 128; wider heads re-read the rest from shared memory),
//   K's by ldmatrix (K is D-contiguous: already K-major).
// - The int32 logits are requantized and masked in registers and stored as
//   int8 in a row of shared memory per query row (block_k up to 512), with
//   the row max; a quad of lanes shares a row in the fragment layout, so
//   the max and the sum are reduced with __shfl_xor 1 and 2.
// - P V: the exponentials (one table lookup per logit: t = m - l is in
//   [0, 255]; values in [0, 127], a valid s8 operand) are built straight
//   into the A fragment; V [keys, D] is N-contiguous, so its K-major B
//   fragments come from the same 4x4 byte transpose as int8_gemm's w.  The
//   accumulator stays in registers: renormalized before the block's P V is
//   added by the MMA (integer addition, exact in any order), guarded after
//   it, and finalized there (floor division by a double reciprocal with an
//   exact integer correction, Q7.7, output requant).
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_arith.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int KS = 128;    // keys per staged K or V sub-tile
constexpr int DV = 64;     // output columns per block (grid.y)
constexpr int NSTAGE = 4;  // deepest cp.async ring (sub-tiles); wide heads take 3 or 2
constexpr int QREG = 4;    // Q k-steps held in registers (D <= 128)
constexpr int M_SENTINEL = -(1 << 15);
constexpr int RESCALE_THRESH = 1 << 21;
constexpr int SMEM_MAX = 227 * 1024 - 384;  // dynamic part; the LUTs are static

struct Layout {
  int dp, bkp, lrow, slot;
  size_t q_off, l_off, p_off, x_off, ring_off, bytes;
};

// Shared memory of a block of `qw` row groups (16 query rows each) with a
// ring of `nstage` sub-tiles.  dp: D padded to the MMA's k-step; bkp:
// block_k padded to whole sub-tiles.
__host__ __device__ Layout make_layout(int qw, int block_k, int d, int nstage) {
  Layout L;
  L.dp = (d + 31) / 32 * 32;
  L.bkp = (block_k + KS - 1) / KS * KS;
  L.lrow = L.bkp + 16;  // int8 logits per row, padded against bank conflicts
  L.slot = KS * (L.dp > DV ? L.dp : DV);
  size_t o = 0;
  L.q_off = o; o += (size_t)16 * qw * L.dp;     // Q tile
  L.l_off = o; o += (size_t)16 * qw * L.lrow;   // int8 logits of the KV block
  L.p_off = o; o += (size_t)16 * qw * KS;       // P of one sub-tile (split keys)
  L.x_off = o; o += (size_t)qw * 2 * 2 * 16 * 4;  // row max / row sum exchange
  L.ring_off = o; o += (size_t)nstage * L.slot;   // K/V sub-tile ring
  L.bytes = o;
  return L;
}

// x * 2^(-delta/32), delta >= 0 (itamax.py _renorm_factor_apply)
__device__ __forceinline__ int renorm(const int* rlut, int x, int delta) {
  int q = min(delta >> 5, 31);
  return ita::mul_q10(ita::rshift_round(x, q), rlut[delta & 31]);
}

// Stage chunk (r, c) of rows [0, nrows) x chunks [0, cpr) of a D-contiguous
// tile whose row 0, column col0 is src; rows >= rows_valid and columns >= D
// are zero.
__device__ __forceinline__ void load_chunk(int8_t* dst, int e, int r, int col,
                                           const int8_t* src, const int8_t* any_valid,
                                           int rows_valid, int D, bool vec) {
  if (vec) {  // D % 16 == 0: each chunk is all in range or all out
    bool ok = r < rows_valid && col < D;
    mma::cp_async16(dst + 16 * mma::swz(e), ok ? src + (size_t)r * D + col : any_valid,
                    ok ? 16 : 0);
  } else {  // D % 4 == 0: 4-byte words, each all in or all out
    uint32_t w[4] = {0, 0, 0, 0};
    if (r < rows_valid)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (col + 4 * i < D)
          w[i] = *reinterpret_cast<const uint32_t*>(src + (size_t)r * D + col + 4 * i);
    *reinterpret_cast<uint4*>(dst + 16 * mma::swz(e)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// This thread's 16-byte chunks of a tile of `cpr` chunks per row, worked
// out once per kernel (no integer division in the loads): when the block's
// nt threads are a multiple of cpr, column c of rows r0, r0 + step, ...
struct Chunks {
  int cpr, c, r0, step;
  bool fixed;
};
__device__ __forceinline__ Chunks make_chunks(int cpr, int tid, int nt) {
  return Chunks{cpr, tid % cpr, tid / cpr, nt / cpr, nt % cpr == 0};
}

__device__ __forceinline__ void load_tile(int8_t* dst, int nrows, const Chunks& ch,
                                          const int8_t* src, const int8_t* any_valid,
                                          int rows_valid, int col0, int D, bool vec, int tid,
                                          int nt) {
  if (ch.fixed) {
    for (int r = ch.r0; r < nrows; r += ch.step)
      load_chunk(dst, r * ch.cpr + ch.c, r, col0 + 16 * ch.c, src, any_valid, rows_valid, D,
                 vec);
  } else {
    for (int e = tid; e < nrows * ch.cpr; e += nt)
      load_chunk(dst, e, e / ch.cpr, col0 + 16 * (e % ch.cpr), src, any_valid, rows_valid, D,
                 vec);
  }
}

// S[0..NTK) += Q (16 rows, k-step ks) x K^T of the sub-tile's keys kb..
template <int NTK>
__device__ __forceinline__ void qk_step(int S[][4], const uint32_t a[4], const int8_t* kt,
                                        int cpr, int kb, int ks, int lane) {
#pragma unroll
  for (int np = 0; np < NTK / 2; ++np) {
    uint32_t b[4];
    mma::load_b_kmajor(b, kt, cpr, kb + 16 * np, ks, lane);
    mma::mma_s8(S[2 * np], a, b[0], b[1]);
    mma::mma_s8(S[2 * np + 1], a, b[2], b[3]);
  }
}

// One block of 32 * qw * KSPLIT threads per (bh, 16 * qw query rows, DV
// output columns).  A row group of 16 rows belongs to KSPLIT warps: each
// computes the logits and exponentials of KS / KSPLIT of every sub-tile's
// keys and P V for DV / KSPLIT of the output columns (KSPLIT = 2 shares P,
// the row max and the row sum through shared memory), so a small grid
// still has warps enough to hide each other's latency.
template <int KSPLIT>
__global__ void __launch_bounds__(128) ita_attention_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ k,
    const int8_t* __restrict__ v, const int* __restrict__ luts,
    int8_t* __restrict__ out, int Sq, int Sk, int D, int group, int logit_mult,
    int logit_shift, int out_mult, int out_shift, int causal, int block_k, int kv_valid,
    int qw, int nstage) {
  constexpr int KW = KS / KSPLIT;  // keys per warp per sub-tile
  constexpr int NTK = KW / 8;      // n8 tiles of logits per warp
  constexpr int CG = 2 / KSPLIT;   // 32-column output groups per warp
  extern __shared__ __align__(128) unsigned char smem[];
  // exp LUT over every t = m - l the logits can give (int8 m >= l: t in
  // [0, 255]), then the 10-bit renormalization LUT
  __shared__ __align__(16) uint8_t exp_t[256];
  __shared__ int rlut[32];
  const Layout L = make_layout(qw, block_k, D, nstage);
  int8_t* Qs = reinterpret_cast<int8_t*>(smem + L.q_off);     // [16 qw][dp], swizzled
  int8_t* Ls = reinterpret_cast<int8_t*>(smem + L.l_off);     // [16 qw][lrow] int8 logits
  int8_t* Ps = reinterpret_cast<int8_t*>(smem + L.p_off);     // [qw][16][KS], swizzled
  int* Xs = reinterpret_cast<int*>(smem + L.x_off);           // [qw][max, sum][half][16]
  int8_t* ring = reinterpret_cast<int8_t*>(smem + L.ring_off);  // nstage sub-tiles

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / KSPLIT, hf = warp % KSPLIT;  // row group; keys / columns half
  const int kb = hf * KW, cg0 = hf * CG;
  const int rows = 16 * qw;
  const int qtiles = (Sq + rows - 1) / rows;
  const int bh = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x % qtiles) * rows;
  const int dcol0 = blockIdx.y * DV;
  const int q_offset = Sk - Sq;
  const int8_t* qg = q + (size_t)bh * Sq * D;
  const int8_t* kg = k + (size_t)(bh / group) * Sk * D;
  const int8_t* vg = v + (size_t)(bh / group) * Sk * D;
  const int dt = L.dp / 32, cpr = L.dp / 16;
  const bool vec = D % 16 == 0;

  // KV blocks that hold a key some row of this block keeps
  int kv_end = min(Sk, max(kv_valid, 0));
  if (causal) kv_end = min(kv_end, q0 + rows + q_offset);  // keys <= last query position
  const int nb = kv_end > 0 ? (kv_end + block_k - 1) / block_k : 0;
  const int nsub = (block_k + KS - 1) / KS;
  // units: per KV block, nsub K sub-tiles then nsub V sub-tiles; a unit is
  // (block b, rem in [0, 2 nsub)), walked with counters, not divisions
  const int units = nb * 2 * nsub;
  auto advance = [&](int& b, int& rem) {
    if (++rem == 2 * nsub) rem = 0, ++b;
  };
  const Chunks kch = make_chunks(cpr, tid, nt), vch = make_chunks(DV / 16, tid, nt);
  auto load_unit = [&](int b, int rem, int slot) {
    int s = rem < nsub ? rem : rem - nsub;
    int key0 = b * block_k + s * KS;
    int8_t* dst = ring + (size_t)slot * L.slot;
    int valid = min(KS, block_k - s * KS);
    if (rem < nsub)
      load_tile(dst, KS, kch, kg + (size_t)key0 * D, k, valid, 0, D, vec, tid, nt);
    else
      load_tile(dst, KS, vch, vg + (size_t)key0 * D, v, valid, dcol0, D, vec, tid, nt);
  };

  load_tile(Qs, rows, kch, qg + (size_t)q0 * D, q, Sq - q0, 0, D, vec, tid, nt);
  mma::cp_async_commit();
  int pb = 0, prem = 0;  // next unit to load
  for (int s = 0; s < nstage - 1; ++s) {
    if (s < units) load_unit(pb, prem, s), advance(pb, prem);
    mma::cp_async_commit();
  }

  // the tables, while the copies are in flight (first read after a barrier)
  for (int i = tid; i < 64 + 32; i += nt) {
    if (i < 64) reinterpret_cast<int*>(exp_t)[i] = luts[i];
    else rlut[i - 64] = luts[i];
  }

  // per-row state of rows g (h = 0) and g + 8 (h = 1), shared by a quad
  int m_run[2] = {M_SENTINEL, M_SENTINEL}, d_run[2] = {0, 0}, sum[2] = {0, 0};
  int bm[2] = {-128, -128};
  int acc[CG][4][4];  // [32-column group][n8 tile][fragment]
#pragma unroll
  for (int c = 0; c < CG; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[c][j][r] = 0;
  uint32_t qf[QREG][4];
  int8_t* lrow_base = Ls + (size_t)(16 * rg) * L.lrow;
  int8_t* ptile = Ps + (size_t)(16 * rg) * KS;
  int* xmax = Xs + rg * 64;  // [half][16]
  int* xsum = xmax + 32;
  int voff[CG][8];  // this lane's V words per column group (keys 32 kk further: + 32 kk DV)
#pragma unroll
  for (int c = 0; c < CG; ++c) mma::b_transposed_offsets(voff[c], DV / 16, 2 * (cg0 + c), lane);
  const int qpos0 = q0 + 16 * rg + g + q_offset;  // query position of row g
  const int qpos_min = q0 + 16 * rg + q_offset;   // of the group's first row

  int cb = 0, crem = 0;                       // unit being used
  int cslot = 0, pslot = nstage - 1;          // its ring slot; the next load's
  for (int u = 0; u < units; ++u) {
    // sub-tile u (and Q) landed: this thread's copies, then everyone's;
    // slot (u - 1) % nstage is free
    if (nstage == NSTAGE) mma::cp_async_wait<NSTAGE - 2>();
    else if (nstage == 3) mma::cp_async_wait<1>();
    else mma::cp_async_wait<0>();
    __syncthreads();
    if (u == 0) {
#pragma unroll
      for (int ks = 0; ks < QREG; ++ks)
        if (ks < dt) mma::load_a(qf[ks], Qs, cpr, 16 * rg, ks, lane);
    }
    if (u + nstage - 1 < units) load_unit(pb, prem, pslot), advance(pb, prem);
    mma::cp_async_commit();
    pslot = pslot + 1 == nstage ? 0 : pslot + 1;

    const int8_t* tile = ring + (size_t)cslot * L.slot;
    const int b = cb, rem = crem, s = rem < nsub ? rem : rem - nsub;
    advance(cb, crem);
    cslot = cslot + 1 == nstage ? 0 : cslot + 1;
    const int j0 = b * block_k, kl0 = s * KS;
    // no key of this sub-tile is masked for any row of this group
    const bool full = kl0 + KS <= block_k && j0 + kl0 + KS <= kv_valid &&
                      (!causal || j0 + kl0 + KS - 1 <= qpos_min);
    auto keep = [&](int kl, int h) {
      int key = j0 + kl;
      return kl < block_k && key < kv_valid && (!causal || key <= qpos0 + 8 * h);
    };

    if (rem < nsub) {
      // ---- logits of this warp's keys kl0+kb.. of block b: requant(Q K^T), masked
      int S[NTK][4];
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) S[n][r] = 0;
#pragma unroll
      for (int ks = 0; ks < QREG; ++ks)
        if (ks < dt) qk_step<NTK>(S, qf[ks], tile, cpr, kb, ks, lane);
      for (int ks = QREG; ks < dt; ++ks) {  // heads wider than 128: Q from shared memory
        uint32_t a[4];
        mma::load_a(a, Qs, cpr, 16 * rg, ks, lane);
        qk_step<NTK>(S, a, tile, cpr, kb, ks, lane);
      }
      if (s == 0) bm[0] = bm[1] = -128;
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kl = kl0 + kb + 8 * n + 2 * t;
          int l2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            l2[e] = full || keep(kl + e, h)
                        ? ita::requant_i8(S[n][2 * h + e], logit_mult, logit_shift)
                        : -128;
            bm[h] = max(bm[h], l2[e]);
          }
          *reinterpret_cast<uint16_t*>(lrow_base + (g + 8 * h) * L.lrow + kl) =
              (uint16_t)((l2[0] & 0xff) | ((l2[1] & 0xff) << 8));
        }
      if (s == nsub - 1) {  // block max known: move m, renormalize d and acc
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bm[h] = max(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 1));
          bm[h] = max(bm[h], __shfl_xor_sync(0xffffffffu, bm[h], 2));
        }
        if (KSPLIT > 1) {  // the other half's keys
          if (t == 0) xmax[16 * hf + g] = bm[0], xmax[16 * hf + g + 8] = bm[1];
          __syncthreads();
          bm[0] = max(bm[0], xmax[16 * (1 - hf) + g]);
          bm[1] = max(bm[1], xmax[16 * (1 - hf) + g + 8]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int new_m = max(m_run[h], bm[h]);
          int delta = min(max(new_m - m_run[h], 0), 1 << 12);
          // renorm by 2^0 is the identity, and d, acc are 0 before the
          // first block: skip both
          if (delta != 0 && m_run[h] != M_SENTINEL) {
            d_run[h] = renorm(rlut, d_run[h], delta);
#pragma unroll
            for (int c = 0; c < CG; ++c)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  acc[c][j][2 * h + e] = renorm(rlut, acc[c][j][2 * h + e], delta);
          }
          m_run[h] = new_m;
          sum[h] = 0;
        }
      }
    } else {
      // ---- acc += P V over keys kl0..kl0+KS-1 of block b
      // P of the 32-key step at key kq of the block, as an A fragment
      auto p_frag = [&](uint32_t pa[4], int kq) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // a0: row g, a1: row g+8, a2/a3: keys +16
          const int h = r & 1, koff = kq + 4 * t + 16 * (r >> 1);
          uint32_t lw =
              *reinterpret_cast<const uint32_t*>(lrow_base + (g + 8 * h) * L.lrow + koff);
          uint32_t p = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // m >= every logit of the block: t = m - l in [0, 255]
            int val = exp_t[m_run[h] - (int)(int8_t)(lw >> (8 * i))];
            if (!full && !keep(koff + i, h)) val = 0;
            sum[h] += val;
            p |= (uint32_t)val << (8 * i);
          }
          pa[r] = p;
        }
      };
      if (KSPLIT > 1) {  // this warp's keys kb.. of the sub-tile, shared through ptile
#pragma unroll
        for (int st = 0; st < KW / 32; ++st) {
          uint32_t pa[4];
          p_frag(pa, kl0 + kb + 32 * st);
#pragma unroll
          for (int r = 0; r < 4; ++r)  // row g + 8 (r & 1), chunk (kb + 32 st) / 16 + (r >> 1)
            *reinterpret_cast<uint32_t*>(
                ptile +
                16 * mma::swz((g + 8 * (r & 1)) * (KS / 16) + (kb + 32 * st) / 16 + (r >> 1)) +
                4 * t) = pa[r];
        }
        __syncthreads();
      }
#pragma unroll
      for (int kk = 0; kk < KS / 32; ++kk) {
        uint32_t pa[4];
        if (KSPLIT == 1) p_frag(pa, kl0 + 32 * kk);
        else mma::load_a(pa, ptile, KS / 16, 0, kk, lane);
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          const int grp = cg0 + c;
          if (dcol0 + 32 * grp >= D) continue;
          uint32_t b0[4], b1[4];
          mma::load_b_transposed(b0, b1, tile + 32 * kk * DV, voff[c]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma::mma_s8(acc[c][j], pa, b0[j], b1[j]);
        }
      }
      if (s == nsub - 1) {  // block done: denominator, then the 2^21 guard
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        }
        if (KSPLIT > 1) {  // the other half's keys
          if (t == 0) xsum[16 * hf + g] = sum[0], xsum[16 * hf + g + 8] = sum[1];
          __syncthreads();
          sum[0] += xsum[16 * (1 - hf) + g];
          sum[1] += xsum[16 * (1 - hf) + g + 8];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int d_new = ita::wadd(d_run[h], sum[h]);
          bool over = d_new > RESCALE_THRESH;
          d_run[h] = over ? ita::rshift_round(d_new, 8) : d_new;
          if (over) {
#pragma unroll
            for (int c = 0; c < CG; ++c)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  acc[c][j][2 * h + e] = ita::rshift_round(acc[c][j][2 * h + e], 8);
          }
        }
      }
    }
  }
  mma::cp_async_wait<0>();

  // finalize: Q7.7 by exact floor division, then the output requant.  n8
  // tile j, fragment column c -> column 4c + j of its 32-column group, so
  // this thread holds 8 consecutive columns of rows g and g + 8.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * rg + g + 8 * h;
    if (row >= Sq) continue;
    const int dv = max(d_run[h], 1);
    const double inv = 1.0 / dv;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col0 = dcol0 + 32 * (cg0 + c) + 8 * t;
      if (col0 >= D) continue;
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        int a = acc[c][i & 3][2 * h + (i >> 2)];
        int quo = ita::floor_div_rcp(a, dv, inv);
        int rem = a - quo * dv;
        int frac = ita::floor_div_rcp((rem << 7) + (dv >> 1), dv, inv);
        uint32_t o = (uint8_t)ita::requant_i8(quo * 128 + frac, out_mult, out_shift);
        if (i < 4) lo |= o << (8 * i);
        else hi |= o << (8 * (i - 4));
      }
      int8_t* dst = out + ((size_t)bh * Sq + row) * D + col0;
      if (D % 8 == 0) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (col0 + i < D) dst[i] = (int8_t)((i < 4 ? lo : hi) >> (8 * (i & 3)));
      }
    }
  }
}

template <int KSPLIT>
int launch(const void* q, const void* k, const void* v, const void* luts, void* out, int Sq,
           int Sk, int D, int group, int logit_mult, int logit_shift, int out_mult,
           int out_shift, int causal, int block_k, int kv_valid, int qw, int nstage, dim3 grid,
           size_t bytes, cudaStream_t stream) {
  if (bytes > 48 * 1024)  // above 48 KB only after an explicit opt-in
    cudaFuncSetAttribute(ita_attention_kernel<KSPLIT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  ita_attention_kernel<KSPLIT><<<grid, 32 * qw * KSPLIT, bytes, stream>>>(
      (const int8_t*)q, (const int8_t*)k, (const int8_t*)v, (const int*)luts, (int8_t*)out,
      Sq, Sk, D, group, logit_mult, logit_shift, out_mult, out_shift, causal, block_k,
      kv_valid, qw, nstage);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch shape comes from the wrapper (ops.attn_grid): `qw` row groups
// of 16 query rows per block, `ksplit` warps per row group (qw * ksplit
// <= 4), a ring of `nstage` sub-tiles, grid_x = BH * ceil(Sq / (16 qw))
// query tiles, grid_y = ceil(D / 64).
extern "C" int ita_attention_launch(const void* q, const void* k, const void* v,
                                    const void* luts, void* out, int BH, int Sq, int Sk, int D,
                                    int group, int logit_mult, int logit_shift,
                                    int out_mult, int out_shift, int causal,
                                    int block_k, int kv_valid, int qw, int ksplit,
                                    int nstage, int grid_x, int grid_y, void* stream) {
  if (qw < 1 || (ksplit != 1 && ksplit != 2) || qw * ksplit > 4 || nstage < 2 ||
      nstage > NSTAGE)
    return (int)cudaErrorInvalidValue;
  const int rows = 16 * qw;
  if (grid_x != BH * ((Sq + rows - 1) / rows) || grid_y != (D + DV - 1) / DV)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = make_layout(qw, block_k, D, nstage).bytes;  // ops.attn_smem mirrors it
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto run = ksplit == 2 ? launch<2> : launch<1>;
  return run(q, k, v, luts, out, Sq, Sk, D, group, logit_mult, logit_shift, out_mult,
             out_shift, causal, block_k, kv_valid, qw, nstage, dim3(grid_x, grid_y), bytes,
             (cudaStream_t)stream);
}
