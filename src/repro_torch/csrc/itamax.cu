// Standalone rowwise ITAMax: int8 logits [R, n] -> int8 A [R, n] in [0, 127].
//
// Replaces the Pallas TPU kernel src/repro/kernels/itamax/kernel.py
// (itamax_pallas, body _itamax_kernel), the softmax stage of the
// paper-faithful attention schedule that materializes 8-bit A before the
// A V product (core/attention.py attention_rowwise_i8).  Per row, in the
// order of core/itamax.py itamax_rowwise: the row max m; t = m - x; the
// 8-bit exp LUT with the round-half-up shift; d = max(sum, 1);
// inv = floor((2^23 + d/2) / d); a = clip(rshift_round(val * inv, 16), 0, 127).
//
// What bounds it on an H100 (80GB HBM3, 700 W; chip_smoke.py).  The byte
// bound is 2 bytes per element at 3.35 TB/s.  A first version (one warp per
// row, three walks over the row, the exponential evaluated per element in
// two of them, byte loads when n % 4 != 0) ran some 36 integer
// instructions per element and sat at 3.7-11x that bound: instructions,
// not bytes, set its time.  This design takes 0.0114 ms for Whisper's
// 24576 rows of 512, 1.5x the byte bound; on the shorter tensors the cost
// of a launch (the floor: one row of one element, 0.0026 ms) dominates.
//
// Design:
// - The weight is a table.  The logits are int8 and the kernel has no
//   mask, so t = m - x lies in [0, 255]: W[t] = exp2_lut(lut, t), built
//   once per block from the 32-entry LUT the wrapper passes.  Random
//   lookups from 32 lanes would collide on the banks, so the table is laid
//   out per lane (256 x 32 ints, 32 KB): lane l reads only bank l.
// - A block owns a contiguous run of rows; it stages G = 256 / L rows at a
//   time (L lanes per row) into shared memory with 16-byte cp.async copies
//   of the aligned chunks that cover them, double-buffered, and writes A
//   back in place through the same buffer: every byte of device memory is
//   read once and written once, as whole 16-byte words, for every n.  Only
//   the step's first and last chunk, which it may share with a neighbour,
//   are stored byte by byte.
// - Each lane holds CH chunks of its row in registers for the three
//   passes; the bytes of a chunk that lie outside the row read as -128,
//   and their weight W[m + 128] is taken off the sum once per row.  Rows
//   of up to 32 L chunks share a warp (segmented shuffles for the max and
//   the sum); the wrapper picks the fewest lanes that keep CH <= 4 while
//   every SM still gets a step, since a step's fixed work (copies,
//   barriers, two reductions and a division per row) is then spread over
//   more elements.  Rows of more than 256 chunks take the whole block
//   (L = 256) and reduce across its warps in shared memory.
// - Per element: the max takes int16 pairs (prmt, then a 3-way int16x2
//   max), the sum one lookup, and A one multiply-add; the shift by 16 is
//   the pack itself (byte 2 of each product), see a_of4.
// - The launch shape (rows per block, L, shared bytes) comes from the
//   wrapper (kernels/itamax/ops.py itamax_grid, which this file mirrors).
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_arith.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int NT = 256;
constexpr int WARPS = NT / 32;
constexpr int TAB_BYTES = 256 * 32 * 4;  // W[t] for t in [0, 255], one copy per lane
constexpr int MAX_CH = 9;                // chunks per lane: n <= 2^15 at L = 256
constexpr int MAX_ROW = 1 << 15;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int INV_BITS = 23;
constexpr int A_SHIFT = 16;  // INV_BITS - A_BITS
constexpr int KEEP_CH = 4;  // up to this many chunks a lane keeps its weights for pass 3

struct Geometry {
  int lanes;  // per row: 1, 2, 4, 8, 16, 32, or NT (the whole block)
  int rows;   // rows staged per step (NT / lanes)
  int ch;     // 16-byte chunks per lane
  int stage;  // bytes of one staging buffer
  int bytes;  // dynamic shared memory: the table and two staging buffers
};

// chunks one row may span: n / 16 when rows start 16-byte aligned
int chunks_spanned(int n) { return n % 16 == 0 ? n / 16 : (n + 30) / 16; }

Geometry geometry(int n, int lanes) {
  Geometry g;
  g.lanes = lanes;
  g.rows = NT / lanes;
  g.ch = (chunks_spanned(n) + lanes - 1) / lanes;
  g.stage = 16 * ((g.rows * n + 30) / 16);
  g.bytes = TAB_BYTES + 2 * g.stage;
  return g;
}

// W[m - x] from the lane's copy of the table: `wm` is the byte address of
// W[m] in it, and the entries for consecutive t lie 128 bytes apart
__device__ __forceinline__ int weight(const char* wm, int x) {
  return *reinterpret_cast<const int*>(wm - 128 * x);
}

// byte b of w, sign-extended (prmt's sign-replicate mode)
__device__ __forceinline__ int sbyte(unsigned w, int b) {
  const unsigned sel = b | ((b | 8) << 4) | ((b | 8) << 8) | ((b | 8) << 12);
  int r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(w), "r"(sel));
  return r;
}

// bytes 0..h-1 of a word, h clamped to [0, 4]
__device__ __forceinline__ unsigned bytes_below(int h) {
  h = min(max(h, 0), 4);
  return h == 4 ? 0xffffffffu : (1u << (8 * h)) - 1u;
}

// word q of a chunk (q a constant after unrolling: the chunk stays in registers)
__device__ __forceinline__ unsigned word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// the row max of four int8 in w, as two int16 lanes: bytes 0 and 2, and
// bytes 1 and 3, sign-extended into the halves of a word (prmt)
__device__ __forceinline__ unsigned max4_s16x2(unsigned m2, unsigned w) {
  unsigned lo, hi;
  asm("prmt.b32 %0, %1, 0, 0xA280;" : "=r"(lo) : "r"(w));
  asm("prmt.b32 %0, %1, 0, 0xB391;" : "=r"(hi) : "r"(w));
  return __vimax3_s16x2(m2, lo, hi);
}

// a = clip(rshift_round(val * inv, 16), 0, 127) for four weights of the
// row, packed into the bytes of a word.  A row's weight is at most 256 and
// at most d (its max has weight 256), so val * inv <= val * 2^23 / d +
// val / 2 <= 2^23 + 128: the rounded product p = val * inv + 2^15 has no
// bits above 23 and p >> 16 lies in [0, 128].  So byte 2 of p is that
// shift, the clip's lower bound never bites, and the upper bound only
// turns a byte 0x80 into 0x7f (subtracting bit 7 borrows nothing).
__device__ __forceinline__ unsigned a_of4(int v0, int v1, int v2, int v3, int inv) {
  const int r = 1 << (A_SHIFT - 1);
  const unsigned p0 = ita::wadd(ita::wmul(v0, inv), r), p1 = ita::wadd(ita::wmul(v1, inv), r);
  const unsigned p2 = ita::wadd(ita::wmul(v2, inv), r), p3 = ita::wadd(ita::wmul(v3, inv), r);
  const unsigned a = __byte_perm(__byte_perm(p0, p1, 0x0062), __byte_perm(p2, p3, 0x0062), 0x5410);
  return a - ((a >> 7) & 0x01010101u);
}

// entry t of the per-lane table: 32 copies of v at tab[32 t .. 32 t + 31],
// as eight 16-byte stores; eight consecutive threads (one phase of a
// warp's 16-byte stores) write eight distinct bank groups
__device__ __forceinline__ void fill_lanes(int* tab, int t, int v) {
  const int4 v4 = make_int4(v, v, v, v);
#pragma unroll
  for (int s = 0; s < 8; ++s) reinterpret_cast<int4*>(tab + 32 * t)[(s + t) & 7] = v4;
}

// max or sum over the row's L lanes (a segment of the warp, or the block)
template <bool MAX>
__device__ __forceinline__ int row_reduce(int v, int lanes, int* red) {
  const int width = min(lanes, 32);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < width) {
      int u = __shfl_xor_sync(0xffffffffu, v, o);
      v = MAX ? max(v, u) : v + u;
    }
  }
  if (lanes == NT) {  // uniform over the block
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = red[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v = MAX ? max(v, red[w]) : v + red[w];
  }
  return v;
}

template <int CH>
__global__ void __launch_bounds__(NT) itamax_kernel(const int8_t* __restrict__ x,
                                                    const int* __restrict__ lut,
                                                    int8_t* __restrict__ out, int R, int n,
                                                    int rows_per_block, int lanes, int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red_max[WARPS], red_sum[WARPS];
  int* tab = reinterpret_cast<int*>(smem);  // [t][lane]
  const int tid = threadIdx.x, lane = tid & 31;
  const int G = NT / lanes;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, (long long)R - row0);
  const int steps = (rows + G - 1) / G;
  // byte offsets from here on are relative to the block's first chunk
  // (rows_per_block * n + 16 < 2^31, checked by the launch)
  const long long cbase = (row0 * n) >> 4;
  const int8_t* xb = x + cbase * 16;
  int8_t* ob = out + cbase * 16;
  const int skew = (int)((row0 * n) & 15);
  const int left = (int)min((long long)R * n - cbase * 16, (long long)rows_per_block * n + 16);

  // step s: rows [s G, +G) of this block, bytes [b0, b1), copied as the
  // aligned chunks [b0 / 16, ceil(b1 / 16)) into buffer s % 2
  auto b0_of = [&](int s) { return skew + s * G * n; };
  auto b1_of = [&](int s) { return skew + min((s + 1) * G, rows) * n; };
  auto prefetch = [&](int s) {
    unsigned char* buf = smem + TAB_BYTES + (s & 1) * stage;
    const int c0 = b0_of(s) >> 4, c1 = (b1_of(s) + 15) >> 4;
    for (int c = c0 + tid; c < c1; c += NT)  // the tensor's last chunk may be short
      mma::cp_async16(buf + (c - c0) * 16, xb + c * 16, min(left - c * 16, 16));
    mma::cp_async_commit();
  };

  prefetch(0);
  {  // the weight table, while the first step's copies are in flight
    const int W = ita::exp2_lut(lut, tid);
    fill_lanes(tab, tid, W);
  }
  const char* tl = reinterpret_cast<const char*>(tab + lane);

  const int seg = tid / lanes, j = tid % lanes;
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      prefetch(s + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int b0 = b0_of(s), b1 = b1_of(s);
    unsigned char* buf = smem + TAB_BYTES + (s & 1) * stage;
    const bool live = seg < min(G, rows - s * G);
    const int rs = (b0 & 15) + seg * n;  // the row's first byte in buf

    // the row's chunks into registers; bytes outside the row read as -128
    uint4 v[CH];
    int lo[CH], hi[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int c = (rs >> 4) + j + k * lanes;
      lo[k] = max(rs - 16 * c, 0);
      hi[k] = live ? min(rs + n - 16 * c, 16) : 0;
      v[k] = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
      if (hi[k] > lo[k]) {
        v[k] = *reinterpret_cast<const uint4*>(buf + 16 * c);
        if (lo[k] > 0 || hi[k] < 16) {
          unsigned w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            unsigned keep = bytes_below(hi[k] - 4 * q) & ~bytes_below(lo[k] - 4 * q);
            w[q] = (word(v[k], q) & keep) | (0x80808080u & ~keep);
          }
          v[k] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
    __syncthreads();  // every row's chunks are read before any is overwritten

    unsigned m2 = 0xff80ff80u;  // -128 in both int16 lanes
#pragma unroll
    for (int k = 0; k < CH; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) m2 = max4_s16x2(m2, word(v[k], q));
    }
    int m = max((int)(short)(m2 & 0xffffu), (int)(short)(m2 >> 16));
    m = row_reduce<true>(m, lanes, red_max);

    constexpr bool KEEP = CH <= KEEP_CH;
    int keep_w[KEEP ? CH * 16 : 1];
    const char* wm = tl + 128 * m;
    int d = 0;  // at most 256 per slot, L * CH * 16 * 256 < 2^31: no wrap
#pragma unroll
    for (int k = 0; k < CH; ++k) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        int wt = weight(wm, sbyte(word(v[k], e >> 2), e & 3));
        if (KEEP) keep_w[k * 16 + e] = wt;
        d += wt;
      }
    }
    d = row_reduce<false>(d, lanes, red_sum);
    d -= (lanes * CH * 16 - n) * weight(wm, -128);  // the slots outside the row
    d = max(d, 1);
    const int inv = ((1 << INV_BITS) + (d >> 1)) / d;  // both positive: / floors

#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (hi[k] <= lo[k]) continue;
      int wt[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        wt[e] = KEEP ? keep_w[k * 16 + e] : weight(wm, sbyte(word(v[k], e >> 2), e & 3));
      const uint4 o = make_uint4(a_of4(wt[0], wt[1], wt[2], wt[3], inv),
                                 a_of4(wt[4], wt[5], wt[6], wt[7], inv),
                                 a_of4(wt[8], wt[9], wt[10], wt[11], inv),
                                 a_of4(wt[12], wt[13], wt[14], wt[15], inv));
      unsigned char* dst = buf + 16 * ((rs >> 4) + j + k * lanes);
      if (lo[k] == 0 && hi[k] == 16) {
        *reinterpret_cast<uint4*>(dst) = o;
      } else {  // a chunk shared with a neighbouring row: only this row's bytes
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (e >= lo[k] && e < hi[k]) dst[e] = (unsigned char)(word(o, e >> 2) >> (8 * (e & 3)));
      }
    }
    __syncthreads();

    // A back to device memory: whole chunks as 16-byte words; the step's
    // first and last chunk byte by byte when it shares them
    const int c0 = b0 >> 4, c1 = (b1 + 15) >> 4;
    for (int c = c0 + tid; c < c1; c += NT) {
      const int g = c * 16;
      const unsigned char* src = buf + (c - c0) * 16;
      if (g >= b0 && g + 16 <= b1) {
        *reinterpret_cast<uint4*>(ob + g) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int p = max(g, b0); p < min(g + 16, b1); ++p) ob[p] = (int8_t)src[p - g];
      }
    }
    __syncthreads();  // the buffer is free for step s + 2's copies
  }
}

template <int CH>
int run(const void* x, const void* lut, void* out, int R, int n, int rows_per_block,
        const Geometry& g, cudaStream_t stream) {
  if (g.bytes > 48 * 1024)  // above 48 KB only after an explicit opt-in
    cudaFuncSetAttribute(itamax_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         g.bytes);
  const int grid = (R + rows_per_block - 1) / rows_per_block;
  itamax_kernel<CH><<<grid, NT, g.bytes, stream>>>((const int8_t*)x, (const int*)lut,
                                                   (int8_t*)out, R, n, rows_per_block,
                                                   g.lanes, g.stage);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: int8 [R, n], contiguous, 16-byte aligned; lut: int32 [32]
// (core/itamax.py exp_lut).  The launch shape comes from ops.itamax_grid:
// `rows_per_block` (a multiple of 256 / lanes), `lanes` per row and the
// dynamic shared bytes, which must equal this file's geometry.
extern "C" int itamax_launch(const void* x, const void* lut, void* out, int R, int n,
                             int rows_per_block, int lanes, int smem_bytes, void* stream) {
  if (R <= 0) return 0;
  const bool pow2 = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (n <= 0 || n > MAX_ROW || !(pow2 || lanes == NT)) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(n, lanes);
  if (g.ch < 1 || g.ch > MAX_CH || rows_per_block <= 0 || rows_per_block % g.rows ||
      (long long)rows_per_block * n > (1 << 30) ||
      g.bytes != smem_bytes || g.bytes > SMEM_MAX || (uintptr_t)x % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (g.ch) {
    case 1: return run<1>(x, lut, out, R, n, rows_per_block, g, st);
    case 2: return run<2>(x, lut, out, R, n, rows_per_block, g, st);
    case 3: return run<3>(x, lut, out, R, n, rows_per_block, g, st);
    case 4: return run<4>(x, lut, out, R, n, rows_per_block, g, st);
    case 5: return run<5>(x, lut, out, R, n, rows_per_block, g, st);
    case 6: return run<6>(x, lut, out, R, n, rows_per_block, g, st);
    case 7: return run<7>(x, lut, out, R, n, rows_per_block, g, st);
    case 8: return run<8>(x, lut, out, R, n, rows_per_block, g, st);
    default: return run<9>(x, lut, out, R, n, rows_per_block, g, st);
  }
}
