// int8 GEMM + int32 bias + per-channel fixed-point requant + activation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_gemm/kernel.py
// (int8_gemm_pallas, body _gemm_kernel): ITA's GEMM mode, out[M,N] =
// act(requant(x[M,K] @ w[K,N] + bias)).  The TPU grid's sequential K axis
// (an int32 VMEM accumulator carried across grid steps) becomes a K loop
// inside each thread block; the epilogue (bias, requant, ReLU or i-GeLU
// with its second requant) runs in registers, so the int32 accumulator
// never reaches device memory.
//
// What bounds it on an H100: at the encoder shapes (M = 1024..4096,
// K, N = 128..1536) one call is 0.07-4.8 GOP on 0.2-8 MB, a few
// microseconds at the int8 tensor-core rate (1979 TOP/s) or the memory
// rate; what is left is latency: the K loop's load-to-use chain, the
// epilogue's integer work, and how well a grid of output tiles fills the
// 132 SMs.
//
// Design (csrc/mma_s8.cuh):
// - the products run on the int8 tensor cores, warp-level
//   mma.sync m16n8k32 s8 (no .satfinite: the accumulator wraps as the
//   reference's int32 sum does), each warp a 32x32 (or 16x32) output tile;
// - a 3-stage cp.async ring of 64-deep K slices (16-byte copies, XOR
//   swizzled), one __syncthreads per slice, so the next slices load while
//   the current one multiplies;
// - x tiles feed ldmatrix.x4; w [K, N] is N-contiguous and the int8 MMAs
//   take B only K-major, so B fragments are built in registers by a 4x4
//   byte transpose of four k-rows (__byte_perm), with no copy of w;
// - the block tile (BM x BN) is chosen per call by the wrapper
//   (ops.gemm_grid) so the grid fills the card: 16x32 up to 128x64;
// - ragged edges: out-of-range 16-byte chunks are zero-filled by cp.async;
//   when K or N is not a multiple of 16 (rows not 16-byte aligned) the
//   same loop stages its tiles with masked byte loads instead.  Zero fill
//   is exact: a zero k adds 0, a zero row or column is never stored;
// - the epilogue works on the accumulator fragments; the transpose's
//   column order gives each thread 8 consecutive columns of a row, stored
//   as one 8-byte word when N is a multiple of 8.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_arith.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int BK = 64;      // K bytes per pipeline stage (two m16n8k32 steps)
constexpr int STAGES = 3;   // cp.async ring depth
constexpr int A_CPR = BK / 16;  // 16-byte chunks per staged x row

struct Epi {
  const int32_t* bias;
  const int32_t* mult;
  const int32_t* shift;
  int act, q_b, q_c, q_1, gelu_mult, gelu_shift;
};

__device__ __forceinline__ int epilogue(int acc, int bv, int mv, int sv, const Epi& e) {
  int a = ita::wadd(acc, bv);
  if (e.act == 1) return ita::requant_i8(max(a, 0), mv, sv);  // ReLU
  if (e.act == 2) {  // i-GeLU: requant to the pre-activation grid first
    int pre = ita::requant_i8(a, mv, sv);
    return ita::requant_i8(ita::igelu_int(pre, e.q_b, e.q_c, e.q_1), e.gelu_mult,
                           e.gelu_shift);
  }
  return ita::requant_i8(a, mv, sv);
}

// Stage one K slice [k0, k0 + BK) of x (BM rows) and w (BN columns).
template <int BM, int BN, int NT>
__device__ __forceinline__ void load_stage(int8_t* As, int8_t* Bs, const int8_t* x,
                                           const int8_t* w, int M, int N, int K, int m0,
                                           int n0, int k0, bool vec, int tid) {
  constexpr int B_CPR = BN / 16;
  if (vec) {  // K, N multiples of 16: every chunk is all in range or all out
    for (int e = tid; e < BM * A_CPR; e += NT) {
      int r = e / A_CPR, c = e % A_CPR;
      int gr = m0 + r, gk = k0 + 16 * c;
      bool ok = gr < M && gk < K;
      mma::cp_async16(As + 16 * mma::swz(e), ok ? x + (size_t)gr * K + gk : x, ok ? 16 : 0);
    }
    for (int e = tid; e < BK * B_CPR; e += NT) {
      int r = e / B_CPR, c = e % B_CPR;
      int gk = k0 + r, gn = n0 + 16 * c;
      bool ok = gk < K && gn < N;
      mma::cp_async16(Bs + 16 * mma::swz(e), ok ? w + (size_t)gk * N + gn : w, ok ? 16 : 0);
    }
    return;
  }
  // rows not 16-byte aligned: masked byte loads, zero fill
  for (int e = tid; e < BM * A_CPR; e += NT) {
    int r = e / A_CPR, c = e % A_CPR;
    int gr = m0 + r, gk = k0 + 16 * c;
    uint32_t v[4] = {0, 0, 0, 0};
    if (gr < M)
      for (int b = 0; b < 16 && gk + b < K; ++b)
        v[b >> 2] |= (uint32_t)(uint8_t)x[(size_t)gr * K + gk + b] << (8 * (b & 3));
    *reinterpret_cast<uint4*>(As + 16 * mma::swz(e)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int e = tid; e < BK * B_CPR; e += NT) {
    int r = e / B_CPR, c = e % B_CPR;
    int gk = k0 + r, gn = n0 + 16 * c;
    uint32_t v[4] = {0, 0, 0, 0};
    if (gk < K)
      for (int b = 0; b < 16 && gn + b < N; ++b)
        v[b >> 2] |= (uint32_t)(uint8_t)w[(size_t)gk * N + gn + b] << (8 * (b & 3));
    *reinterpret_cast<uint4*>(Bs + 16 * mma::swz(e)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Block tile BM x BN; warps of WM x 32 (WM = 32, or 16 when BM = 16).
template <int BM, int BN>
__global__ void __launch_bounds__((BM / (BM >= 32 ? 32 : 16)) * (BN / 32) * 32, 1)
    int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Epi epi,
                     int8_t* __restrict__ out, int M, int N, int K) {
  constexpr int WM = BM >= 32 ? 32 : 16;
  constexpr int MT = WM / 16;  // m16 tiles per warp
  constexpr int WARPS_N = BN / 32;
  constexpr int NT = (BM / WM) * WARPS_N * 32;
  constexpr int B_CPR = BN / 16;
  __shared__ __align__(128) int8_t As[STAGES][BM * BK];
  __shared__ __align__(128) int8_t Bs[STAGES][BK * BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool vec = (K % 16 == 0) && (N % 16 == 0);
  const int nk = (K + BK - 1) / BK;
  int boff[8];  // this lane's B words in a stage (rows 32 ks further: + 32 ks * BN)
  mma::b_transposed_offsets(boff, B_CPR, wn / 16, lane);

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<BM, BN, NT>(As[s], Bs[s], x, w, M, N, K, m0, n0, s * BK, vec, tid);
    mma::cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<STAGES - 2>();  // slice kt has landed (this thread's copies)
    __syncthreads();                   // ... everyone's; slot (kt-1) % STAGES is free
    int pre = kt + STAGES - 1;
    if (pre < nk)
      load_stage<BM, BN, NT>(As[pre % STAGES], Bs[pre % STAGES], x, w, M, N, K, m0, n0,
                             pre * BK, vec, tid);
    mma::cp_async_commit();

    const int8_t* as = As[kt % STAGES];
    const int8_t* bs = Bs[kt % STAGES];
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) mma::load_a(a[i], as, A_CPR, wm + 16 * i, ks, lane);
      uint32_t b0[4], b1[4];
      mma::load_b_transposed(b0, b1, bs + 32 * ks * BN, boff);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma::mma_s8(acc[i][j], a[i], b0[j], b1[j]);
    }
  }
  mma::cp_async_wait<0>();

  // epilogue: n8 tile j, fragment column c -> block column wn + 4c + j, so
  // this thread holds columns col0..col0+7 of rows g and g+8 of each m16 tile
  const int g = lane >> 2, t = lane & 3;
  const int col0 = n0 + wn + 8 * t;
  if (col0 >= N) return;
  int bv[8], mv[8], sv[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    int c = min(col0 + q, N - 1);
    bv[q] = epi.bias[c], mv[q] = epi.mult[c], sv[q] = epi.shift[c];
  }
  const bool packed = (N % 8 == 0);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row = m0 + wm + 16 * i + g + 8 * h;
      if (row >= M) continue;
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t o = (uint8_t)epilogue(acc[i][q & 3][2 * h + (q >> 2)], bv[q], mv[q], sv[q], epi);
        if (q < 4) lo |= o << (8 * q);
        else hi |= o << (8 * (q - 4));
      }
      int8_t* dst = out + (size_t)row * N + col0;
      if (packed) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (col0 + q < N) dst[q] = (int8_t)((q < 4 ? lo : hi) >> (8 * (q & 3)));
      }
    }
}

template <int BM, int BN>
int launch(const int8_t* x, const int8_t* w, const Epi& epi, int8_t* out, int M, int N,
           int K, dim3 grid, cudaStream_t stream) {
  constexpr int NT = (BM / (BM >= 32 ? 32 : 16)) * (BN / 32) * 32;
  if (grid.x != (unsigned)((M + BM - 1) / BM) || grid.y != (unsigned)((N + BN - 1) / BN))
    return (int)cudaErrorInvalidValue;
  int8_gemm_kernel<BM, BN><<<grid, NT, 0, stream>>>(x, w, epi, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch shape comes from the wrapper (ops.gemm_grid): block tile
// (bm, bn), one of ops.GEMM_TILES, and the grid that covers (M, N) with it.
extern "C" int int8_gemm_launch(const void* x, const void* w, const void* bias,
                                const void* mult, const void* shift, void* out,
                                int M, int N, int K, int act, int q_b, int q_c,
                                int q_1, int gelu_mult, int gelu_shift, int bm, int bn,
                                int grid_x, int grid_y, void* stream) {
  Epi epi{(const int32_t*)bias, (const int32_t*)mult, (const int32_t*)shift, act, q_b, q_c,
          q_1, gelu_mult, gelu_shift};
  auto xp = (const int8_t*)x;
  auto wp = (const int8_t*)w;
  auto op = (int8_t*)out;
  auto st = (cudaStream_t)stream;
  dim3 grid(grid_x, grid_y);
  if (bm == 128 && bn == 64) return launch<128, 64>(xp, wp, epi, op, M, N, K, grid, st);
  if (bm == 64 && bn == 64) return launch<64, 64>(xp, wp, epi, op, M, N, K, grid, st);
  if (bm == 64 && bn == 32) return launch<64, 32>(xp, wp, epi, op, M, N, K, grid, st);
  if (bm == 32 && bn == 32) return launch<32, 32>(xp, wp, epi, op, M, N, K, grid, st);
  if (bm == 16 && bn == 32) return launch<16, 32>(xp, wp, epi, op, M, N, K, grid, st);
  return (int)cudaErrorInvalidValue;
}
