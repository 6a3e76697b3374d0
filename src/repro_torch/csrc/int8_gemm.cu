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
// K, N = 128..1536) the work is 0.03-2.4 GOP against 0.2-8 MB of traffic,
// so the int8 tensor-core rate (1979 TOP/s) would make it memory- or
// launch-bound; this first version computes on the CUDA cores with
// __dp4a (4 int8 products per instruction), which is far below that rate
// and makes it compute-bound.  Tensor cores (mma.sync s8 or wgmma) and TMA
// staging are the next step.
//
// Design: one 64x64 output tile per block of 256 threads, each thread
// holding a 4x4 int32 accumulator; 32-deep K slices staged in shared
// memory (A row-major, B transposed so four consecutive k of one column
// form one 32-bit word for __dp4a, rows padded by one word against bank
// conflicts).  Loads are bytewise and bounds-checked, so ragged M, N and
// K need no padding by the caller; zero fill is exact.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_arith.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int ROWW = BK / 4 + 1;  // shared row stride in 32-bit words

__global__ void __launch_bounds__(256) int8_gemm_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ bias, const int32_t* __restrict__ mult,
    const int32_t* __restrict__ shift, int8_t* __restrict__ out, int M, int N,
    int K, int act, int q_b, int q_c, int q_1, int gelu_mult, int gelu_shift) {
  __shared__ int32_t As[BM][ROWW];
  __shared__ int32_t Bs[BN][ROWW];
  int8_t* as8 = reinterpret_cast<int8_t*>(&As[0][0]);
  int8_t* bs8 = reinterpret_cast<int8_t*>(&Bs[0][0]);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM x BK bytes, 8 per thread, consecutive threads on
    // consecutive k of one row.
#pragma unroll
    for (int e = tid; e < BM * BK; e += 256) {
      int r = e / BK, kk = e % BK;
      int gr = m0 + r, gk = k0 + kk;
      as8[r * ROWW * 4 + kk] = (gr < M && gk < K) ? x[(size_t)gr * K + gk] : 0;
    }
    // B tile transposed: Bs[n][k], consecutive threads on consecutive n.
#pragma unroll
    for (int e = tid; e < BN * BK; e += 256) {
      int kk = e / BN, c = e % BN;
      int gk = k0 + kk, gc = n0 + c;
      bs8[c * ROWW * 4 + kk] = (gk < K && gc < N) ? w[(size_t)gk * N + gc] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BK / 4; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int col = n0 + tx + 16 * j;
    if (col >= N) continue;
    int bv = bias[col], mv = mult[col], sv = shift[col];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int row = m0 + ty + 16 * i;
      if (row >= M) continue;
      int a = ita::wadd(acc[i][j], bv);
      int o;
      if (act == 1) {  // ReLU
        o = ita::requant_i8(max(a, 0), mv, sv);
      } else if (act == 2) {  // i-GeLU: requant to the pre-activation grid first
        int pre = ita::requant_i8(a, mv, sv);
        o = ita::requant_i8(ita::igelu_int(pre, q_b, q_c, q_1), gelu_mult, gelu_shift);
      } else {
        o = ita::requant_i8(a, mv, sv);
      }
      out[(size_t)row * N + col] = (int8_t)o;
    }
  }
}

}  // namespace

extern "C" int int8_gemm_launch(const void* x, const void* w, const void* bias,
                                const void* mult, const void* shift, void* out,
                                int M, int N, int K, int act, int q_b, int q_c,
                                int q_1, int gelu_mult, int gelu_shift,
                                void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const int32_t*)bias,
      (const int32_t*)mult, (const int32_t*)shift, (int8_t*)out, M, N, K, act,
      q_b, q_c, q_1, gelu_mult, gelu_shift);
  return (int)cudaGetLastError();
}
