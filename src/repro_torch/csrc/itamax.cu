// Standalone rowwise ITAMax: int8 logits [R, n] -> int8 A [R, n] in [0, 127].
//
// Replaces the Pallas TPU kernel src/repro/kernels/itamax/kernel.py
// (itamax_pallas, body _itamax_kernel), the softmax stage of the
// paper-faithful attention schedule that materializes 8-bit A before the
// A V product (core/attention.py attention_rowwise_i8).  Per row, in the
// order of core/itamax.py itamax_rowwise: the row max m; t = clip(m - x, 0,
// 2^20); the 8-bit exp LUT with the round-half-up shift; d = max(sum, 1);
// inv = floor((2^23 + d/2) / d); a = clip(rshift_round(val * inv, 16), 0, 127).
//
// What bounds it on an H100: each byte of input is read and each byte of
// output written once from device memory (the row's re-reads hit L1), with
// a dozen integer instructions per element, so it is bound by bytes: at the
// path's shapes, 0.1-25 MB at 3.35 TB/s.  The Pallas kernel took blocks of
// 256 whole rows in VMEM; here rows are independent and short (n <= 2^15),
// so one warp owns a row and reduces the max and the sum with shuffles,
// with no shared state between warps and any number of rows (ragged R).
//
// Design: 256 threads per block, one warp per row, 8 rows per block.  The
// warp walks its row three times (max, sum, write): word loads (4 int8 per
// lane) when n is a multiple of 4, byte loads otherwise.  The 32-entry LUT
// sits in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_arith.cuh"

namespace {

constexpr int NT = 256;
constexpr int ROWS = NT / 32;
constexpr int INV_BITS = 23;
constexpr int A_SHIFT = 16;  // INV_BITS - A_BITS

__device__ __forceinline__ int byte_of(int w, int b) { return (int)(int8_t)(w >> (8 * b)); }

__device__ __forceinline__ int weight(const int* lut, int m, int x) {
  return ita::exp2_lut(lut, min(max(m - x, 0), 1 << 20));
}

__device__ __forceinline__ int a_of(int val, int inv) {
  return max(0, min(127, ita::rshift_round(ita::wmul(val, inv), A_SHIFT)));
}

// VEC = 4: four int8 per lane per step (n % 4 == 0, 4-byte aligned rows);
// VEC = 1: one.
template <int VEC>
__global__ void __launch_bounds__(NT) itamax_kernel(const int8_t* __restrict__ x,
                                                    const int* __restrict__ lut,
                                                    int8_t* __restrict__ out, int R, int n) {
  __shared__ int lut_s[32];
  if (threadIdx.x < 32) lut_s[threadIdx.x] = lut[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= R) return;
  const int8_t* xr = x + row * n;
  int8_t* orow = out + row * n;
  const int steps = n / VEC;

  int m = -128;
  for (int i = lane; i < steps; i += 32) {
    if (VEC == 4) {
      int w = reinterpret_cast<const int*>(xr)[i];
#pragma unroll
      for (int b = 0; b < 4; ++b) m = max(m, byte_of(w, b));
    } else {
      m = max(m, (int)xr[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));

  int d = 0;  // n * 256 <= 2^23: no wrap
  for (int i = lane; i < steps; i += 32) {
    if (VEC == 4) {
      int w = reinterpret_cast<const int*>(xr)[i];
#pragma unroll
      for (int b = 0; b < 4; ++b) d += weight(lut_s, m, byte_of(w, b));
    } else {
      d += weight(lut_s, m, xr[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
  d = max(d, 1);
  const int inv = ((1 << INV_BITS) + (d >> 1)) / d;  // both positive: / floors

  for (int i = lane; i < steps; i += 32) {
    if (VEC == 4) {
      int w = reinterpret_cast<const int*>(xr)[i];
      unsigned o = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        o |= (unsigned)a_of(weight(lut_s, m, byte_of(w, b)), inv) << (8 * b);
      reinterpret_cast<unsigned*>(orow)[i] = o;
    } else {
      orow[i] = (int8_t)a_of(weight(lut_s, m, xr[i]), inv);
    }
  }
}

}  // namespace

// x, out: int8 [R, n], contiguous; lut: int32 [32] (core/itamax.py exp_lut).
extern "C" int itamax_launch(const void* x, const void* lut, void* out, int R, int n,
                             void* stream) {
  if (R <= 0 || n <= 0) return 0;
  dim3 grid((R + ROWS - 1) / ROWS);
  bool words = n % 4 == 0 && ((uintptr_t)x % 4 == 0) && ((uintptr_t)out % 4 == 0);
  if (words)
    itamax_kernel<4><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int*)lut, (int8_t*)out, R, n);
  else
    itamax_kernel<1><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int*)lut, (int8_t*)out, R, n);
  return (int)cudaGetLastError();
}
