// Standalone elementwise i-GeLU: int8 in -> igelu_int -> requant -> int8 out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/igelu/kernel.py
// (igelu_pallas, body _igelu_kernel): ITA's activation unit for a GELU node
// that the planner could not fuse into its GEMM's epilogue, which happens
// when that GEMM went to the cluster.  out = requant_i8(igelu_int(x; q_b,
// q_c, q_1), mult, shift), with the integer helpers the int8_gemm epilogue
// uses (int_arith.cuh), so both give the same ints.
//
// What bounds it on an H100: one byte read and one written per element and
// some twenty integer instructions, so it is bound by bytes: 2.4 MB at the
// DeiT-Ti-width path's (8*197, 768), under a microsecond at 3.35 TB/s.  The
// Pallas kernel walked (256, 512) blocks and required the shape to divide
// into them; elementwise work has no shape, so here the tensor is one flat
// run of elements of any length.
//
// Design: a grid-stride loop in which each thread loads 16 int8 as one
// 128-bit word and stores 16 results the same way; the last n % 16
// elements (and a misaligned tensor) go byte by byte.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_arith.cuh"

namespace {

constexpr int NT = 256;

struct Params {
  int q_b, q_c, q_1, mult, shift;
};

__device__ __forceinline__ int igelu_i8(int q, const Params& p) {
  return ita::requant_i8(ita::igelu_int(q, p.q_b, p.q_c, p.q_1), p.mult, p.shift);
}

__device__ __forceinline__ unsigned igelu_word(unsigned w, const Params& p) {
  unsigned o = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    int q = (int)(int8_t)(w >> (8 * b));
    o |= ((unsigned)igelu_i8(q, p) & 0xffu) << (8 * b);
  }
  return o;
}

__global__ void __launch_bounds__(NT) igelu_kernel(const int8_t* __restrict__ x,
                                                   int8_t* __restrict__ out,
                                                   long long n_vec, long long n,
                                                   Params p) {
  const long long stride = (long long)gridDim.x * NT;
  const long long tid = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long i = tid; i < n_vec; i += stride) {
    uint4 w = reinterpret_cast<const uint4*>(x)[i];
    w.x = igelu_word(w.x, p);
    w.y = igelu_word(w.y, p);
    w.z = igelu_word(w.z, p);
    w.w = igelu_word(w.w, p);
    reinterpret_cast<uint4*>(out)[i] = w;
  }
  for (long long i = n_vec * 16 + tid; i < n; i += stride) out[i] = (int8_t)igelu_i8(x[i], p);
}

}  // namespace

// x, out: int8, n elements, contiguous.
extern "C" int igelu_launch(const void* x, void* out, long long n, int q_b, int q_c,
                            int q_1, int mult, int shift, void* stream) {
  if (n <= 0) return 0;
  bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  long long n_vec = aligned ? n / 16 : 0;
  long long work = n_vec > 0 ? n_vec : n;
  long long blocks = (work + NT - 1) / NT;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks per SM
  Params p{q_b, q_c, q_1, mult, shift};
  igelu_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (int8_t*)out, n_vec, n, p);
  return (int)cudaGetLastError();
}
