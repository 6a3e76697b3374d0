// Standalone elementwise i-GeLU: int8 in -> igelu_int -> requant -> int8 out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/igelu/kernel.py
// (igelu_pallas, body _igelu_kernel): ITA's activation unit for a GELU node
// that the planner could not fuse into its GEMM's epilogue, which happens
// when that GEMM went to the cluster.  out = requant_i8(igelu_int(x; q_b,
// q_c, q_1), mult, shift), with the integer helpers the int8_gemm epilogue
// uses (int_arith.cuh), so both give the same ints.
//
// What bounds it on an H100 (80GB HBM3, 700 W; chip_smoke.py).  The byte
// bound is one byte read and one written per element at 3.35 TB/s: 0.72
// us at the DeiT-Ti-width path's (8*197, 768).  A first version evaluated
// the polynomial and the requant per element (some 25 integer
// instructions) and took 0.0032 ms there.  This design takes 0.0023 ms,
// of which the launch itself (the floor: the same kernel on 16 elements)
// is 0.0016 ms: what remains is about the time the bytes take.
//
// Design: the input is int8, so the whole function is a 256-entry table.
// Each block first builds T[u] for every byte pattern u in shared memory,
// one byte per thread, while its first 16-byte words are already being
// loaded.  The table is 64 words, two to a bank, so 32 lanes' lookups
// cost at most two passes (lanes reading one word share it); one copy per
// lane would make them conflict-free but cost 32 KB of stores per block,
// more than the lookups save at this size.  Then each thread maps `wpt`
// 16-byte words per round of a grid-stride loop: byte extract, lookup,
// pack; the last n % 16 elements go byte by byte.  Words are dealt out
// round-robin over the grid's threads (ops.igelu_grid), so every SM gets
// the same share.
// The Pallas kernel walked (256, 512) blocks and required the shape to
// divide into them; here the tensor is one flat run of any length.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_arith.cuh"

namespace {

constexpr int NT = 256;

struct Params {
  int q_b, q_c, q_1, mult, shift;
};

// four bytes of w through the table
__device__ __forceinline__ unsigned map_word(unsigned w, const uint8_t* tab) {
  int t0 = tab[__byte_perm(w, 0, 0x4440)];
  int t1 = tab[__byte_perm(w, 0, 0x4441)];
  int t2 = tab[__byte_perm(w, 0, 0x4442)];
  int t3 = tab[__byte_perm(w, 0, 0x4443)];
  return __byte_perm(__byte_perm(t0, t1, 0x0040), __byte_perm(t2, t3, 0x0040), 0x5410);
}

// Thread g of the grid (T threads in all) maps words g + k T, k < WPT, of
// each round of WPT * T words: every SM gets the same share, and every
// warp's loads and stores are 512 contiguous bytes.
template <int WPT>
__global__ void __launch_bounds__(NT) igelu_kernel(const int8_t* __restrict__ x,
                                                   int8_t* __restrict__ out,
                                                   long long n_vec, long long n, Params p) {
  __shared__ uint8_t tab[256];  // T[u] by byte pattern u
  const int tid = threadIdx.x;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const long long threads = (long long)gridDim.x * NT;
  const long long g = (long long)blockIdx.x * NT + tid;

  uint4 w[WPT];
  auto load = [&](long long base) {
#pragma unroll
    for (int k = 0; k < WPT; ++k)
      if (base + k * threads < n_vec) w[k] = x4[base + k * threads];
  };
  load(g);  // in flight while the table is built
  tab[tid] = (uint8_t)ita::requant_i8(ita::igelu_int((int)(int8_t)tid, p.q_b, p.q_c, p.q_1),
                                      p.mult, p.shift);
  __syncthreads();

  for (long long base = g; base < n_vec; base += WPT * threads) {
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      if (base + k * threads < n_vec) {
        uint4 v = w[k];
        o4[base + k * threads] = make_uint4(map_word(v.x, tab), map_word(v.y, tab),
                                            map_word(v.z, tab), map_word(v.w, tab));
      }
    }
    if (base + WPT * threads < n_vec) load(base + WPT * threads);
  }
  for (long long i = n_vec * 16 + g; i < n; i += threads)
    out[i] = (int8_t)tab[(uint8_t)x[i]];
}

}  // namespace

// x, out: int8, n elements, contiguous.  `blocks` and `wpt` (16-byte words
// per thread per round: 1 to 3) come from ops.igelu_grid.
extern "C" int igelu_launch(const void* x, void* out, long long n, int q_b, int q_c,
                            int q_1, int mult, int shift, int blocks, int wpt, void* stream) {
  if (n <= 0) return 0;
  if (blocks < 1 || wpt < 1 || wpt > 3) return (int)cudaErrorInvalidValue;
  bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  long long n_vec = aligned ? n / 16 : 0;
  Params p{q_b, q_c, q_1, mult, shift};
  auto kernel = wpt == 3 ? igelu_kernel<3> : wpt == 2 ? igelu_kernel<2> : igelu_kernel<1>;
  kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (int8_t*)out, n_vec, n, p);
  return (int)cudaGetLastError();
}
