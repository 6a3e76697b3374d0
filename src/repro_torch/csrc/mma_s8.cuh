// Warp-level int8 tensor-core building blocks shared by the int8_gemm and
// ita_attention kernels (sm_80+; built here for sm_90a).
//
// - cp.async 16-byte copies into shared memory (zero fill past the edge);
// - a 16-byte-chunk XOR swizzle of shared tiles (conflict-free ldmatrix
//   on rows of 32, 64 or 128 bytes);
// - ldmatrix.x4 fragment loads;
// - mma.sync m16n8k32 s8 x s8 -> s32, written WITHOUT .satfinite: the
//   int32 accumulator wraps, as the references' int32 sums do;
// - the 4x4 byte transpose that turns four words of four k-rows of an
//   N-contiguous tile (w [K, N], V [keys, D]) into four K-major words, the
//   only layout the int8 MMAs take for B (no ldmatrix .trans for 8-bit).
//
// Fragment layout of m16n8k32 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16 x 32, row-major): a0 = row g, k 4t..4t+3;   a1 = row g+8, same k;
//                           a2 = row g, k 16+4t..;    a3 = row g+8, k 16+4t..
//   B (32 x 8, K-major):    b0 = col g, k 4t..4t+3;   b1 = col g, k 16+4t..
//   C (16 x 8, int32):      c0, c1 = row g, cols 2t, 2t+1; c2, c3 = row g+8.
#pragma once
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; bytes past src_bytes (0 to 16) are zero-filled.
// `src` must be a valid 16-byte-aligned address even when src_bytes is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Physical 16-byte chunk of logical chunk L of a tile stored as rows of
// whole chunks: XOR the chunk's slot within its 128-byte line with the
// line's index (CUTLASS's Swizzle<3,4,3>).  Eight consecutive rows of 32,
// 64 or 128 bytes at one logical chunk land on eight distinct bank groups;
// any row width stays correct (a bijection on each 8-chunk line).
__device__ __forceinline__ int swz(int L) { return L ^ ((L >> 3) & 7); }

// four 8x8 b16 matrices (8 rows of 16 bytes each); lane l gives the row
// address of matrix l / 8, row l % 8; register j gets matrix j's word
// (row lane / 4, bytes 4 * (lane % 4)..+3).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row_addr)));
}

// c += a (16x32 s8) * b (32x8 s8), int32 accumulator, wrapping.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w[i] holds bytes (row i, cols 0..3); afterwards w[j] holds bytes
// (rows 0..3, col j): four k of one column, the K-major B word.
__device__ __forceinline__ void transpose4x4(uint32_t w[4]) {
  uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);  // r0c0 r1c0 r0c1 r1c1
  uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);  // r0c2 r1c2 r0c3 r1c3
  uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);  // r2c0 r3c0 r2c1 r3c1
  uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);  // r2c2 r3c2 r2c3 r3c3
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

// B fragments of four n8 tiles from an N-contiguous tile of swizzled
// rows of `cpr` chunks: rows 4t + i (i = 0..3) and 16 + 4t + i, bytes
// 4g..4g+3 of the 32-column group starting at chunk c0 (even).  n8 tile j,
// column g, is the tile's column 4g + j of the group.  off[] holds this
// lane's eight word offsets, worked out once (b_transposed_offsets): with
// cpr even, the rows 32 m further down keep the same swizzle, so their
// words lie at these offsets plus 32 m rows (the caller moves `tile`).
__device__ __forceinline__ void b_transposed_offsets(int off[8], int cpr, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int c = c0 + (g >> 2), wo = 4 * (g & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    off[i] = 16 * swz((4 * t + i) * cpr + c) + wo;
    off[4 + i] = 16 * swz((16 + 4 * t + i) * cpr + c) + wo;
  }
}
__device__ __forceinline__ void load_b_transposed(uint32_t b0[4], uint32_t b1[4],
                                                  const int8_t* tile, const int off[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b0[i] = *reinterpret_cast<const uint32_t*>(tile + off[i]);
    b1[i] = *reinterpret_cast<const uint32_t*>(tile + off[4 + i]);
  }
  transpose4x4(b0);
  transpose4x4(b1);
}

// A fragment (rows r0..r0+15, k 32 * ks..+31) of a swizzled row-major tile
// of `cpr` chunks per row.
__device__ __forceinline__ void load_a(uint32_t a[4], const int8_t* tile, int cpr, int r0,
                                       int ks, int lane) {
  int r = r0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  int c = 2 * ks + (lane >> 4);
  ldmatrix_x4(a, tile + 16 * swz(r * cpr + c));
}

// B fragments of two n8 tiles (rows n0..n0+15 of a K-contiguous swizzled
// tile, e.g. K [keys, D]): r[0], r[1] = b0, b1 of rows n0..n0+7; r[2],
// r[3] = b0, b1 of rows n0+8..n0+15; k 32 * ks..+31.
__device__ __forceinline__ void load_b_kmajor(uint32_t r[4], const int8_t* tile, int cpr,
                                              int n0, int ks, int lane) {
  int n = n0 + (lane & 7) + 8 * (lane >> 4);
  int c = 2 * ks + ((lane >> 3) & 1);
  ldmatrix_x4(r, tile + 16 * swz(n * cpr + c));
}

}  // namespace mma
