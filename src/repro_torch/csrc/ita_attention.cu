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
// ALL KV blocks of its rows in order, block_k rows at a time, exactly as
// the TPU grid's sequential KV axis did; KV is never split across thread
// blocks.  The query tiling is free: rows are independent, and a KV block
// that is fully masked for a row leaves that row's state unchanged.
//
// What bounds it on an H100: at the encoder shapes (BH = 32..48, S =
// 128..512, D = 64) the int8 work is 0.07-1.6 GOP on 0.8-4.7 MB, which the
// tensor cores would finish in about a microsecond; this first version
// runs the two products with __dp4a on the CUDA cores and the softmax
// steps with one warp per row, so it is bound by those instructions and
// by the block's serial walk over KV.  Tensor-core products (mma.sync s8)
// for Q K^T and P V are the next step.
//
// Design: one block of 256 threads per (bh, tile of QT query rows).
// Shared memory holds the Q tile, one K block (row-major) and one V block
// (transposed, so four consecutive keys form one __dp4a word), the int32
// logits, the int8 exponentials P, and the running m, d, acc of every
// row.  Rows are padded by one word against bank conflicts.
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_arith.cuh"

namespace {

constexpr int NT = 256;
constexpr int M_SENTINEL = -(1 << 15);
constexpr int RESCALE_THRESH = 1 << 21;


struct Layout {
  int qt, bk, d;
  size_t s_off, acc_off, m_off, dd_off, delta_off, over_off, q_off, k_off,
      vt_off, p_off, bytes;
  __host__ __device__ int qrow() const { return d + 4; }    // bytes
  __host__ __device__ int vtrow() const { return bk + 4; }  // bytes
};

__host__ __device__ Layout make_layout(int qt, int bk, int d) {
  Layout L;
  L.qt = qt, L.bk = bk, L.d = d;
  size_t o = 0;
  L.s_off = o; o += (size_t)qt * bk * 4;
  L.acc_off = o; o += (size_t)qt * d * 4;
  L.m_off = o; o += qt * 4;
  L.dd_off = o; o += qt * 4;
  L.delta_off = o; o += qt * 4;
  L.over_off = o; o += qt * 4;
  L.q_off = o; o += (size_t)qt * (d + 4);
  L.k_off = o; o += (size_t)bk * (d + 4);
  L.vt_off = o; o += (size_t)d * (bk + 4);
  L.p_off = o; o += (size_t)qt * (bk + 4);
  L.bytes = o;
  return L;
}

// x * 2^(-delta/32), delta >= 0 (itamax.py _renorm_factor_apply)
__device__ __forceinline__ int renorm(const int* rlut, int x, int delta) {
  int q = min(delta >> 5, 31);
  return ita::mul_q10(ita::rshift_round(x, q), rlut[delta & 31]);
}

__global__ void __launch_bounds__(NT) ita_attention_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ k,
    const int8_t* __restrict__ v, const int* __restrict__ luts,
    int8_t* __restrict__ out, int Sq, int Sk,
    int D, int group, int logit_mult, int logit_shift, int out_mult,
    int out_shift, int causal, int block_k, int kv_valid, int qt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int lut_s[64];  // 7-bit exp LUT, then 10-bit renorm LUT
  const Layout L = make_layout(qt, block_k, D);
  int* S = reinterpret_cast<int*>(smem + L.s_off);          // [qt][bk]
  int* acc = reinterpret_cast<int*>(smem + L.acc_off);      // [qt][D]
  int* m_s = reinterpret_cast<int*>(smem + L.m_off);        // [qt]
  int* d_s = reinterpret_cast<int*>(smem + L.dd_off);       // [qt]
  int* delta_s = reinterpret_cast<int*>(smem + L.delta_off);
  int* over_s = reinterpret_cast<int*>(smem + L.over_off);
  int8_t* Qs = reinterpret_cast<int8_t*>(smem + L.q_off);   // [qt][D+4]
  int8_t* Ks = reinterpret_cast<int8_t*>(smem + L.k_off);   // [bk][D+4]
  int8_t* Vt = reinterpret_cast<int8_t*>(smem + L.vt_off);  // [D][bk+4]
  int8_t* Ps = reinterpret_cast<int8_t*>(smem + L.p_off);   // [qt][bk+4]
  const int qrow = L.qrow(), vtrow = L.vtrow();
  const int dw = D / 4;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * qt;
  const int kvh = bh / group;
  const int q_offset = Sk - Sq;
  const int8_t* qg = q + (size_t)bh * Sq * D;
  const int8_t* kg = k + (size_t)kvh * Sk * D;
  const int8_t* vg = v + (size_t)kvh * Sk * D;

  // Q tile (rows past Sq are zero and never written back) + state init
  for (int e = tid; e < qt * dw; e += NT) {
    int r = e / dw, c = e % dw;
    int val = 0;
    if (q0 + r < Sq) val = reinterpret_cast<const int*>(qg + (size_t)(q0 + r) * D)[c];
    reinterpret_cast<int*>(Qs + r * qrow)[c] = val;
  }
  for (int e = tid; e < qt * D; e += NT) acc[e] = 0;
  if (tid < 64) lut_s[tid] = luts[tid];
  const int* lut7 = lut_s;
  const int* rlut = lut_s + 32;
  for (int r = tid; r < qt; r += NT) {
    m_s[r] = M_SENTINEL;
    d_s[r] = 0;
  }

  const int last_q = q0 + qt - 1 + q_offset;  // largest global query position
  for (int j0 = 0; j0 < Sk; j0 += block_k) {
    if (causal && j0 > last_q) break;  // every later block is fully masked
    __syncthreads();  // previous block's readers are done with Ks/Vt/Ps
    for (int e = tid; e < block_k * dw; e += NT) {
      int r = e / dw, c = e % dw;
      int kw = reinterpret_cast<const int*>(kg + (size_t)(j0 + r) * D)[c];
      reinterpret_cast<int*>(Ks + r * qrow)[c] = kw;
      int vw = reinterpret_cast<const int*>(vg + (size_t)(j0 + r) * D)[c];
#pragma unroll
      for (int b = 0; b < 4; ++b) Vt[(4 * c + b) * vtrow + r] = (int8_t)(vw >> (8 * b));
    }
    __syncthreads();

    // logits: requant(Q K^T) onto the ITAMax grid, masked entries -> -128
    for (int e = tid; e < qt * block_k; e += NT) {
      int r = e / block_k, c = e % block_k;
      const int* qw = reinterpret_cast<const int*>(Qs + r * qrow);
      const int* kw = reinterpret_cast<const int*>(Ks + c * qrow);
      int s = 0;
      for (int w = 0; w < dw; ++w) s = __dp4a(qw[w], kw[w], s);
      int kpos = j0 + c;
      bool keep = kpos < kv_valid && (!causal || kpos <= q0 + r + q_offset);
      S[e] = keep ? ita::requant_i8(s, logit_mult, logit_shift) : -128;
    }
    __syncthreads();

    // one warp per row: block max, exponentials, denominator, guard
    for (int r = warp; r < qt; r += NT / 32) {
      const int* Sr = S + r * block_k;
      int bm = -128;
      for (int c = lane; c < block_k; c += 32) bm = max(bm, Sr[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) bm = max(bm, __shfl_xor_sync(0xffffffffu, bm, o));
      const int m_old = m_s[r];
      const int new_m = max(m_old, bm);
      const int qpos = q0 + r + q_offset;
      int sum = 0;
      for (int c = lane; c < block_k; c += 32) {
        int kpos = j0 + c;
        bool keep = kpos < kv_valid && (!causal || kpos <= qpos);
        int val = keep ? ita::exp2_lut(lut7, min(max(new_m - Sr[c], 0), 1 << 20)) : 0;
        Ps[r * vtrow + c] = (int8_t)val;
        sum += val;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        int delta = min(max(new_m - m_old, 0), 1 << 12);
        int d_new = ita::wadd(renorm(rlut, d_s[r], delta), sum);
        int over = d_new > RESCALE_THRESH;
        d_s[r] = over ? ita::rshift_round(d_new, 8) : d_new;
        m_s[r] = new_m;
        delta_s[r] = delta;
        over_s[r] = over;
      }
    }
    __syncthreads();

    // acc = renorm(acc) + P V, then the guard's rescale
    for (int e = tid; e < qt * D; e += NT) {
      int r = e / D, c = e % D;
      const int* pw = reinterpret_cast<const int*>(Ps + r * vtrow);
      const int* vw = reinterpret_cast<const int*>(Vt + c * vtrow);
      int s = 0;
      for (int w = 0; w < block_k / 4; ++w) s = __dp4a(pw[w], vw[w], s);
      int a = ita::wadd(renorm(rlut, acc[e], delta_s[r]), s);
      acc[e] = over_s[r] ? ita::rshift_round(a, 8) : a;
    }
  }
  __syncthreads();

  // finalize: Q7.7 by exact floor division, then the output requant
  for (int e = tid; e < qt * D; e += NT) {
    int r = e / D, c = e % D;
    if (q0 + r >= Sq) continue;
    int dv = max(d_s[r], 1);
    int a = acc[e];
    int quo = ita::floor_div(a, dv);
    int rem = a - quo * dv;
    int frac = ita::floor_div((rem << 7) + (dv >> 1), dv);
    int q77 = quo * 128 + frac;
    out[((size_t)bh * Sq + q0 + r) * D + c] = (int8_t)ita::requant_i8(q77, out_mult, out_shift);
  }
}

}  // namespace

// Shared bytes a launch needs, or 0 when no query tile fits in 227 KB.
extern "C" long long ita_attention_smem(int block_k, int d, int* qt_out) {
  for (int qt = 32; qt >= 8; qt /= 2) {
    Layout L = make_layout(qt, block_k, d);
    if (L.bytes <= 227 * 1024) {
      *qt_out = qt;
      return (long long)L.bytes;
    }
  }
  return 0;
}

extern "C" int ita_attention_launch(const void* q, const void* k, const void* v,
                                    const void* luts, void* out, int BH, int Sq, int Sk, int D,
                                    int group, int logit_mult, int logit_shift,
                                    int out_mult, int out_shift, int causal,
                                    int block_k, int kv_valid, void* stream) {
  int qt = 0;
  long long bytes = ita_attention_smem(block_k, D, &qt);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024)  // above 48 KB only after an explicit opt-in
    cudaFuncSetAttribute(ita_attention_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  dim3 grid(BH, (Sq + qt - 1) / qt);
  ita_attention_kernel<<<grid, NT, (size_t)bytes, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const int8_t*)k, (const int8_t*)v, (const int*)luts,
      (int8_t*)out, Sq,
      Sk, D, group, logit_mult, logit_shift, out_mult, out_shift, causal,
      block_k, kv_valid, qt);
  return (int)cudaGetLastError();
}
