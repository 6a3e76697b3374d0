// Integer arithmetic shared by the ITA kernels: the device-side twins of
// repro_torch/quant/qparams.py (requantize), core/igelu.py (igelu_int)
// and core/itamax.py (exp2 LUT, renormalization, floor division).
//
// Every product or sum that the reference lets wrap in int32 is written
// with unsigned operands here: signed overflow is undefined in C++, while
// the unsigned form wraps exactly as int32 arithmetic in torch and XLA.
#pragma once
#include <stdint.h>

namespace ita {

__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int clamp_i8(int v) { return max(-128, min(127, v)); }

// round(acc * mult / 2^shift), base-2^10 split (qparams.py requantize);
// shift in [10, 31], mult < 2^15.  >> on int is arithmetic in nvcc.
__device__ __forceinline__ int requant_core(int acc, int mult, int shift) {
  int hi = acc >> 10;
  int lo = acc & 1023;
  int b = wmul(hi, mult);
  int c = lo * mult + (1 << (shift - 1));
  return wadd(b, c >> 10) >> (shift - 10);
}
__device__ __forceinline__ int requant_i8(int acc, int mult, int shift) {
  return clamp_i8(requant_core(acc, mult, shift));
}

// i-GeLU polynomial (igelu.py igelu_int) on an int8 pre-activation.
__device__ __forceinline__ int igelu_int(int q, int q_b, int q_c, int q_1) {
  int sgn = (q > 0) - (q < 0);
  int qa = min(abs(q), -q_b);
  int ql = wadd(wmul(qa + q_b, qa + q_b), q_c);
  int qerf = wmul(sgn, ql);
  return (int)(0u - (unsigned)wmul(q, wadd(qerf, q_1)));
}

// round(2^bits * 2^(-t/32)) for t >= 0 (itamax.py _exp2_int, ITAMAX_B = 5),
// from the 32-entry LUT of that function at t = 0..31: the fractional part
// of t/32 indexes the LUT, the integer part is a round-half-up shift.
__device__ __forceinline__ int exp2_lut(const int* lut, int t) {
  int q = min(t >> 5, 31);
  int bias = q > 0 ? (1 << (q - 1)) : 0;
  return (lut[t & 31] + bias) >> q;
}

// floor(a / b) for b > 0, given inv = 1.0 / b in double: |a * inv - a / b|
// < 2^-20, so the floor is off by at most one, and the remainder (exact in
// wrapping int32: its true value lies in [-b, 2b)) corrects it.  Far fewer
// instructions than an integer division when one b divides many a.
__device__ __forceinline__ int floor_div_rcp(int a, int b, double inv) {
  int q = (int)floor((double)a * inv);
  int r = wadd(a, -wmul(q, b));
  if (r < 0) q -= 1;
  else if (r >= b) q += 1;
  return q;
}

// round-half-up right shift for shift in [0, 31] (itamax.py rounding_rshift_safe)
__device__ __forceinline__ int rshift_round(int x, int shift) {
  int bias = shift > 0 ? (1 << (shift - 1)) : 0;
  return wadd(x, bias) >> shift;
}

// floor((x * mult + 512) / 1024), exact in int32 (itamax.py _mul_q10)
__device__ __forceinline__ int mul_q10(int x, int mult) {
  int hi = x >> 10;
  int lo = x & 1023;
  return wadd(wmul(hi, mult), (lo * mult + 512) >> 10);
}

}  // namespace ita
