// The exact integer core of the 2-D fixed-point transform, shared by K1
// (transform2d.cu) and the encode and decode wavefronts
// (encode_wavefront.cu, decode_wavefront.cu).
//
// For an n x n int32 block x and bases ck, rk:
//
//     t   = round2(ck · x, s1)        (column pass)
//     out = round2(t · rkᵀ, s2)       (row pass)
//
// with int32 two's-complement wraparound, as XLA's int32 einsum gives:
// products and sums are taken in uint32, which wraps exactly as int32
// does, and round2(v, b) = (int32)((uint32)v + 2^(b-1)) >> b.
//
// One thread computes one output element (i, j); the operands are in
// shared memory, row-major, with rk held transposed (rkT[k*N + j] =
// rk[j][k]) so that the row pass reads along j.

#pragma once

#include <stdint.h>

namespace avt {

__device__ __forceinline__ int32_t round2_wrap(uint32_t acc, int bits) {
  if (bits == 0) return (int32_t)acc;
  return ((int32_t)(acc + (1u << (bits - 1)))) >> bits;
}

// Element (i, j) of round2(ck · x, shift).
template <int N>
__device__ __forceinline__ int32_t column_pass(const int32_t* ck, const int32_t* x, int i, int j,
                                               int shift) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) acc += (uint32_t)ck[i * N + k] * (uint32_t)x[k * N + j];
  return round2_wrap(acc, shift);
}

// Element (i, j) of round2(t · rkᵀ, shift), with rkT = rk transposed.
template <int N>
__device__ __forceinline__ int32_t row_pass(const int32_t* t, const int32_t* rkT, int i, int j,
                                            int shift) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) acc += (uint32_t)t[i * N + k] * (uint32_t)rkT[k * N + j];
  return round2_wrap(acc, shift);
}

}  // namespace avt
