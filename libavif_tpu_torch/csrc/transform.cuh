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
// One thread computes one output element (i, j), or four along j (the
// *4 forms); the operands are in shared memory, row-major, with rk held
// transposed (rkT[k*N + j] = rk[j][k]) so that the row pass reads along j.
// The 4x4 form computes a 4 x 4 tile of either pass from two k-major
// operands, so that each 16-byte load of one feeds sixteen multiply-adds.

#pragma once

#include <cuda_runtime.h>
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

// Elements (i, j .. j + 3) of round2(ck · x, shift), j a multiple of 4
// and x 16-byte aligned: four outputs share each load of ck.
template <int N>
__device__ __forceinline__ int4 column_pass4(const int32_t* ck, const int32_t* x, int i, int j,
                                             int shift) {
  uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint32_t c = (uint32_t)ck[i * N + k];
    const int4 xv = *reinterpret_cast<const int4*>(x + k * N + j);
    a0 += c * (uint32_t)xv.x;
    a1 += c * (uint32_t)xv.y;
    a2 += c * (uint32_t)xv.z;
    a3 += c * (uint32_t)xv.w;
  }
  return make_int4(round2_wrap(a0, shift), round2_wrap(a1, shift), round2_wrap(a2, shift),
                   round2_wrap(a3, shift));
}

// Elements (i, j .. j + 3) of round2(t · rkᵀ, shift), rkT = rk transposed,
// j a multiple of 4 and rkT 16-byte aligned.
template <int N>
__device__ __forceinline__ int4 row_pass4(const int32_t* t, const int32_t* rkT, int i, int j,
                                          int shift) {
  uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const uint32_t v = (uint32_t)t[i * N + k];
    const int4 r = *reinterpret_cast<const int4*>(rkT + k * N + j);
    a0 += v * (uint32_t)r.x;
    a1 += v * (uint32_t)r.y;
    a2 += v * (uint32_t)r.z;
    a3 += v * (uint32_t)r.w;
  }
  return make_int4(round2_wrap(a0, shift), round2_wrap(a1, shift), round2_wrap(a2, shift),
                   round2_wrap(a3, shift));
}

// Rows i0 .. i0 + 3, columns j0 .. j0 + 3 of round2(a · b, shift) for
// n x n a and b, both held k-major: aT[k*N + i] = a[i][k] and
// b[k*N + j]; i0 and j0 multiples of 4, aT and b 16-byte aligned. The
// column pass is (aT, b) = (ck transposed, x), the row pass (t
// transposed, rkT). Per k: one 16-byte load of each, 16 multiply-adds.
template <int N>
__device__ __forceinline__ void pass4x4(const int32_t* aT, const int32_t* b, int i0, int j0, int shift,
                                        int4 (&rows)[4]) {
  uint32_t acc[4][4] = {};
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int4 av = *reinterpret_cast<const int4*>(aT + k * N + i0);
    const int4 bv = *reinterpret_cast<const int4*>(b + k * N + j0);
    const uint32_t a[4] = {(uint32_t)av.x, (uint32_t)av.y, (uint32_t)av.z, (uint32_t)av.w};
    const uint32_t c[4] = {(uint32_t)bv.x, (uint32_t)bv.y, (uint32_t)bv.z, (uint32_t)bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] += a[r] * c[q];
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rows[r] = make_int4(round2_wrap(acc[r][0], shift), round2_wrap(acc[r][1], shift),
                        round2_wrap(acc[r][2], shift), round2_wrap(acc[r][3], shift));
  }
}

}  // namespace avt
