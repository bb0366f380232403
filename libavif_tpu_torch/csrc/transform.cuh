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
//
// The vector forms (K2) hold one column or row v of the block in a
// thread's registers and compute M v for one pass's matrix M, whose words
// the thread reads from shared memory as 16-byte broadcasts: the direct
// product (n^2 multiply-adds), the diagonal (n), or a partial butterfly
// (about n^2 / 3) where M mirrors itself at every level. For the forward
// DCT, M[i][m-1-k] = (-1)^i M[i][k]: the even rows see v[k] + v[m-1-k],
// the odd rows v[k] - v[m-1-k], and the even rows restricted to the first
// half are the m/2-point forward DCT again. For the inverse,
// M[m-1-i][k] = (-1)^k M[i][k]: the first half of the outputs is E + O
// and the second half, mirrored, E - O, with E the m/2-point inverse of
// the even inputs and O the odd inputs' products. Regrouping a sum is
// exact in the ring of int32 values mod 2^32, so each form gives the
// direct product's wrapped sums bit for bit. ops/wavefront.pass_plan lays
// the words out (butterfly_words: each level's (m/2) x (m/2) odd part,
// row-major, from m = n down, then the 1 x 1 base) and checks the
// symmetry.

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

// How K2 computes one pass (ops/wavefront.py, PASS_*).
enum PassKind : int { kPassDense = 0, kPassDiagonal = 1, kPassForwardButterfly = 2, kPassInverseButterfly = 3 };

__device__ __forceinline__ int4 load_words4(const int32_t* w) { return *reinterpret_cast<const int4*>(w); }

// y = W x for an H x H row-major W in shared memory, 16-byte aligned when
// H >= 2 (one broadcast load feeds four multiply-adds).
template <int H>
__device__ __forceinline__ void matvec(const int32_t* w, const uint32_t (&x)[H], uint32_t (&y)[H]) {
  if constexpr (H == 1) {
    y[0] = (uint32_t)w[0] * x[0];
  } else if constexpr (H == 2) {
    const int4 a = load_words4(w);
    y[0] = (uint32_t)a.x * x[0] + (uint32_t)a.y * x[1];
    y[1] = (uint32_t)a.z * x[0] + (uint32_t)a.w * x[1];
  } else {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      uint32_t acc = 0;
#pragma unroll
      for (int k = 0; k < H; k += 4) {
        const int4 a = load_words4(w + i * H + k);
        acc += (uint32_t)a.x * x[k] + (uint32_t)a.y * x[k + 1] + (uint32_t)a.z * x[k + 2] +
               (uint32_t)a.w * x[k + 3];
      }
      y[i] = acc;
    }
  }
}

// v = M v, M the forward butterfly's words from w (level by level).
template <int M>
__device__ __forceinline__ void forward_butterfly(const int32_t* w, uint32_t (&v)[M]) {
  if constexpr (M == 1) {
    v[0] *= (uint32_t)w[0];
  } else {
    constexpr int H = M / 2;
    uint32_t s[H], d[H], o[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      s[k] = v[k] + v[M - 1 - k];
      d[k] = v[k] - v[M - 1 - k];
    }
    matvec<H>(w, d, o);
    forward_butterfly<H>(w + H * H, s);
#pragma unroll
    for (int i = 0; i < H; ++i) {
      v[2 * i] = s[i];
      v[2 * i + 1] = o[i];
    }
  }
}

// v = M v, M the inverse butterfly's words from w (level by level).
template <int M>
__device__ __forceinline__ void inverse_butterfly(const int32_t* w, uint32_t (&v)[M]) {
  if constexpr (M == 1) {
    v[0] *= (uint32_t)w[0];
  } else {
    constexpr int H = M / 2;
    uint32_t e[H], od[H], o[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      e[k] = v[2 * k];
      od[k] = v[2 * k + 1];
    }
    matvec<H>(w, od, o);
    inverse_butterfly<H>(w + H * H, e);
#pragma unroll
    for (int i = 0; i < H; ++i) {
      v[i] = e[i] + o[i];
      v[M - 1 - i] = e[i] - o[i];
    }
  }
}

// v = M v for one pass of `kind` whose words start at w: a forward pass
// (the butterfly if any is the forward one) or an inverse. The caller
// rounds.
template <int N, bool kInverse>
__device__ __forceinline__ void vector_pass(int kind, const int32_t* w, uint32_t (&v)[N]) {
  if (kind == (kInverse ? kPassInverseButterfly : kPassForwardButterfly)) {
    if constexpr (kInverse) {
      inverse_butterfly<N>(w, v);
    } else {
      forward_butterfly<N>(w, v);
    }
  } else if (kind == kPassDiagonal) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] *= (uint32_t)w[i];
  } else {
    uint32_t y[N];
    matvec<N>(w, v, y);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = y[i];
  }
}

}  // namespace avt
