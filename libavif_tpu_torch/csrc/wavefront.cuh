// The persistent-wavefront scaffold of the port's wavefront kernels:
// per-lane progress counters in device memory, their CTA-scope
// counterparts in shared memory (the decode wavefront's lanes inside one
// CTA), and the intra predictor (ops/intra.py), by element and by column.
//
// A wavefront kernel walks a (P, Rb, Cb) grid of n x n blocks. A lane is
// one block row of one plane, flattened as plane * Rb + r; a CTA walks
// its lanes left to right, and progress[lane] counts the blocks of the
// lane whose outputs are written. Block (r, c) needs the reconstruction of
// (r - 1, c) above it, (r, c - 1) to its left (the same lane, done by the
// same CTA) and (r - 2, c) for its corner, which is done before (r - 1, c)
// publishes.
//
// Ordering. The writer's threads store the block's outputs, meet at a
// __syncthreads (K2: the winning slot's warp and the helper warp at a
// named barrier), and one thread stores c + 1 with release semantics
// (K3 fences before it too). The reader's thread 0 spins with acquire
// loads, then its warp meets at __syncwarp before reading the
// neighbours. The
// reconstruction is written during the kernel, so it is read with
// ld.global.cg (L2), never through __ldg, `const __restrict__` or another
// ld.global.nc path, which may return stale lines.

#pragma once

#include <stdint.h>

namespace avt {

// How long a CTA waits for the lane above before it reports a hang. A
// whole lane's pass takes milliseconds, so only a fault in the counters
// reaches it.
constexpr unsigned long long kWaitBudgetNs = 4000000000ull;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// CTA-scope counterparts, for counters in shared memory that the warps of
// one CTA hand to each other.
__device__ __forceinline__ int load_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release_cta(int* p, int v) {
  asm volatile("st.release.cta.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The `count` threads of the CTA that call it with barrier `id` (1-15)
// meet; their memory accesses before it are performed for each other.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void fail(int* error, int who) {
  atomicExch(error, who);
  __threadfence();
  __trap();
}

// Thread 0 of a CTA: wait until progress[lane] >= count, polling every
// `sleep_ns` (0: as fast as it can). Past the budget, write `who` to
// *error and trap, so that the launch fails instead of hanging.
__device__ __forceinline__ void wait_progress(const int* progress, int lane, int count, int* error,
                                              int who, unsigned sleep_ns = 0) {
  if (load_acquire(progress + lane) >= count) return;
  const unsigned long long t0 = global_ns();
  for (unsigned polls = 1;; ++polls) {
    if (sleep_ns) __nanosleep(sleep_ns);
    if (load_acquire(progress + lane) >= count) return;
    if ((polls & 1023u) == 0 && global_ns() - t0 > kWaitBudgetNs) fail(error, who);
  }
}

// One thread: wait until the shared-memory counter *counter >= count,
// which another warp of the CTA releases; the same budget.
__device__ __forceinline__ void wait_shared(const int* counter, int count, int* error, int who) {
  if (load_acquire_cta(counter) >= count) return;
  const unsigned long long t0 = global_ns();
  for (unsigned polls = 1;; ++polls) {
    if (load_acquire_cta(counter) >= count) return;
    if ((polls & 1023u) == 0 && global_ns() - t0 > kWaitBudgetNs) fail(error, who);
  }
}

// Thread 0 of a CTA, after a __syncthreads that follows every output
// store of the block: publish that the lane's first `count` blocks are
// written.
__device__ __forceinline__ void publish_progress(int* progress, int lane, int count) {
  __threadfence();
  store_release(progress + lane, count);
}

// Edge sample q of [topleft, edge[0..n-1], edge[n-1] repeated n times].
template <int N>
__device__ __forceinline__ int32_t extended(const int32_t* edge, int32_t tl, int q) {
  return q == 0 ? tl : edge[min(q - 1, N - 1)];
}

// A directional prediction from its packed table word
// (use_top | idx << 1 | frac << 8, tables.dir_tables).
template <int N>
__device__ __forceinline__ int32_t directional(int32_t packed, const int32_t* top, const int32_t* left,
                                               int32_t tl) {
  const int idx = (packed >> 1) & 0x7f, frac = packed >> 8;
  const int32_t* edge = (packed & 1) ? top : left;
  const int32_t e0 = extended<N>(edge, tl, idx);
  const int32_t e1 = extended<N>(edge, tl, min(idx + 1, 2 * N));
  return (e0 * (32 - frac) + e1 * frac + 16) >> 5;
}

// Prediction of element (i, j) in intra mode `mode` (ops/intra.py). top,
// left, dir and weights are in shared memory; dir holds, for modes
// D45..D203 (3..8), one word per element: use_top | idx << 1 | frac << 8.
template <int N>
__device__ __forceinline__ int32_t predict(int mode, int i, int j, const int32_t* top,
                                           const int32_t* left, int32_t tl, int32_t dc,
                                           const int32_t* dir, const int32_t* weights) {
  switch (mode) {
    case 0:  // DC
      return dc;
    case 1:  // V
      return top[j];
    case 2:  // H
      return left[i];
    case 9: {  // SMOOTH
      const int32_t wi = weights[i], wj = weights[j];
      const int32_t acc = wi * top[j] + (256 - wi) * left[N - 1] + wj * left[i] + (256 - wj) * top[N - 1];
      return (acc + 256) >> 9;
    }
    case 10: {  // SMOOTH_V
      const int32_t wi = weights[i];
      return (wi * top[j] + (256 - wi) * left[N - 1] + 128) >> 8;
    }
    case 11: {  // SMOOTH_H
      const int32_t wj = weights[j];
      return (wj * left[i] + (256 - wj) * top[N - 1] + 128) >> 8;
    }
    case 12: {  // PAETH, with the tie order of intra.py:paeth_pred
      const int32_t t = top[j], l = left[i];
      const int32_t base = t + l - tl;
      const int32_t pt = abs(base - t), pl = abs(base - l), ptl = abs(base - tl);
      if (pl <= pt && pl <= ptl) return l;
      return pt <= ptl ? t : tl;
    }
    default:  // D45..D203: interpolate along the angle (tables.dir_tables)
      return directional<N>(dir[(mode - 3) * N * N + i * N + j], top, left, tl);
  }
}

// The extended edges of a block for predict_column: [left ext | top ext],
// each 2N + 2 words [topleft, edge[0 .. N-1], edge[N-1] repeated N + 1
// times], so that a directional tap q of `extended` is ext[q] with no
// clamp (tables.dir_tables' idx <= 2N - 1, so q <= 2N).
template <int N>
constexpr int kExtWords = 2 * N + 2;

// A directional table word for predict_column: the tap's offset into the
// extended edges (the top's past the left's) | frac << 8, from the packed
// (use_top, idx, frac) of `predict`.
template <int N>
__device__ __forceinline__ int32_t ext_word(int32_t use_top, int32_t idx, int32_t frac) {
  return (use_top ? kExtWords<N> : 0) + min(idx, 2 * N) + (frac << 8);
}

// Rows row0 .. row0 + R - 1 of column j of the prediction in `mode` (the
// formulas of `predict`), into pred, from the extended edges `ext` and the
// directional words of ext_word: one branch on the mode for the column.
template <int N, int R>
__device__ __forceinline__ void predict_column(int mode, int j, int row0, const int32_t* ext, int32_t dc,
                                               const int32_t* dir, const int32_t* weights, int32_t (&pred)[R]) {
  const int32_t* left = ext + 1 + row0;  // left[q] is row row0 + q's
  const int32_t* top = ext + kExtWords<N> + 1;
  const int32_t tl = ext[0], tj = top[j];
  switch (mode) {
    case 0:
#pragma unroll
      for (int q = 0; q < R; ++q) pred[q] = dc;
      break;
    case 1:
#pragma unroll
      for (int q = 0; q < R; ++q) pred[q] = tj;
      break;
    case 2:
#pragma unroll
      for (int q = 0; q < R; ++q) pred[q] = left[q];
      break;
    case 9: {
      const int32_t wj = weights[j], ln = ext[N], tn = top[N - 1];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int32_t wi = weights[row0 + q];
        pred[q] = (wi * tj + (256 - wi) * ln + wj * left[q] + (256 - wj) * tn + 256) >> 9;
      }
      break;
    }
    case 10: {
      const int32_t ln = ext[N];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int32_t wi = weights[row0 + q];
        pred[q] = (wi * tj + (256 - wi) * ln + 128) >> 8;
      }
      break;
    }
    case 11: {
      const int32_t wj = weights[j], tn = top[N - 1];
#pragma unroll
      for (int q = 0; q < R; ++q) pred[q] = (wj * left[q] + (256 - wj) * tn + 128) >> 8;
      break;
    }
    case 12:
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int32_t l = left[q], base = tj + l - tl;
        const int32_t pt = abs(base - tj), pl = abs(base - l), ptl = abs(base - tl);
        pred[q] = (pl <= pt && pl <= ptl) ? l : (pt <= ptl ? tj : tl);
      }
      break;
    default: {  // D45..D203: interpolate along the angle
      const int32_t* d = dir + (mode - 3) * N * N + row0 * N + j;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int32_t word = d[q * N], off = word & 0xff, frac = word >> 8;
        pred[q] = (ext[off] * (32 - frac) + ext[off + 1] * frac + 16) >> 5;
      }
    }
  }
}

}  // namespace avt
