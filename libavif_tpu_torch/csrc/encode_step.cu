// K2: one wavefront diagonal of the own-format encoder, fused, for Hopper
// (sm_90a).
//
// Replaces the body of the JAX package's `lax.scan` in
// libavif_tpu/codec/recon.py:284-337 (an XLA program), with K1's
// transform (libavif_tpu/ops/pallas_kernels.py:84, here transform.cuh)
// as its inner loop. For diagonal d and every on-plane lane r (block
// (r, d - r)) of each plane p it:
//
//   - reads its neighbours from the carried wavefront state: the top row
//     is lane r-1's bottom row, the left column lane r's right column,
//     the corner lane r-1's carried top-last pixel; `mid` on the top
//     edge and in column 0 (recon.py:_wavefront_neighbors);
//   - walks the candidates k = m*T + t in index order: predicts with the
//     m-th searched mode (mode m itself when all 13 are searched, as the
//     JAX package's step does), and for transform t runs the forward
//     transform, the deadzone quantizer sign(c)*((|c| + bias) // step), the dequantizer and the
//     inverse, and reconstructs clip(pred + res, 0, maxv); lossless is
//     the Walsh-Hadamard pair with no quantizer and a final >> 2*log2(n);
//   - costs each candidate SSE((src - cand) >> (depth - 8)) + lam * sum
//     (3 + 2 * min(bitlen|level|, 16)) over nonzero levels, in int64;
//   - keeps the least cost, replacing the best only on a strict
//     improvement, so ties keep the first index as jnp.argmin does;
//   - writes the winner's mode and transform symbols, levels and
//     reconstruction into the (P, Rb, Cb, ...) outputs at (r, d - r), and
//     the new carry (bottom row, right column, top-last pixel) into the
//     second carry buffer. Off-plane lanes are skipped: no on-plane lane
//     ever reads their carry.
//
// What bounds it on this card: the transforms' int32 multiply-adds,
// 4 passes of n^3 per candidate (13 modes x 4 x 16^3 = 213 K per 16x16
// block at speed 6; 6.8 M for a 32-lane luma diagonal, about 0.41 us at
// 132 SMs x 64 INT32 lanes x 1.98 GHz); its bytes (source block in,
// levels, reconstruction and carry out) are a few hundred KB.
//
// What the design does about it: one launch per diagonal does the whole
// step, so nothing between diagonals goes through device memory but the
// outputs and the carry, and the host issues one launch instead of about
// 290. One CTA per (plane, on-plane lane); one thread per coefficient,
// as in K1. For n <= 8 a CTA runs several candidates at once, one group
// of n*n threads each (16 groups at n = 4, 4 at n = 8), each group
// walking its share of the candidates in index order and keeping its own
// best in registers; the groups' winners are merged by (cost, index),
// which keeps the first index on ties. Shared memory holds the bases of
// every searched transform, the source block, the edges, and per group
// the transform's input and intermediate; a thread keeps its element's
// prediction, level and reconstruction, and the running best, in
// registers, so the 13 x T candidates are never stored. Tensor cores are
// not used: the products are exact int32 with wraparound.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "transform.cuh"

namespace {

constexpr int kMaxModes = 13;
constexpr int kMaxTx = 5;

// Mirror of wavefront._StepParams (ctypes).
struct StepParams {
  int p, rb, cb, n, depth, lossless, dc_step, ac_step, lam, n_modes, n_tx;
  int modes[kMaxModes];       // the symbol coded for search index m
  int pred_modes[kMaxModes];  // the mode search index m predicts with
  int tx_syms[kMaxTx];
};

template <int N>
struct StepGeometry {
  static constexpr int kElems = N * N;
  // Candidate groups per CTA: 256 threads for n <= 16, one 1024-thread group at n = 32.
  static constexpr int kGroups = kElems >= 256 ? 1 : 256 / kElems;
  static constexpr int kThreads = kGroups * kElems;
  static constexpr int kLog2 = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
};

// Bytes of dynamic shared memory for n_tx searched transforms.
template <int N>
constexpr size_t smem_bytes(int n_tx) {
  using G = StepGeometry<N>;
  return sizeof(long long) * (32 + 16) + sizeof(int) * 16 +
         sizeof(int32_t) * (2 * N + 4 + G::kElems + 2 * G::kGroups * G::kElems +
                            4 * n_tx * G::kElems);
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {  // b > 0
  int32_t q = a / b;
  if (a % b != 0 && a < 0) --q;
  return q;
}

// Edge sample q of [topleft, edge[0..n-1], edge[n-1] repeated n times].
template <int N>
__device__ __forceinline__ int32_t extended(const int32_t* edge, int32_t tl, int q) {
  return q == 0 ? tl : edge[min(q - 1, N - 1)];
}

// Prediction of element (i, j) in intra mode `mode` (ops/intra.py).
template <int N>
__device__ __forceinline__ int32_t predict(int mode, int i, int j, const int32_t* top,
                                           const int32_t* left, int32_t tl, int32_t dc,
                                           const int32_t* dir, const int32_t* weights) {
  constexpr int E = N * N;
  switch (mode) {
    case 0:  // DC
      return dc;
    case 1:  // V
      return top[j];
    case 2:  // H
      return left[i];
    case 9: {  // SMOOTH
      const int32_t wi = __ldg(weights + i), wj = __ldg(weights + j);
      const int32_t acc = wi * top[j] + (256 - wi) * left[N - 1] + wj * left[i] + (256 - wj) * top[N - 1];
      return (acc + 256) >> 9;
    }
    case 10: {  // SMOOTH_V
      const int32_t wi = __ldg(weights + i);
      return (wi * top[j] + (256 - wi) * left[N - 1] + 128) >> 8;
    }
    case 11: {  // SMOOTH_H
      const int32_t wj = __ldg(weights + j);
      return (wj * left[i] + (256 - wj) * top[N - 1] + 128) >> 8;
    }
    case 12: {  // PAETH, with the tie order of intra.py:paeth_pred
      const int32_t t = top[j], l = left[i];
      const int32_t base = t + l - tl;
      const int32_t pt = abs(base - t), pl = abs(base - l), ptl = abs(base - tl);
      if (pl <= pt && pl <= ptl) return l;
      return pt <= ptl ? t : tl;
    }
    default: {  // D45..D203: interpolate along the angle (tables.dir_tables)
      const int32_t* tab = dir + (mode - 3) * 3 * E;
      const int e = i * N + j;
      const int32_t use_top = __ldg(tab + e), idx = __ldg(tab + E + e), frac = __ldg(tab + 2 * E + e);
      const int32_t* edge = use_top ? top : left;
      const int32_t e0 = extended<N>(edge, tl, idx);
      const int32_t e1 = extended<N>(edge, tl, min(idx + 1, 2 * N));
      return (e0 * (32 - frac) + e1 * frac + 16) >> 5;
    }
  }
}

// Sum of v over each group of N*N threads; every thread gets its group's sum.
template <int N>
__device__ __forceinline__ long long group_sum(long long v, long long* s_red, int tid) {
  constexpr int E = N * N;
  constexpr int kWidth = E < 32 ? E : 32;
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off, kWidth);
  if constexpr (E > 32) {
    constexpr int kWarps = E / 32;
    if ((tid & 31) == 0) s_red[tid >> 5] = v;
    __syncthreads();
    const int first = (tid / E) * kWarps;
    v = 0;
#pragma unroll 8
    for (int w = 0; w < kWarps; ++w) v += s_red[first + w];
  }
  return v;
}

template <int N>
__global__ void __launch_bounds__(StepGeometry<N>::kThreads)
encode_step_kernel(const StepParams prm, int d, int r_lo, const int32_t* __restrict__ src,
                   const int32_t* __restrict__ bottoms_in, const int32_t* __restrict__ rights_in,
                   const int32_t* __restrict__ toplasts_in, int32_t* __restrict__ bottoms_out,
                   int32_t* __restrict__ rights_out, int32_t* __restrict__ toplasts_out,
                   int32_t* __restrict__ modes_out, int32_t* __restrict__ tx_out,
                   int32_t* __restrict__ levels_out, int32_t* __restrict__ recon_out,
                   const int32_t* __restrict__ table) {
  using G = StepGeometry<N>;
  constexpr int E = G::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_red = reinterpret_cast<long long*>(smem);  // 32 warp partials
  long long* s_win_cost = s_red + 32;                     // per group, for the merge
  int* s_win_k = reinterpret_cast<int*>(s_win_cost + 16);
  int32_t* s_top = s_win_k + 16;
  int32_t* s_left = s_top + N;
  int32_t* s_corner = s_left + N;  // [topleft, dc]
  int32_t* s_src = s_corner + 4;
  int32_t* s_x = s_src + E;                // per group: transform input
  int32_t* s_t = s_x + G::kGroups * E;     // per group: transform intermediate
  int32_t* s_bases = s_t + G::kGroups * E;  // per transform: fwd ck, fwd rkT, inv ck, inv rkT

  const int T = prm.n_tx;
  const int K = prm.n_modes * T;
  const int tid = threadIdx.x;
  const int g = tid / E, e = tid % E, i = e / N, j = e % N;
  const int plane = blockIdx.y;
  const int r = r_lo + blockIdx.x;
  const int c = d - r;
  const int lane = plane * prm.rb + r;
  const long long blk = (long long)lane * prm.cb + c;
  const int32_t mid = 1 << (prm.depth - 1);
  const int32_t maxv = (1 << prm.depth) - 1;
  const int dshift = prm.depth - 8;
  const int32_t* dir = table + 4 * T * E;
  const int32_t* weights = dir + 18 * E;

  for (int m = tid; m < 4 * T * E; m += G::kThreads) {
    const int which = (m / E) & 3, q = m % E;
    const int32_t v = table[m];
    // rk (which 1 and 3) is stored transposed for the row pass.
    s_bases[(which & 1) ? m - q + (q % N) * N + q / N : m] = v;
  }
  if (tid < E) s_src[tid] = src[blk * E + tid];
  if (tid < N) {
    s_top[tid] = r == 0 ? mid : bottoms_in[(lane - 1) * N + tid];
    s_left[tid] = c == 0 ? mid : rights_in[lane * N + tid];
  }
  if (tid == 0) s_corner[0] = (r == 0 || c == 0) ? mid : toplasts_in[lane - 1];
  __syncthreads();
  if (tid == 0) {
    long long s = 0;
    for (int k = 0; k < N; ++k) s += (long long)s_top[k] + s_left[k];
    s_corner[1] = (int32_t)((s + N) >> (G::kLog2 + 1));
  }
  __syncthreads();

  const int32_t tl = s_corner[0], dc = s_corner[1], src_e = s_src[e];
  const int32_t step = e == 0 ? prm.dc_step : prm.ac_step;
  const int32_t bias = e == 0 ? prm.dc_step / 2 : prm.ac_step * 3 / 8;
  const int fs1 = prm.lossless ? 0 : 10, fs2 = prm.lossless ? 0 : 11;  // COS_BIT - 2, - 1
  const int is1 = prm.lossless ? 0 : 12, is2 = prm.lossless ? 0 : 15;  // COS_BIT, + 3
  int32_t* x = s_x + g * E;
  int32_t* t = s_t + g * E;

  long long best_cost = LLONG_MAX;
  int best_k = K;
  int32_t best_level = 0, best_rec = 0;
  const int iters = (K + G::kGroups - 1) / G::kGroups;
  for (int it = 0; it < iters; ++it) {
    const int k = it * G::kGroups + g;
    const bool active = k < K;  // an idle group runs candidate 0 and drops it
    const int kk = active ? k : 0;
    const int tt = kk % T;
    const int32_t* bases = s_bases + 4 * tt * E;
    const int32_t pred = predict<N>(prm.pred_modes[kk / T], i, j, s_top, s_left, tl, dc, dir, weights);
    x[e] = wrap_add(src_e, -pred);
    __syncthreads();
    t[e] = avt::column_pass<N>(bases, x, i, j, fs1);
    __syncthreads();
    const int32_t coef = avt::row_pass<N>(t, bases + E, i, j, fs2);
    int32_t level = coef, deq = coef;
    if (!prm.lossless) {
      const int32_t mag = floor_div(wrap_add(coef < 0 ? wrap_mul(coef, -1) : coef, bias), step);
      level = wrap_mul((coef > 0) - (coef < 0), mag);
      deq = wrap_mul(level, step);
    }
    x[e] = deq;
    __syncthreads();
    t[e] = avt::column_pass<N>(bases + 2 * E, x, i, j, is1);
    __syncthreads();
    int32_t res = avt::row_pass<N>(t, bases + 3 * E, i, j, is2);
    if (prm.lossless) res >>= 2 * G::kLog2;  // H·Hᵀ = n·I per dimension
    const int32_t rec = min(max(wrap_add(pred, res), 0), maxv);
    const int32_t err = wrap_add(src_e, -rec) >> dshift;
    const int32_t a = level < 0 ? wrap_mul(level, -1) : level;
    const int bits = a > 0 ? 3 + 2 * min(32 - __clz(a), 16) : 0;
    const long long cost =
        group_sum<N>((long long)err * err + (long long)prm.lam * bits, s_red, tid);
    if (active && cost < best_cost) {
      best_cost = cost;
      best_k = k;
      best_level = level;
      best_rec = rec;
    }
  }

  if constexpr (G::kGroups > 1) {
    if (e == 0) {
      s_win_cost[g] = best_cost;
      s_win_k[g] = best_k;
    }
    __syncthreads();
    int win = 0;
    for (int q = 1; q < G::kGroups; ++q)
      if (s_win_cost[q] < s_win_cost[win] ||
          (s_win_cost[q] == s_win_cost[win] && s_win_k[q] < s_win_k[win]))
        win = q;
    if (g != win) return;
  }
  levels_out[blk * E + e] = best_level;
  recon_out[blk * E + e] = best_rec;
  if (i == N - 1) bottoms_out[lane * N + j] = best_rec;
  if (j == N - 1) rights_out[lane * N + i] = best_rec;
  if (e == 0) {
    modes_out[blk] = prm.modes[best_k / T];
    tx_out[blk] = prm.tx_syms[best_k % T];
    toplasts_out[lane] = s_top[N - 1];
  }
}

template <int N>
cudaError_t launch(const StepParams& prm, int d, const int32_t* const* in, int32_t* const* out,
                   const int32_t* table, cudaStream_t stream) {
  const int r_lo = max(0, d - prm.cb + 1), r_hi = min(prm.rb - 1, d);
  const dim3 grid(r_hi - r_lo + 1, prm.p);
  const size_t bytes = smem_bytes<N>(prm.n_tx);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        encode_step_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  encode_step_kernel<N><<<grid, StepGeometry<N>::kThreads, bytes, stream>>>(
      prm, d, r_lo, in[0], in[1], in[2], in[3], out[0], out[1], out[2], out[3], out[4], out[5],
      out[6], table);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. params: StepParams; src: (P, Rb, Cb, n, n);
// carry in and out: bottoms (P, Rb, n), rights (P, Rb, n), toplasts
// (P, Rb); modes, tx: (P, Rb, Cb); levels, recon: (P, Rb, Cb, n, n); table:
// per searched transform the forward and inverse (ck, rk), then the
// directional tables of modes 3..8 and the smooth weights. All int32,
// contiguous, on the current device. Returns a cudaError_t (0 = launched).
extern "C" int avt_encode_step(const void* params, int d, const void* src, const void* bottoms_in,
                               const void* rights_in, const void* toplasts_in, void* bottoms_out,
                               void* rights_out, void* toplasts_out, void* modes, void* tx,
                               void* levels, void* recon, const void* table, void* stream) {
  const StepParams& prm = *static_cast<const StepParams*>(params);
  if (prm.p <= 0) return 0;
  if (prm.n_modes < 1 || prm.n_modes > kMaxModes || prm.n_tx < 1 || prm.n_tx > kMaxTx ||
      prm.depth < 8 || prm.depth > 16 || prm.dc_step < 1 || prm.ac_step < 1 || d < 0 ||
      d > prm.rb + prm.cb - 2)
    return (int)cudaErrorInvalidValue;
  const int32_t* in[4] = {static_cast<const int32_t*>(src), static_cast<const int32_t*>(bottoms_in),
                          static_cast<const int32_t*>(rights_in),
                          static_cast<const int32_t*>(toplasts_in)};
  int32_t* out[7] = {static_cast<int32_t*>(bottoms_out), static_cast<int32_t*>(rights_out),
                     static_cast<int32_t*>(toplasts_out), static_cast<int32_t*>(modes),
                     static_cast<int32_t*>(tx), static_cast<int32_t*>(levels),
                     static_cast<int32_t*>(recon)};
  const auto* tab = static_cast<const int32_t*>(table);
  auto s = static_cast<cudaStream_t>(stream);
  switch (prm.n) {
    case 4: return (int)launch<4>(prm, d, in, out, tab, s);
    case 8: return (int)launch<8>(prm, d, in, out, tab, s);
    case 16: return (int)launch<16>(prm, d, in, out, tab, s);
    case 32: return (int)launch<32>(prm, d, in, out, tab, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
