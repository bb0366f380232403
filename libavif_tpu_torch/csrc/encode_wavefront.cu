// K2: the own-format encoder's whole wavefront, one persistent
// cooperative launch per plane group, for Hopper (sm_90a).
//
// Replaces the JAX package's `lax.scan` over anti-diagonals in
// libavif_tpu/codec/recon.py:284-337 (an XLA program), with K1's
// transform (libavif_tpu/ops/pallas_kernels.py:84, here transform.cuh) as
// its inner loop. For every block (r, c) of every plane it:
//
//   - reads its neighbours from the reconstruction already written
//     (wavefront.cuh: the bottom row of (r - 1, c), the right column of
//     (r, c - 1), the bottom-right pixel of (r - 2, c), which is what the
//     JAX package's rolled `toplasts` carry holds; `mid` off the edges);
//   - walks the candidates k = m*T + t in index order: predicts with the
//     m-th searched mode (mode m itself when all 13 are searched, as the
//     JAX package's step does), and for transform t runs the forward
//     transform, the deadzone quantizer sign(c)*((|c| + bias) // step),
//     the dequantizer and the inverse, and reconstructs
//     clip(pred + res, 0, maxv); lossless is the Walsh-Hadamard pair with
//     no quantizer and a final >> 2*log2(n);
//   - costs each candidate SSE((src - cand) >> (depth - 8)) + lam * sum
//     (3 + 2 * min(bitlen|level|, 16)) over nonzero levels, in int64;
//   - keeps the least cost, replacing the best only on a strict
//     improvement, so ties keep the first index as jnp.argmin does;
//   - writes the winner's mode and transform symbols, levels and
//     reconstruction into the (P, Rb, Cb, ...) outputs.
//
// Schedule. The grid is as many CTAs as the card holds at once
// (occupancy x SMs), capped at the P * Rb lanes. CTA b owns lanes b,
// b + G, b + 2G, ... of the flattened (plane, row) list and encodes each
// lane left to right. Block (r, c) waits only for progress[lane - 1] to
// reach c + 1. So a lane's pass depends only on lanes of lower index, and
// with every CTA resident the launch cannot deadlock. A wait longer than
// wavefront.cuh's budget writes the waiting lane (plus one) to the error
// word and traps: a fault in the counters fails the launch, it does not
// hang.
//
// Within a block: 1024 threads in groups of n*n, one thread per
// coefficient (64 groups of 16 at n = 4, 16 of 64 at n = 8, 4 of 256 at
// n = 16, one of 1024 at n = 32). Group g walks candidates g, g + groups,
// ... in index order, keeps its best in registers, and synchronises on
// its own named barrier; the groups' winners merge by (cost, index),
// which keeps the first index on ties. The bases, the directional tables
// (one packed word per entry) and the smooth weights go into shared
// memory once per CTA. The source block of the CTA's next block is
// prefetched with cp.async into the other half of a double buffer while
// this block computes.
//
// Bounds on an H100 SXM (132 SMs x 64 INT32 lanes x 1.98 GHz):
//   - throughput: the transforms' int32 multiply-adds, 4 passes of n^3
//     per candidate: 13 x 4 x 16^3 = 213 K per 16x16 block at speed 6,
//     327 M for a 768x512 luma plane, 0.0196 ms at the whole card's rate;
//     its bytes (sources in; levels, reconstruction and symbols out,
//     about 4.7 MB) take 0.0014 ms at 3.35 TB/s;
//   - chain: the Rb + Cb - 1 blocks of the longest dependency chain run
//     one after another, each at best at one SM's rate: 79 x 213 K /
//     (64 x 1.98 GHz) = 0.13 ms for the same plane.
// The chain bound is the floor: a plane has few lanes (32 rows at 768x512
// luma), so most SMs idle whatever the kernel does. The design gives each
// block a whole SM (the candidates in parallel) to shorten each link of
// the chain, and one launch per plane group replaces the host's launch
// per diagonal (118 a 4:2:0 frame at 768x512).
//
// Tensor cores are not used. The products are exact int32 mod 2^32, and
// IMMA takes int8 operands, so each product would need several limb
// products; a block's transform is 16x16x16, under wgmma's 64-row tile;
// and arithmetic is not what bounds K2: the chain and the
// synchronisation are.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "transform.cuh"
#include "wavefront.cuh"

namespace {

constexpr int kMaxModes = 13;
constexpr int kMaxTx = 5;
constexpr int kThreads = 1024;

// Mirror of wavefront._StepParams (ctypes).
struct StepParams {
  int p, rb, cb, n, depth, lossless, dc_step, ac_step, lam, n_modes, n_tx;
  int modes[kMaxModes];       // the symbol coded for search index m
  int pred_modes[kMaxModes];  // the mode search index m predicts with
  int tx_syms[kMaxTx];
};

template <int N>
struct Geometry {
  static constexpr int kElems = N * N;
  static constexpr int kGroups = kThreads / kElems;
  // Threads per barrier: one group from n = 16 up; two groups of 64 at
  // n = 8 (16 groups would need more than the 15 named barriers); the
  // warp that holds two groups of 16 at n = 4.
  static constexpr int kSync = kElems >= 128 ? kElems : kElems == 64 ? 128 : 32;
  static constexpr int kLog2 = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
};

// Bytes of dynamic shared memory for n_tx searched transforms.
template <int N>
constexpr size_t smem_bytes(int n_tx) {
  using G = Geometry<N>;
  return sizeof(long long) * (32 + G::kGroups) +
         sizeof(int32_t) * (G::kGroups + 2 * N + 4 + 2 * G::kElems + 2 * kThreads +
                            4 * n_tx * G::kElems + 6 * G::kElems + N);
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

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(K) : "memory");
}

// Barrier of the candidate group that holds thread tid.
template <int N>
__device__ __forceinline__ void group_sync(int tid) {
  using G = Geometry<N>;
  if constexpr (G::kSync == kThreads) {
    __syncthreads();
  } else if constexpr (G::kSync == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + tid / G::kSync), "n"(G::kSync) : "memory");
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
    group_sync<N>(tid);
    const int first = (tid / E) * kWarps;
    v = 0;
#pragma unroll 8
    for (int w = 0; w < kWarps; ++w) v += s_red[first + w];
  }
  return v;
}

// recon is read back during the launch (wavefront.cuh), so it is neither
// const nor __restrict__.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
encode_wavefront_kernel(const StepParams prm, const int32_t* __restrict__ src,
                        int32_t* __restrict__ modes_out, int32_t* __restrict__ tx_out,
                        int32_t* __restrict__ levels_out, int32_t* recon, int* progress,
                        const int32_t* __restrict__ table) {
  using G = Geometry<N>;
  constexpr int E = G::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_red = reinterpret_cast<long long*>(smem);  // 32 warp partials
  long long* s_win_cost = s_red + 32;                     // per group, for the merge
  int* s_win_k = reinterpret_cast<int*>(s_win_cost + G::kGroups);
  int32_t* s_top = s_win_k + G::kGroups;
  int32_t* s_left = s_top + N;
  int32_t* s_edge = s_left + N;       // [topleft, dc]
  int32_t* s_src = s_edge + 4;        // two source blocks
  int32_t* s_x = s_src + 2 * E;       // per group: transform input
  int32_t* s_t = s_x + kThreads;      // per group: transform intermediate
  int32_t* s_bases = s_t + kThreads;  // per transform: fwd ck, fwd rkT, inv ck, inv rkT
  int32_t* s_dir = s_bases + 4 * prm.n_tx * E;
  int32_t* s_weights = s_dir + 6 * E;

  const int T = prm.n_tx;
  const int K = prm.n_modes * T;
  const int tid = threadIdx.x;
  const int g = tid / E, e = tid % E, i = e / N, j = e % N;
  const int lanes = prm.p * prm.rb;
  const int32_t mid = 1 << (prm.depth - 1);
  const int32_t maxv = (1 << prm.depth) - 1;
  const int dshift = prm.depth - 8;
  int* error = progress + lanes;

  // The constants, once per CTA.
  for (int m = tid; m < 4 * T * E; m += kThreads) {
    const int which = (m / E) & 3, q = m % E;
    // rk (which 1 and 3) is stored transposed for the row pass.
    s_bases[(which & 1) ? m - q + (q % N) * N + q / N : m] = table[m];
  }
  const int32_t* dir = table + 4 * T * E;  // modes 3..8: (use_top, idx, frac), each E
  for (int m = tid; m < 6 * E; m += kThreads) {
    const int32_t* entry = dir + (m / E) * 3 * E + m % E;
    s_dir[m] = entry[0] | (entry[E] << 1) | (entry[2 * E] << 8);
  }
  if (tid < N) s_weights[tid] = dir[18 * E + tid];

  const int32_t step = e == 0 ? prm.dc_step : prm.ac_step;
  const int32_t bias = e == 0 ? prm.dc_step / 2 : prm.ac_step * 3 / 8;
  const int fs1 = prm.lossless ? 0 : 10, fs2 = prm.lossless ? 0 : 11;  // COS_BIT - 2, - 1
  const int is1 = prm.lossless ? 0 : 12, is2 = prm.lossless ? 0 : 15;  // COS_BIT, + 3
  int32_t* x = s_x + g * E;
  int32_t* t = s_t + g * E;
  const int iters = (K + G::kGroups - 1) / G::kGroups;

  int lane = blockIdx.x, c = 0, buf = 0;
  if (tid < E && lane < lanes) cp_async4(s_src + e, src + (long long)lane * prm.cb * E + e);
  cp_async_commit();
  while (lane < lanes) {
    const int r = lane % prm.rb;
    int next_lane = lane, next_c = c + 1;
    if (next_c == prm.cb) {
      next_lane += gridDim.x;
      next_c = 0;
    }
    if (tid < E && next_lane < lanes)
      cp_async4(s_src + (buf ^ 1) * E + e, src + ((long long)next_lane * prm.cb + next_c) * E + e);
    cp_async_commit();
    if (tid < 32) {
      if (r > 0 && tid == 0) avt::wait_progress(progress, lane - 1, c + 1, error, lane + 1);
      __syncwarp();
      avt::fetch_neighbors<N>(recon, lane, r, c, prm.cb, mid, s_top, s_left, s_edge, tid);
    }
    cp_async_wait<1>();  // this block's source has landed
    __syncthreads();

    const int32_t tl = s_edge[0], dc = s_edge[1], src_e = s_src[buf * E + e];
    long long best_cost = LLONG_MAX;
    int best_k = K;
    int32_t best_level = 0, best_rec = 0;
    for (int it = 0; it < iters; ++it) {
      const int k = it * G::kGroups + g;
      const bool active = k < K;  // an idle group runs candidate 0 and drops it
      const int kk = active ? k : 0;
      const int32_t* bases = s_bases + 4 * (kk % T) * E;
      const int32_t pred =
          avt::predict<N>(prm.pred_modes[kk / T], i, j, s_top, s_left, tl, dc, s_dir, s_weights);
      x[e] = wrap_add(src_e, -pred);
      group_sync<N>(tid);
      t[e] = avt::column_pass<N>(bases, x, i, j, fs1);
      group_sync<N>(tid);
      const int32_t coef = avt::row_pass<N>(t, bases + E, i, j, fs2);
      int32_t level = coef, deq = coef;
      if (!prm.lossless) {
        const int32_t mag = floor_div(wrap_add(coef < 0 ? wrap_mul(coef, -1) : coef, bias), step);
        level = wrap_mul((coef > 0) - (coef < 0), mag);
        deq = wrap_mul(level, step);
      }
      x[e] = deq;
      group_sync<N>(tid);
      t[e] = avt::column_pass<N>(bases + 2 * E, x, i, j, is1);
      group_sync<N>(tid);
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

    int win = 0;
    if constexpr (G::kGroups > 1) {
      if (e == 0) {
        s_win_cost[g] = best_cost;
        s_win_k[g] = best_k;
      }
      __syncthreads();
      for (int q = 1; q < G::kGroups; ++q)
        if (s_win_cost[q] < s_win_cost[win] ||
            (s_win_cost[q] == s_win_cost[win] && s_win_k[q] < s_win_k[win]))
          win = q;
    }
    if (g == win) {
      const long long blk = (long long)lane * prm.cb + c;
      levels_out[blk * E + e] = best_level;
      recon[blk * E + e] = best_rec;
      if (e == 0) {
        modes_out[blk] = prm.modes[best_k / T];
        tx_out[blk] = prm.tx_syms[best_k % T];
      }
    }
    __syncthreads();
    if (tid == 0) avt::publish_progress(progress, lane, c + 1);
    lane = next_lane;
    c = next_c;
    buf ^= 1;
  }
  cp_async_wait<0>();
}

// Sets the kernel's shared memory and returns in *capacity how many of its
// CTAs the current device holds at once.
template <int N>
cudaError_t prepare(int n_tx, size_t* bytes, int* capacity) {
  *bytes = smem_bytes<N>(n_tx);
  cudaError_t err = cudaFuncSetAttribute(encode_wavefront_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, encode_wavefront_kernel<N>,
                                                        kThreads, *bytes);
  *capacity = per_sm * sms;
  if (err == cudaSuccess && *capacity < 1) err = cudaErrorCooperativeLaunchTooLarge;
  return err;
}

template <int N>
cudaError_t launch(const StepParams& prm, const int32_t* src, int32_t* modes, int32_t* tx,
                   int32_t* levels, int32_t* recon, int* progress, const int32_t* table,
                   cudaStream_t stream) {
  size_t bytes = 0;
  int capacity = 0;
  cudaError_t err = prepare<N>(prm.n_tx, &bytes, &capacity);
  if (err != cudaSuccess) return err;
  const int grid = min(capacity, prm.p * prm.rb);
  void* args[] = {const_cast<StepParams*>(&prm), &src, &modes, &tx, &levels, &recon, &progress,
                  &table};
  err = cudaLaunchCooperativeKernel((const void*)encode_wavefront_kernel<N>, dim3(grid),
                                    dim3(kThreads), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. params: StepParams; src: (P, Rb, Cb, n, n);
// modes, tx: (P, Rb, Cb); levels, recon: (P, Rb, Cb, n, n); progress:
// P * Rb + 1 zeroed words (the per-lane counters, then the error word);
// table: per searched transform the forward and inverse (ck, rk), then the
// directional tables of modes 3..8 and the smooth weights. All int32,
// contiguous, on the current device. Returns a cudaError_t (0 = launched).
extern "C" int avt_encode_wavefront(const void* params, const void* src, void* modes, void* tx,
                                    void* levels, void* recon, void* progress, const void* table,
                                    void* stream) {
  const StepParams& prm = *static_cast<const StepParams*>(params);
  if (prm.n_modes < 1 || prm.n_modes > kMaxModes || prm.n_tx < 1 || prm.n_tx > kMaxTx ||
      prm.depth < 8 || prm.depth > 16 || prm.dc_step < 1 || prm.ac_step < 1 || prm.p < 0 ||
      prm.rb < 0 || prm.cb < 0)
    return (int)cudaErrorInvalidValue;
  if (prm.p * prm.rb == 0 || prm.cb == 0) return 0;
  const auto* s = static_cast<const int32_t*>(src);
  auto* m = static_cast<int32_t*>(modes);
  auto* x = static_cast<int32_t*>(tx);
  auto* l = static_cast<int32_t*>(levels);
  auto* rc = static_cast<int32_t*>(recon);
  auto* pr = static_cast<int*>(progress);
  const auto* tab = static_cast<const int32_t*>(table);
  auto st = static_cast<cudaStream_t>(stream);
  switch (prm.n) {
    case 4: return (int)launch<4>(prm, s, m, x, l, rc, pr, tab, st);
    case 8: return (int)launch<8>(prm, s, m, x, l, rc, pr, tab, st);
    case 16: return (int)launch<16>(prm, s, m, x, l, rc, pr, tab, st);
    case 32: return (int)launch<32>(prm, s, m, x, l, rc, pr, tab, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The largest cooperative grid of the kernel for block size n and n_tx
// searched transforms on the current device, or minus a cudaError_t.
extern "C" int avt_encode_wavefront_capacity(int n, int n_tx) {
  if (n_tx < 1 || n_tx > kMaxTx) return -(int)cudaErrorInvalidValue;
  size_t bytes = 0;
  int capacity = 0;
  cudaError_t err;
  switch (n) {
    case 4: err = prepare<4>(n_tx, &bytes, &capacity); break;
    case 8: err = prepare<8>(n_tx, &bytes, &capacity); break;
    case 16: err = prepare<16>(n_tx, &bytes, &capacity); break;
    case 32: err = prepare<32>(n_tx, &bytes, &capacity); break;
    default: return -(int)cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? capacity : -(int)err;
}
