// K3: the own-format decoder's whole wavefront, one persistent
// cooperative launch per plane group, for Hopper (sm_90a).
//
// Replaces the JAX package's `lax.scan` over anti-diagonals in
// libavif_tpu/codec/recon.py:226-243 (an XLA program) and, for the
// residual synthesis before it (:193-220), K1's inverse transform
// (libavif_tpu/ops/pallas_kernels.py:84, here transform.cuh). For every
// block (r, c) of every plane it:
//
//   - synthesises the residual, which does not depend on the
//     reconstruction, before it waits for any neighbour: lossy levels are
//     dequantized (level * step, int32 wrap), clamped to +-cmax (the
//     hostile-stream guard), and inverted with the signalled transform
//     type only (the symbol clamped to [0, 4]; at n = 32 ADST symbols 1-3
//     mean DCT); lossless levels take the Walsh-Hadamard inverse and a
//     final >> 2*log2(n);
//   - waits for the block above, reads its neighbours from the
//     reconstruction already written (wavefront.cuh), predicts the
//     signalled mode only, and writes clip(pred + res, 0, maxv) into the
//     (P, Rb, Cb, n, n) output.
// The JAX package inverts every type over every block and predicts all 13
// modes, then selects; the values kept are the same.
//
// Schedule: K2's (encode_wavefront.cu). The grid is as many CTAs as the
// card holds at once (occupancy x SMs), capped at the P * Rb lanes; CTA b
// owns lanes b, b + G, ... of the flattened (plane, row) list and decodes
// each lane left to right; block (r, c) waits for progress[lane - 1] to
// reach c + 1, so the launch cannot deadlock, and a wait past
// wavefront.cuh's budget writes the error word and traps.
//
// Within a block: one thread per coefficient, max(n*n, 32) threads (the
// neighbour fetch needs all of warp 0). The inverse bases of the types
// that exist at n (all five up to n = 16, DCT and IDTX at n = 32, H for
// lossless), the directional tables (one packed word per entry) and the
// smooth weights go into shared memory once per CTA. Each thread loads
// its level of the next block, and the next block's mode and transform
// symbols, into registers while the current block computes.
//
// Bounds on an H100 SXM, for a 768x512 luma plane (1536 blocks of 16x16):
//   - bytes: levels in, reconstruction out, 3.1 MB, 0.00094 ms at
//     3.35 TB/s;
//   - operations: two passes of n^3 int32 multiply-adds a block, 12.6 M,
//     0.00075 ms at the card's 16.7 T/s;
//   - chain: the Rb + Cb - 1 = 79 blocks of the longest dependency chain
//     run one after another, each link a release store, an acquire load
//     on another SM and a dependent read of the neighbours from L2.
// The chain is the floor: a block's own work off the chain is a few
// hundred cycles. So the residual runs before the wait, only the
// signalled type and mode are computed, and one launch per plane group
// replaces the host's launches per diagonal (about 290 each, 118
// diagonals a 4:2:0 frame at 768x512).
//
// Tensor cores are not used: the products are exact int32 mod 2^32, and
// the work is a few microseconds of the chain's length.

#include <cuda_runtime.h>
#include <stdint.h>

#include "transform.cuh"
#include "wavefront.cuh"

namespace {

// Mirror of wavefront._DecodeParams (ctypes).
struct DecodeParams {
  int p, rb, cb, n, depth, lossless, dc_step, ac_step, cmax;
};

template <int N>
struct Geometry {
  static constexpr int kElems = N * N;
  static constexpr int kThreads = kElems < 32 ? 32 : kElems;
  static constexpr int kLog2 = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
  // Inverse bases a lossy plane can signal: symbols 0-4 in order up to
  // n = 16; DCT and IDTX at n = 32.
  static constexpr int kSlots = N > 16 ? 2 : 5;
};

template <int N>
__host__ __device__ constexpr int slots(int lossless) {
  return lossless ? 1 : Geometry<N>::kSlots;
}

// Bytes of dynamic shared memory.
template <int N>
constexpr size_t smem_bytes(int lossless) {
  constexpr int E = Geometry<N>::kElems;
  return sizeof(int32_t) * (2 * N + 4 + 2 * E + 2 * slots<N>(lossless) * E + 6 * E + N);
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// The shared-memory slot of a lossy block's transform symbol.
template <int N>
__device__ __forceinline__ int tx_slot(int32_t sym) {
  const int t = min(max(sym, 0), 4);
  if constexpr (N > 16) return t == 4 ? 1 : 0;
  return t;
}

// recon is read back during the launch (wavefront.cuh), so it is neither
// const nor __restrict__. tx_types may be null: every block is DCT.
template <int N>
__global__ void __launch_bounds__(Geometry<N>::kThreads)
decode_wavefront_kernel(const DecodeParams prm, const int32_t* __restrict__ levels,
                        const int32_t* __restrict__ modes, const int32_t* __restrict__ tx_types,
                        int32_t* recon, int* progress, const int32_t* __restrict__ table) {
  using G = Geometry<N>;
  constexpr int E = G::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_top = reinterpret_cast<int32_t*>(smem);
  int32_t* s_left = s_top + N;
  int32_t* s_edge = s_left + N;  // [topleft, dc]
  int32_t* s_x = s_edge + 4;     // the dequantized block
  int32_t* s_t = s_x + E;        // the column pass
  int32_t* s_bases = s_t + E;    // per slot: ck, then rk transposed
  const int n_slots = slots<N>(prm.lossless);
  int32_t* s_dir = s_bases + 2 * n_slots * E;
  int32_t* s_weights = s_dir + 6 * E;

  const int tid = threadIdx.x;
  const bool owner = tid < E;  // at n = 4, threads 16-31 only help fetch
  const int e = owner ? tid : 0, i = e / N, j = e % N;
  const int lanes = prm.p * prm.rb;
  const int32_t mid = 1 << (prm.depth - 1);
  const int32_t maxv = (1 << prm.depth) - 1;
  const int32_t step = e == 0 ? prm.dc_step : prm.ac_step;
  const int s1 = prm.lossless ? 0 : 12, s2 = prm.lossless ? 0 : 15;  // COS_BIT, + 3
  int* error = progress + lanes;

  // The constants, once per CTA; the first __syncthreads below publishes them.
  for (int m = tid; m < 2 * n_slots * E; m += G::kThreads) {
    const int q = m % E;
    s_bases[((m / E) & 1) ? m - q + (q % N) * N + q / N : m] = table[m];
  }
  const int32_t* dir = table + 2 * n_slots * E;  // modes 3..8: (use_top, idx, frac), each E
  for (int m = tid; m < 6 * E; m += G::kThreads) {
    const int32_t* entry = dir + (m / E) * 3 * E + m % E;
    s_dir[m] = entry[0] | (entry[E] << 1) | (entry[2 * E] << 8);
  }
  if (tid < N) s_weights[tid] = dir[18 * E + tid];

  int lane = blockIdx.x, c = 0;
  int32_t level = 0, mode = 0, sym = 0;
  if (lane < lanes) {
    const long long blk = (long long)lane * prm.cb;
    if (owner) level = levels[blk * E + e];
    mode = modes[blk];
    if (tx_types) sym = tx_types[blk];
  }
  while (lane < lanes) {
    const int r = lane % prm.rb;
    const long long blk = (long long)lane * prm.cb + c;
    int next_lane = lane, next_c = c + 1;
    if (next_c == prm.cb) {
      next_lane += gridDim.x;
      next_c = 0;
    }
    // The next block's symbols and level, in flight while this one computes.
    int32_t next_level = 0, next_mode = 0, next_sym = 0;
    if (next_lane < lanes) {
      const long long nb = (long long)next_lane * prm.cb + next_c;
      if (owner) next_level = levels[nb * E + e];
      next_mode = modes[nb];
      if (tx_types) next_sym = tx_types[nb];
    }

    // 1. The residual: no neighbour needed.
    const int32_t* ck = s_bases + 2 * (prm.lossless ? 0 : tx_slot<N>(sym)) * E;
    if (owner) {
      int32_t x = level;
      if (!prm.lossless) x = min(max(wrap_mul(level, step), -prm.cmax), prm.cmax);
      s_x[e] = x;
    }
    __syncthreads();
    if (owner) s_t[e] = avt::column_pass<N>(ck, s_x, i, j, s1);
    __syncthreads();
    int32_t res = 0;
    if (owner) {
      res = avt::row_pass<N>(s_t, ck + E, i, j, s2);
      if (prm.lossless) res >>= 2 * G::kLog2;  // H·Hᵀ = n·I per dimension
    }

    // 2. The neighbours, once the block above is written.
    if (tid < 32) {
      if (r > 0 && tid == 0) avt::wait_progress(progress, lane - 1, c + 1, error, lane + 1);
      __syncwarp();
      avt::fetch_neighbors<N>(recon, lane, r, c, prm.cb, mid, s_top, s_left, s_edge, tid);
    }
    __syncthreads();

    // 3-4. The signalled mode's prediction, and the reconstruction.
    if (owner) {
      const int m = min(max(mode, 0), 12);
      const int32_t pred =
          avt::predict<N>(m, i, j, s_top, s_left, s_edge[0], s_edge[1], s_dir, s_weights);
      recon[blk * E + e] = min(max(wrap_add(pred, res), 0), maxv);
    }
    __syncthreads();
    if (tid == 0) avt::publish_progress(progress, lane, c + 1);
    lane = next_lane;
    c = next_c;
    level = next_level;
    mode = next_mode;
    sym = next_sym;
  }
}

// Sets the kernel's shared memory and returns in *capacity how many of its
// CTAs the current device holds at once.
template <int N>
cudaError_t prepare(int lossless, size_t* bytes, int* capacity) {
  *bytes = smem_bytes<N>(lossless);
  cudaError_t err = cudaFuncSetAttribute(decode_wavefront_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_wavefront_kernel<N>,
                                                        Geometry<N>::kThreads, *bytes);
  *capacity = per_sm * sms;
  if (err == cudaSuccess && *capacity < 1) err = cudaErrorCooperativeLaunchTooLarge;
  return err;
}

template <int N>
cudaError_t launch(const DecodeParams& prm, const int32_t* levels, const int32_t* modes,
                   const int32_t* tx_types, int32_t* recon, int* progress, const int32_t* table,
                   cudaStream_t stream) {
  size_t bytes = 0;
  int capacity = 0;
  cudaError_t err = prepare<N>(prm.lossless, &bytes, &capacity);
  if (err != cudaSuccess) return err;
  const int grid = min(capacity, prm.p * prm.rb);
  void* args[] = {const_cast<DecodeParams*>(&prm), &levels, &modes, &tx_types, &recon, &progress,
                  &table};
  err = cudaLaunchCooperativeKernel((const void*)decode_wavefront_kernel<N>, dim3(grid),
                                    dim3(Geometry<N>::kThreads), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. params: DecodeParams; levels, recon: (P, Rb, Cb,
// n, n); modes, tx_types: (P, Rb, Cb), tx_types null for all-DCT (read only
// when lossy); progress: P * Rb + 1 zeroed words (the per-lane counters,
// then the error word); table: per inverse basis (ck, rk) as K1 takes them,
// then the directional tables of modes 3..8 and the smooth weights. All
// int32, contiguous, on the current device. Returns a cudaError_t (0 =
// launched).
extern "C" int avt_decode_wavefront(const void* params, const void* levels, const void* modes,
                                    const void* tx_types, void* recon, void* progress,
                                    const void* table, void* stream) {
  const DecodeParams& prm = *static_cast<const DecodeParams*>(params);
  if (prm.depth < 8 || prm.depth > 16 || prm.cmax < 1 || prm.p < 0 || prm.rb < 0 || prm.cb < 0)
    return (int)cudaErrorInvalidValue;
  if (prm.p * prm.rb == 0 || prm.cb == 0) return 0;
  const auto* lv = static_cast<const int32_t*>(levels);
  const auto* md = static_cast<const int32_t*>(modes);
  const auto* tx = static_cast<const int32_t*>(tx_types);
  auto* rc = static_cast<int32_t*>(recon);
  auto* pr = static_cast<int*>(progress);
  const auto* tab = static_cast<const int32_t*>(table);
  auto st = static_cast<cudaStream_t>(stream);
  switch (prm.n) {
    case 4: return (int)launch<4>(prm, lv, md, tx, rc, pr, tab, st);
    case 8: return (int)launch<8>(prm, lv, md, tx, rc, pr, tab, st);
    case 16: return (int)launch<16>(prm, lv, md, tx, rc, pr, tab, st);
    case 32: return (int)launch<32>(prm, lv, md, tx, rc, pr, tab, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The largest cooperative grid of the kernel for block size n on the
// current device, or minus a cudaError_t.
extern "C" int avt_decode_wavefront_capacity(int n, int lossless) {
  size_t bytes = 0;
  int capacity = 0;
  cudaError_t err;
  switch (n) {
    case 4: err = prepare<4>(lossless, &bytes, &capacity); break;
    case 8: err = prepare<8>(lossless, &bytes, &capacity); break;
    case 16: err = prepare<16>(lossless, &bytes, &capacity); break;
    case 32: err = prepare<32>(lossless, &bytes, &capacity); break;
    default: return -(int)cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? capacity : -(int)err;
}
