// K3: the own-format decoder's whole wavefront, and K4's in-loop filters
// behind it, in one persistent cooperative launch per plane group, for
// Hopper (sm_90a).
//
// Replaces the JAX package's `lax.scan` over anti-diagonals in
// libavif_tpu/codec/recon.py:226-243 (an XLA program), the residual
// synthesis before it (:193-220, K1's inverse,
// libavif_tpu/ops/pallas_kernels.py:84, here transform.cuh), and, when the
// filter stage is on, the deblocking and CDEF passes that follow it
// (libavif_tpu/ops/filters.py:47-59, :95-132, vmapped at
// libavif_tpu/codec/recon.py:483-486; here loop_filter.cuh). The values
// are those of the JAX package: it inverts every type over every block and
// predicts all 13 modes, then selects; this computes the signalled ones.
//
// One launch, three stages:
//
//   1. Residuals, off the chain, on every CTA of the grid: blocks in a
//      grid-stride loop, 2048 coefficients a pass, four of a row a thread
//      (16-byte loads and stores; each load of a basis row serves four
//      outputs). Lossy levels are dequantized (level * step, int32 wrap),
//      clamped to +-cmax (the hostile-stream guard) and inverted with the
//      signalled transform type only (the symbol clamped to [0, 4]; at
//      n = 32 ADST symbols 1-3 mean DCT); lossless levels take the
//      Walsh-Hadamard inverse and a final >> 2*log2(n). Each residual is
//      written into the reconstruction buffer itself, where the chain
//      overwrites it in place with clip(pred + res, 0, maxv), by the
//      thread that reads it.
//   2. One grid barrier (a counter in device memory; the launch is
//      cooperative, so every CTA is resident).
//   3. A work list, built on the host (ops/wavefront.decode_work_list),
//      taken item by item through one atomic counter, so a CTA only ever
//      waits on an item that a resident CTA has already taken:
//        - a lane group: L consecutive lanes (block rows) of one plane,
//          kLaneWarps warps per lane meeting on a named barrier, each lane
//          walked left to right. Per block, lane r waits on a
//          shared-memory counter of lane r - 1 and reads its top row and
//          corner from an edge ring that lane r - 1 fills (kRing slots of
//          the bottom row and the corner; lane r releases a consumer
//          counter that lane r - 1 waits on before it reuses a slot),
//          computes the block's bottom row and right column first and
//          releases them, then the whole block. The corner is the last
//          pixel of the top row that lane r - 1 used, the bottom-right
//          pixel of (r - 2, c) (ROADMAP fault l, kept). The left column
//          is the lane's own previous block. Only the group's first lane
//          waits on another CTA, on the device-memory counter of the lane
//          above (wavefront.cuh: release/acquire, ld.cg, the wait budget),
//          which a helper warp publishes for the group's last lane, as far
//          as every lane of the group is done;
//        - a filter tile (plane, ty, tx), when the filter stage is on: it
//          waits until the group that holds the tile's last halo row has
//          published the block column that covers its last halo column,
//          then runs loop_filter.cuh's tile from the unfiltered
//          reconstruction into the raster output. The list puts each item
//          after everything it waits on, ordered by the diagonal at which
//          it can start, so most tiles finish while the chain still runs.
//
// Layouts: the reconstruction is (P, Rb, Cb, n, n) (decode_wavefront) or
// raster (P, Rb*n, Cb*n) (decode_filtered, which also takes the filter
// stage: the reconstruction is then scratch and the filtered planes go to
// a second raster buffer).
//
// Bounds on an H100 SXM, for a 768x512 luma plane (1536 blocks of 16x16):
//   - bytes: levels in, reconstruction out, 3.1 MB, 0.00094 ms at
//     3.35 TB/s (the symbols add 12 KB);
//   - operations: two passes of n^3 int32 multiply-adds a block, 12.6 M,
//     0.00075 ms at the card's 16.7 T/s; the filters' 36 ops a pixel and
//     32 a deblocking edge add 14 M.
// The dependency chain, Rb + Cb - 1 = 79 blocks, is walked one block
// after another whatever the design, so each link is made short: the
// residual is off it, a link inside a lane group is a shared-memory
// handoff between lanes of one SM, the lane below starts once the bottom
// row is written, and a plane crosses SMs once every L lanes instead of at
// every link. What is left a block is a chain of dependent latencies
// (the waits, the barriers, the predictor's shared loads), which more
// threads a lane do not shorten. The filters run on the SMs the chain
// leaves idle.
//
// Tensor cores are not used: the products are exact int32 mod 2^32.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "loop_filter.cuh"
#include "transform.cuh"
#include "wavefront.cuh"

namespace {

// Mirror of wavefront._DecodeParams (ctypes).
struct DecodeParams {
  int p, rb, cb, n, depth, lossless, dc_step, ac_step, cmax;
  int lanes_per_cta;  // L: lanes of a group, one warp each
  int raster;         // 1: raster reconstruction, 0: (P, Rb, Cb, n, n)
  int filter;         // 1: the filter stage runs (raster only)
  int deblock_thresh, cdef_thresh, deblock, cdef;
  int n_items;  // length of the work list
};

constexpr int kLaneWarps = 2;  // warps a lane
constexpr int kLaneThreads = 32 * kLaneWarps;
constexpr int kMaxLanes = 8;  // named barriers 1-8, one a lane
constexpr int kMaxThreads = kLaneThreads * kMaxLanes + 32;  // the lanes, and the helper warp
constexpr int kRing = 4;  // edge-ring slots: how far a lane may run ahead of the next
constexpr int kPassWords = 2048;  // a residual pass's coefficients (at least one block)
constexpr unsigned kTileSleepNs = 256;  // a filter tile's poll interval

template <int N>
struct Geometry {
  static constexpr int kElems = N * N;
  // A lane's threads take the block's bottom row and right column (2n - 1
  // elements, which the lanes below and to the right need) first.
  static constexpr int kEdgeIters = (2 * N - 1 + kLaneThreads - 1) / kLaneThreads;
  // Then the whole block, lane thread t at column t % n and rows t / n +
  // k * kRows (where a block has fewer elements than the lane threads,
  // the first n * n of them).
  static constexpr int kRows = kLaneThreads / N;
  static constexpr int kIters = kElems > kLaneThreads ? kElems / kLaneThreads : 1;
  static constexpr int kLog2 = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
  // Inverse bases a lossy plane can signal: symbols 0-4 in order up to
  // n = 16; DCT and IDTX at n = 32.
  static constexpr int kSlots = N > 16 ? 2 : 5;
  static constexpr int kPass = kElems < kPassWords ? kPassWords : kElems;  // a residual pass's words
  static constexpr int kEdge = N + 1;  // an edge-ring slot: the bottom row, then the corner
};

// Offsets into dynamic shared memory, in int32 words; the filter tile's
// TileSmem follows at `words` when the filter stage is on.
struct Layout {
  int dir, weights, x, t, ring, top, left, edges, done, consumed, slot, item, words;
};

template <int N>
__host__ __device__ constexpr Layout layout(int lossless) {
  using G = Geometry<N>;
  Layout l{};
  l.dir = 2 * (lossless ? 1 : G::kSlots) * G::kElems;  // the bases come first
  l.weights = l.dir + 6 * G::kElems;
  l.x = l.weights + N;
  l.t = l.x + G::kPass;
  l.ring = l.t + G::kPass;
  l.top = l.ring + kMaxLanes * kRing * G::kEdge;
  l.left = l.top + kMaxLanes * G::kEdge;  // two columns a lane, alternating
  l.edges = l.left + kMaxLanes * 2 * N;
  l.done = l.edges + kMaxLanes;
  l.consumed = l.done + kMaxLanes;
  l.slot = l.consumed + kMaxLanes;
  l.item = l.slot + kPassWords / 16;  // a pass holds at most this many blocks
  l.words = l.item + 4;
  return l;
}

template <int N>
size_t smem_bytes(int lossless, int filter) {
  return sizeof(int32_t) * layout<N>(lossless).words + (filter ? sizeof(avt::lf::TileSmem) : 0);
}

// Where element (i, j) of block c of a lane lies, from the lane's start.
struct Strides {
  long long lane;
  int col, row;
};

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

// Edge element q of a block: the bottom row, then the right column above
// it.
template <int N>
__device__ __forceinline__ void edge_at(int q, int& i, int& j) {
  i = q < N ? N - 1 : q - N;
  j = q < N ? q : N - 1;
}

// What one block's elements need besides their residuals.
struct BlockView {
  const int32_t* top;   // the top row, then the corner candidate at [N]
  const int32_t* left;  // the left column
  int32_t tl, dc, maxv;
  int32_t* rec;         // element (0, 0) of the block
  int row;              // the reconstruction's row stride
  int32_t* next_left;   // the right column, for the lane's next block
  int32_t* edge_out;    // the bottom row, for the lane below (null: none)
};

// Every pointer is generic, so a store could alias any later load: each
// pass computes its elements first and stores them after, or the compiler
// runs them one after another.

// The block's bottom row and right column (lane thread t's edge elements
// q = t + kLaneThreads k), predicted in mode M (ops/intra.py): clip(pred + res) into the
// reconstruction, the lane's next left column and the lane below's ring.
template <int N, int M>
__device__ __forceinline__ void block_edges(const BlockView& b, const int32_t* res, int t,
                                            const int32_t* s_dir, const int32_t* s_weights) {
  using G = Geometry<N>;
  int32_t v[G::kEdgeIters];
#pragma unroll
  for (int k = 0; k < G::kEdgeIters; ++k) {
    int i, j;
    edge_at<N>(min(t + kLaneThreads * k, 2 * N - 2), i, j);
    const int32_t pred = avt::predict<N>(M, i, j, b.top, b.left, b.tl, b.dc, s_dir, s_weights);
    v[k] = min(max(wrap_add(pred, res[k]), 0), b.maxv);
  }
#pragma unroll
  for (int k = 0; k < G::kEdgeIters; ++k) {
    if (t + kLaneThreads * k < 2 * N - 1) {
      int i, j;
      edge_at<N>(t + kLaneThreads * k, i, j);
      b.rec[i * b.row + j] = v[k];
      if (j == N - 1) b.next_left[i] = v[k];
      if (b.edge_out && i == N - 1) b.edge_out[j] = v[k];
    }
  }
}

// Iterations K0 .. K1 - 1 of the whole block, lane thread t at column t % n,
// rows t / n + k * kRows, into the reconstruction (the edges again, with
// the same values), eight at a time.
template <int N, int M, int K0, int K1>
__device__ __forceinline__ void block_rows(const BlockView& b, const int32_t* res, int t,
                                           const int32_t* s_dir, const int32_t* s_weights) {
  using G = Geometry<N>;
  if constexpr (K1 - K0 > 8) {
    block_rows<N, M, K0, K0 + 8>(b, res, t, s_dir, s_weights);
    block_rows<N, M, K0 + 8, K1>(b, res, t, s_dir, s_weights);
  } else {
    const int i0 = t / N, j = t % N;
    int32_t v[K1 - K0];
#pragma unroll
    for (int k = K0; k < K1; ++k) {
      const int i = min(i0 + k * G::kRows, N - 1);
      const int32_t pred = avt::predict<N>(M, i, j, b.top, b.left, b.tl, b.dc, s_dir, s_weights);
      v[k - K0] = min(max(wrap_add(pred, res[k]), 0), b.maxv);
    }
    int32_t* out = b.rec + i0 * b.row + j;
#pragma unroll
    for (int k = K0; k < K1; ++k)
      if (i0 + k * G::kRows < N) out[k * G::kRows * b.row] = v[k - K0];
  }
}

// The block's elements with the mode a run-time value: one switch a pass,
// not one an element. kEdges: the edge pass, else the whole block.
template <int N, bool kEdges>
__device__ __forceinline__ void block_pass(int mode, const BlockView& b, const int32_t* res, int t,
                                           const int32_t* s_dir, const int32_t* s_weights) {
  switch (mode) {
#define AVT_MODE(m)                                                                      \
  case m:                                                                                \
    if constexpr (kEdges) {                                                              \
      block_edges<N, m>(b, res, t, s_dir, s_weights);                                    \
    } else {                                                                             \
      block_rows<N, m, 0, Geometry<N>::kIters>(b, res, t, s_dir, s_weights);             \
    }                                                                                    \
    break;
    AVT_MODE(0) AVT_MODE(1) AVT_MODE(2) AVT_MODE(3) AVT_MODE(4) AVT_MODE(5) AVT_MODE(6)
    AVT_MODE(7) AVT_MODE(8) AVT_MODE(9) AVT_MODE(10) AVT_MODE(11) default: AVT_MODE(12)
#undef AVT_MODE
  }
}

// Stage 1: every block's residual into the reconstruction buffer. A
// thread takes four coefficients of a row at a time: 16-byte loads and
// stores, and each load of a basis row serves four outputs.
template <int N>
__device__ __forceinline__ void residual_stage(const DecodeParams& prm, const Strides& st,
                                               const int32_t* __restrict__ levels,
                                               const int32_t* __restrict__ tx_types, int32_t* recon,
                                               const int32_t* s_bases, int32_t* s_x, int32_t* s_t,
                                               int* s_slot) {
  using G = Geometry<N>;
  constexpr int E = G::kElems;
  constexpr int per = G::kPass / E;     // blocks a pass
  constexpr int quads = G::kPass / 4;   // four coefficients a thread at a time
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const long long total = (long long)prm.p * prm.rb * prm.cb;
  const long long passes = (total + per - 1) / per;
  const int s1 = prm.lossless ? 0 : 12, s2 = prm.lossless ? 0 : 15;  // COS_BIT, + 3
  for (long long pass = blockIdx.x; pass < passes; pass += gridDim.x) {
    const long long first = pass * per;
#pragma unroll 2
    for (int k = tid; k < quads; k += nthreads) {
      const int q = 4 * k / E, e = 4 * k % E;
      const long long b = first + q;
      int4 x = make_int4(0, 0, 0, 0);
      int slot = 0;
      if (b < total) {
        x = *reinterpret_cast<const int4*>(levels + b * E + e);
        if (!prm.lossless) {
          x.x = min(max(wrap_mul(x.x, e == 0 ? prm.dc_step : prm.ac_step), -prm.cmax), prm.cmax);
          x.y = min(max(wrap_mul(x.y, prm.ac_step), -prm.cmax), prm.cmax);
          x.z = min(max(wrap_mul(x.z, prm.ac_step), -prm.cmax), prm.cmax);
          x.w = min(max(wrap_mul(x.w, prm.ac_step), -prm.cmax), prm.cmax);
          if (tx_types && e == 0) slot = tx_slot<N>(tx_types[b]);
        }
      }
      *reinterpret_cast<int4*>(s_x + 4 * k) = x;
      if (e == 0) s_slot[q] = slot;
    }
    __syncthreads();
    for (int k = tid; k < quads; k += nthreads) {
      const int q = 4 * k / E, e = 4 * k % E;
      *reinterpret_cast<int4*>(s_t + 4 * k) =
          avt::column_pass4<N>(s_bases + 2 * s_slot[q] * E, s_x + q * E, e / N, e % N, s1);
    }
    __syncthreads();
    for (int k = tid; k < quads; k += nthreads) {
      const int q = 4 * k / E, e = 4 * k % E;
      const long long b = first + q;
      if (b >= total) continue;
      int4 res = avt::row_pass4<N>(s_t + q * E, s_bases + (2 * s_slot[q] + 1) * E, e / N, e % N, s2);
      if (prm.lossless) {  // H·Hᵀ = n·I per dimension
        res.x >>= 2 * G::kLog2;
        res.y >>= 2 * G::kLog2;
        res.z >>= 2 * G::kLog2;
        res.w >>= 2 * G::kLog2;
      }
      *reinterpret_cast<int4*>(recon + (b / prm.cb) * st.lane + (b % prm.cb) * st.col + (e / N) * st.row +
                               e % N) = res;
    }
    __syncthreads();
  }
}

// Stage 2: every CTA's residuals are written before any lane reads one.
__device__ __forceinline__ void grid_barrier(int* arrived, int* error) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1);
    avt::wait_progress(arrived, 0, gridDim.x, error, -1);
  }
  __syncthreads();
}

// Stage 3, a lane group: lanes r0 .. r0 + lanes - 1 of `plane`, lane
// r0 + w walked by the kLaneThreads threads w (kLaneWarps warps); the
// helper warp after them publishes the group's progress to device memory.
// Every thread of the CTA calls it.
//
// Per block, lane w waits for the bottom row of the block above
// (edges[w - 1], or device memory for the first lane), computes the
// block's bottom row and right column first and releases edges[w], so the
// lane below starts while lane w computes the rest; then it releases
// consumed[w - 1] (its ring slot may be reused) and done[w]. The helper
// publishes min(done) of the group: the lanes below it (the next group's
// first lane) and the filter tiles may then read every pixel of those
// columns of the group, and of the groups above (they waited for it).
template <int N>
__device__ __forceinline__ void lane_group(const DecodeParams& prm, const Strides& st, int plane,
                                           int group, const int32_t* __restrict__ modes,
                                           int32_t* recon, int* progress, int* error,
                                           const int32_t* s_dir, const int32_t* s_weights,
                                           int32_t* s_ring, int32_t* s_top, int32_t* s_left,
                                           int* s_edges, int* s_done, int* s_consumed) {
  using G = Geometry<N>;
  constexpr int kEdge = G::kEdge;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int L = prm.lanes_per_cta;
  const int r0 = group * L, lanes = min(L, prm.rb - r0);
  const int32_t mid = 1 << (prm.depth - 1);
  if (tid < kMaxLanes) {
    s_edges[tid] = 0;
    s_done[tid] = 0;
    s_consumed[tid] = 0;
  }
  for (int k = tid; k < kMaxLanes * kEdge; k += nthreads) s_top[k] = mid;
  for (int k = tid; k < kMaxLanes * 2 * N; k += nthreads) s_left[k] = mid;
  __syncthreads();

  // Lane w's threads are tid / kLaneThreads = w, t = tid % kLaneThreads;
  // the helper warp follows the last lane (w = L).
  const int w = tid / kLaneThreads, t = tid % kLaneThreads;
  // The lane's threads meet, on named barrier 1 + w.
  auto lane_sync = [&] { avt::named_sync(1 + w, kLaneThreads); };
  if (w == L) {
    // The helper: the group's last lane, as far as every lane of it is done.
    if (t == 0) {
      const int last = plane * prm.rb + r0 + lanes - 1;
      const unsigned long long t0 = avt::global_ns();
      for (int published = 0, polls = 1; published < prm.cb; ++polls) {
        int m = avt::load_acquire_cta(s_done + lanes - 1);
        for (int v = 0; v + 1 < lanes && m > published; ++v) m = min(m, avt::load_acquire_cta(s_done + v));
        if (m > published) {
          avt::publish_progress(progress, last, m);
          published = m;
        } else if ((polls & 1023) == 0 && avt::global_ns() - t0 > avt::kWaitBudgetNs) {
          avt::fail(error, last + 1);
        }
      }
    }
  } else if (w < lanes) {
    const int r = r0 + w, lane = plane * prm.rb + r;
    const bool first = w == 0, producer = w + 1 < lanes;
    int32_t* own_top = s_top + w * kEdge;  // the first lane's top row and corner
    const int32_t* ring_in = s_ring + (w - 1) * kRing * kEdge;  // read only when w > 0
    int32_t* ring_out = s_ring + w * kRing * kEdge;
    int32_t* rec = recon + lane * st.lane;
    const int32_t* lane_modes = modes + (long long)lane * prm.cb;
    const int i0 = t / N, j0 = t % N;
    for (int c = 0; c < prm.cb; ++c) {
      // The block's residuals (its edges, then the whole block in rows) and
      // mode, in flight while the lane waits.
      const int32_t* block = rec + c * st.col;
      int32_t res[G::kEdgeIters + G::kIters];
#pragma unroll
      for (int k = 0; k < G::kEdgeIters; ++k) {
        int i, j;
        edge_at<N>(min(t + kLaneThreads * k, 2 * N - 2), i, j);
        res[k] = __ldcg(block + i * st.row + j);
      }
#pragma unroll
      for (int k = 0; k < G::kIters; ++k)
        res[G::kEdgeIters + k] = __ldcg(block + min(i0 + k * G::kRows, N - 1) * st.row + j0);
      const int mode = min(max(__ldg(lane_modes + c), 0), 12);
      const int slot = c % kRing;
      if (t == 0) {
        if (!first) {
          avt::wait_shared(s_edges + w - 1, c + 1, error, lane + 1);
        } else if (r > 0) {
          avt::wait_progress(progress, lane - 1, c + 1, error, lane + 1);
        }
        if (producer && c >= kRing) avt::wait_shared(s_consumed + w, c + 1 - kRing, error, lane + 1);
      }
      lane_sync();
      if (first && r > 0) {
        // The lane above is another CTA's: its bottom row, and the corner
        // (the bottom-right pixel of (r - 2, c)), from device memory.
        const int32_t* above = rec - st.lane + c * st.col + (N - 1) * st.row;
        if (t < N) own_top[t] = __ldcg(above + t);
        if (t == 0 && r >= 2 && c > 0) own_top[N] = __ldcg(above - st.lane + N - 1);
        lane_sync();
      }
      BlockView b;
      b.top = first ? own_top : ring_in + slot * kEdge;
      b.left = s_left + (2 * w + (c & 1)) * N;
      b.tl = (r >= 2 && c > 0) ? b.top[N] : mid;
      b.dc = 0;
      if (mode == 0) {  // DC: the mean of the top row and the left column, in each warp
        const int u = t & 31;
        int sum = u < N ? b.top[u] + b.left[u] : 0;  // at most 64 x 65535: no overflow
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        b.dc = (sum + N) >> (G::kLog2 + 1);
      }
      b.maxv = (1 << prm.depth) - 1;
      b.rec = rec + c * st.col;
      b.row = st.row;
      b.next_left = s_left + (2 * w + ((c + 1) & 1)) * N;
      b.edge_out = producer ? ring_out + slot * kEdge : nullptr;
      // The bottom row and the right column, then the lane below may go on.
      block_pass<N, true>(mode, b, res, t, s_dir, s_weights);
      // The corner of the lane below: the last pixel of this block's top row.
      if (producer && t == 0) b.edge_out[N] = b.top[N - 1];
      lane_sync();
      if (t == 0 && producer) avt::store_release_cta(s_edges + w, c + 1);
      block_pass<N, false>(mode, b, res + G::kEdgeIters, t, s_dir, s_weights);
      lane_sync();
      if (t == 0) {
        if (!first) avt::store_release_cta(s_consumed + w - 1, c + 1);
        avt::store_release_cta(s_done + w, c + 1);
      }
    }
  }
  __syncthreads();
}

// Stage 3, a filter tile: once the reconstruction under tile (ty, tx) of
// `plane` and its halo is written, the tile from `recon` into `out`.
template <int N>
__device__ __forceinline__ void filter_item(const DecodeParams& prm, int plane, int ty, int tx,
                                            int item, const int32_t* recon, int32_t* out,
                                            int* progress, int* error, avt::lf::TileSmem& sm) {
  using avt::lf::kHalo;
  using avt::lf::kTile;
  const int h = prm.rb * N, w = prm.cb * N, L = prm.lanes_per_cta;
  if (threadIdx.x == 0) {
    const int last_row = min(h, (ty + 1) * kTile + kHalo) - 1;
    const int last_col = min(w, (tx + 1) * kTile + kHalo) - 1;
    const int group_end = min(prm.rb, (last_row / N / L + 1) * L);  // lanes before it, in the plane
    avt::wait_progress(progress, plane * prm.rb + group_end - 1, last_col / N + 1, error, -2 - item,
                       kTileSleepNs);
  }
  __syncthreads();
  const avt::lf::Settings s{h, w, N, prm.deblock_thresh, prm.cdef_thresh, prm.deblock, prm.cdef};
  const long long off = (long long)plane * h * w;
  avt::lf::filter_tile(s, recon + off, out + off, ty, tx, sm, threadIdx.x, blockDim.x);
}

// recon is read back during the launch, so it is neither const nor
// __restrict__. tx_types may be null: every block is DCT. counters: the
// P * Rb per-lane counters, then the error word, the barrier's count and
// the work list's next item, all zero at launch.
template <int N>
__global__ void __launch_bounds__(kMaxThreads)
decode_wavefront_kernel(const DecodeParams prm, const int32_t* __restrict__ levels,
                        const int32_t* __restrict__ modes, const int32_t* __restrict__ tx_types,
                        int32_t* recon, int32_t* out, int* counters,
                        const int32_t* __restrict__ table, const int4* __restrict__ work) {
  using G = Geometry<N>;
  constexpr int E = G::kElems;
  const Layout lay = layout<N>(prm.lossless);
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_words = reinterpret_cast<int32_t*>(smem);
  int32_t* s_bases = s_words;  // per slot: ck, then rk transposed
  int32_t* s_dir = s_words + lay.dir;
  int32_t* s_weights = s_words + lay.weights;
  int* s_item = s_words + lay.item;
  auto& s_tile = *reinterpret_cast<avt::lf::TileSmem*>(s_words + lay.words);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lanes = prm.p * prm.rb;
  int* progress = counters;
  int* error = counters + lanes;
  int* arrived = error + 1;
  int* next_item = error + 2;
  const Strides st{(long long)prm.cb * E, prm.raster ? N : E, prm.raster ? prm.cb * N : N};

  // The constants, once per CTA.
  const int n_slots = prm.lossless ? 1 : G::kSlots;
  for (int m = tid; m < 2 * n_slots * E; m += nthreads) {
    const int q = m % E;
    s_bases[((m / E) & 1) ? m - q + (q % N) * N + q / N : m] = table[m];
  }
  const int32_t* dir = table + 2 * n_slots * E;  // modes 3..8: (use_top, idx, frac), each E
  for (int m = tid; m < 6 * E; m += nthreads) {
    const int32_t* entry = dir + (m / E) * 3 * E + m % E;
    s_dir[m] = entry[0] | (entry[E] << 1) | (entry[2 * E] << 8);
  }
  if (tid < N) s_weights[tid] = dir[18 * E + tid];
  __syncthreads();

  residual_stage<N>(prm, st, levels, tx_types, recon, s_bases, s_words + lay.x, s_words + lay.t,
                    s_words + lay.slot);
  grid_barrier(arrived, error);

  for (;;) {
    if (tid == 0) *s_item = atomicAdd(next_item, 1);
    __syncthreads();
    const int item = *s_item;
    __syncthreads();
    if (item >= prm.n_items) break;
    const int4 it = work[item];  // (kind, plane, group or ty, tx)
    if (it.x == 0) {
      lane_group<N>(prm, st, it.y, it.z, modes, recon, progress, error, s_dir, s_weights,
                    s_words + lay.ring, s_words + lay.top, s_words + lay.left, s_words + lay.edges,
                    s_words + lay.done, s_words + lay.consumed);
    } else {
      filter_item<N>(prm, it.y, it.z, it.w, item, recon, out, progress, error, s_tile);
    }
  }
}

// How many of the kernel's CTAs of `threads` threads with the dynamic
// shared memory of (lossless, filter) the current device holds at once,
// into *capacity; the largest shared memory the kernel takes is allowed
// once per device. Both are cached, so a launch queries nothing.
template <int N>
cudaError_t prepare(int lossless, int filter, int lanes_per_cta, int* capacity) {
  constexpr int kDevices = 16;
  static std::atomic<int> allowed[kDevices];                       // 1: the attribute is set
  static std::atomic<int> cached[kDevices][2][2][kMaxLanes + 1];  // capacity + 1, 0: not asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidValue;
  std::atomic<int>& slot = cached[dev][lossless != 0][filter != 0][lanes_per_cta];
  if (const int known = slot.load()) {
    *capacity = known - 1;
    return cudaSuccess;
  }
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(decode_wavefront_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<N>(0, 1));
    if (err != cudaSuccess) return err;
    allowed[dev] = 1;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_wavefront_kernel<N>,
                                                        kLaneThreads * lanes_per_cta + 32,
                                                        smem_bytes<N>(lossless, filter));
  if (err != cudaSuccess) return err;
  if (per_sm * sms < 1) return cudaErrorCooperativeLaunchTooLarge;
  *capacity = per_sm * sms;
  slot.store(*capacity + 1);
  return cudaSuccess;
}

template <int N>
cudaError_t launch(const DecodeParams& prm, const int32_t* levels, const int32_t* modes,
                   const int32_t* tx_types, int32_t* recon, int32_t* out, int* counters,
                   const int32_t* table, const int4* work, cudaStream_t stream) {
  int capacity = 0;
  cudaError_t err = prepare<N>(prm.lossless, prm.filter, prm.lanes_per_cta, &capacity);
  if (err != cudaSuccess) return err;
  const long long total = (long long)prm.p * prm.rb * prm.cb;
  constexpr int per = Geometry<N>::kPass / (N * N);
  const long long passes = (total + per - 1) / per;
  const int grid = (int)std::min<long long>(capacity, std::max<long long>(passes, prm.n_items));
  void* args[] = {const_cast<DecodeParams*>(&prm), &levels, &modes, &tx_types, &recon, &out,
                  &counters, &table, &work};
  err = cudaLaunchCooperativeKernel((const void*)decode_wavefront_kernel<N>, dim3(grid),
                                    dim3(kLaneThreads * prm.lanes_per_cta + 32), args,
                                    smem_bytes<N>(prm.lossless, prm.filter), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int N>
int capacity_of(int lossless, int lanes_per_cta, int filter) {
  int capacity = 0;
  const cudaError_t err = prepare<N>(lossless, filter, lanes_per_cta, &capacity);
  return err == cudaSuccess ? capacity : -(int)err;
}

}  // namespace

// C interface for ctypes. params: DecodeParams; levels: (P, Rb, Cb, n, n);
// recon: (P, Rb, Cb, n, n), or (P, Rb*n, Cb*n) when raster; out: the
// filtered (P, Rb*n, Cb*n) planes when filter, else unused; modes,
// tx_types: (P, Rb, Cb), tx_types null for all-DCT (read only when lossy);
// counters: P * Rb + 3 zeroed words; table: per inverse basis (ck, rk) as
// K1 takes them, then the directional tables of modes 3..8 and the smooth
// weights; work: n_items (kind, plane, a, b) items, kind 0 a lane group
// (a = group), 1 a filter tile (a = ty, b = tx). All int32, contiguous, on
// the current device. Returns a cudaError_t (0 = launched).
extern "C" int avt_decode_wavefront(const void* params, const void* levels, const void* modes,
                                    const void* tx_types, void* recon, void* out, void* counters,
                                    const void* table, const void* work, void* stream) {
  const DecodeParams& prm = *static_cast<const DecodeParams*>(params);
  if (prm.depth < 8 || prm.depth > 16 || prm.cmax < 1 || prm.p < 0 || prm.rb < 0 || prm.cb < 0 ||
      prm.lanes_per_cta < 1 || prm.lanes_per_cta > kMaxLanes || prm.n_items < 0 ||
      (prm.raster != 0 && prm.raster != 1) || (prm.filter != 0 && prm.filter != 1) ||
      (prm.filter && !prm.raster))
    return (int)cudaErrorInvalidValue;
  if (prm.p * prm.rb == 0 || prm.cb == 0) return 0;
  const auto* lv = static_cast<const int32_t*>(levels);
  const auto* md = static_cast<const int32_t*>(modes);
  const auto* tx = static_cast<const int32_t*>(tx_types);
  auto* rc = static_cast<int32_t*>(recon);
  auto* ot = static_cast<int32_t*>(out);
  auto* ct = static_cast<int*>(counters);
  const auto* tab = static_cast<const int32_t*>(table);
  const auto* wk = static_cast<const int4*>(work);
  auto s = static_cast<cudaStream_t>(stream);
  switch (prm.n) {
    case 4: return (int)launch<4>(prm, lv, md, tx, rc, ot, ct, tab, wk, s);
    case 8: return (int)launch<8>(prm, lv, md, tx, rc, ot, ct, tab, wk, s);
    case 16: return (int)launch<16>(prm, lv, md, tx, rc, ot, ct, tab, wk, s);
    case 32: return (int)launch<32>(prm, lv, md, tx, rc, ot, ct, tab, wk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The largest cooperative grid of the kernel for block size n, L lanes a
// CTA and the filter stage on or off, on the current device, or minus a
// cudaError_t.
extern "C" int avt_decode_wavefront_capacity(int n, int lossless, int lanes_per_cta, int filter) {
  if (lanes_per_cta < 1 || lanes_per_cta > kMaxLanes) return -(int)cudaErrorInvalidValue;
  switch (n) {
    case 4: return capacity_of<4>(lossless, lanes_per_cta, filter);
    case 8: return capacity_of<8>(lossless, lanes_per_cta, filter);
    case 16: return capacity_of<16>(lossless, lanes_per_cta, filter);
    case 32: return capacity_of<32>(lossless, lanes_per_cta, filter);
    default: return -(int)cudaErrorInvalidValue;
  }
}
