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
//   - keeps the least cost, the first index on ties, as jnp.argmin does;
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
// Within a block, a candidate per slot of n threads (8 slots a warp at
// n = 4, 4 at n = 8, 2 at n = 16, one warp at n = 32), as many slots as
// candidates up to 224 threads (13 slots in 7 warps at n = 16 speed 6),
// and one helper warp. Slot s walks candidates s, s + S, ... in index
// order, keeps its best (strict improvement, so the first index on ties),
// and synchronises only with __syncwarp on its own lanes; its SSE and
// rate are shuffle sums over those lanes. Thread j of a slot holds column
// j of the residual in registers and transforms it with transform.cuh's
// vector forms: for a DCT dimension the partial butterfly (86
// multiply-adds a 16-point vector where the product has 256), its words
// read from shared memory as broadcast 16-byte loads; IDTX is the
// diagonal, ADST and WHT the direct product. A padded tile (n + 1 words a row: no bank conflicts, two slots
// of a warp on disjoint banks) turns the columns into rows for the row
// pass and back for the inverse. The quantizer divides by a multiply-high
// with one correction (`floor_div`): no division instruction. The
// candidate's levels go to one of two shared row buffers (the best's and
// the candidate's); the winner is the least cost * 128 + index, one
// shared atomicMin a slot behind a barrier of the compute warps. The
// winning slot writes the outputs and hands over to the helper warp (a
// named barrier), which publishes the lane's progress with a release
// store; while the slots compute, the helper prefetches the next block's
// source with cp.async and its top row if the lane above has published it
// (a poll, never a wait, so that a block's publication waits on nothing
// but its own outputs), and after the hand-over completes the next
// block's neighbours (the winner's right column is its left). So a block
// has two CTA-wide barriers: the neighbours and source in, the winners
// out.
//
// Bounds on an H100 SXM (132 SMs x 64 INT32 lanes x 1.98 GHz), at
// 768x512 luma speed 6 (13 candidates, the DCT):
//   - throughput: the butterflies' int32 multiply-adds, 4 passes of
//     16 vectors of 86 per candidate: 13 x 4 x 16 x 86 = 71.6 K per block,
//     110 M a plane, 0.0066 ms at the whole card's rate (the direct
//     products' n^3 figure: 213 K a block, 0.0196 ms); its bytes (sources
//     in; levels, reconstruction and symbols out, about 4.7 MB) take
//     0.0014 ms at 3.35 TB/s;
//   - chain: the Rb + Cb - 1 blocks of the longest dependency chain run
//     one after another, each at best at one SM's rate: 79 x 71.6 K /
//     (64 x 1.98 GHz) = 0.045 ms (0.133 ms for n^3).
// The chain bound is the floor: a plane has few lanes (32 rows at 768x512
// luma), so most SMs idle whatever the kernel does, and a link of the
// chain is one block's latency. What holds a link (tools/k2_times.py
// --ablate): an SM's 64 INT32 lanes issue a warp's multiply-add in two
// cycles, and the busiest of the four schedulers holds 4 of the 13
// candidates, so the passes' products alone take some 1.4 us of a block's
// 4.3 us. Two or more CTAs fit an SM, so a batch's 256 luma lanes are
// resident together.
//
// Tensor cores are not used. The products are exact int32 mod 2^32, and
// IMMA takes int8 operands, so each product would need several limb
// products; a block's transform is 16x16x16, under wgmma's 64-row tile.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "transform.cuh"
#include "wavefront.cuh"

namespace {

constexpr int kMaxModes = 13;
constexpr int kMaxTx = 5;
constexpr int kMaxCand = kMaxModes * kMaxTx;
constexpr int kMaxThreads = 256;                 // the compute warps, then the helper warp
constexpr int kBarCompute = 1, kBarHandoff = 2;  // named barriers (0 is __syncthreads)

// Mirror of wavefront._StepParams (ctypes).
struct StepParams {
  int p, rb, cb, n, depth, lossless, dc_step, ac_step, dc_bias, ac_bias;
  unsigned dc_magic, ac_magic, rb_magic;  // wavefront.division_magic of dc_step, ac_step, rb
  int lam, n_modes, n_tx;
  int cand[kMaxCand];         // candidate k: pred mode | t << 4 | mode symbol << 8 | tx symbol << 12
  int pass_kind[4 * kMaxTx];  // per transform: fwd column, fwd row, inv column, inv row (PassKind)
};

template <int N>
struct Geometry {
  static constexpr int kElems = N * N;
  static constexpr int kPitch = N + 1;  // a padded tile row
  static constexpr int kTile = N * kPitch;
  static constexpr int kSlotTiles = 5;  // two transpose tiles, the prediction, two level buffers
  static constexpr int kMaxSlots = (kMaxThreads - 32) / N;
  static constexpr int kMinBlocks = N <= 8 ? 3 : N == 16 ? 2 : 1;
  static constexpr int kLog2 = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
  static constexpr int kExt = avt::kExtWords<N>;
  static constexpr int kNeighbors = (2 * kExt + 1 + 3) & ~3;  // [left ext | top ext | dc], padded
};

template <int N>
__host__ __device__ constexpr int slots_for(int k) {
  return k < Geometry<N>::kMaxSlots ? k : Geometry<N>::kMaxSlots;
}

// The compute warps of `slots` slots of n threads, and the helper warp.
template <int N>
__host__ __device__ constexpr int threads_for(int slots) {
  return (slots * N + 31) / 32 * 32 + 32;
}

// Offsets (in 4-byte words) of the shared-memory regions; the two winner
// keys come first, as 8-byte words.
template <int N>
struct Layout {
  int neighbors, kinds, cand, bases, dir, weights, src, tiles, words;
  __host__ __device__ Layout(int n_tx, int k, int slots) {
    using G = Geometry<N>;
    neighbors = 4;
    kinds = neighbors + 2 * G::kNeighbors;
    cand = kinds + 4 * kMaxTx;
    bases = (cand + k + 3) & ~3;
    dir = bases + 4 * n_tx * G::kElems;
    weights = dir + 6 * G::kElems;
    src = weights + ((N + 3) & ~3);
    tiles = src + 2 * G::kTile;
    words = tiles + G::kSlotTiles * slots * G::kTile;
  }
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// floor(a / d) for every int32 a and 1 <= d < 2^31, given
// magic = wavefront.division_magic(d) = min(floor(2^32 / d), 2^32 - 1).
//
// Proof. For a < 0, floor(a / d) = -ceil(-a / d) = -1 - floor((-a - 1) / d)
// = ~floor(~a / d), and ~a = -a - 1 >= 0; so with s = a >> 31 (0 or -1)
// and u = a ^ s (a or ~a, in [0, 2^31)), floor(a / d) = floor(u / d) ^ s.
// For u: magic <= 2^32 / d and magic > 2^32 / d - 1 (d = 1: 2^32 - 1 =
// 2^32 / d - 1 exactly, which still gives u * magic / 2^32 > u - 1 for
// u > 0, and 0 for u = 0), so u / d - 1 < u / d - u / 2^32 <=
// u * magic / 2^32 <= u / d, as u < 2^32. Hence q0 = umulhi(u, magic) is
// floor(u / d) or one less, and r = u - q0 d lies in [0, 2d), below 2^32:
// one step q0 + (r >= d) is exact. No wrapped dividend escapes: a
// wrapped |c| + bias is an int32 like any other. (r = u + q0 (2^32 - d)
// mod 2^32: one multiply-add.)
__device__ __forceinline__ int32_t floor_div(int32_t a, uint32_t d, uint32_t magic) {
  const int32_t s = a >> 31;
  const uint32_t u = (uint32_t)(a ^ s);
  uint32_t q = __umulhi(u, magic);
  q += (u + q * (0u - d)) >= d;
  return (int32_t)q ^ s;
}

// Rate bits of one level: 3 + 2 * min(bitlen|level|, 16), 0 for a zero
// (and for INT32_MIN, whose wrapped magnitude is negative, as in the
// plain version). Branch-free, so that a row's levels interleave.
__device__ __forceinline__ int rate_bits(int32_t level) {
  const int32_t a = level < 0 ? wrap_mul(level, -1) : level;
  return (3 + 2 * min(32 - __clz(a), 16)) & -(int)(a > 0);
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

// Row of `lane` in its plane: lane mod rb, by floor_div.
__device__ __forceinline__ int lane_row(int lane, const StepParams& prm) {
  return lane - floor_div(lane, (uint32_t)prm.rb, prm.rb_magic) * prm.rb;
}

// The helper warp (lane = its thread's lane): block (blk_lane, c)'s source
// into a padded tile, by 4-byte cp.async copies.
template <int N>
__device__ __forceinline__ void prefetch_source(int32_t* tile, const int32_t* src, int blk_lane, int c,
                                                int cb, int lane) {
  using G = Geometry<N>;
  const int32_t* from = src + ((long long)blk_lane * cb + c) * G::kElems;
#pragma unroll 1
  for (int e = lane; e < G::kElems; e += 32) cp_async4(tile + (e / N) * G::kPitch + e % N, from + e);
}

// The helper warp: whether block (blk_lane, c), row r of its plane, may
// read its top row now (the lane above has published c + 1), without
// waiting.
__device__ __forceinline__ bool top_ready(const int* progress, int blk_lane, int r, int c, int lane) {
  int ready = 1;
  if (lane == 0 && r > 0) ready = avt::load_acquire(progress + blk_lane - 1) >= c + 1;
  return __shfl_sync(0xffffffffu, ready, 0) != 0;
}

// The helper warp: the neighbours of block (blk_lane, c) that do not come
// from this CTA's previous block, into nb (its extended edges and DC
// word), once the lane above has published (r - 1, c): the top row
// (the bottom row of (r - 1, c)), repeated past its end, and the corner
// (the bottom-right pixel of (r - 2, c), which is what the JAX package's
// rolled `toplasts` carry holds), `mid` for either off the plane; the
// left column too when c = 0 (mid). ops/wavefront.neighbors_from_outputs
// is the plain version.
template <int N>
__device__ __forceinline__ void load_top(const int32_t* recon, int blk_lane, int r, int c, int cb, int32_t mid,
                                         int lane, int32_t* nb) {
  using G = Geometry<N>;
  constexpr int E = G::kElems;
  const long long blk = (long long)blk_lane * cb + c;
  int32_t* left = nb;
  int32_t* top = nb + G::kExt;
  int32_t t = mid;
  if (lane < N && r > 0) t = __ldcg(recon + (blk - cb) * E + (N - 1) * N + lane);
  const int32_t last = __shfl_sync(0xffffffffu, t, N - 1);
  if (lane < N) top[1 + lane] = t;
  for (int q = N + 1 + lane; q < G::kExt; q += 32) top[q] = last;
  if (lane == 0) {
    const int32_t corner = (r >= 2 && c > 0) ? __ldcg(recon + (blk - 2 * cb) * E + E - 1) : mid;
    top[0] = corner;
    left[0] = corner;
  }
  if (c == 0 && lane < N) left[1 + lane] = mid;
}

// The helper warp, once block (., c)'s left column is in nb: the left
// edge's tail and the DC predictor's value.
template <int N>
__device__ __forceinline__ void finish_neighbors(int lane, int32_t* nb) {
  using G = Geometry<N>;
  int32_t* left = nb;
  const int32_t* top = nb + G::kExt;
  const int32_t l = lane < N ? left[1 + lane] : 0;
  int sum = lane < N ? l + top[1 + lane] : 0;  // at most 64 x 65535: no overflow
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const int32_t last = __shfl_sync(0xffffffffu, l, N - 1);
  for (int q = N + 1 + lane; q < G::kExt; q += 32) left[q] = last;
  if (lane == 0) nb[2 * G::kExt] = (sum + N) >> (G::kLog2 + 1);
}

// Thread j of a slot holds column j of a block in v: afterwards it holds
// row j. `tile` is the slot's padded tile.
template <int N>
__device__ __forceinline__ void columns_to_rows(int32_t* tile, uint32_t (&v)[N], int j, unsigned mask) {
  constexpr int P = Geometry<N>::kPitch;
#pragma unroll
  for (int i = 0; i < N; ++i) tile[i * P + j] = (int32_t)v[i];
  __syncwarp(mask);
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = (uint32_t)tile[j * P + q];
}

// Thread j of a slot holds row j of a block in v: afterwards column j.
template <int N>
__device__ __forceinline__ void rows_to_columns(int32_t* tile, uint32_t (&v)[N], int j, unsigned mask) {
  constexpr int P = Geometry<N>::kPitch;
#pragma unroll
  for (int q = 0; q < N; ++q) tile[j * P + q] = (int32_t)v[q];
  __syncwarp(mask);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = (uint32_t)tile[i * P + j];
}

// Rounds of one pass: (rounding constant, shift), 0 and 0 for none.
struct Round {
  uint32_t add;
  int shift;
  __device__ __forceinline__ int32_t operator()(uint32_t v) const { return (int32_t)(v + add) >> shift; }
};

__device__ __forceinline__ Round round_of(int shift) { return {shift ? 1u << (shift - 1) : 0u, shift}; }

// A pass of a candidate's transform on v (forward for passes 0 and 1,
// inverse for 2 and 3), rounded.
template <int N, bool kInverse>
__device__ __forceinline__ void pass(int kind, const int32_t* w, uint32_t (&v)[N], Round rd) {
  avt::vector_pass<N, kInverse>(kind, w, v);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = (uint32_t)rd(v[i]);
}

// The lanes of a warp that hold thread tid's slot.
template <int N>
__device__ __forceinline__ unsigned slot_mask(int tid) {
  if constexpr (N == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << N) - 1) << ((tid & 31) & ~(N - 1));
  }
}

// recon is read back during the launch (wavefront.cuh), so it is neither
// const nor __restrict__.
template <int N>
__global__ void __launch_bounds__(kMaxThreads, Geometry<N>::kMinBlocks)
encode_wavefront_kernel(const StepParams prm, const int32_t* __restrict__ src,
                        int32_t* __restrict__ modes_out, int32_t* __restrict__ tx_out,
                        int32_t* __restrict__ levels_out, int32_t* recon, int* progress,
                        const int32_t* __restrict__ table) {
  using G = Geometry<N>;
  constexpr int E = G::kElems, P = G::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = prm.n_tx, K = prm.n_modes * T;
  const int S = slots_for<N>(K);
  const Layout<N> L(T, K, S);
  int32_t* sw = reinterpret_cast<int32_t*>(smem);
  long long* s_key = reinterpret_cast<long long*>(smem);  // per buffer: least cost * 128 + index
  int32_t* s_nb = sw + L.neighbors;                        // per buffer: extended edges, DC
  int* s_kinds = sw + L.kinds;
  int* s_cand = sw + L.cand;
  int32_t* s_bases = sw + L.bases;
  int32_t* s_dir = sw + L.dir;
  int32_t* s_weights = sw + L.weights;
  int32_t* s_src = sw + L.src;

  const int tid = threadIdx.x, threads = blockDim.x;
  const int computing = threads - 32;  // the last warp is the helper
  const bool helper = tid >= computing;
  const int slot = tid / N, j = tid % N;
  const bool computes = !helper && slot < S;
  const unsigned mask = slot_mask<N>(tid);
  int32_t* x0 = sw + L.tiles + G::kSlotTiles * slot * G::kTile;  // the slot's two transpose tiles
  int32_t* x1 = x0 + G::kTile;
  int32_t* pt = x1 + G::kTile;   // its prediction, column-major in, row-major out
  int32_t* lvs = pt + G::kTile;  // two level buffers, row-major: the best and the candidate's
  const int lanes = prm.p * prm.rb;
  const int32_t mid = 1 << (prm.depth - 1);
  const int32_t maxv = (1 << prm.depth) - 1;
  const int dshift = prm.depth - 8;
  int* error = progress + lanes;

  // The constants, once per CTA.
#pragma unroll 1
  for (int m = tid; m < 4 * T * E; m += threads) s_bases[m] = table[m];
  const int32_t* dir = table + 4 * T * E;  // modes 3..8: (use_top, idx, frac), each E
#pragma unroll 1
  for (int m = tid; m < 6 * E; m += threads) {
    const int32_t* entry = dir + (m / E) * 3 * E + m % E;
    s_dir[m] = avt::ext_word<N>(entry[0], entry[E], entry[2 * E]);
  }
  if (tid < N) s_weights[tid] = dir[18 * E + tid];
  if (tid < 4 * T) s_kinds[tid] = prm.pass_kind[tid];
#pragma unroll 1
  for (int k = tid; k < K; k += threads) s_cand[k] = prm.cand[k];
  if (tid == 0) s_key[0] = s_key[1] = LLONG_MAX;

  const Round fr1 = round_of(prm.lossless ? 0 : 10), fr2 = round_of(prm.lossless ? 0 : 11);  // COS_BIT - 2, - 1
  const Round ir1 = round_of(prm.lossless ? 0 : 12), ir2 = round_of(prm.lossless ? 0 : 15);  // COS_BIT, + 3
  const int lossless_shift = prm.lossless ? 2 * G::kLog2 : 0;  // H·Hᵀ = n·I per dimension
  // Quantizer of row j: its element 0 is the DC at j = 0.
  const uint32_t step0 = j == 0 ? prm.dc_step : prm.ac_step;
  const int32_t bias0 = j == 0 ? prm.dc_bias : prm.ac_bias;
  const uint32_t magic0 = j == 0 ? prm.dc_magic : prm.ac_magic;

  int lane = blockIdx.x, c = 0, buf = 0;
  if (lane >= lanes) return;
  int r = lane_row(lane, prm);
  const int hl = tid & 31;  // the helper's lane
  if (helper) {
    prefetch_source<N>(s_src, src, lane, 0, prm.cb, hl);
    cp_async_commit();
    if (hl == 0 && r > 0) avt::wait_progress(progress, lane - 1, 1, error, lane + 1);
    __syncwarp();
    load_top<N>(recon, lane, r, 0, prm.cb, mid, hl, s_nb);
    __syncwarp();
    finish_neighbors<N>(hl, s_nb);
    cp_async_wait<0>();
  }
  while (lane < lanes) {
    int next_lane = lane, next_c = c + 1, next_r = r;
    if (next_c == prm.cb) {
      next_lane += gridDim.x;
      next_c = 0;
      next_r = next_lane < lanes ? lane_row(next_lane, prm) : 0;
    }
    const bool has_next = next_lane < lanes;
    int32_t* nb = s_nb + buf * G::kNeighbors;
    int32_t* nb_next = s_nb + (buf ^ 1) * G::kNeighbors;
    __syncthreads();  // this block's source and neighbours are in; the last block's outputs are out

    if (helper) {
      // While the slots compute: the next block's source, and its top row
      // if the lane above has it already (no wait here: this block's
      // publication must not hang on the next block's inputs).
      if (hl == 0) s_key[buf ^ 1] = LLONG_MAX;
      bool early = false;
      if (has_next) {
        prefetch_source<N>(s_src + (buf ^ 1) * G::kTile, src, next_lane, next_c, prm.cb, hl);
        cp_async_commit();
        early = top_ready(progress, next_lane, next_r, next_c, hl);
        if (early) load_top<N>(recon, next_lane, next_r, next_c, prm.cb, mid, hl, nb_next);
      }
      avt::named_sync(kBarHandoff, 64);  // the winner's warp: its outputs and right column are in
      if (hl == 0) avt::store_release(progress + lane, c + 1);
      if (has_next) {
        if (!early) {
          if (hl == 0) avt::wait_progress(progress, next_lane - 1, next_c + 1, error, next_lane + 1);
          __syncwarp();
          load_top<N>(recon, next_lane, next_r, next_c, prm.cb, mid, hl, nb_next);
        }
        __syncwarp();
        finish_neighbors<N>(hl, nb_next);
        cp_async_wait<0>();
      }
    } else {
      long long best_cost = LLONG_MAX;
      int best_k = K, best_buf = 0;
      int32_t best_rec[N];  // row j of the slot's best reconstruction
#pragma unroll
      for (int q = 0; q < N; ++q) best_rec[q] = 0;
      if (computes) {
        const int32_t* cur = s_src + buf * G::kTile;
        const int32_t dc = nb[2 * G::kExt];
        for (int k = slot; k < K; k += S) {
          const int word = s_cand[k];
          const int t = (word >> 4) & 15;
          const int32_t* bases = s_bases + 4 * t * E;
          const int* kinds = s_kinds + 4 * t;
          int32_t* lv = lvs + (best_buf ^ 1) * G::kTile;  // the buffer the best is not in
          __syncwarp(mask);  // the slot's last candidate is done with its tiles
          uint32_t v[N];
          {
            int32_t pred[N];
            avt::predict_column<N, N>(word & 15, j, 0, nb, dc, s_dir, s_weights, pred);
#pragma unroll
            for (int i = 0; i < N; ++i) {
              pt[i * P + j] = pred[i];
              v[i] = (uint32_t)cur[i * P + j] - (uint32_t)pred[i];
            }
          }
          pass<N, false>(kinds[0], bases, v, fr1);  // column j of the column pass
          columns_to_rows<N>(x0, v, j, mask);
          pass<N, false>(kinds[1], bases + E, v, fr2);  // row j of the coefficients
          // The row's levels, and the dequantized row in v; no branch inside
          // either loop, so that the row's elements interleave.
          int bits = 0;
          if (prm.lossless) {
#pragma unroll
            for (int q = 0; q < N; ++q) {
              lv[j * P + q] = (int32_t)v[q];
              bits += rate_bits((int32_t)v[q]);
            }
          } else {
#pragma unroll
            for (int q = 0; q < N; ++q) {
              const uint32_t step = q == 0 ? step0 : prm.ac_step;
              const int32_t bias = q == 0 ? bias0 : prm.ac_bias;
              const uint32_t magic = q == 0 ? magic0 : prm.ac_magic;
              const int32_t coef = (int32_t)v[q], neg = coef >> 31;
              // sign(coef) * floor((|coef| + bias) / step), all wrapped
              const int32_t mag = floor_div(wrap_add((coef ^ neg) - neg, bias), step, magic);
              const int32_t level = coef == 0 ? 0 : wrap_add(mag ^ neg, -neg);
              v[q] = (uint32_t)level * step;
              lv[j * P + q] = level;
              bits += rate_bits(level);
            }
          }
          rows_to_columns<N>(x1, v, j, mask);
          pass<N, true>(kinds[2], bases + 2 * E, v, ir1);  // column j of the inverse's first pass
          columns_to_rows<N>(x0, v, j, mask);
          pass<N, true>(kinds[3], bases + 3 * E, v, ir2);  // row j of the residual
          long long sse = 0;
          int32_t rec[N];
#pragma unroll
          for (int q = 0; q < N; ++q) {
            rec[q] = min(max(wrap_add(pt[j * P + q], (int32_t)v[q] >> lossless_shift), 0), maxv);
            const int32_t err = wrap_add(cur[j * P + q], -rec[q]) >> dshift;
            sse += (long long)wrap_mul(err, err);  // the plain version squares in int32
          }
#pragma unroll
          for (int off = N / 2; off > 0; off >>= 1) {
            sse += __shfl_xor_sync(mask, sse, off, N);
            bits += __shfl_xor_sync(mask, bits, off, N);
          }
          const long long cost = sse + (long long)prm.lam * bits;
          if (cost < best_cost) {
            best_cost = cost;
            best_k = k;
            best_buf ^= 1;
#pragma unroll
            for (int q = 0; q < N; ++q) best_rec[q] = rec[q];
          }
        }
        if (j == 0) atomicMin(s_key + buf, best_cost * 128 + best_k);  // |cost| < 2^56
      }
      avt::named_sync(kBarCompute, computing);  // every slot's winner is in

      const int win_k = (int)(s_key[buf] & 127);
      const bool wins = computes && best_k == win_k;
      if (wins) {  // row j: its levels from the best buffer, its reconstruction from registers
        const long long blk = (long long)lane * prm.cb + c;
        const int32_t* lv = lvs + best_buf * G::kTile + j * P;
        int4* lo = reinterpret_cast<int4*>(levels_out + blk * E + j * N);
        int4* ro = reinterpret_cast<int4*>(recon + blk * E + j * N);
#pragma unroll
        for (int q = 0; q < N; q += 4) {
          lo[q / 4] = make_int4(lv[q], lv[q + 1], lv[q + 2], lv[q + 3]);
          ro[q / 4] = make_int4(best_rec[q], best_rec[q + 1], best_rec[q + 2], best_rec[q + 3]);
        }
        if (j == 0) {
          const int word = s_cand[best_k];
          modes_out[blk] = (word >> 8) & 15;
          tx_out[blk] = (word >> 12) & 15;
        }
        if (has_next && next_c > 0) nb_next[1 + j] = best_rec[N - 1];  // the next block's left column
      }
      if (__any_sync(0xffffffffu, wins)) avt::named_sync(kBarHandoff, 64);  // with the helper
    }
    lane = next_lane;
    c = next_c;
    r = next_r;
    buf ^= 1;
  }
}

// Sets the kernel's shared memory and returns its block size and in
// *capacity how many of its CTAs the current device holds at once.
template <int N>
cudaError_t prepare(int n_modes, int n_tx, size_t* bytes, int* threads, int* capacity) {
  const int k = n_modes * n_tx, slots = slots_for<N>(k);
  *threads = threads_for<N>(slots);
  *bytes = sizeof(int32_t) * (size_t)Layout<N>(n_tx, k, slots).words;
  cudaError_t err = cudaFuncSetAttribute(encode_wavefront_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, encode_wavefront_kernel<N>, *threads,
                                                        *bytes);
  *capacity = per_sm * sms;
  if (err == cudaSuccess && *capacity < 1) err = cudaErrorCooperativeLaunchTooLarge;
  return err;
}

template <int N>
cudaError_t launch(const StepParams& prm, const int32_t* src, int32_t* modes, int32_t* tx,
                   int32_t* levels, int32_t* recon, int* progress, const int32_t* table,
                   cudaStream_t stream) {
  size_t bytes = 0;
  int threads = 0, capacity = 0;
  cudaError_t err = prepare<N>(prm.n_modes, prm.n_tx, &bytes, &threads, &capacity);
  if (err != cudaSuccess) return err;
  const int grid = min(capacity, prm.p * prm.rb);
  void* args[] = {const_cast<StepParams*>(&prm), &src, &modes, &tx, &levels, &recon, &progress,
                  &table};
  err = cudaLaunchCooperativeKernel((const void*)encode_wavefront_kernel<N>, dim3(grid), dim3(threads),
                                    args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. params: StepParams; src: (P, Rb, Cb, n, n);
// modes, tx: (P, Rb, Cb); levels, recon: (P, Rb, Cb, n, n); progress:
// P * Rb + 1 zeroed words (the per-lane counters, then the error word);
// table: per searched transform the words of its four passes (n * n each,
// wavefront.pass_plan), then the directional tables of modes 3..8 and the
// smooth weights. All int32, contiguous, on the current device. Returns a
// cudaError_t (0 = launched).
extern "C" int avt_encode_wavefront(const void* params, const void* src, void* modes, void* tx,
                                    void* levels, void* recon, void* progress, const void* table,
                                    void* stream) {
  const StepParams& prm = *static_cast<const StepParams*>(params);
  if (prm.n_modes < 1 || prm.n_modes > kMaxModes || prm.n_tx < 1 || prm.n_tx > kMaxTx ||
      prm.depth < 8 || prm.depth > 16 || prm.dc_step < 1 || prm.ac_step < 1 || prm.p < 0 ||
      prm.rb < 0 || prm.cb < 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4 * prm.n_tx; ++i)
    if (prm.pass_kind[i] < avt::kPassDense || prm.pass_kind[i] > avt::kPassInverseButterfly)
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

// The largest cooperative grid of the kernel for block size n, n_modes
// searched modes and n_tx searched transforms on the current device, or
// minus a cudaError_t.
extern "C" int avt_encode_wavefront_capacity(int n, int n_modes, int n_tx) {
  if (n_modes < 1 || n_modes > kMaxModes || n_tx < 1 || n_tx > kMaxTx) return -(int)cudaErrorInvalidValue;
  size_t bytes = 0;
  int threads = 0, capacity = 0;
  cudaError_t err;
  switch (n) {
    case 4: err = prepare<4>(n_modes, n_tx, &bytes, &threads, &capacity); break;
    case 8: err = prepare<8>(n_modes, n_tx, &bytes, &threads, &capacity); break;
    case 16: err = prepare<16>(n_modes, n_tx, &bytes, &threads, &capacity); break;
    case 32: err = prepare<32>(n_modes, n_tx, &bytes, &threads, &capacity); break;
    default: return -(int)cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? capacity : -(int)err;
}
