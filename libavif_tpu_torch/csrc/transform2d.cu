// K1: batched 2-D fixed-point integer transform for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `_mm_round2` / `transform_2d`
// (libavif_tpu/ops/pallas_kernels.py:53-117). For each n x n int32 block
//
//     t   = round2(ck · x, s1)        (column pass)
//     out = round2(t · rkᵀ, s2)       (row pass)
//
// with int32 two's-complement wraparound (transform.cuh holds the exact
// integer core, which the encode and decode wavefronts share).
//
// What bounds it on this card: each block is read once and written once
// (8·n² bytes) and needs 2·n³ multiply-adds, which have no exact tensor-
// core form (no int32 product; the int8 paths cannot hold 12-bit bases
// times int32 inputs), so they run on the CUDA cores' int32 lanes. At
// n <= 16 the bytes bound it, at n = 32 the multiply-adds. For a 768x512
// plane (B = 1536 at n = 16) the launch itself takes longer than either.
//
// What the design does about it:
//   - a thread computes a 4 x 4 tile of each pass (avt::pass4x4), the
//     operands held k-major in shared memory, so one 16-byte shared load
//     of each operand feeds 16 multiply-adds;
//   - a CTA of 128 threads takes 128 / (n/4)² whole blocks a step, and
//     the grid is the CTAs that fit on the card at once, each walking the
//     steps with a grid stride: the bases are transposed into shared
//     memory once per CTA, not once per block;
//   - a step's blocks are contiguous in device memory, so its load and its
//     store are each one coalesced run of 16-byte accesses; the output
//     goes through shared memory to get there (a thread's own 4 x 4 tile
//     written straight out touches 8-16 lines a warp store);
//   - each thread issues the next step's loads into registers before it
//     computes the current one;
//   - the intermediate t never leaves shared memory: the column pass
//     stores it transposed, which is the k-major form the row pass reads;
//   - blocks sit n words apart in shared memory, so the 16-byte loads of
//     one warp from several blocks fall in different banks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "transform.cuh"

namespace {

constexpr int kThreads = 128;

template <int N>
struct Geometry {
  static constexpr int kTiles = (N / 4) * (N / 4);        // 4 x 4 tiles of a block, one a thread
  static constexpr int kBlocks = kThreads / kTiles;       // blocks a step: 128, 32, 8, 2
  static constexpr int kStride = N * N + N;               // words between blocks in shared memory
  static constexpr int kVecs = kBlocks * N * N / 4 / kThreads;  // 16-byte loads a thread a step (4)
  static_assert(kBlocks * kTiles == kThreads && kVecs * 4 * kThreads == kBlocks * N * N, "geometry");
};

// The int4 vectors of step `step` this thread loads (zeros past the batch).
template <int N>
__device__ __forceinline__ void load_step(const int4* __restrict__ x, long long vecs, int step,
                                          int4 (&staged)[Geometry<N>::kVecs]) {
  using G = Geometry<N>;
  const long long base = (long long)step * (G::kBlocks * N * N / 4) + threadIdx.x;
#pragma unroll
  for (int r = 0; r < G::kVecs; ++r) {
    const long long v = base + r * kThreads;
    staged[r] = v < vecs ? __ldg(x + v) : make_int4(0, 0, 0, 0);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
transform2d_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ ck,
                   const int32_t* __restrict__ rk, int32_t* __restrict__ out,
                   int batch, int shift1, int shift2) {
  using G = Geometry<N>;
  __shared__ __align__(16) int32_t s_ckT[N * N];  // ck[i][k] at k*N+i
  __shared__ __align__(16) int32_t s_rkT[N * N];  // rk[j][k] at k*N+j
  __shared__ __align__(16) int32_t s_x[G::kBlocks * G::kStride];   // x[k][j] at k*N+j
  __shared__ __align__(16) int32_t s_tT[G::kBlocks * G::kStride];  // t[i][k] at k*N+i
  __shared__ __align__(16) int32_t s_o[G::kBlocks * G::kStride];   // out[i][j] at i*N+j

  const int tid = threadIdx.x;
  for (int m = tid; m < N * N; m += kThreads) {
    const int mt = (m % N) * N + m / N;
    s_ckT[mt] = ck[m];
    s_rkT[mt] = rk[m];
  }
  const int steps = (batch + G::kBlocks - 1) / G::kBlocks;
  const long long vecs = (long long)batch * (N * N / 4);
  const int4* xv = reinterpret_cast<const int4*>(x);
  const int g = tid / G::kTiles, tile = tid % G::kTiles;
  const int i0 = 4 * (tile / (N / 4)), j0 = 4 * (tile % (N / 4));
  int32_t* const my_x = s_x + g * G::kStride;
  int32_t* const my_tT = s_tT + g * G::kStride;
  int32_t* const my_o = s_o + g * G::kStride;

  int4 staged[G::kVecs];
  int step = blockIdx.x;
  if (step < steps) load_step<N>(xv, vecs, step, staged);
  for (; step < steps; step += gridDim.x) {
#pragma unroll
    for (int r = 0; r < G::kVecs; ++r) {
      const int v = tid + r * kThreads;
      const int blk = v / (N * N / 4), w = v % (N * N / 4);
      *reinterpret_cast<int4*>(s_x + blk * G::kStride + 4 * w) = staged[r];
    }
    __syncthreads();
    if (step + (int)gridDim.x < steps) load_step<N>(xv, vecs, step + gridDim.x, staged);

    int4 t[4];
    avt::pass4x4<N>(s_ckT, my_x, i0, j0, shift1, t);
    *reinterpret_cast<int4*>(my_tT + (j0 + 0) * N + i0) = make_int4(t[0].x, t[1].x, t[2].x, t[3].x);
    *reinterpret_cast<int4*>(my_tT + (j0 + 1) * N + i0) = make_int4(t[0].y, t[1].y, t[2].y, t[3].y);
    *reinterpret_cast<int4*>(my_tT + (j0 + 2) * N + i0) = make_int4(t[0].z, t[1].z, t[2].z, t[3].z);
    *reinterpret_cast<int4*>(my_tT + (j0 + 3) * N + i0) = make_int4(t[0].w, t[1].w, t[2].w, t[3].w);
    __syncthreads();

    int4 o[4];
    avt::pass4x4<N>(my_tT, s_rkT, i0, j0, shift2, o);
#pragma unroll
    for (int r = 0; r < 4; ++r) *reinterpret_cast<int4*>(my_o + (i0 + r) * N + j0) = o[r];
    __syncthreads();

    // s_o is written again only after the next step's two barriers
    const long long base = (long long)step * (G::kBlocks * N * N / 4);
#pragma unroll
    for (int r = 0; r < G::kVecs; ++r) {
      const int v = tid + r * kThreads;
      const int blk = v / (N * N / 4), w = v % (N * N / 4);
      if (base + v < vecs)
        reinterpret_cast<int4*>(out)[base + v] = *reinterpret_cast<const int4*>(s_o + blk * G::kStride + 4 * w);
    }
  }
}

template <int N>
cudaError_t launch(const int32_t* x, const int32_t* ck, const int32_t* rk, int32_t* out,
                   int batch, int shift1, int shift2, cudaStream_t stream) {
  // CTAs resident on one SM (the same on every card of one kind), asked once
  static const int per_sm = [] {
    int v = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, transform2d_kernel<N>, kThreads, 0);
    return v > 0 ? v : 1;
  }();
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int steps = (batch + Geometry<N>::kBlocks - 1) / Geometry<N>::kBlocks;
  const int grid = steps < sms * per_sm ? steps : sms * per_sm;
  transform2d_kernel<N><<<grid, kThreads, 0, stream>>>(x, ck, rk, out, batch, shift1, shift2);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// C interface for ctypes. x, out: (batch, n, n) int32, contiguous and
// 16-byte aligned, on the current device; ck, rk: (n, n) int32. Returns a
// cudaError_t (0 = launched).
extern "C" int avt_transform2d(const void* x, const void* ck, const void* rk, void* out,
                               int batch, int n, int shift1, int shift2, void* stream) {
  if (batch <= 0) return 0;
  if (shift1 < 0 || shift1 > 31 || shift2 < 0 || shift2 > 31) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const auto* xi = static_cast<const int32_t*>(x);
  const auto* cki = static_cast<const int32_t*>(ck);
  const auto* rki = static_cast<const int32_t*>(rk);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: return (int)launch<4>(xi, cki, rki, o, batch, shift1, shift2, s);
    case 8: return (int)launch<8>(xi, cki, rki, o, batch, shift1, shift2, s);
    case 16: return (int)launch<16>(xi, cki, rki, o, batch, shift1, shift2, s);
    case 32: return (int)launch<32>(xi, cki, rki, o, batch, shift1, shift2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One launch of an empty kernel on the stream, through the same ctypes
// path: the launch floor that K1's bound leaves out.
extern "C" int avt_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
