// K1: batched 2-D fixed-point integer transform for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `_mm_round2` / `transform_2d`
// (libavif_tpu/ops/pallas_kernels.py:53-117). For each n x n int32 block
//
//     t   = round2(ck · x, s1)        (column pass)
//     out = round2(t · rkᵀ, s2)       (row pass)
//
// with int32 two's-complement wraparound (transform.cuh holds the exact
// integer core, which the encode step kernel shares).
//
// What bounds it on this card: on the main path it runs on decode, one
// launch per transform type per plane group (B = 1536 blocks of 16 x 16
// for a 768x512 luma plane): one launch reads and writes about 3 MB and
// does 2·B·n³ ≈ 12.6 M multiply-adds, about a microsecond of HBM traffic
// or of the CUDA cores' int32 IMAD rate, so the launch latency (a few
// microseconds) bounds it, not bytes or operations.
//
// What the design does about it: one launch does both passes. A CTA
// holds one or more whole blocks plus both bases in shared memory, one
// thread owns one output element, and the intermediate t never leaves
// shared memory (the Pallas version relays t through XLA between two
// kernels). Small blocks (n = 4, 8) pack several blocks into one CTA so
// each CTA still has 256 threads. Tensor cores are not used: they have
// no exact int32 product, and this kernel is launch-bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "transform.cuh"

namespace {

template <int N>
struct Geometry {
  static constexpr int kElems = N * N;
  // Blocks per CTA: 256 threads for n <= 16, one 1024-thread block at n = 32.
  static constexpr int kBlocks = kElems >= 256 ? 1 : 256 / kElems;
  static constexpr int kThreads = kBlocks * kElems;
};

template <int N>
__global__ void __launch_bounds__(Geometry<N>::kThreads)
transform2d_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ ck,
                   const int32_t* __restrict__ rk, int32_t* __restrict__ out,
                   int batch, int shift1, int shift2) {
  constexpr int kElems = Geometry<N>::kElems;
  constexpr int kBlocks = Geometry<N>::kBlocks;
  __shared__ int32_t s_ck[kElems];   // ck[i][k] at i*N+k
  __shared__ int32_t s_rkT[kElems];  // rk[j][k] at k*N+j: row pass reads along j
  __shared__ int32_t s_x[kBlocks][kElems];
  __shared__ int32_t s_t[kBlocks][kElems];

  const int tid = threadIdx.x;
  for (int m = tid; m < kElems; m += blockDim.x) {
    s_ck[m] = ck[m];
    s_rkT[(m % N) * N + m / N] = rk[m];
  }
  const int local = tid / kElems;
  const int e = tid % kElems;
  const long long b = (long long)blockIdx.x * kBlocks + local;
  const bool valid = b < batch;
  s_x[local][e] = valid ? x[b * kElems + e] : 0;
  __syncthreads();

  const int i = e / N, j = e % N;
  s_t[local][e] = avt::column_pass<N>(s_ck, s_x[local], i, j, shift1);
  __syncthreads();

  const int32_t v = avt::row_pass<N>(s_t[local], s_rkT, i, j, shift2);
  if (valid) out[b * kElems + e] = v;
}

template <int N>
cudaError_t launch(const int32_t* x, const int32_t* ck, const int32_t* rk, int32_t* out,
                   int batch, int shift1, int shift2, cudaStream_t stream) {
  const int grid = (batch + Geometry<N>::kBlocks - 1) / Geometry<N>::kBlocks;
  transform2d_kernel<N><<<grid, Geometry<N>::kThreads, 0, stream>>>(
      x, ck, rk, out, batch, shift1, shift2);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. x, out: (batch, n, n) int32, contiguous, on the
// current device; ck, rk: (n, n) int32. Returns a cudaError_t (0 = launched).
extern "C" int avt_transform2d(const void* x, const void* ck, const void* rk, void* out,
                               int batch, int n, int shift1, int shift2, void* stream) {
  if (batch <= 0) return 0;
  if (shift1 < 0 || shift1 > 31 || shift2 < 0 || shift2 > 31) return (int)cudaErrorInvalidValue;
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
