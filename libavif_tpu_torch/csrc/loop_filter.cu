// K4: the own-format decoder's in-loop filters, deblocking then the CDEF
// stage, in one launch per plane group, for Hopper (sm_90a).
//
// Replaces the JAX package's whole-plane passes deblock_plane
// (libavif_tpu/ops/filters.py:47-59) and cdef_plane (:95-132), which XLA
// fuses into the decoder's jitted program, vmapped over the planes of a
// group (libavif_tpu/codec/recon.py:483-486). What a tile computes, and
// how, is in loop_filter.cuh.
//
// The decode's main path runs the same tile function inside the fused
// decode launch (decode_wavefront.cu), behind the wavefront, and does not
// launch this kernel: it serves ops.filters.loop_filter on CUDA tensors.
//
// Design: one CTA of 256 threads per 32x32 output tile of one plane.
//
// Bounds on an H100 SXM, for a 768x512 luma plane with both filters on
// (n = 16), the larger of:
//   - bytes: the plane read once and written once, int32, 3.1 MB,
//     0.00094 ms at 3.35 TB/s;
//   - operations: the arithmetic the output needs, about 36 int32 ops a
//     pixel for the CDEF stage (four directions' energies, one
//     direction's taps, the select) and 32 a boundary row for
//     deblocking, 0.00094 ms at the card's 16.7 T/s.
// The halo's reloads (1.7x the tile) come from L2. One launch replaces the
// host's launches, so the kernel's time is a few microseconds of launch
// and one pass over the planes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "loop_filter.cuh"

namespace {

// Mirror of filters._LoopFilterParams (ctypes).
struct LoopFilterParams {
  int p, h, w, n, deblock_thresh, cdef_thresh, deblock, cdef;
};

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
loop_filter_kernel(const LoopFilterParams prm, const int32_t* __restrict__ in,
                   int32_t* __restrict__ out) {
  __shared__ avt::lf::TileSmem sm;
  const avt::lf::Settings s{prm.h, prm.w, prm.n, prm.deblock_thresh, prm.cdef_thresh, prm.deblock,
                            prm.cdef};
  const long long plane = (long long)blockIdx.z * prm.h * prm.w;
  avt::lf::filter_tile(s, in + plane, out + plane, blockIdx.y, blockIdx.x, sm, threadIdx.x, kThreads);
}

}  // namespace

// C interface for ctypes. params: LoopFilterParams; in, out: (P, H, W)
// int32, contiguous, distinct, on the current device. deblock needs
// n >= 4. Returns a cudaError_t (0 = launched).
extern "C" int avt_loop_filter(const void* params, const void* in, void* out, void* stream) {
  const LoopFilterParams& prm = *static_cast<const LoopFilterParams*>(params);
  if (prm.p < 0 || prm.h < 0 || prm.w < 0 || prm.p > 65535 || (prm.deblock && prm.n < 4))
    return (int)cudaErrorInvalidValue;
  if (prm.p == 0 || prm.h == 0 || prm.w == 0) return 0;
  const int tile = avt::lf::kTile;
  const dim3 grid((prm.w + tile - 1) / tile, (prm.h + tile - 1) / tile, prm.p);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  loop_filter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      prm, static_cast<const int32_t*>(in), static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
