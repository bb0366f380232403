// K4's 32x32 tile of the in-loop filters, deblocking then the CDEF stage,
// as a device function: the body of the standalone K4 kernel
// (loop_filter.cu) and the filter stage of the fused decode launch
// (decode_wavefront.cu), which runs it on each tile once the
// reconstruction under the tile and its halo is written.
//
// Replaces the JAX package's whole-plane passes deblock_plane
// (libavif_tpu/ops/filters.py:47-59) and cdef_plane (:95-132). Per plane:
//
//   - deblocking (when on): at every vertical boundary b = n, 2n, ... <=
//     W - 2, the rows' p1 p0 | q0 q1 are smoothed where the step looks
//     like a quantization artifact (|p0 - q0| < t, |p1 - p0| and
//     |q1 - q0| < (t >> 1) + 1), p0 and q0 to the same mid value; then the
//     same at every horizontal boundary, on the vertically filtered plane.
//     Each boundary rewrites its four pixels from their values before it;
//     with n >= 4 no two boundaries share a pixel;
//   - the CDEF stage (when on and its threshold > 0), on the deblocked
//     plane padded with its edge to multiples of 8: per 8x8 block the
//     direction (h, v, down-right, down-left) of least energy
//     sum |p - fwd|, fwd the plane shifted one step along it, the first on
//     ties; each pixel then takes p + ((4 c1 + 2 c2 + 8) >> 4), c1 and c2
//     the clamped (+-t) differences to its +-1 and +-2 neighbours along
//     that direction. A shift clamps rows to the plane, but where the
//     column leaves the padded plane it takes the edge column of the
//     pixel's own row, not of the shifted row (the JAX package's _shift2);
//     the output is cropped back to H x W.
//
// A tile: the 32x32 output pixels (an 8-aligned tile holds whole CDEF
// blocks) and a halo of 5 go into shared memory once: the CDEF taps reach
// 2 pixels, and a deblocked value at 2 pixels out depends on originals 3
// pixels further. Deblocking runs in place there over the whole halo,
// vertical boundaries then horizontal ones, skipping boundaries whose four
// pixels are not all loaded (those pixels lie farther out than the CDEF
// taps reach). The block energies reduce through shared memory, and each
// output pixel computes its block's direction only, where the JAX package
// computes all four and selects. The input is read through L2 (ld.cg):
// in the fused launch it is written during the kernel.

#pragma once

#include <stdint.h>

namespace avt {
namespace lf {

constexpr int kTile = 32;                 // output pixels a side
constexpr int kHalo = 5;                  // CDEF's reach (2) + deblocking's (3)
constexpr int kSide = kTile + 2 * kHalo;  // the shared region a side
constexpr int kBlocksPerSide = kTile / 8;
constexpr int kBlocks = kBlocksPerSide * kBlocksPerSide;  // CDEF blocks a tile

// One plane's filters: its size, the deblocking grid n, the thresholds and
// which filters are on.
struct Settings {
  int h, w, n, deblock_thresh, cdef_thresh, deblock, cdef;
};

// The tile's shared memory.
struct TileSmem {
  int32_t d[kSide * kSide];      // the region, deblocked in place
  int32_t part[kBlocks * 4 * 8];  // energy per (block, direction, row)
  int best[kBlocks];
};

// The CDEF directions (dy, dx): h (0, 1), v (1, 0), down-right (1, 1),
// down-left (1, -1).
__device__ __forceinline__ int dir_dy(int d) { return d == 0 ? 0 : 1; }
__device__ __forceinline__ int dir_dx(int d) { return d == 1 ? 0 : (d == 3 ? -1 : 1); }

// One boundary: p1 p0 | q0 q1 at v[0], v[s], v[2s], v[3s], rewritten in
// place from their values before it.
__device__ __forceinline__ void deblock4(int32_t* v, int s, int32_t thresh) {
  const int32_t p1 = v[0], p0 = v[s], q0 = v[2 * s], q1 = v[3 * s];
  const int32_t half = (thresh >> 1) + 1;
  if (abs(p0 - q0) < thresh && abs(p1 - p0) < half && abs(q1 - q0) < half) {
    const int32_t mid = (p1 + 3 * p0 + 3 * q0 + q1 + 4) >> 3;
    v[0] = (2 * p1 + p0 + q0 + 2) >> 2;
    v[s] = mid;
    v[2 * s] = mid;
    v[3 * s] = (p0 + q0 + 2 * q1 + 2) >> 2;
  }
}

__device__ __forceinline__ int32_t clamp_t(int32_t v, int32_t t) { return min(max(v, -t), t); }

// The first multiple of n at or after v (v >= 0).
__device__ __forceinline__ int round_up(int v, int n) { return (v + n - 1) / n * n; }

// Every thread of the CTA (tid of nthreads) calls it: the filtered tile
// (ty, tx) of one plane, from `in` into `out` (both that plane's (h, w)
// int32, row-major, distinct). Ends with a __syncthreads, so the caller
// may reuse `sm` at once.
__device__ __forceinline__ void filter_tile(const Settings& prm, const int32_t* __restrict__ in,
                                            int32_t* __restrict__ out, int ty, int tx, TileSmem& sm,
                                            int tid, int nthreads) {
  const int h = prm.h, w = prm.w;
  const int y0 = ty * kTile, x0 = tx * kTile;
  // Plane coordinates of sm.d[0], and the loaded part [ry0, ry1) x [rx0, rx1).
  const int oy = y0 - kHalo, ox = x0 - kHalo;
  const int ry0 = max(oy, 0), ry1 = min(oy + kSide, h);
  const int rx0 = max(ox, 0), rx1 = min(ox + kSide, w);
  // Four loads in flight a thread, then their stores.
  constexpr int kLoads = 4;
  for (int k0 = tid; k0 < kSide * kSide; k0 += kLoads * nthreads) {
    int32_t v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = k0 + u * nthreads, r = oy + k / kSide, c = ox + k % kSide;
      const bool on = k < kSide * kSide && r >= ry0 && r < ry1 && c >= rx0 && c < rx1;
      v[u] = on ? __ldcg(in + (long long)r * w + c) : 0;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = k0 + u * nthreads, r = oy + k / kSide, c = ox + k % kSide;
      if (k < kSide * kSide && r >= ry0 && r < ry1 && c >= rx0 && c < rx1) sm.d[k] = v[u];
    }
  }
  __syncthreads();

  if (prm.deblock) {
    const int n = prm.n;
    const int32_t t = prm.deblock_thresh;
    // Vertical boundaries b (n <= b <= w - 2) whose b - 2 .. b + 1 are loaded.
    int lo = round_up(max(n, rx0 + 2), n), hi = min(w - 2, rx1 - 2);
    int nb = hi >= lo ? (hi - lo) / n + 1 : 0;
    for (int k = tid; k < nb * (ry1 - ry0); k += nthreads) {
      const int r = ry0 + k / nb, b = lo + (k % nb) * n;
      deblock4(sm.d + (r - oy) * kSide + (b - 2 - ox), 1, t);
    }
    __syncthreads();
    // Horizontal boundaries, on the vertically filtered values.
    lo = round_up(max(n, ry0 + 2), n);
    hi = min(h - 2, ry1 - 2);
    nb = hi >= lo ? (hi - lo) / n + 1 : 0;
    const int cols = rx1 - rx0;
    for (int k = tid; k < nb * cols; k += nthreads) {
      const int b = lo + (k / cols) * n, c = rx0 + k % cols;
      deblock4(sm.d + (b - 2 - oy) * kSide + (c - ox), kSide, t);
    }
    __syncthreads();
  }

  // D(r, c): the deblocked plane at plane coordinates inside the region.
  auto D = [&](int r, int c) { return sm.d[(r - oy) * kSide + (c - ox)]; };
  const int wp = (w + 7) & ~7;
  // The edge-padded plane shifted by (dy, dx), at padded (y, x).
  auto tap = [&](int y, int x, int dy, int dx) {
    const int sc = x - dx;
    if (sc < 0) return D(min(y, h - 1), 0);
    if (sc >= wp) return D(min(y, h - 1), w - 1);
    return D(min(max(y - dy, 0), h - 1), min(sc, w - 1));
  };

  const int32_t t = prm.cdef_thresh;
  const bool cdef = prm.cdef && t > 0;
  if (cdef) {
    for (int k = tid; k < kBlocks * 4 * 8; k += nthreads) {
      const int blk = k / 32, d = (k / 8) % 4, i = k % 8;
      const int by = y0 + (blk / kBlocksPerSide) * 8, bx = x0 + (blk % kBlocksPerSide) * 8;
      int32_t e = 0;
      if (by < h && bx < w) {
        const int y = by + i, dy = dir_dy(d), dx = dir_dx(d);
        for (int j = 0; j < 8; ++j) {
          const int x = bx + j;
          e += abs(D(min(y, h - 1), min(x, w - 1)) - tap(y, x, dy, dx));
        }
      }
      sm.part[k] = e;
    }
    __syncthreads();
    if (tid < kBlocks) {
      int best = 0;
      int32_t best_e = 0;
      for (int d = 0; d < 4; ++d) {
        int32_t e = 0;
        for (int i = 0; i < 8; ++i) e += sm.part[tid * 32 + d * 8 + i];
        if (d == 0 || e < best_e) {
          best = d;
          best_e = e;
        }
      }
      sm.best[tid] = best;
    }
    __syncthreads();
  }

  for (int k = tid; k < kTile * kTile; k += nthreads) {
    const int y = y0 + k / kTile, x = x0 + k % kTile;
    if (y >= h || x >= w) continue;
    int32_t v = D(y, x);
    if (cdef) {
      const int d = sm.best[((y - y0) / 8) * kBlocksPerSide + (x - x0) / 8];
      const int dy = dir_dy(d), dx = dir_dx(d);
      const int32_t c1 = clamp_t(tap(y, x, dy, dx) - v, t) + clamp_t(tap(y, x, -dy, -dx) - v, t);
      const int32_t c2 =
          clamp_t(tap(y, x, 2 * dy, 2 * dx) - v, t) + clamp_t(tap(y, x, -2 * dy, -2 * dx) - v, t);
      v += (4 * c1 + 2 * c2 + 8) >> 4;
    }
    out[(long long)y * w + x] = v;
  }
  __syncthreads();
}

}  // namespace lf
}  // namespace avt
