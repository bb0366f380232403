// The reformat: RGB -> YUV and YUV -> RGB, one launch each way, for
// Hopper (sm_90a).
//
// Replaces the JAX package's jitted programs (libavif_tpu/pixels/reformat.py:
// _yuv_to_rgb_float and _rgb_to_yuv_float, :156-283; the identity and
// YCgCo-Re/Ro liftings, :284-358), which XLA compiles into one fused program
// per configuration. The port's plain versions (pixels/reformat.py) run the
// same arithmetic as a chain of eager ops; these kernels compute it bit for
// bit as they do:
//   - every fp32 operation is written with __fmul_rn / __fadd_rn /
//     __fsub_rn, so nvcc contracts nothing into an FMA;
//   - every fused multiply-add of the plain version (its _fma: the fp32
//     operands widened to double, an exact product, one add, one rounding
//     to fp32) is fma_d below: __dmul_rn, __dadd_rn, __double2float_rn;
//   - the constants arrive as the doubles the plain version uses (its
//     _recip, _k and bias + 0.5), in the parameter struct.
//
// What bounds it on an H100 SXM. A 12.2 MP 8-bit 4:2:0 conversion reads
// and writes 4.5 bytes a pixel (RGB 3, YUV 1.5): 54.9 MB, 0.0164 ms at
// 3.35 TB/s. The fp64 emulation of each FMA costs about 20 fp32 <-> fp64
// conversions a pixel (RGB -> YUV at 4:2:0 with the average; about four
// times that with the sharp filter, which converts each pixel once for
// each of the four chroma sites whose window holds it), and Hopper
// converts to and from 64-bit types at 16 a clock an SM: 4.2 T/s, so
// about 0.06 ms, above the byte bound.
//
// Design: one thread per chroma site, a block of 32 x 8 sites.
//   - A site is the (1 << sy) x (1 << sx) luma pixels that share one U and
//     one V sample: at 4:2:0 a thread reads 4 RGB pixels and writes 4 Y,
//     1 U and 1 V, or reads 4 Y, 1 U and 1 V and writes 4 RGB pixels.
//     Neighbouring threads take neighbouring sites, so a warp's loads and
//     stores of a row are contiguous runs.
//   - Everything the configuration fixes is a template parameter: the
//     mode (matrix, YCgCo, identity, YCgCo-Re/Ro lifting), sx and sy,
//     nearest or bilinear upsampling, average or sharp downsampling,
//     monochrome, and 8- or 16-bit samples in and out (16-bit samples as
//     uint16, the bit pattern of the int16 tensors the wrapper passes).
//   - Bilinear upsampling reads the 3 x 3 chroma window around the site,
//     the sharp filter the 4 x 4 pixel window (both clamped at the
//     edges): the overlap between threads is served by L1.
//   - Odd sizes: the average and the sharp taps replicate the last row and
//     column, and a site writes only the pixels inside the image.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Mode { kMatrix = 0, kYCgCo = 1, kIdentity = 2, kLifted = 3 };

// Mirror of reformat._YuvToRgbParams (ctypes).
struct YuvToRgbParams {
  int h, w;             // the Y plane and the RGB image
  int ch, cw;           // the U and V planes
  int mode, sx, sy, bilinear, mono;
  int in_bytes, out_bytes;
  int shift;            // identity: rgb_depth - depth
  int offset;           // YCgCo-Re/Ro: 1 << (depth - 1)
  int rgb_max;          // YCgCo-Re/Ro: the clamp
  double y_bias, uv_bias, inv_y, inv_uv;
  double cr_k, cb_k, g_cr, g_cb, g_k;  // matrix
  double out_scale, out_round, out_max;  // the unorm of R, G and B
};

// Mirror of reformat._RgbToYuvParams (ctypes).
struct RgbToYuvParams {
  int h, w;             // the RGB image and the Y plane
  int ch, cw;           // the U and V planes
  int mode, sx, sy, sharp, mono;
  int in_bytes, out_bytes;
  int shift;            // identity: depth - rgb_depth
  int offset;           // YCgCo-Re/Ro: 1 << (depth - 1)
  int unused;
  double inv, kr, kg, kb, half_g;       // RGB -> Y and the chroma differences
  double scale_u, scale_v, k3_u, k3_v;  // the differences' factors; 3 x those (sharp)
  double y_scale, y_round;              // the unorm of Y
  double uv_scale_u, uv_scale_v, uv_round;  // the unorm of U and V
  double out_max;
};

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// a * b + c, the product exact in fp64 and the sum rounded once to fp32:
// the plain version's _fma.
__device__ __forceinline__ float fma_d(float a, double b, double c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, b), c));
}

__device__ __forceinline__ float f32(double x) { return __double2float_rn(x); }

// floor(x * scale + round) clamped to [0, max]: the plain version's _unorm.
__device__ __forceinline__ int unorm(float x, double scale, double round, float max_value) {
  return (int)fminf(fmaxf(floorf(fma_d(x, scale, round)), 0.0f), max_value);
}

__device__ __forceinline__ int shifted(int x, int shift) {
  return shift > 0 ? x << shift : shift < 0 ? x >> -shift : x;
}

// --------------------------------------------------------------- YUV -> RGB

// 2x upsampling along one axis: (3 c + the clamped neighbour) / 4, the
// neighbour above or left for the even output, below or right for the odd.
__device__ __forceinline__ float upsample_tap(float centre, float neighbour) {
  return __fmul_rn(__fadd_rn(__fmul_rn(3.0f, centre), neighbour), 0.25f);
}

// The site's chroma, upsampled to its (1 << SY) x (1 << SX) pixels.
template <int SX, int SY, bool Bilinear, typename In>
__device__ __forceinline__ void upsample(const YuvToRgbParams& p, const In* __restrict__ c, int i, int j,
                                         float (&out)[1 << SY][1 << SX]) {
  const size_t cw = p.cw;
  if constexpr (!Bilinear) {
    const float s = (float)c[i * cw + j];
#pragma unroll
    for (int dy = 0; dy < (1 << SY); ++dy)
#pragma unroll
      for (int dx = 0; dx < (1 << SX); ++dx) out[dy][dx] = s;
  } else {
    // the vertical pass at columns j - 1, j, j + 1 (clamped), then the
    // horizontal pass over them
    const int cols[3] = {max(j - 1, 0), j, min(j + 1, p.cw - 1)};
    const int above = max(i - 1, 0), below = min(i + 1, p.ch - 1);
    float vert[1 << SY][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (!SX && k != 1) continue;
      const float centre = (float)c[i * cw + cols[k]];
      if constexpr (SY) {
        vert[0][k] = upsample_tap(centre, (float)c[above * cw + cols[k]]);
        vert[1][k] = upsample_tap(centre, (float)c[below * cw + cols[k]]);
      } else {
        vert[0][k] = centre;
      }
    }
#pragma unroll
    for (int dy = 0; dy < (1 << SY); ++dy) {
      if constexpr (SX) {
        out[dy][0] = upsample_tap(vert[dy][1], vert[dy][0]);
        out[dy][1] = upsample_tap(vert[dy][1], vert[dy][2]);
      } else {
        out[dy][0] = vert[dy][1];
      }
    }
  }
}

template <typename Out>
__device__ __forceinline__ void store_rgb(const YuvToRgbParams& p, Out* __restrict__ rgb, size_t px, float r,
                                          float g, float b) {
  const float rgb_max = f32(p.out_max);
  rgb[3 * px + 0] = (Out)unorm(fminf(fmaxf(r, 0.0f), 1.0f), p.out_scale, p.out_round, rgb_max);
  rgb[3 * px + 1] = (Out)unorm(fminf(fmaxf(g, 0.0f), 1.0f), p.out_scale, p.out_round, rgb_max);
  rgb[3 * px + 2] = (Out)unorm(fminf(fmaxf(b, 0.0f), 1.0f), p.out_scale, p.out_round, rgb_max);
}

template <typename In, typename Out, int M, int SX, int SY, bool Bilinear>
__global__ void __launch_bounds__(kBlockX* kBlockY)
yuv_to_rgb_float(const YuvToRgbParams p, const In* __restrict__ y, const In* __restrict__ u,
                 const In* __restrict__ v, Out* __restrict__ rgb) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int r0 = i << SY, c0 = j << SX;
  if (r0 >= p.h || c0 >= p.w) return;
  float cb[1 << SY][1 << SX], cr[1 << SY][1 << SX];
  upsample<SX, SY, Bilinear>(p, u, i, j, cb);
  upsample<SX, SY, Bilinear>(p, v, i, j, cr);
  const float y_bias = f32(p.y_bias), uv_bias = f32(p.uv_bias), inv_y = f32(p.inv_y), inv_uv = f32(p.inv_uv);
#pragma unroll
  for (int dy = 0; dy < (1 << SY); ++dy) {
#pragma unroll
    for (int dx = 0; dx < (1 << SX); ++dx) {
      const int r = r0 + dy, c = c0 + dx;
      if (r >= p.h || c >= p.w) continue;
      const size_t px = (size_t)r * p.w + c;
      const float yf = __fsub_rn((float)y[px], y_bias);
      const float b = __fsub_rn(cb[dy][dx], uv_bias), rr = __fsub_rn(cr[dy][dx], uv_bias);
      float R, G, B;
      if constexpr (M == kYCgCo) {
        const float cg = __fmul_rn(b, inv_uv);
        const float t = fma_d(yf, p.inv_y, -(double)cg);  // Y - Cg
        G = fma_d(yf, p.inv_y, cg);                         // Y + Cg
        B = fma_d(rr, -p.inv_uv, t);                        // t - Co
        R = fma_d(rr, p.inv_uv, t);                         // t + Co
      } else {
        if constexpr (SX || SY) {  // the chroma term fused
          const float yl = __fmul_rn(yf, inv_y);
          R = fma_d(rr, p.cr_k, yl);
          B = fma_d(b, p.cb_k, yl);
        } else {  // the luma term fused
          R = fma_d(yf, p.inv_y, __fmul_rn(rr, f32(p.cr_k)));
          B = fma_d(yf, p.inv_y, __fmul_rn(b, f32(p.cb_k)));
        }
        const float g = fma_d(rr, p.g_cr, __fmul_rn(b, f32(p.g_cb)));
        G = fma_d(yf, p.inv_y, -(double)__fmul_rn(g, f32(p.g_k)));
      }
      store_rgb(p, rgb, px, R, G, B);
    }
  }
}

// No chroma: R = G = B = Y.
template <typename In, typename Out>
__global__ void __launch_bounds__(kBlockX* kBlockY)
yuv_to_rgb_mono(const YuvToRgbParams p, const In* __restrict__ y, Out* __restrict__ rgb) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (r >= p.h || c >= p.w) return;
  const size_t px = (size_t)r * p.w + c;
  const float g = __fmul_rn(__fsub_rn((float)y[px], f32(p.y_bias)), f32(p.inv_y));
  store_rgb(p, rgb, px, g, g, g);
}

// Identity (G = Y, B = U, R = V, shifted to the RGB depth) or the YCgCo-Re/Ro
// inverse lifting, exact in int32 with arithmetic shifts.
template <typename In, typename Out, bool Lifted>
__global__ void __launch_bounds__(kBlockX* kBlockY)
yuv_to_rgb_int(const YuvToRgbParams p, const In* __restrict__ y, const In* __restrict__ u,
               const In* __restrict__ v, Out* __restrict__ rgb) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (r >= p.h || c >= p.w) return;
  const size_t px = (size_t)r * p.w + c;
  const int Y = y[px], U = u[px], V = v[px];
  int R, G, B;
  if constexpr (Lifted) {
    const int cg = U - p.offset, co = V - p.offset;
    const int t = Y - (cg >> 1);
    G = min(max(t + cg, 0), p.rgb_max);
    const int b = t - (co >> 1);
    B = min(max(b, 0), p.rgb_max);
    R = min(max(b + co, 0), p.rgb_max);
  } else {
    G = shifted(Y, p.shift);
    B = shifted(U, p.shift);
    R = shifted(V, p.shift);
  }
  rgb[3 * px + 0] = (Out)R;
  rgb[3 * px + 1] = (Out)G;
  rgb[3 * px + 2] = (Out)B;
}

// --------------------------------------------------------------- RGB -> YUV

// One pixel's Y and its two chroma differences before their factors:
// (B - Y, R - Y) for a matrix, (Cg, Co) for YCgCo.
struct Pixel {
  float y, du, dv;
};

template <int M, typename In>
__device__ __forceinline__ Pixel convert(const RgbToYuvParams& p, const In* __restrict__ rgb, int r, int c) {
  const size_t px = 3 * ((size_t)r * p.w + c);
  const float R = (float)rgb[px], G = (float)rgb[px + 1], B = (float)rgb[px + 2];
  const float inv = f32(p.inv);
  if constexpr (M == kYCgCo) {
    const float q = __fmul_rn(fma_d(R, p.inv, __fmul_rn(B, inv)), 0.25f);  // (R + B) / 4
    return {fma_d(G, p.half_g, q), fma_d(G, p.half_g, -(double)q), fma_d(R, p.inv, -(double)__fmul_rn(B, inv))};
  } else {
    // Y for U with green's product rounded first, for V with red's
    const float y = fma_d(B, p.kb, fma_d(R, p.kr, __fmul_rn(G, f32(p.kg))));
    const float y_for_v = fma_d(B, p.kb, fma_d(G, p.kg, __fmul_rn(R, f32(p.kr))));
    return {y, fma_d(B, p.inv, -(double)y), fma_d(R, p.inv, -(double)y_for_v)};
  }
}

// One axis of the sharp [1, 3, 3, 1] / 8 filter; scale is 1 on the second
// axis (the plain version then skips the multiplies, which are exact).
__device__ __forceinline__ float sharp_tap(float left, float mid, float right, float right2, float scale,
                                           double k3) {
  left = __fmul_rn(left, scale);
  right = __fmul_rn(right, scale);
  right2 = __fmul_rn(right2, scale);
  const float acc = fma_d(right, 3.0, fma_d(mid, k3, left));
  return __fmul_rn(__fadd_rn(acc, right2), 0.125f);
}

template <typename Out>
__device__ __forceinline__ void store_y(const RgbToYuvParams& p, Out* __restrict__ y, int r, int c, float value) {
  if (r < p.h && c < p.w) y[(size_t)r * p.w + c] = (Out)unorm(value, p.y_scale, p.y_round, f32(p.out_max));
}

template <typename In, typename Out, int M, int SX, int SY, bool Sharp, bool Mono>
__global__ void __launch_bounds__(kBlockX* kBlockY)
rgb_to_yuv_float(const RgbToYuvParams p, const In* __restrict__ rgb, Out* __restrict__ y, Out* __restrict__ u,
                 Out* __restrict__ v) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int r0 = i << SY, c0 = j << SX;
  if (r0 >= p.h || c0 >= p.w) return;
  float su, sv;  // the chroma filters' sums
  if constexpr (!Sharp) {
    // the site's pixels, the last row and column replicated past the edge;
    // the average's sum in the plain version's order (row by row)
    su = sv = 0.0f;
#pragma unroll
    for (int dy = 0; dy < (1 << SY); ++dy) {
#pragma unroll
      for (int dx = 0; dx < (1 << SX); ++dx) {
        const Pixel q = convert<M>(p, rgb, min(r0 + dy, p.h - 1), min(c0 + dx, p.w - 1));
        store_y(p, y, r0 + dy, c0 + dx, q.y);
        if constexpr (SX || SY) {
          if (dy == 0 && dx == 0) {
            su = __fmul_rn(q.du, f32(p.scale_u));
            sv = __fmul_rn(q.dv, f32(p.scale_v));
          } else {
            su = fma_d(q.du, p.scale_u, su);
            sv = fma_d(q.dv, p.scale_v, sv);
          }
        } else {
          su = q.du;  // 4:4:4: the factor goes into the unorm's scale
          sv = q.dv;
        }
      }
    }
  } else {
    // the 4-tap window of each subsampled axis, clamped; the vertical pass
    // first, with the factor, then the horizontal pass
    constexpr int kRows = SY ? 4 : 1, kCols = SX ? 4 : 1;
    float du[kRows][kCols], dv[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = SY ? min(max(r0 - 1 + a, 0), p.h - 1) : r0;
#pragma unroll
      for (int b = 0; b < kCols; ++b) {
        const int c = SX ? min(max(c0 - 1 + b, 0), p.w - 1) : c0;
        const Pixel q = convert<M>(p, rgb, r, c);
        du[a][b] = q.du;
        dv[a][b] = q.dv;
        if ((!SY || a == 1 || a == 2) && (!SX || b == 1 || b == 2))
          store_y(p, y, r0 + (SY ? a - 1 : 0), c0 + (SX ? b - 1 : 0), q.y);
      }
    }
    float scale_u = f32(p.scale_u), scale_v = f32(p.scale_v);
    double k3_u = p.k3_u, k3_v = p.k3_v;
    if constexpr (SY) {
#pragma unroll
      for (int b = 0; b < kCols; ++b) {
        du[0][b] = sharp_tap(du[0][b], du[1][b], du[2][b], du[3][b], scale_u, k3_u);
        dv[0][b] = sharp_tap(dv[0][b], dv[1][b], dv[2][b], dv[3][b], scale_v, k3_v);
      }
      scale_u = scale_v = 1.0f;
      k3_u = k3_v = 3.0;
    }
    if constexpr (SX) {
      du[0][0] = sharp_tap(du[0][0], du[0][1], du[0][2], du[0][3], scale_u, k3_u);
      dv[0][0] = sharp_tap(dv[0][0], dv[0][1], dv[0][2], dv[0][3], scale_v, k3_v);
    }
    su = du[0][0];
    sv = dv[0][0];
  }
  if constexpr (!Mono) {
    const size_t site = (size_t)i * p.cw + j;
    u[site] = (Out)unorm(su, p.uv_scale_u, p.uv_round, f32(p.out_max));
    v[site] = (Out)unorm(sv, p.uv_scale_v, p.uv_round, f32(p.out_max));
  }
}

// Identity (Y = G, U = B, V = R, shifted to the YUV depth) or the YCgCo-Re/Ro
// forward lifting; nothing is clamped, and the store wraps.
template <typename In, typename Out, bool Lifted>
__global__ void __launch_bounds__(kBlockX* kBlockY)
rgb_to_yuv_int(const RgbToYuvParams p, const In* __restrict__ rgb, Out* __restrict__ y, Out* __restrict__ u,
               Out* __restrict__ v) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (r >= p.h || c >= p.w) return;
  const size_t px = (size_t)r * p.w + c;
  const int R = rgb[3 * px], G = rgb[3 * px + 1], B = rgb[3 * px + 2];
  if constexpr (Lifted) {
    const int co = R - B;
    const int t = B + (co >> 1);
    const int cg = G - t;
    y[px] = (Out)(t + (cg >> 1));
    u[px] = (Out)(cg + p.offset);
    v[px] = (Out)(co + p.offset);
  } else {
    y[px] = (Out)shifted(G, p.shift);
    u[px] = (Out)shifted(B, p.shift);
    v[px] = (Out)shifted(R, p.shift);
  }
}

// ------------------------------------------------------------------ dispatch

template <typename T>
struct Tag {
  using type = T;
};
template <int V>
using Int = std::integral_constant<int, V>;

template <typename F>
int by_width(int bytes, F&& f) {
  if (bytes == 1) return f(Tag<uint8_t>{});
  if (bytes == 2) return f(Tag<uint16_t>{});
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int by_widths(int in_bytes, int out_bytes, F&& f) {
  return by_width(in_bytes, [&](auto in) { return by_width(out_bytes, [&](auto out) { return f(in, out); }); });
}

template <typename F>
int by_flag(int flag, F&& f) {
  return flag ? f(std::true_type{}) : f(std::false_type{});
}

// 4:4:4, 4:2:2 and 4:2:0
template <typename F>
int by_shifts(int sx, int sy, F&& f) {
  if (sx == 0 && sy == 0) return f(Int<0>{}, Int<0>{});
  if (sx == 1 && sy == 0) return f(Int<1>{}, Int<0>{});
  if (sx == 1 && sy == 1) return f(Int<1>{}, Int<1>{});
  return (int)cudaErrorInvalidValue;
}

// matrix or YCgCo
template <typename F>
int by_float_mode(int mode, F&& f) {
  if (mode == kMatrix) return f(Int<kMatrix>{});
  if (mode == kYCgCo) return f(Int<kYCgCo>{});
  return (int)cudaErrorInvalidValue;
}

// One thread a site of (1 << sx) x (1 << sy) pixels.
bool grid_of(int h, int w, int sx, int sy, dim3* grid) {
  const long long rows = ((long long)h + (1 << sy) - 1) >> sy, cols = ((long long)w + (1 << sx) - 1) >> sx;
  *grid = dim3((unsigned)((cols + kBlockX - 1) / kBlockX), (unsigned)((rows + kBlockY - 1) / kBlockY));
  return (rows + kBlockY - 1) / kBlockY <= 65535 && (cols + kBlockX - 1) / kBlockX <= 0x7fffffff;
}

}  // namespace

// C interface for ctypes. params: YuvToRgbParams; y: (h, w); u, v: (ch, cw),
// unused when params.mono; rgb: (h, w, 3); samples of in_bytes / out_bytes
// bytes, contiguous, on the current device. Returns a cudaError_t (0 =
// launched).
extern "C" int avt_yuv_to_rgb(const void* params, const void* y, const void* u, const void* v, void* rgb,
                              void* stream) {
  const YuvToRgbParams& p = *static_cast<const YuvToRgbParams*>(params);
  if (p.h < 0 || p.w < 0 || p.ch < 0 || p.cw < 0 || p.sx < 0 || p.sx > 1 || p.sy < 0 || p.sy > p.sx)
    return (int)cudaErrorInvalidValue;
  if (p.h == 0 || p.w == 0) return 0;
  const bool per_site = !p.mono && (p.mode == kMatrix || p.mode == kYCgCo);
  if (per_site && (p.ch < ((p.h + p.sy) >> p.sy) || p.cw < ((p.w + p.sx) >> p.sx)))
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  if (!grid_of(p.h, p.w, per_site ? p.sx : 0, per_site ? p.sy : 0, &grid)) return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = by_widths(p.in_bytes, p.out_bytes, [&](auto in, auto out) -> int {
    using In = typename decltype(in)::type;
    using Out = typename decltype(out)::type;
    const In* Y = static_cast<const In*>(y);
    const In* U = static_cast<const In*>(u);
    const In* V = static_cast<const In*>(v);
    Out* RGB = static_cast<Out*>(rgb);
    if (p.mode == kIdentity || p.mode == kLifted) {
      return by_flag(p.mode == kLifted, [&](auto lifted) {
        yuv_to_rgb_int<In, Out, decltype(lifted)::value><<<grid, block, 0, s>>>(p, Y, U, V, RGB);
        return 0;
      });
    }
    if (p.mode != kMatrix && p.mode != kYCgCo) return (int)cudaErrorInvalidValue;
    if (p.mono) {
      yuv_to_rgb_mono<In, Out><<<grid, block, 0, s>>>(p, Y, RGB);
      return 0;
    }
    return by_float_mode(p.mode, [&](auto mode) {
      return by_shifts(p.sx, p.sy, [&](auto sx, auto sy) {
        constexpr int SX = decltype(sx)::value, SY = decltype(sy)::value;
        constexpr int M = decltype(mode)::value;
        if constexpr (SX == 0 && SY == 0) {
          yuv_to_rgb_float<In, Out, M, 0, 0, false><<<grid, block, 0, s>>>(p, Y, U, V, RGB);
          return 0;
        } else {
          return by_flag(p.bilinear, [&](auto bilinear) {
            yuv_to_rgb_float<In, Out, M, SX, SY, decltype(bilinear)::value><<<grid, block, 0, s>>>(p, Y, U, V, RGB);
            return 0;
          });
        }
      });
    });
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// C interface for ctypes. params: RgbToYuvParams; rgb: (h, w, 3); y: (h, w);
// u, v: (ch, cw), unused when params.mono; samples of in_bytes / out_bytes
// bytes, contiguous, on the current device. Returns a cudaError_t (0 =
// launched).
extern "C" int avt_rgb_to_yuv(const void* params, const void* rgb, void* y, void* u, void* v, void* stream) {
  const RgbToYuvParams& p = *static_cast<const RgbToYuvParams*>(params);
  if (p.h < 0 || p.w < 0 || p.ch < 0 || p.cw < 0 || p.sx < 0 || p.sx > 1 || p.sy < 0 || p.sy > p.sx)
    return (int)cudaErrorInvalidValue;
  if (p.h == 0 || p.w == 0) return 0;
  const bool per_site = !p.mono && (p.mode == kMatrix || p.mode == kYCgCo);
  if (per_site && (p.ch != ((p.h + p.sy) >> p.sy) || p.cw != ((p.w + p.sx) >> p.sx)))
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  if (!grid_of(p.h, p.w, per_site ? p.sx : 0, per_site ? p.sy : 0, &grid)) return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = by_widths(p.in_bytes, p.out_bytes, [&](auto in, auto out) -> int {
    using In = typename decltype(in)::type;
    using Out = typename decltype(out)::type;
    const In* RGB = static_cast<const In*>(rgb);
    Out* Y = static_cast<Out*>(y);
    Out* U = static_cast<Out*>(u);
    Out* V = static_cast<Out*>(v);
    if (p.mode == kIdentity || p.mode == kLifted) {
      return by_flag(p.mode == kLifted, [&](auto lifted) {
        rgb_to_yuv_int<In, Out, decltype(lifted)::value><<<grid, block, 0, s>>>(p, RGB, Y, U, V);
        return 0;
      });
    }
    return by_float_mode(p.mode, [&](auto mode) {
      constexpr int M = decltype(mode)::value;
      if (p.mono) {
        rgb_to_yuv_float<In, Out, M, 0, 0, false, true><<<grid, block, 0, s>>>(p, RGB, Y, U, V);
        return 0;
      }
      return by_shifts(p.sx, p.sy, [&](auto sx, auto sy) {
        constexpr int SX = decltype(sx)::value, SY = decltype(sy)::value;
        if constexpr (SX == 0 && SY == 0) {
          rgb_to_yuv_float<In, Out, M, 0, 0, false, false><<<grid, block, 0, s>>>(p, RGB, Y, U, V);
          return 0;
        } else {
          return by_flag(p.sharp, [&](auto sharp) {
            rgb_to_yuv_float<In, Out, M, SX, SY, decltype(sharp)::value, false><<<grid, block, 0, s>>>(p, RGB, Y, U,
                                                                                                       V);
            return 0;
          });
        }
      });
    });
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
