// The reformat: RGB -> YUV and YUV -> RGB, one launch each way, for
// Hopper (sm_90a).
//
// Replaces the JAX package's jitted programs (libavif_tpu/pixels/reformat.py:
// _yuv_to_rgb_float and _rgb_to_yuv_float, :156-283; the identity and
// YCgCo-Re/Ro liftings, :284-358), which XLA compiles into one fused program
// per configuration. The port's plain versions (pixels/reformat.py) run the
// same arithmetic as a chain of eager ops; these kernels compute it bit for
// bit as they do:
//   - every fp32 product and sum is written with __fmul_rn / __fadd_rn /
//     __fsub_rn, so nvcc contracts nothing into an FMA;
//   - every fused multiply-add of the plain version (its _fma: the fp32
//     operands widened to double, an exact product, one fp64 add, one
//     rounding to fp32) is either a single fp32 FMA, where that provably
//     gives the same float (group (a), below), or a single fp32 FMA behind
//     a guard that falls back to the fp64 form (group (b));
//   - the constants arrive as the doubles the plain version uses (its
//     _recip, _k and bias + 0.5), each an fp32 value (the parameter builders
//     assert it), and are narrowed to float once per thread.
//
// What bounds it on an H100 SXM. A 12.2 MP 8-bit 4:2:0 conversion reads
// and writes 4.5 bytes a pixel (RGB 3, YUV 1.5): 54.9 MB, 0.0164 ms at
// 3.35 TB/s. Emulating every FMA in fp64 costs 70-92 fp32 <-> fp64
// conversions a 2x2 site (313 with the sharp filter), which Hopper runs at
// 16 a clock an SM: three to five times the byte bound. Here the fast path
// converts nothing: samples become floats by the exponent trick
// (sample_bits), the unorm's floor and convert are a directed add
// (floor_bits), the constants are narrowed once per thread, and the fp64
// form runs only where a guard and its certificate fail. What is left is
// instruction issue (some 150-250 a site) and bytes.
//
// Design:
//   - A tile is 4 rows of chroma sites by kSpan = 256 pixel columns; a warp
//     takes one site row of it, a thread kPx = 8 pixels along it (4 sites
//     at 4:2:x, 8 at 4:4:4) in each of its sites' (1 << SY) pixel rows.
//   - The average and bilinear kernels are persistent: as many blocks as
//     fit on the card walk the tiles, staging the next tile's input rows in
//     shared memory with cp.async while they convert the current one (two
//     buffers). The sharp filter's launch takes one tile a block.
//   - Staging: the interior tiles of a plane whose rows start 16-byte
//     aligned are 16-byte blocks alone (stage_blocks); other tiles go row
//     by row (stage_row: the aligned 16-byte blocks inside the row's byte
//     range, its ragged ends byte by byte, so any width and alignment take
//     the wide path). Threads read their spans as words with funnel shifts
//     (read_words). Edges: rows past the image are staged as its last row,
//     columns past it (-1, w, w + 1 where a filter reaches them) as its
//     last column: every filter reads the replicated edge the plain
//     version pads with.
//   - Outputs are packed into words and stored as 16-, 8- or 4-byte
//     vectors where the address allows (store_bytes), else byte by byte; a
//     thread writes only pixels and sites inside the image.
//   - The sharp filter (rgb_to_yuv_sharp) converts each pixel of its tile
//     once into shared memory (chroma differences), takes the vertical taps
//     once per site row and column, then the horizontal ones per site.
//   - Everything the configuration fixes is a template parameter: the
//     mode, sx and sy, nearest or bilinear upsampling, average or sharp
//     downsampling, monochrome, 8- or 16-bit samples in and out (16-bit as
//     uint16, the bit pattern of the int16 tensors the wrapper passes).
//
// ----------------------------------------------------- the two FMA groups
//
// _fma(a, b, c) is rn32(rn64(a*b + c)): a*b of two fp32 values is exact in
// fp64 (48 bits), so only the add rounds twice. Three facts:
//   F1. An fp32 value K with 2^e <= |K| < 2^(e+1) is a multiple of 2^(e-23);
//       a sample is an integer.
//   F2. Rounding to fp32 keeps a multiple of 2^q a multiple of 2^q: either
//       the fp32 grid around the value is a grid of multiples of 2^q, or the
//       value lies on it. So a result built from samples and constants is a
//       multiple of 2^q, q the least exponent among its terms' lowest bits
//       (a product adds them).
//   F3. A sum that is a multiple of 2^q and smaller than 2^(53+q) in
//       magnitude is an fp64 value: the fp64 add is exact, and then
//       rn32(rn64(a*b + c)) = rn32(a*b + c) = __fmaf_rn(a, b, c).
// Group (a): FMAs whose sum F1-F3 bound for every operand the configuration
// can produce. The bounds quoted beside each (q and |sum|) hold for every
// depth and RGB depth up to 16 and every matrix calc_yuv_coefficients gives
// (tests/test_torch_reformat_kernel.py recomputes them from the packed
// constants); the tightest leaves |sum| / 2^q below 2^45, 2^8 under 2^53.
// Group (b), each behind its guard (fma_w, Window; the G guard; unorm_uv):
//   - the average's chroma sums and the sharp filter's two FMAs a tap: a
//     difference of any magnitude times a full-mantissa factor, added to a
//     running sum; their fp64 sums are inexact when the two sit far apart;
//   - G of the YUV -> RGB matrix: its addend is a product of two rounded
//     values, whose lowest bit F1-F2 cannot bound;
//   - the chroma unorm of configurations whose scale unorm_safe does not
//     cover (4:4:4 with a matrix; depths above 13 at full range).
// The Y and RGB unorms are group (a) by the argument at floor_bits.

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
  int guard_uv;         // the chroma unorm is group (b): see unorm_uv
  double inv, kr, kg, kb, half_g;       // RGB -> Y and the chroma differences
  double scale_u, scale_v, k3_u, k3_v;  // the differences' factors; 3 x those (sharp)
  double y_scale, y_round;              // the unorm of Y
  double uv_scale_u, uv_scale_v, uv_round;  // the unorm of U and V
  double out_max;
};

// The integer kernels: one thread a pixel, a block of 32 x 8.
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// The float kernels: a block of kWarps warps, a thread kPx pixels of a row.
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPx = 8;
constexpr int kSpan = 32 * kPx;     // pixel columns of a block
constexpr float kTwo23 = 8388608.0f;

// A staged row's bytes: its span, the 16 bytes before it (room for column
// -1), up to 15 + 15 widened to 16-byte boundaries (stage_row), the word
// the reader loads past its end; rounded to 16 so every row starts aligned.
__host__ __device__ constexpr int row_bytes(int span) { return (span + 64 + 15) & ~15; }

__device__ __forceinline__ float f32(double x) { return __double2float_rn(x); }

// a * b + c, the product exact in fp64 and the sum rounded once to fp32:
// the plain version's _fma. Only group (b) FMAs reach it, where a guard
// failed; b and c are fp32 values, so widening them is exact.
__device__ __noinline__ float fma_d(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// ------------------------------------------------------------ the guards

// Where fma(a, b, c) is exact in fp64, for one factor b: |c| in
// [lo |a|, hi |a|]. With 2^ea <= |a| < 2^(ea+1), 2^eb <= b < 2^(eb+1), b's
// lowest set bit 2^lb and 2^ec <= |c| < 2^(ec+1), the sum a*b + c is a
// multiple of 2^min(ea - 23 + lb, ec - 23) (F1) and below
// 2^max(ea + eb + 3, ec + 2) in magnitude, so by F3 it is exact when
// eb - 27 <= ec - ea <= lb + 28. |c| >= 2^(eb - 27) |a| gives the first
// (ec >= ea + eb - 27), |c| <= 2^(lb + 28) |a| < 2^(lb + 29 + ea) the second.
// a = c = 0 passes (the sum is 0); a = 0 or c = 0 alone fails, though exact:
// a fallback, never a wrong float. Both scalings are by powers of two, exact
// in fp32 for these magnitudes (|a| < 4, b's exponents within [-30, 2]).
struct Window {
  float lo, hi;
};

__device__ __forceinline__ Window window_of(float b) {
  const uint32_t bits = __float_as_uint(b);
  const int eb = (int)((bits >> 23) & 0xFF) - 127;
  const int lb = eb - 24 + __ffs((bits & 0x7FFFFF) | 0x800000);  // the lowest set bit
  return {__uint_as_float((uint32_t)(eb - 27 + 127) << 23), __uint_as_float((uint32_t)(lb + 28 + 127) << 23)};
}

// Past a failed window, r = __fmaf_rn(a, b, c) is still the plain
// version's float where c dominates and the residual certifies r; else the
// fp64 form decides. The proof: if |c| > 2^(lb+28) |a| (the window's upper
// side failed), then |a b| < 2^(eb+1) |a| <= 2^(lb+24) |a| < |c| / 16, so
// v = a b + c and r = rn32(v) lie in [c/2, 2c]: d = r - c is exact
// (Sterbenz) and e = rn32(a b - d), one fp32 FMA, is v - r rounded once. The
// roundings differ only where rn64(v) is the fp32 midpoint m between r and
// a neighbour while v != m; with r's mantissa nonzero both neighbours are
// u = ulp(r) away, so there |v - r| >= u/2 - 2^-53 |m| > (u/2)(1 - 2^-26)
// and |e| > (u/2)(1 - 2^-23). So |e| <= (u/2)(1 - 2^-23), two floats below
// u/2 = 2^(er - 24), proves r.
__device__ __forceinline__ float fma_rare(float a, float b, float c, float r, Window win) {
  if (fabsf(c) > __fmul_rn(win.hi, fabsf(a))) {
    const uint32_t rb = __float_as_uint(r);
    const uint32_t eb = __float_as_uint(__fmaf_rn(a, b, -__fsub_rn(r, c))) & 0x7FFFFFFFu;
    if ((rb & 0x7FFFFFu) != 0 && eb + 2u + (24u << 23) <= (rb & 0x7F800000u)) return r;
  }
  return fma_d(a, b, c);
}

// Group (b): __fmaf_rn(a, b, c), clearing `exact` unless the window proves
// the fp64 sum exact; with Slow (where a window of the site failed), the
// window, then fma_rare.
template <bool Slow>
__device__ __forceinline__ float fma_w(float a, float b, float c, Window win, bool& exact) {
  const float r = __fmaf_rn(a, b, c);
  const float m = fabsf(c);
  const bool in = (m >= __fmul_rn(win.lo, fabsf(a))) & (m <= __fmul_rn(win.hi, fabsf(a)));
  if constexpr (Slow) {
    return in ? r : fma_rare(a, b, c, r, win);
  } else {
    exact &= in;
    return r;
  }
}

// ---------------------------------------------------------- samples, unorm

// Sample k of a span of samples of Bytes bytes packed in words, as the float
// 2^23 + sample (one byte permute, no conversion: 0x4B000000 | x is the
// float 2^23 + x for x < 2^23; subtracting 2^23, or 2^23 + an integral bias,
// is exact).
template <int Bytes, int NW>
__device__ __forceinline__ float sample_bits(const uint32_t (&w)[NW], int k) {
  const int b = k * Bytes;
  if constexpr (Bytes == 1)
    return __uint_as_float(__byte_perm(w[b >> 2], 0x4B000000u, 0x7540 | (b & 3)));
  else
    return __uint_as_float(__byte_perm(w[b >> 2], 0x4B000000u, 0x7500 | (((b & 3) + 1) << 4) | (b & 3)));
}

// floor(x) as the float 2^23 + floor(x), for 0 <= x < 2^23: its low bits are
// the integer, which the packing stores without a conversion.
//
// Why the Y and RGB unorms are group (a). A unorm is floor(rn32(v)),
// v = x*s + c, clamped to [0, max], where c = beta + 1/2 with beta an integer
// bias >= 0. Double rounding can change floor(rn32(v)) only where rn64(v) is
// the fp32 midpoint m just below an integer k in [1, max] and v != m
// (elsewhere both roundings give one float, or two floats with one floor; k
// <= 0 or k > max clamp alike). Let 2^E <= m < 2^(E+1), E <= 15. Then
// 0 < |v - m| <= 2^(E-53), and m and c are multiples of 2^(E-24), so x*s is
// not a multiple of 2^(E-52): lowbit(x) lowbit(s) < 2^(E-52). As |x| <
// 2^24 lowbit(x) (F1), |x*s| < 2^(E-28) S with S = s / lowbit(s), an odd
// integer below 2^24. But x*s = v - c is within 2^(E-24) + 2^(E-53) of the
// half-integer k - beta - 1/2:
//   - beta = 0 (RGB; Y at full range): |x*s| >= k - 1/2 - 2^(E-23) >=
//     max(1, 2^E) - 1/2 - 2^(E-23) > 2^(E-4) > 2^(E-28) S. No such v.
//   - beta > 0: |x*s| >= 1/2 - 2^(E-23), so none when S <= 2^(27-E) - 2^5,
//     i.e. S <= 2^(28-d) - 2^5 for E <= d - 1, d the output depth
//     (unorm_safe). Y at limited range has S = 219: safe up to d = 19.
__device__ __forceinline__ float floor_bits(float x) { return __fadd_rd(x, kTwo23); }

// The Y unorm (group (a)): floor of one fp32 FMA, clamped to [0, max].
__device__ __forceinline__ float unorm(float x, float scale, float round, float max_value) {
  return floor_bits(fminf(fmaxf(__fmaf_rn(x, scale, round), 0.0f), max_value));
}

// The chroma unorm. Group (a) when the host found unorm_safe (guard_uv 0);
// else group (b): by the argument above, the two roundings floor apart only
// if r = rn32(v) is an integer or its fp32 successor is one, which the guard
// tests (for r in [0, max]; outside it both clamp alike).
template <bool Slow>
__device__ __forceinline__ float unorm_uv(float x, float scale, float round, float max_value, bool guard,
                                          bool& exact) {
  if constexpr (Slow) {
    return floor_bits(fminf(fmaxf(fma_d(x, scale, round), 0.0f), max_value));
  } else {
    const float r = __fmaf_rn(x, scale, round);
    const float t = floor_bits(fminf(fmaxf(r, 0.0f), max_value));
    if (guard) {
      const float fl = __fsub_rn(t, kTwo23);
      exact &= (r != fl) & (__uint_as_float(__float_as_uint(r) + 1u) < __fadd_rn(fl, 1.0f));
    }
    return t;
  }
}

// ------------------------------------------------------- staging, storing

// One 16-byte block from global to shared memory: with Async a cp.async
// (the thread does not wait for it; cp_async_wait does), else a load and a
// store.
template <bool Async>
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src) {
#if defined(__CUDA_ARCH__)
  if constexpr (Async) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src));
    return;
  }
#endif
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// Closes the group of this thread's cp.asyncs issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;");
#endif
}

// Waits until at most `pending` of this thread's groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;" ::"n"(pending));
#endif
}

// Copies bytes [src, src + n) to dst, where dst and src agree mod 16, with
// the 32 lanes of a warp: the 16-byte blocks inside the range with copy16,
// its ragged ends byte by byte. Reads nothing outside it.
template <bool Async>
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* __restrict__ src, int n, int lane) {
  const int head = min((int)((16 - ((uintptr_t)src & 15)) & 15), n);
  const int blocks = (n - head) >> 4;
  if (lane < head) dst[lane] = src[lane];
  for (int k = lane; k < blocks; k += 32) copy16<Async>(dst + head + 16 * k, src + head + 16 * k);
  const int tail = head + (blocks << 4);
  if (tail + lane < n) dst[tail + lane] = src[tail + lane];
}

// NW words of shared memory at byte offset off (any alignment): NW + 1
// aligned loads and funnel shifts.
template <int NW>
__device__ __forceinline__ void read_words(const uint8_t* row, int off, uint32_t (&out)[NW]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (off & ~3));
  const uint32_t sh = (uint32_t)(off & 3) * 8;
  uint32_t prev = w[0];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint32_t next = w[k + 1];
    out[k] = __funnelshift_r(prev, next, sh);
    prev = next;
  }
}

// The low byte or half-word of each of N values (floats 2^23 + v, or
// integers) packed into words.
template <typename Out, int N>
__device__ __forceinline__ void pack(const float (&t)[N], uint32_t (&w)[N * sizeof(Out) / 4]) {
#pragma unroll
  for (int k = 0; k < N * (int)sizeof(Out) / 4; ++k) {
    if constexpr (sizeof(Out) == 1) {
      const uint32_t lo = __byte_perm(__float_as_uint(t[4 * k]), __float_as_uint(t[4 * k + 1]), 0x0040);
      const uint32_t hi = __byte_perm(__float_as_uint(t[4 * k + 2]), __float_as_uint(t[4 * k + 3]), 0x0040);
      w[k] = __byte_perm(lo, hi, 0x5410);
    } else {
      w[k] = __byte_perm(__float_as_uint(t[2 * k]), __float_as_uint(t[2 * k + 1]), 0x5410);
    }
  }
}

// Stores the first n bytes of NW words at dst: as 16-, 8- or 4-byte
// vectors when all 4 NW are wanted and dst allows, else byte by byte.
template <int NW>
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint32_t (&w)[NW], int n) {
  const uintptr_t a = (uintptr_t)dst;
  if (n == 4 * NW) {
    if constexpr (NW % 4 == 0) {
      if ((a & 15) == 0) {
#pragma unroll
        for (int k = 0; k < NW; k += 4)
          *reinterpret_cast<uint4*>(dst + 4 * k) = make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
        return;
      }
    }
    if constexpr (NW % 2 == 0) {
      if ((a & 7) == 0) {
#pragma unroll
        for (int k = 0; k < NW; k += 2) *reinterpret_cast<uint2*>(dst + 4 * k) = make_uint2(w[k], w[k + 1]);
        return;
      }
    }
    if ((a & 3) == 0) {
#pragma unroll
      for (int k = 0; k < NW; ++k) *reinterpret_cast<uint32_t*>(dst + 4 * k) = w[k];
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < 4 * NW; ++k)
    if (k < n) dst[k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
}

// Stages columns [c_lo, c_lo + cols) of one row (w pixels of ncomp samples
// of T) into dst_row with the 32 lanes of a warp; returns the offset in
// dst_row of column c_lo (the columns follow at ncomp * sizeof(T) bytes
// each). The bytes copied are the row's columns inside [0, w) among them,
// widened to 16-byte boundaries as far as the row reaches, so a row that
// starts aligned is copied in 16-byte blocks only; the columns outside
// [0, w) get the edge columns' bytes (the replicated edge).
template <bool Async, typename T>
__device__ __forceinline__ int stage_row(uint8_t* dst_row, const T* row, int c_lo, int cols, int w, int ncomp,
                                         int lane) {
  const int px = ncomp * (int)sizeof(T);
  const uint8_t* src = reinterpret_cast<const uint8_t*>(row);
  const uintptr_t base = (uintptr_t)src;
  int b0 = max(c_lo, 0) * px, b1 = min(c_lo + cols, w) * px;
  b0 = max(b0 - (int)((base + b0) & 15), 0);
  b1 = min(b1 + (int)((16 - ((base + b1) & 15)) & 15), w * px);
  const int off0 = 16 + (int)((base + b0) & 15);  // dst_row + off0 agrees with src + b0 mod 16
  stage_bytes<Async>(dst_row + off0, src + b0, b1 - b0, lane);
  const int off = off0 + c_lo * px - b0;
  for (int k = lane; k < -min(c_lo, 0) * px; k += 32) dst_row[off + k] = src[k % px];
  const int right = max(w - c_lo, 0);  // the first column past the edge, from c_lo
  for (int k = lane; k < (cols - right) * px; k += 32) dst_row[off + right * px + k] = src[(w - 1) * px + k % px];
  return off;
}

// Stages `rows` rows of `blocks` 16-byte blocks each, row k from
// src + k * stride, to dst + k * dst_stride + 16, with all the block's
// threads: the interior of an aligned plane, whose rows need no widening,
// edge or byte.
template <int rows, int blocks>
__device__ __forceinline__ void stage_blocks(uint8_t* dst, int dst_stride, const uint8_t* src, size_t stride) {
  for (int k = threadIdx.x; k < rows * blocks; k += kThreads) {
    const int row = k / blocks, col = k % blocks;
    copy16<true>(dst + row * dst_stride + 16 + 16 * col, src + row * stride + 16 * col);
  }
}

// The tiles of a persistent launch: each block takes tiles blockIdx.x,
// blockIdx.x + gridDim.x, ..., staging the next one's rows (cp.async into
// the other of two buffers) while it converts the current one.
struct Tiles {
  int across, count;
};

// --------------------------------------------------------------- YUV -> RGB

// R, G, B of one pixel in [0, 1] (the plain version's clamp), from
// yf = Y - y_bias and the chroma b = U - uv_bias, rr = V - uv_bias.
struct Matrix {
  float inv_y, inv_uv, cr_k, cb_k, g_cr, g_cb, g_k;
};

// fma.rn.sat: the fp32 FMA, clamped to [0, 1] after its rounding (the
// plain version's clamp of R, G and B).
__device__ __forceinline__ float fma_sat(float a, float b, float c) {
#if defined(__CUDA_ARCH__)
  float d;
  asm("fma.rn.sat.f32 %0, %1, %2, %3;" : "=f"(d) : "f"(a), "f"(b), "f"(c));
  return d;
#else
  return __saturatef(__fmaf_rn(a, b, c));
#endif
}

// The G guard. G = fma(yf, inv_y, -t), t = rn32(g * g_k). yf inv_y is a
// multiple of lowbit(inv_y) >= 2^-40 and below 2 in magnitude; with t = 0,
// or |t| >= 2^-16 (so t is a multiple of 2^-39, F1), the sum is a multiple of
// 2^-40 below 2^4: exact (F3). Only 0 < |t| < 2^-16 (g within 2^-17 of 0,
// a near cancellation of its two terms) takes the fp64 form.
__device__ __forceinline__ bool g_exact(float t) { return (t == 0.0f) | (fabsf(t) >= 0x1p-16f); }

template <int M, bool Sub, bool Slow>
__device__ __forceinline__ void to_rgb(const Matrix& k, float yf, float b, float rr, float& R, float& G, float& B,
                                       bool& exact) {
  if constexpr (M == kYCgCo) {
    // (a): yf inv_y, a multiple of lowbit(inv_y), plus cg = rn32(b inv_uv), a
    // multiple of lowbit(b) lowbit(inv_uv) (b a multiple of 1/16): q >= -43,
    // |sum| < 2.4; then t +- rr inv_uv alike.
    const float cg = __fmul_rn(b, k.inv_uv);
    const float t = __fmaf_rn(yf, k.inv_y, -cg);  // Y - Cg
    G = fma_sat(yf, k.inv_y, cg);                 // Y + Cg
    B = fma_sat(rr, -k.inv_uv, t);                // t - Co
    R = fma_sat(rr, k.inv_uv, t);                 // t + Co
  } else {
    // (a): R and B are yl = rn32(yf inv_y) (a multiple of lowbit(inv_y))
    // plus rr cr_k (rr a multiple of 1/16 after bilinear upsampling): q >=
    // -43, |sum| < 2.2. g: two chroma products, q >= -47, |g| < 0.16.
    if constexpr (Sub) {  // the chroma term fused
      const float yl = __fmul_rn(yf, k.inv_y);
      R = fma_sat(rr, k.cr_k, yl);
      B = fma_sat(b, k.cb_k, yl);
    } else {  // the luma term fused
      R = fma_sat(yf, k.inv_y, __fmul_rn(rr, k.cr_k));
      B = fma_sat(yf, k.inv_y, __fmul_rn(b, k.cb_k));
    }
    const float g = __fmaf_rn(rr, k.g_cr, __fmul_rn(b, k.g_cb));
    const float t = __fmul_rn(g, k.g_k);
    if constexpr (Slow) {
      G = __saturatef(fma_d(yf, k.inv_y, -t));
    } else {
      exact &= g_exact(t);  // (b)
      G = fma_sat(yf, k.inv_y, -t);
    }
  }
}

// A tile is 4 site rows by kSpan pixel columns; a launch is persistent
// (Tiles). The staged chroma has one site of halo on each upsampled axis
// (bilinear).
template <typename In, typename Out, int M, int SX, int SY, bool Bilinear, bool Mono>
__global__ void __launch_bounds__(kThreads, sizeof(In) == 2 ? 6 : 5)  // blocks an SM: 96 registers at 8 bits, 80 at 16
yuv_to_rgb_float(const YuvToRgbParams p, const Tiles tiles, const In* __restrict__ y, const In* __restrict__ u,
                 const In* __restrict__ v, Out* __restrict__ rgb) {
  constexpr int sz = sizeof(In);
  constexpr int K = kPx >> SX;                   // sites a thread
  constexpr int kRows = kWarps << SY;            // Y rows of a tile
  constexpr int HX = Bilinear && SX ? 1 : 0, HY = Bilinear && SY ? 1 : 0;  // chroma halo
  constexpr int kCRows = Mono ? 1 : kWarps + 2 * HY, kCCols = 32 * K + 2 * HX;
  constexpr int kYBytes = row_bytes(kSpan * sz), kCBytes = row_bytes(kCCols * sz);
  constexpr int NWY = kPx * sz / 4;              // words of a thread's Y span
  constexpr int NWC = ((K + 2 * HX) * sz + 3) / 4;  // words of its chroma span
  __shared__ __align__(16) uint8_t ys[2][kRows][kYBytes];
  __shared__ __align__(16) uint8_t cs[2][2][Mono ? 1 : kCRows][Mono ? 16 : kCBytes];
  __shared__ int y_off[2][kRows], c_off[2][2][Mono ? 1 : kCRows];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // planes whose rows all start 16-byte aligned: their interior tiles are
  // staged in 16-byte blocks alone (the chroma from 16 bytes before the
  // halo column)
  const bool y_aligned = ((uintptr_t)y & 15) == 0 && (p.w * sz) % 16 == 0;
  const bool c_aligned =
      Mono || (((uintptr_t)u & 15) == 0 && ((uintptr_t)v & 15) == 0 && (p.cw * sz) % 16 == 0);
  // stages tile t's rows into buffer b (cp.async; the caller commits)
  auto stage = [&](int b, int t) {
    const int r_blk = t / tiles.across * kRows, c_blk = t % tiles.across * kSpan;
    if (y_aligned && r_blk + kRows <= p.h && c_blk + kSpan <= p.w) {
      stage_blocks<kRows, kSpan * sz / 16>(&ys[b][0][0], kYBytes,
                                           reinterpret_cast<const uint8_t*>(y + (size_t)r_blk * p.w + c_blk),
                                           (size_t)p.w * sz);
      if (threadIdx.x < kRows) y_off[b][threadIdx.x] = 16;
    } else {
      for (int q = warp; q < kRows; q += kWarps) {
        const In* row = y + (size_t)min(r_blk + q, p.h - 1) * p.w;
        const int off = stage_row<true>(ys[b][q], row, c_blk, kSpan, p.w, 1, lane);
        if (lane == 0) y_off[b][q] = off;
      }
    }
    if constexpr (!Mono) {
      const int i_blk = t / tiles.across * kWarps, j_blk = t % tiles.across * 32 * K;
      constexpr int back = HX * 16 / sz;  // columns staged before the tile's: 16 bytes with a halo
      if (c_aligned && i_blk >= HY && i_blk - HY + kCRows <= p.ch && j_blk >= back &&
          j_blk + 32 * K + back <= p.cw) {
#pragma unroll
        for (int plane = 0; plane < 2; ++plane)
          stage_blocks<kCRows, (32 * K * sz + 32 * HX) / 16>(
              &cs[b][plane][0][0], kCBytes,
              reinterpret_cast<const uint8_t*>((plane ? v : u) + (size_t)(i_blk - HY) * p.cw + j_blk - back),
              (size_t)p.cw * sz);
        if (threadIdx.x < 2 * kCRows) c_off[b][threadIdx.x / kCRows][threadIdx.x % kCRows] = 16 + HX * (16 - sz);
      } else {
        for (int q = warp; q < 2 * kCRows; q += kWarps) {
          const int plane = q / kCRows, row = q % kCRows;
          const In* c = (plane ? v : u) + (size_t)min(max(i_blk - HY + row, 0), p.ch - 1) * p.cw;
          const int off = stage_row<true>(cs[b][plane][row], c, j_blk - HX, kCCols, p.cw, 1, lane);
          if (lane == 0) c_off[b][plane][row] = off;
        }
      }
    }
  };

  const float y_bias = __fadd_rn(f32(p.y_bias), kTwo23), uv_bias = f32(p.uv_bias);
  const float out_scale = f32(p.out_scale), out_round = f32(p.out_round);
  const Matrix k{f32(p.inv_y), f32(p.inv_uv), f32(p.cr_k), f32(p.cb_k), f32(p.g_cr), f32(p.g_cb), f32(p.g_k)};
  int t = blockIdx.x;
  stage(0, t);
  cp_async_commit();
  for (int n = 0; t < tiles.count; ++n, t += gridDim.x) {
    const int b = n & 1;
    if (t + (int)gridDim.x < tiles.count) stage(b ^ 1, t + gridDim.x);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    __syncthreads();     // and every thread's

    const int i = t / tiles.across * kWarps + warp;       // site row
    const int c0 = t % tiles.across * kSpan + lane * kPx;  // first pixel column
    if ((i << SY) < p.h && c0 < p.w) {
      // the site's chroma at each of its pixels, minus uv_bias: exact for
      // any order of the taps (values are multiples of 1/16 below 2^16), so
      // the taps are summed unscaled, (3 c + n) each axis, and scaled once
      float cb[1 << SY][kPx], cr[1 << SY][kPx];
      if constexpr (!Mono) {
        constexpr float kScale = 1.0f / (float)(1 << (2 * (HX + HY)));
#pragma unroll
        for (int plane = 0; plane < 2; ++plane) {
          float cv[3][K + 2 * HX];  // rows above, at and below the site row
#pragma unroll
          for (int a = 0; a < 1 + 2 * HY; ++a) {
            uint32_t w[NWC];
            read_words(cs[b][plane][warp + a], c_off[b][plane][warp + a] + lane * K * sz, w);
#pragma unroll
            for (int x = 0; x < K + 2 * HX; ++x) cv[a][x] = __fsub_rn(sample_bits<sz>(w, x), kTwo23);
          }
          float vert[1 << SY][K + 2 * HX];
#pragma unroll
          for (int x = 0; x < K + 2 * HX; ++x) {
            if constexpr (HY) {
              vert[0][x] = __fmaf_rn(3.0f, cv[1][x], cv[0][x]);  // exact: integers below 2^18
              vert[1][x] = __fmaf_rn(3.0f, cv[1][x], cv[2][x]);
            } else {
#pragma unroll
              for (int dy = 0; dy < (1 << SY); ++dy) vert[dy][x] = cv[0][x];
            }
          }
          float(&out)[1 << SY][kPx] = plane ? cr : cb;
#pragma unroll
          for (int dy = 0; dy < (1 << SY); ++dy) {
#pragma unroll
            for (int s = 0; s < K; ++s) {
#pragma unroll
              for (int dx = 0; dx < (1 << SX); ++dx) {
                float h = vert[dy][s + HX];
                if constexpr (HX) h = __fmaf_rn(3.0f, h, vert[dy][s + 2 * dx]);  // the left, then the right
                out[dy][(s << SX) + dx] = __fmaf_rn(h, kScale, -uv_bias);
              }
            }
          }
        }
      }

#pragma unroll
      for (int dy = 0; dy < (1 << SY); ++dy) {
        const int r = (i << SY) + dy;
        if (r >= p.h) break;
        const int q = (warp << SY) + dy;
        uint32_t wy[NWY];
        read_words(ys[b][q], y_off[b][q] + lane * kPx * sz, wy);
        float R[kPx], G[kPx], B[kPx];
        bool exact = true;
#pragma unroll
        for (int x = 0; x < kPx; ++x) {
          const float yf = __fsub_rn(sample_bits<sz>(wy, x), y_bias);
          if constexpr (Mono) {
            R[x] = G[x] = B[x] = __saturatef(__fmul_rn(yf, k.inv_y));  // no chroma: R = G = B = Y
          } else {
            to_rgb<M, (SX || SY), false>(k, yf, cb[dy][x], cr[dy][x], R[x], G[x], B[x], exact);
          }
        }
        if (!exact) {  // a G guard failed: G again in the plain version's fp64 form
#pragma unroll
          for (int x = 0; x < kPx; ++x) {
            const float yf = __fsub_rn(sample_bits<sz>(wy, x), y_bias);
            float r_, b_;
            to_rgb<M, (SX || SY), true>(k, yf, cb[dy][x], cr[dy][x], r_, G[x], b_, exact);
          }
        }
        // (a): the RGB unorm, beta = 0 (floor_bits); x in [0, 1], so
        // x s + 1/2 lies in [1/2, s + 1/2] and neither clamp can act
        float o[3 * kPx];
#pragma unroll
        for (int x = 0; x < kPx; ++x) {
          o[3 * x + 0] = floor_bits(__fmaf_rn(R[x], out_scale, out_round));
          o[3 * x + 1] = floor_bits(__fmaf_rn(G[x], out_scale, out_round));
          o[3 * x + 2] = floor_bits(__fmaf_rn(B[x], out_scale, out_round));
        }
        uint32_t w[3 * kPx * sizeof(Out) / 4];
        pack<Out>(o, w);
        store_bytes(reinterpret_cast<uint8_t*>(rgb + 3 * ((size_t)r * p.w + c0)), w,
                    3 * min(kPx, p.w - c0) * (int)sizeof(Out));
      }
    }
    __syncthreads();  // buffer b is read; the next iteration stages into it
  }
}

// Identity (G = Y, B = U, R = V, shifted to the RGB depth) or the YCgCo-Re/Ro
// inverse lifting, exact in int32 with arithmetic shifts.
__device__ __forceinline__ int shifted(int x, int shift) {
  return shift > 0 ? x << shift : shift < 0 ? x >> -shift : x;
}

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

struct Forward {
  float inv, kr, kg, kb, half_g;
};

// One pixel's Y and its two chroma differences before their factors:
// (B - Y, R - Y) for a matrix, (Cg, Co) for YCgCo. All group (a).
template <int M>
__device__ __forceinline__ void convert(const Forward& f, float R, float G, float B, float& y, float& du,
                                        float& dv) {
  if constexpr (M == kYCgCo) {
    // R inv + rn32(B inv), multiples of lowbit(inv): q >= -39, |sum| < 2;
    // then G half_g -+ q/4 and R inv - rn32(B inv) alike (q >= -41, < 1)
    const float bi = __fmul_rn(B, f.inv);
    const float q = __fmul_rn(__fmaf_rn(R, f.inv, bi), 0.25f);  // (R + B) / 4
    y = __fmaf_rn(G, f.half_g, q);
    du = __fmaf_rn(G, f.half_g, -q);
    dv = __fmaf_rn(R, f.inv, -bi);
  } else {
    // Y for U with green's product rounded first, for V with red's. Sums of
    // samples times kr, kg, kb (F1-F2): q >= -43, |sum| <= 1.001. Then
    // B inv - Y and R inv - Y: q >= -43, |sum| < 1.01.
    y = __fmaf_rn(B, f.kb, __fmaf_rn(R, f.kr, __fmul_rn(G, f.kg)));
    const float y_for_v = __fmaf_rn(B, f.kb, __fmaf_rn(G, f.kg, __fmul_rn(R, f.kr)));
    du = __fmaf_rn(B, f.inv, -y);
    dv = __fmaf_rn(R, f.inv, -y_for_v);
  }
}

// Samples x of a thread's span of RGB pixels, converted.
template <int M, int sz, int NW>
__device__ __forceinline__ void convert_span(const Forward& f, const uint32_t (&w)[NW], int x, float& y,
                                             float& du, float& dv) {
  const float R = __fsub_rn(sample_bits<sz>(w, 3 * x), kTwo23);
  const float G = __fsub_rn(sample_bits<sz>(w, 3 * x + 1), kTwo23);
  const float B = __fsub_rn(sample_bits<sz>(w, 3 * x + 2), kTwo23);
  convert<M>(f, R, G, B, y, du, dv);
}

struct Unorms {
  float y_scale, y_round, uv_scale_u, uv_scale_v, uv_round, out_max;
  bool guard_uv;
};

__device__ __forceinline__ Unorms unorms_of(const RgbToYuvParams& p) {
  return {f32(p.y_scale), f32(p.y_round), f32(p.uv_scale_u), f32(p.uv_scale_v), f32(p.uv_round), f32(p.out_max),
          p.guard_uv != 0};
}

// The average over a site (4:2:0 / 4:2:2; at 4:4:4 the difference itself):
// the first difference times its factor, then fma(d, factor, sum) in the
// plain version's order, row by row (group (b)).
template <int SX, int SY, bool Slow>
__device__ __forceinline__ float site_sum(const float (&d)[1 << SY][kPx], int s, float scale, Window win,
                                          bool& exact) {
  if constexpr (!SX && !SY) {
    return d[0][s];  // 4:4:4: the factor goes into the unorm's scale
  } else {
    float sum = __fmul_rn(d[0][s << SX], scale);
#pragma unroll
    for (int k = 1; k < (1 << (SX + SY)); ++k) sum = fma_w<Slow>(d[k >> SX][(s << SX) + (k & SX)], scale, sum, win, exact);
    return sum;
  }
}

// RGB -> YUV with the average (and at 4:4:4 and 4:0:0): a tile is 4 site
// rows by kSpan pixel columns, a launch persistent (Tiles); a thread takes
// 8 pixels of each of its site row's pixel rows, held in registers.
template <typename In, typename Out, int M, int SX, int SY, bool Mono>
__global__ void __launch_bounds__(kThreads)
rgb_to_yuv_float(const RgbToYuvParams p, const Tiles tiles, const In* __restrict__ rgb, Out* __restrict__ y,
                 Out* __restrict__ u, Out* __restrict__ v) {
  constexpr int sz = sizeof(In);
  constexpr int K = kPx >> SX;        // sites a thread
  constexpr int kRows = kWarps << SY;
  constexpr int kBytes = row_bytes(kSpan * 3 * sz);
  constexpr int NW = kPx * 3 * sz / 4;
  __shared__ __align__(16) uint8_t stage[2][kRows][kBytes];
  __shared__ int offs[2][kRows];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // an image whose rows all start 16-byte aligned: its interior tiles are
  // staged in 16-byte blocks alone
  const bool aligned = ((uintptr_t)rgb & 15) == 0 && (p.w * 3 * sz) % 16 == 0;
  // stages tile t's rows into buffer b (cp.async; the caller commits)
  auto stage_tile = [&](int b, int t) {
    const int r_blk = t / tiles.across * kRows, c_blk = t % tiles.across * kSpan;
    if (aligned && r_blk + kRows <= p.h && c_blk + kSpan <= p.w) {
      stage_blocks<kRows, kSpan * 3 * sz / 16>(&stage[b][0][0], kBytes,
                                               reinterpret_cast<const uint8_t*>(rgb + ((size_t)r_blk * p.w + c_blk) * 3),
                                               (size_t)p.w * 3 * sz);
      if (threadIdx.x < kRows) offs[b][threadIdx.x] = 16;
    } else {
      for (int q = warp; q < kRows; q += kWarps) {
        const In* row = rgb + (size_t)min(r_blk + q, p.h - 1) * p.w * 3;
        const int off = stage_row<true>(stage[b][q], row, c_blk, kSpan, p.w, 3, lane);
        if (lane == 0) offs[b][q] = off;
      }
    }
  };

  const Forward f{f32(p.inv), f32(p.kr), f32(p.kg), f32(p.kb), f32(p.half_g)};
  const Unorms un = unorms_of(p);
  const float scale_u = f32(p.scale_u), scale_v = f32(p.scale_v);
  const Window wu = window_of(scale_u), wv = window_of(scale_v);
  int t = blockIdx.x;
  stage_tile(0, t);
  cp_async_commit();
  for (int n = 0; t < tiles.count; ++n, t += gridDim.x) {
    const int b = n & 1;
    if (t + (int)gridDim.x < tiles.count) stage_tile(b ^ 1, t + gridDim.x);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    __syncthreads();     // and every thread's

    const int i = t / tiles.across * kWarps + warp;
    const int c0 = t % tiles.across * kSpan + lane * kPx, j0 = c0 >> SX;
    if ((i << SY) < p.h && c0 < p.w) {
      // each pixel of the span, the columns past the edge replicated
      float du[1 << SY][kPx], dv[1 << SY][kPx];
#pragma unroll
      for (int dy = 0; dy < (1 << SY); ++dy) {
        const int q = (warp << SY) + dy, r = (i << SY) + dy;
        uint32_t w[NW];
        read_words(stage[b][q], offs[b][q] + lane * kPx * 3 * sz, w);
        float o[kPx];
#pragma unroll
        for (int x = 0; x < kPx; ++x) {
          float yv;
          convert_span<M, sz>(f, w, x, yv, du[dy][x], dv[dy][x]);
          o[x] = unorm(yv, un.y_scale, un.y_round, un.out_max);  // (a): floor_bits
        }
        if (r < p.h) {
          uint32_t wy[kPx * sizeof(Out) / 4];
          pack<Out>(o, wy);
          store_bytes(reinterpret_cast<uint8_t*>(y + (size_t)r * p.w + c0), wy,
                      min(kPx, p.w - c0) * (int)sizeof(Out));
        }
      }
      if constexpr (!Mono) {
        float su[K], sv[K];
#pragma unroll
        for (int s = 0; s < K; ++s) {
          bool exact = true;
          su[s] = site_sum<SX, SY, false>(du, s, scale_u, wu, exact);
          sv[s] = site_sum<SX, SY, false>(dv, s, scale_v, wv, exact);
          if (!exact) {  // a window failed: the site's sums again, certified or in fp64 form
            su[s] = site_sum<SX, SY, true>(du, s, scale_u, wu, exact);
            sv[s] = site_sum<SX, SY, true>(dv, s, scale_v, wv, exact);
          }
        }
        float tu[K], tv[K];
        bool exact = true;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          tu[s] = unorm_uv<false>(su[s], un.uv_scale_u, un.uv_round, un.out_max, un.guard_uv, exact);
          tv[s] = unorm_uv<false>(sv[s], un.uv_scale_v, un.uv_round, un.out_max, un.guard_uv, exact);
        }
        if (!exact) {
#pragma unroll
          for (int s = 0; s < K; ++s) {
            tu[s] = unorm_uv<true>(su[s], un.uv_scale_u, un.uv_round, un.out_max, true, exact);
            tv[s] = unorm_uv<true>(sv[s], un.uv_scale_v, un.uv_round, un.out_max, true, exact);
          }
        }
        const size_t site = (size_t)i * p.cw + j0;
        const int nb = min(K, p.cw - j0) * (int)sizeof(Out);
        uint32_t wu8[K * sizeof(Out) / 4], wv8[K * sizeof(Out) / 4];
        pack<Out>(tu, wu8);
        pack<Out>(tv, wv8);
        store_bytes(reinterpret_cast<uint8_t*>(u + site), wu8, nb);
        store_bytes(reinterpret_cast<uint8_t*>(v + site), wv8, nb);
      }
    }
    __syncthreads();  // buffer b is read; the next iteration stages into it
  }
}

// One axis of the sharp [1, 3, 3, 1] / 8 filter; scale is 1 on the second
// axis (the plain version then skips the multiplies, which are exact). Both
// FMAs are group (b): window k3 for the first, window 3 for the second.
template <bool Slow>
__device__ __forceinline__ float sharp_tap(float left, float mid, float right, float right2, float scale, float k3,
                                           Window wk3, Window w3, bool& exact) {
  left = __fmul_rn(left, scale);
  right = __fmul_rn(right, scale);
  right2 = __fmul_rn(right2, scale);
  const float acc = fma_w<Slow>(right, 3.0f, fma_w<Slow>(mid, k3, left, wk3, exact), w3, exact);
  return __fmul_rn(__fadd_rn(acc, right2), 0.125f);
}

// RGB -> YUV with the sharp filter (sx = 1; sy = 0 or 1): a block of 4 site
// rows by 128 sites. The tile reaches one pixel before and two after the
// block on each subsampled axis (the taps' window).
//   1. Each pixel of the tile is converted once: its chroma differences go
//      to shared memory, its Y (inside the block and the image) to the plane.
//   2. With sy, the vertical taps, once per site row and tile column (they
//      take the factor), into shared memory.
//   3. The horizontal taps, per site; the unorm; the stores.
template <typename In, typename Out, int M, int SY>
__global__ void __launch_bounds__(kThreads)
rgb_to_yuv_sharp(const RgbToYuvParams p, const In* __restrict__ rgb, Out* __restrict__ y, Out* __restrict__ u,
                 Out* __restrict__ v) {
  constexpr int sz = sizeof(In);
  constexpr int K = kPx / 2;                     // sites a thread
  constexpr int HT = SY, kRows = (kWarps << SY) + 3 * SY;  // tile rows: 1 above, 2 below with sy
  constexpr int kCols = kSpan + 3;               // tile columns: 1 before, 2 after
  constexpr int kBytes = row_bytes(kCols * 3 * sz);
  constexpr int kD = kSpan + 8;                  // a difference row; tile column x at x + 3
  constexpr int NW = kPx * 3 * sz / 4;
  __shared__ __align__(16) uint8_t stage[kRows * kBytes];
  __shared__ __align__(16) float dd[2][kRows][kD];
  __shared__ int offs[kRows];
  static_assert(!SY || 2 * kWarps * kD * sizeof(float) <= sizeof(stage), "the vertical taps reuse the staging");

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_blk = blockIdx.y * (kWarps << SY), c_blk = blockIdx.x * kSpan;
  for (int q = warp; q < kRows; q += kWarps) {
    const In* row = rgb + (size_t)min(max(r_blk - HT + q, 0), p.h - 1) * p.w * 3;
    const int off = stage_row<false>(stage + q * kBytes, row, c_blk - 1, kCols, p.w, 3, lane);
    if (lane == 0) offs[q] = off;
  }
  __syncthreads();

  const Forward f{f32(p.inv), f32(p.kr), f32(p.kg), f32(p.kb), f32(p.half_g)};
  const Unorms un = unorms_of(p);
  // 1. groups of 8 pixels at tile columns 1 + 8 m (the block's own columns),
  // then the three halo columns one pixel each
  for (int item = threadIdx.x; item < kRows * 32; item += kThreads) {
    const int q = item >> 5, m = item & 31;
    uint32_t w[NW];
    read_words(stage + q * kBytes, offs[q] + (1 + 8 * m) * 3 * sz, w);
    float t[kPx];
#pragma unroll
    for (int x = 0; x < kPx; ++x) {
      float yv;
      convert_span<M, sz>(f, w, x, yv, dd[0][q][4 + 8 * m + x], dd[1][q][4 + 8 * m + x]);
      t[x] = unorm(yv, un.y_scale, un.y_round, un.out_max);  // (a)
    }
    const int r = r_blk - HT + q, c = c_blk + 8 * m;
    if (q >= HT && q < HT + (kWarps << SY) && r < p.h && c < p.w) {
      uint32_t wy[kPx * sizeof(Out) / 4];
      pack<Out>(t, wy);
      store_bytes(reinterpret_cast<uint8_t*>(y + (size_t)r * p.w + c), wy, min(kPx, p.w - c) * (int)sizeof(Out));
    }
  }
  for (int item = threadIdx.x; item < kRows * 3; item += kThreads) {
    const int q = item / 3, x = item % 3 ? kSpan + item % 3 : 0;  // tile columns 0, kSpan + 1, kSpan + 2
    uint32_t w[(3 * sz + 3) / 4];
    read_words(stage + q * kBytes, offs[q] + x * 3 * sz, w);
    float yv;
    convert_span<M, sz>(f, w, 0, yv, dd[0][q][x + 3], dd[1][q][x + 3]);
  }
  __syncthreads();

  const float scale_u = f32(p.scale_u), scale_v = f32(p.scale_v), k3_u = f32(p.k3_u), k3_v = f32(p.k3_v);
  const Window w3 = window_of(3.0f);
  // the horizontal pass reads vert[plane][i][x + 3]: the vertical taps, or
  // without sy the differences of tile row i
  const float* vert = &dd[0][0][0];
  int plane_stride = kRows * kD;
  if constexpr (SY != 0) {
    float* vt = reinterpret_cast<float*>(stage);  // [2][kWarps][kD], the staging no longer needed
    const Window wk3u = window_of(k3_u), wk3v = window_of(k3_v);
    float tu[(kWarps * kCols + kThreads - 1) / kThreads], tv[(kWarps * kCols + kThreads - 1) / kThreads];
#pragma unroll
    for (int n = 0; n < (kWarps * kCols + kThreads - 1) / kThreads; ++n) {
      const int item = threadIdx.x + n * kThreads;
      if (item >= kWarps * kCols) break;
      const int i = item / kCols, x = item % kCols + 3;
      bool exact = true;
      const float(&a)[kRows][kD] = dd[0];
      const float(&b)[kRows][kD] = dd[1];
      tu[n] = sharp_tap<false>(a[2 * i][x], a[2 * i + 1][x], a[2 * i + 2][x], a[2 * i + 3][x], scale_u, k3_u, wk3u,
                               w3, exact);
      tv[n] = sharp_tap<false>(b[2 * i][x], b[2 * i + 1][x], b[2 * i + 2][x], b[2 * i + 3][x], scale_v, k3_v, wk3v,
                               w3, exact);
      if (!exact) {
        tu[n] = sharp_tap<true>(a[2 * i][x], a[2 * i + 1][x], a[2 * i + 2][x], a[2 * i + 3][x], scale_u, k3_u, wk3u,
                                w3, exact);
        tv[n] = sharp_tap<true>(b[2 * i][x], b[2 * i + 1][x], b[2 * i + 2][x], b[2 * i + 3][x], scale_v, k3_v, wk3v,
                                w3, exact);
      }
    }
    __syncthreads();  // every thread has read the staging's bytes
#pragma unroll
    for (int n = 0; n < (kWarps * kCols + kThreads - 1) / kThreads; ++n) {
      const int item = threadIdx.x + n * kThreads;
      if (item >= kWarps * kCols) break;
      const int i = item / kCols, x = item % kCols + 3;
      vt[i * kD + x] = tu[n];
      vt[(kWarps + i) * kD + x] = tv[n];
    }
    __syncthreads();
    vert = vt;
    plane_stride = kWarps * kD;
  }
  // 3. site j = 32 s + lane of the block's site row `warp`: tile columns
  // 2 (j - j_blk) .. + 3
  const int i = blockIdx.y * kWarps + warp;
  if (i >= p.ch) return;
  const float hs_u = SY ? 1.0f : scale_u, hs_v = SY ? 1.0f : scale_v;
  const float hk_u = SY ? 3.0f : k3_u, hk_v = SY ? 3.0f : k3_v;
  const Window whu = window_of(hk_u), whv = window_of(hk_v);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int j = blockIdx.x * 32 * K + 32 * s + lane;
    if (j >= p.cw) break;
    const float* a = vert + warp * kD + 2 * (32 * s + lane) + 3;  // row `warp`: the vertical taps, or tile row warp (HT = 0)
    const float* b = a + plane_stride;
    bool exact = true;
    float su = sharp_tap<false>(a[0], a[1], a[2], a[3], hs_u, hk_u, whu, w3, exact);
    float sv = sharp_tap<false>(b[0], b[1], b[2], b[3], hs_v, hk_v, whv, w3, exact);
    if (!exact) {
      su = sharp_tap<true>(a[0], a[1], a[2], a[3], hs_u, hk_u, whu, w3, exact);
      sv = sharp_tap<true>(b[0], b[1], b[2], b[3], hs_v, hk_v, whv, w3, exact);
    }
    exact = true;
    float tu = unorm_uv<false>(su, un.uv_scale_u, un.uv_round, un.out_max, un.guard_uv, exact);
    float tv = unorm_uv<false>(sv, un.uv_scale_v, un.uv_round, un.out_max, un.guard_uv, exact);
    if (!exact) {
      tu = unorm_uv<true>(su, un.uv_scale_u, un.uv_round, un.out_max, true, exact);
      tv = unorm_uv<true>(sv, un.uv_scale_v, un.uv_round, un.out_max, true, exact);
    }
    const size_t site = (size_t)i * p.cw + j;
    u[site] = (Out)__float_as_uint(tu);
    v[site] = (Out)__float_as_uint(tv);
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

// The integer kernels: one thread a pixel.
bool pixel_grid(int h, int w, dim3* grid) {
  *grid = dim3((unsigned)((w + kBlockX - 1) / kBlockX), (unsigned)((h + kBlockY - 1) / kBlockY));
  return (h + kBlockY - 1) / kBlockY <= 65535;
}

// The tiles of the float kernels: 4 site rows by kSpan pixel columns each;
// the sharp filter's launch takes one a block.
bool site_tiles(int h, int w, int sy, Tiles* tiles) {
  const long long rows = (((long long)h + (1 << sy) - 1) >> sy), down = (rows + kWarps - 1) / kWarps;
  tiles->across = (w + kSpan - 1) / kSpan;
  tiles->count = (int)(tiles->across * down);
  return down <= 65535;
}

// Blocks of a persistent kernel that fit on an SM at once.
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) == cudaSuccess ? n : 0;
}

// A persistent launch (Tiles): as many blocks as fit on the device at once,
// at most one a tile.
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, int per_sm, const Tiles& tiles, cudaStream_t s, Args... args) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return (int)cudaGetLastError();
  const int grid = max(1, min(tiles.count, per_sm * sms));
  kernel<<<grid, kThreads, 0, s>>>(args...);
  return 0;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = by_widths(p.in_bytes, p.out_bytes, [&](auto in, auto out) -> int {
    using In = typename decltype(in)::type;
    using Out = typename decltype(out)::type;
    const In* Y = static_cast<const In*>(y);
    const In* U = static_cast<const In*>(u);
    const In* V = static_cast<const In*>(v);
    Out* RGB = static_cast<Out*>(rgb);
    dim3 grid;
    if (p.mode == kIdentity || p.mode == kLifted) {
      if (!pixel_grid(p.h, p.w, &grid)) return (int)cudaErrorInvalidValue;
      return by_flag(p.mode == kLifted, [&](auto lifted) {
        yuv_to_rgb_int<In, Out, decltype(lifted)::value><<<grid, dim3(kBlockX, kBlockY), 0, s>>>(p, Y, U, V, RGB);
        return 0;
      });
    }
    if (p.mode != kMatrix && p.mode != kYCgCo) return (int)cudaErrorInvalidValue;
    Tiles tiles;
    if (!site_tiles(p.h, p.w, per_site ? p.sy : 0, &tiles)) return (int)cudaErrorInvalidValue;
    if (p.mono) {
      const auto kernel = yuv_to_rgb_float<In, Out, kMatrix, 0, 0, false, true>;
      static const int per_sm = resident_blocks(kernel);
      return launch_tiles(kernel, per_sm, tiles, s, p, tiles, Y, U, V, RGB);
    }
    return by_float_mode(p.mode, [&](auto mode) {
      return by_shifts(p.sx, p.sy, [&](auto sx, auto sy) {
        constexpr int SX = decltype(sx)::value, SY = decltype(sy)::value;
        constexpr int M = decltype(mode)::value;
        return by_flag(p.bilinear && (SX || SY), [&](auto bilinear) {
          const auto kernel = yuv_to_rgb_float<In, Out, M, SX, SY, decltype(bilinear)::value && (SX || SY), false>;
          static const int per_sm = resident_blocks(kernel);
          return launch_tiles(kernel, per_sm, tiles, s, p, tiles, Y, U, V, RGB);
        });
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = by_widths(p.in_bytes, p.out_bytes, [&](auto in, auto out) -> int {
    using In = typename decltype(in)::type;
    using Out = typename decltype(out)::type;
    const In* RGB = static_cast<const In*>(rgb);
    Out* Y = static_cast<Out*>(y);
    Out* U = static_cast<Out*>(u);
    Out* V = static_cast<Out*>(v);
    dim3 grid;
    if (p.mode == kIdentity || p.mode == kLifted) {
      if (!pixel_grid(p.h, p.w, &grid)) return (int)cudaErrorInvalidValue;
      return by_flag(p.mode == kLifted, [&](auto lifted) {
        rgb_to_yuv_int<In, Out, decltype(lifted)::value><<<grid, dim3(kBlockX, kBlockY), 0, s>>>(p, RGB, Y, U, V);
        return 0;
      });
    }
    Tiles tiles;
    if (!site_tiles(p.h, p.w, per_site ? p.sy : 0, &tiles)) return (int)cudaErrorInvalidValue;
    return by_float_mode(p.mode, [&](auto mode) {
      constexpr int M = decltype(mode)::value;
      if (p.mono) {
        const auto kernel = rgb_to_yuv_float<In, Out, M, 0, 0, true>;
        static const int per_sm = resident_blocks(kernel);
        return launch_tiles(kernel, per_sm, tiles, s, p, tiles, RGB, Y, U, V);
      }
      return by_shifts(p.sx, p.sy, [&](auto sx, auto sy) {
        constexpr int SX = decltype(sx)::value, SY = decltype(sy)::value;
        if constexpr (SX != 0) {
          if (p.sharp) {  // one tile a block
            rgb_to_yuv_sharp<In, Out, M, SY>
                <<<dim3(tiles.across, tiles.count / tiles.across), kThreads, 0, s>>>(p, RGB, Y, U, V);
            return 0;
          }
        }
        const auto kernel = rgb_to_yuv_float<In, Out, M, SX, SY, false>;
        static const int per_sm = resident_blocks(kernel);
        return launch_tiles(kernel, per_sm, tiles, s, p, tiles, RGB, Y, U, V);
      });
    });
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
