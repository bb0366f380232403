// The spec encoder's RD pre-pass, for Hopper (sm_90a): per block size every
// candidate intra mode's SATD cost and each directional mode's best angle
// delta (avt_rd_satd), and per transform size every mode's quant-aware
// distortion and rate (avt_rd_quant).
//
// Replaces the jitted body of the JAX package's _compiled
// (libavif_tpu/codec/av1/rdsearch_device.py:483), an XLA program built for
// the TPU's matrix unit: every linear prediction is one product ext1 @ G with
// G of (4px+2, V px^2), the SATD and the small DCTs are Kronecker-product
// GEMMs, and every stage between them crosses device memory. The port's
// plain version (codec/av1/rdsearch_device.py, _Program.plain) keeps that
// formulation; these kernels compute the same tables:
//   - satd and delta exactly (the predictions, residuals and Hadamard sums
//     are integers; see the module docstring);
//   - dist and rate in the plain version's order of operations per
//     coefficient: the DCT's products accumulate by FMA as a GEMM does, the
//     quantizer rounds c * rq, then lv * qs, then the difference, each
//     with __f*_rn (nvcc contracts nothing), and the sums are fixed orders.
//
// What bounds it on an H100 SXM. A 768x512 frame at speed 6 reads 1.5 MB and
// writes 1.6 MB of tables (about 1 us at 3.35 TB/s); the work is some 0.6 G
// int32 operations (prediction, residual, 8x8 Hadamard, absolute sums) and
// 1.4 GFLOP fp32 (the separable DCTs, the quantizer and the bit model):
// tens of microseconds. The first design of these kernels reached 7.4% of
// that: rd_quant read both operands of every FMA from shared memory (two
// 4-byte loads an FMA, an SM serving about one warp-wide load a clock), and
// rd_satd ran each 8x8 tile on eight lanes (its columns by 24 shuffles a
// lane), loaded its directional taps from device memory per sample and
// predicted the V and H delta copies (PERF.md has the measurement).
//
// Design: one block's samples and its border stay in shared memory while
// every variant is predicted and transformed; nothing but the tables is
// written to device memory.
//   - avt_rd_satd, templated on px in {8, 16, 32, 64}: a CTA of eight warps
//     takes 32 tile units (one 8x8 Hadamard tile of one block each: 32
//     blocks at px = 8, 8 at 16, 2 at 32; 64 units, one block, at 64) and
//     every variant of them, loading the blocks and their borders once. A
//     lane takes a whole tile; a warp takes one variant over its 32 units
//     (two warps at px = 64), so the prediction's kind is warp-uniform and
//     compiled out of the loop. Prediction, residual and both butterfly
//     passes run in the lane's registers; the last stage is folded into the
//     absolute sum (|a + b| + |a - b| = 2 max(|a|, |b|)), and the block's
//     tiles meet by xor shuffles over its lanes. The samples sit in shared
//     memory tile by tile (65 words a tile: the lanes of different tiles
//     read different banks); the directional tap words come straight from
//     the table, laid out so that the lanes of one block read neighbouring
//     words (rdsearch_device._tile_order). Variants whose SATD another
//     gives are not computed: the delta 0 of a directional mode that is also
//     a candidate (its sum is the candidate's; the host finds the pairs in
//     the table, dir_src), and a delta variant whose kind is not directional
//     (the V and H deltas, reference fault o): its prediction is its delta
//     0's, so its sum is, and the first argmin keeps delta 0. The loops over
//     samples and variants divide by compile-time shapes only (the set-up
//     divides by the plane's block columns).
//   - avt_rd_quant, templated on txs in {4, 8, 16, 32, 64}.
//     txs <= 8 (quant_small): a lane takes one block, a warp one candidate
//     mode over 32 blocks (eight modes a CTA); the residual sits in the
//     lane's registers and each coefficient is its dot of length txs^2 with
//     the Kronecker basis, as the plain version, 16 coefficients at a time:
//     the basis row of 16 comes as four 16-byte shared loads that every lane
//     of the warp reads at one address (a broadcast), so an FMA costs a
//     quarter of a shared load, not two. The lane sums its block's
//     quantities itself, coefficient by coefficient.
//     txs >= 16 (quant_large): a team of (txs/4)^2 threads takes one (block,
//     mode) pair (pairs mode by mode, so a warp's teams mostly share the
//     mode's kind), a thread a 4x4 tile of M r and then of (M r) M^T: per k
//     one 16-byte load of a column of M (from M^T in shared memory) and one
//     of the residual row (or of t1 transposed), 16 FMAs. At txs = 64 the
//     dropped energy is sum(c^2) - sum(c[:32, :32]^2), as the plain version.
//     Each coefficient is the same FMA chain as the plain version's, in the
//     same order (j = 0 .. txs^2 - 1; k = 0 .. txs - 1 in each pass).
//   - The predictions come from host-built tables (rdsearch_device.
//     _kernel_table): per variant a kind (DC, V, H, the smooths, Paeth: their
//     formulas; directional: per sample a word derived from the same
//     _dir_index_tables the plain version's G is). A directional sample's
//     two taps are neighbours on the block's edge, so the word names one
//     pair of the edge array Z = [left(2px) reversed, corner, above(2px)]
//     (its ends repeated), packed as two 16-bit samples in one shared word,
//     and the two weights in 1/32 as bytes: the prediction is one __dp2a_hi,
//     a shift and a clamp, where two taps decoded from a word, two
//     addresses, two loads and two multiply-adds were.
//   - ext1 = [corner, above(2px), left(2px)] is read from the plane with the
//     coordinates clamped to it, which is the reference's replicated pad; the
//     first block row and column see 1 << (bd - 1). Samples are below 2^16
//     (bd <= 12), as the packed pairs need.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxModes = 16;                     // candidate modes a program (13 at most)
constexpr int kDeltas = 7;                        // angle deltas a directional mode: 0, -3, -2, -1, 1, 2, 3
constexpr int kMaxVar = kMaxModes * (1 + kDeltas);  // variants in a table
constexpr int kThreads = 256;                     // both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 65;                         // words of one 8x8 tile in shared memory (64 + 1)

// Variant kinds of the host table (rdsearch_device._KINDS).
enum Kind : int { kDC = 0, kV, kH, kSmooth, kSmoothV, kSmoothH, kPaeth, kDir };

// Both structs are mirrored by ctypes.Structure classes in
// codec/av1/rdsearch_device.py.
struct RdSatdArgs {
  int H, W, rows, cols, bd;
  int n_modes;             // candidate modes: table variants 0 .. n_modes - 1, the satd rows
  int n_dir;               // directional modes: variants n_modes + 7 d + k, the delta rows
  int n_var;               // variants in the table
  int bits[kMaxModes];     // (lam_x16 * bits) >> 4 of each candidate mode
  int dir_src[kMaxModes];  // per directional mode, the candidate variant its delta 0 equals, or -1
};

struct RdQuantArgs {
  int H, W, rows, cols, bd;
  int n_modes, n_var;
  float qs_dc, qs_ac, rq_dc, rq_ac;  // quantizer step and its fp32 reciprocal
  float nz, mag, txb;                // the bit model (bits x16)
};

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// Entry i of ext1 = [corner, above(2PX), left(2PX)] of block (br, bc).
template <int PX>
__device__ __forceinline__ int border_sample(const int* __restrict__ src, int H, int W, int br, int bc,
                                             int base, int i) {
  if (i == 0) return (br > 0 && bc > 0) ? src[(br * PX - 1) * W + bc * PX - 1] : base;
  if (i <= 2 * PX) return br > 0 ? src[(br * PX - 1) * W + min(bc * PX + i - 1, W - 1)] : base;
  return bc > 0 ? src[min(br * PX + i - 1 - 2 * PX, H - 1) * W + bc * PX - 1] : base;
}

// Sample (y, x) of block (br, bc).
template <int PX>
__device__ __forceinline__ int block_sample(const int* __restrict__ src, int H, int W, int br, int bc, int y, int x) {
  return src[min(br * PX + y, H - 1) * W + min(bc * PX + x, W - 1)];
}

// The ext1 column that entry j of the edge array Z repeats. Z runs along
// the block's edge, [left(2PX) reversed, corner, above(2PX)], with its two
// ends repeated (4PX + 3 entries), so the two taps of a directional
// sample are neighbours in it (rdsearch_device._edge_index).
template <int PX>
__device__ __forceinline__ int edge_col(int j) {
  return j == 0 ? 4 * PX : j <= 2 * PX ? 4 * PX + 1 - j : j == 2 * PX + 1 ? 0 : j <= 4 * PX + 1 ? j - 2 * PX - 1 : 2 * PX;
}

// Word j of a block's packed edge pairs, Z[j] | Z[j + 1] << 16, from its
// ext1 row e (samples below 2^16: bd <= 12).
template <int PX>
__device__ __forceinline__ uint32_t edge_pair(const int* e, int j) {
  return (uint32_t(e[edge_col<PX>(j)]) & 0xffffu) | uint32_t(e[edge_col<PX>(j + 1)]) << 16;
}

// DC_PRED of a block from its ext1 row: (sum of above[0..PX) and
// left[0..PX) + PX) >> log2(2 PX), clipped, which is floor(ext1 @ G).
template <int PX>
__device__ __forceinline__ int dc_value(const int* e, int maxv) {
  int s = 0;
#pragma unroll 8
  for (int i = 0; i < PX; ++i) s += e[1 + i] + e[2 * PX + 1 + i];
  return clampi((s + PX) >> ilog2(2 * PX), maxv);
}

// One sample of one variant of kind KIND, equal to clip(floor(ext1 @ G),
// 0, maxv) of the plain version (Paeth: its formula, unclipped). e: the
// block's ext1; ez: its packed edge pairs; tap: the sample's tap word
// (directional only: zi | w_lo << 16 | w_hi << 24, rdsearch_device.
// _edge_taps), whose prediction (Z[zi] w_lo + Z[zi + 1] w_hi + 16) >> 5 is
// one dot product of the pair word ez[zi] with the weight bytes.
template <int PX, int KIND>
__device__ __forceinline__ int predict(const int* e, const uint32_t* ez, const int* smw, uint32_t tap, int dc, int y,
                                       int x, int maxv) {
  if constexpr (KIND == kDC) {
    return dc;
  } else if constexpr (KIND == kV) {
    return clampi(e[1 + x], maxv);
  } else if constexpr (KIND == kH) {
    return clampi(e[2 * PX + 1 + y], maxv);
  } else if constexpr (KIND == kSmooth) {
    const int wy = smw[y], wx = smw[x];
    return clampi((wy * e[1 + x] + (256 - wy) * e[3 * PX] + wx * e[2 * PX + 1 + y] + (256 - wx) * e[PX] + 256) >> 9,
                  maxv);
  } else if constexpr (KIND == kSmoothV) {
    const int wy = smw[y];
    return clampi((wy * e[1 + x] + (256 - wy) * e[3 * PX] + 128) >> 8, maxv);
  } else if constexpr (KIND == kSmoothH) {
    const int wx = smw[x];
    return clampi((wx * e[2 * PX + 1 + y] + (256 - wx) * e[PX] + 128) >> 8, maxv);
  } else if constexpr (KIND == kPaeth) {
    const int a = e[1 + x], l = e[2 * PX + 1 + y], c = e[0];
    const int b = a + l - c, pa = abs(b - a), pl = abs(b - l), pc = abs(b - c);
    return (pa <= pl && pa <= pc) ? a : (pl <= pc ? l : c);
  } else {  // directional: two neighbouring edge samples, their weights in 1/32
    return min(int(__dp2a_hi(ez[tap & 0xffffu], tap, 16u) >> 5), maxv);
  }
}

// ------------------------------------------------------------ avt_rd_satd

template <int PX>
struct SatdShape {
  static constexpr int TW = PX / 8, T = TW * TW;   // 8x8 tiles a block row, a block
  static constexpr int UNITS = T >= 32 ? T : 32;   // tiles a CTA
  static constexpr int NB = UNITS / T;             // blocks a CTA
  static constexpr int WPV = UNITS / 32;           // warps a variant
  static constexpr int VPR = kWarps / WPV;         // variants a round of the CTA's warps
  static constexpr int L = 4 * PX + 1;             // ext1 without its constant 1 (odd: lanes of other blocks, other banks)
  static constexpr int LZ = 4 * PX + 3;            // packed edge pairs a block (4PX + 2 used; odd)
  // dynamic shared memory in 4-byte words: the tiles' samples, ext1 rows,
  // packed edge pairs, smooth weights, DC values, the sums per (block,
  // variant), and the list of variants to compute (its count first)
  static constexpr int kSmp = 0;
  static constexpr int kExt = kSmp + UNITS * kTile;
  static constexpr int kEz = kExt + NB * L;
  static constexpr int kSmw = kEz + NB * LZ;
  static constexpr int kDc = kSmw + PX;
  static constexpr int kSums = kDc + NB;
  static constexpr int kList = kSums + NB * kMaxVar;
  static constexpr int kWords = kList + 1 + kMaxVar;
};

// The sum of |8x8 Hadamard| of one tile's residual under variant KIND, all
// in the lane's registers: the row butterflies, two column stages, and the
// last column stage folded into the absolute sum. taps: the variant's tap
// words from this tile's (``_tile_order``: sample k of tile t at k T + t).
template <int PX, int KIND>
__device__ __forceinline__ int tile_satd(const int* tile, const int* e, const uint32_t* ez, const int* smw,
                                         const uint32_t* __restrict__ taps, int dc, int y0, int x0, int maxv) {
  constexpr int T = (PX / 8) * (PX / 8);
  int r[64];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      r[i * 8 + j] = tile[i * 8 + j] - predict<PX, KIND>(e, ez, smw, KIND == kDir ? __ldg(taps + (i * 8 + j) * T) : 0u,
                                                         dc, y0 + i, x0 + j, maxv);
#pragma unroll
  for (int s = 1; s < 8; s <<= 1)  // rows
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (!(j & s)) {
          const int p = r[i * 8 + j], q = r[i * 8 + (j | s)];
          r[i * 8 + j] = p + q;
          r[i * 8 + (j | s)] = p - q;
        }
#pragma unroll
  for (int s = 1; s < 4; s <<= 1)  // columns, stages 1 and 2
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (!(i & s)) {
          const int p = r[i * 8 + j], q = r[(i | s) * 8 + j];
          r[i * 8 + j] = p + q;
          r[(i | s) * 8 + j] = p - q;
        }
  int acc = 0;  // stage 4 with the absolute sum: |p + q| + |p - q| = 2 max(|p|, |q|)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += max(abs(r[i * 8 + j]), abs(r[(i + 4) * 8 + j]));
  return 2 * acc;
}

template <int PX>
__global__ void __launch_bounds__(kThreads, 2)
    rd_satd_kernel(const int* __restrict__ src, const RdSatdArgs a, const int* __restrict__ table,
                   float* __restrict__ satd_out, float* __restrict__ delta_out) {
  using S = SatdShape<PX>;
  constexpr int T = S::T, TW = S::TW, NB = S::NB, L = S::L, LZ = S::LZ, N2 = PX * PX;
  extern __shared__ int sm[];
  int* smp = sm + S::kSmp;
  int* ext = sm + S::kExt;
  uint32_t* ezs = reinterpret_cast<uint32_t*>(sm + S::kEz);
  int* smw = sm + S::kSmw;
  int* dcv = sm + S::kDc;
  int* sums = sm + S::kSums;
  int* list = sm + S::kList;

  const int nblk = a.rows * a.cols, blk0 = blockIdx.x * NB;
  const int base = 1 << (a.bd - 1), maxv = (1 << a.bd) - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Set-up, once for every variant: the blocks' samples tile by tile, their
  // ext1 rows, the smooth weights, and the list of variants to compute;
  // then the packed edge pairs and the DC values from the ext1 rows.
  for (int i = tid; i < NB * N2; i += kThreads) {
    const int b = i / N2, y = (i % N2) / PX, x = i % PX, blk = min(blk0 + b, nblk - 1);
    smp[(b * T + (y / 8) * TW + x / 8) * kTile + (y % 8) * 8 + x % 8] =
        block_sample<PX>(src, a.H, a.W, blk / a.cols, blk % a.cols, y, x);
  }
  for (int i = tid; i < NB * L; i += kThreads) {
    const int b = i / L, blk = min(blk0 + b, nblk - 1);
    ext[i] = border_sample<PX>(src, a.H, a.W, blk / a.cols, blk % a.cols, base, i % L);
  }
  for (int i = tid; i < PX; i += kThreads) smw[i] = table[a.n_var + i];
  if constexpr (S::WPV > 1)
    for (int i = tid; i < NB * kMaxVar; i += kThreads) sums[i] = 0;
  if (warp == 0) {  // in table order, 32 variants a step: every candidate mode; of the deltas, those whose SATD no
                    // other variant gives
    int n = 0;
    for (int v0 = 0; v0 < a.n_var; v0 += 32) {
      const int v = v0 + lane, d = (v - a.n_modes) / kDeltas, k = (v - a.n_modes) % kDeltas;
      const bool take = v < a.n_modes ||
                        (v < a.n_var && d < a.n_dir && (k == 0 ? a.dir_src[d] < 0 : (__ldg(table + v) & 15) == kDir));
      const unsigned mask = __ballot_sync(0xffffffffu, take);
      if (take) list[1 + n + __popc(mask & ((1u << lane) - 1))] = v;
      n += __popc(mask);
    }
    if (lane == 0) list[0] = n;
  }
  __syncthreads();
  for (int i = tid; i < NB * (LZ - 1); i += kThreads)
    ezs[(i / (LZ - 1)) * LZ + i % (LZ - 1)] = edge_pair<PX>(ext + (i / (LZ - 1)) * L, i % (LZ - 1));
  for (int b = warp; b < NB; b += kWarps)
    if (lane == 0) dcv[b] = dc_value<PX>(ext + b * L, maxv);
  __syncthreads();

  // A warp (two at px = 64) a variant, a lane a tile; the taps straight
  // from the table (in the L1 cache), the lanes of a block on neighbouring
  // words.
  const uint32_t* tapsg = reinterpret_cast<const uint32_t*>(table) + a.n_var + PX;
  const int slot = warp / S::WPV, u = (warp % S::WPV) * 32 + lane, b = u / T, t = u % T;
  const int* tile = smp + u * kTile;
  const int* e = ext + b * L;
  const uint32_t* ez = ezs + b * LZ;
  const int y0 = (t / TW) * 8, x0 = (t % TW) * 8, dc = dcv[b];
  for (int c = slot; c < list[0]; c += S::VPR) {
    const int v = list[1 + c], desc = __ldg(table + v);
    const uint32_t* tp = tapsg + (desc >> 4) * N2 + t;
    int s;
    switch (desc & 15) {
      case kDC: s = tile_satd<PX, kDC>(tile, e, ez, smw, tp, dc, y0, x0, maxv); break;
      case kV: s = tile_satd<PX, kV>(tile, e, ez, smw, tp, dc, y0, x0, maxv); break;
      case kH: s = tile_satd<PX, kH>(tile, e, ez, smw, tp, dc, y0, x0, maxv); break;
      case kSmooth: s = tile_satd<PX, kSmooth>(tile, e, ez, smw, tp, dc, y0, x0, maxv); break;
      case kSmoothV: s = tile_satd<PX, kSmoothV>(tile, e, ez, smw, tp, dc, y0, x0, maxv); break;
      case kSmoothH: s = tile_satd<PX, kSmoothH>(tile, e, ez, smw, tp, dc, y0, x0, maxv); break;
      case kPaeth: s = tile_satd<PX, kPaeth>(tile, e, ez, smw, tp, dc, y0, x0, maxv); break;
      default: s = tile_satd<PX, kDir>(tile, e, ez, smw, tp, dc, y0, x0, maxv); break;
    }
    // the block's tiles are T consecutive lanes (a whole warp at px = 64)
#pragma unroll
    for (int o = (T < 32 ? T : 32) / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (t % 32 == 0) {
      if constexpr (S::WPV > 1)
        atomicAdd(sums + b * kMaxVar + v, s);  // integers: the order does not matter
      else
        sums[b * kMaxVar + v] = s;
    }
  }
  __syncthreads();

  // satd rows: SATD // 16 + the mode's lambda-scaled bits
  for (int i = tid; i < NB * a.n_modes; i += kThreads) {
    const int m = i / NB, bb = i % NB, blk = blk0 + bb;
    if (blk < nblk) satd_out[m * nblk + blk] = __int2float_rn(sums[bb * kMaxVar + m] / 16 + a.bits[m]);
  }
  // delta rows: the first argmin over (0, -3, -2, -1, 1, 2, 3); delta 0 of a
  // mode that is also a candidate has the candidate's sum, and a delta
  // variant that is not directional has its delta 0's
  for (int i = tid; i < NB * a.n_dir; i += kThreads) {
    const int d = i / NB, bb = i % NB, blk = blk0 + bb;
    if (blk >= nblk) continue;
    const int* sb = sums + bb * kMaxVar;
    const int v0 = a.n_modes + kDeltas * d;
    const int s0 = a.dir_src[d] >= 0 ? sb[a.dir_src[d]] : sb[v0];
    int best = 0, cost = s0 / 16;
    for (int k = 1; k < kDeltas; ++k) {
      const int c = ((__ldg(table + v0 + k) & 15) == kDir ? sb[v0 + k] : s0) / 16;
      if (c < cost) {
        cost = c;
        best = k;
      }
    }
    delta_out[d * nblk + blk] = float(best == 0 ? 0 : (best <= 3 ? best - 4 : best - 3));
  }
}

// ----------------------------------------------------------- avt_rd_quant

// One coefficient through the quantizer and the bit model, in the plain
// version's order: lv = round(c * rq), err = c - lv * qs, each product
// rounded; err^2 and log2(1 + min(|lv|, 4095)) into the thread's sums.
__device__ __forceinline__ void quantize(float c, bool dc, const RdQuantArgs& a, float* acc) {
  const float qs = dc ? a.qs_dc : a.qs_ac, rq = dc ? a.rq_dc : a.rq_ac;
  const float lv = rintf(__fmul_rn(c, rq));
  const float err = __fsub_rn(c, __fmul_rn(lv, qs));
  const float alv = fminf(fabsf(lv), 4095.f);
  acc[0] = __fadd_rn(acc[0], __fmul_rn(err, err));
  acc[1] = __fadd_rn(acc[1], alv > 0.f ? 1.f : 0.f);
  acc[2] = __fadd_rn(acc[2], log2f(__fadd_rn(1.f, alv)));
}

__device__ __forceinline__ void store_costs(const RdQuantArgs& a, const float* acc, float dist, int m, int blk,
                                            int nblk, float* dist_out, float* rate_out) {
  dist_out[m * nblk + blk] = dist;
  rate_out[m * nblk + blk] = __fadd_rn(__fadd_rn(__fmul_rn(acc[1], a.nz), __fmul_rn(acc[2], a.mag)), a.txb);
}

template <int TXS>
struct QuantSmall {  // txs <= 8: a lane a block, a warp a mode
  static constexpr int N2 = TXS * TXS, L = 4 * TXS + 1, SS = N2 + 1;  // SS: a block's samples (odd stride)
  static constexpr int LZ = 4 * TXS + 3;                              // packed edge pairs a block
  static constexpr int KG = 16;                                       // coefficients a pass
  // dynamic shared memory in 4-byte words: the Kronecker basis (16-byte
  // aligned), 32 blocks' samples, their ext1 rows and packed edge pairs,
  // smooth weights
  static constexpr int kBasis = 0;
  static constexpr int kSmp = kBasis + N2 * N2;
  static constexpr int kExt = kSmp + 32 * SS;
  static constexpr int kEz = kExt + 32 * L;
  static constexpr int kSmw = kEz + 32 * LZ;
  static constexpr int kWords = kSmw + TXS;
};

// The residual of one block under a mode of kind KIND, as floats (exact).
template <int TXS, int KIND>
__device__ __forceinline__ void residual(float* r, const int* smp, const int* e, const uint32_t* ez, const int* smw,
                                         const uint32_t* __restrict__ taps, int dc, int maxv) {
#pragma unroll
  for (int j = 0; j < TXS * TXS; ++j)
    r[j] = float(smp[j] -
                 predict<TXS, KIND>(e, ez, smw, KIND == kDir ? __ldg(taps + j) : 0u, dc, j / TXS, j % TXS, maxv));
}

template <int TXS>
__device__ __forceinline__ void quant_small(float* sm, const int* __restrict__ src, const RdQuantArgs& a,
                                            const int* __restrict__ table, const float* __restrict__ basis,
                                            float* __restrict__ dist_out, float* __restrict__ rate_out) {
  using S = QuantSmall<TXS>;
  constexpr int N2 = S::N2, L = S::L, LZ = S::LZ, SS = S::SS, KG = S::KG;
  float* bs = sm + S::kBasis;
  int* smp = reinterpret_cast<int*>(sm + S::kSmp);
  int* ext = reinterpret_cast<int*>(sm + S::kExt);
  uint32_t* ezs = reinterpret_cast<uint32_t*>(sm + S::kEz);
  int* smw = reinterpret_cast<int*>(sm + S::kSmw);
  const int nblk = a.rows * a.cols, blk0 = blockIdx.x * 32;
  const int base = 1 << (a.bd - 1), maxv = (1 << a.bd) - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < N2 * N2 / 4; i += kThreads)
    reinterpret_cast<float4*>(bs)[i] = __ldg(reinterpret_cast<const float4*>(basis) + i);
  for (int i = tid; i < 32 * N2; i += kThreads) {  // row by row across the 32 blocks: neighbours read neighbours
    const int y = i / (32 * TXS), b = (i % (32 * TXS)) / TXS, x = i % TXS, blk = min(blk0 + b, nblk - 1);
    smp[b * SS + y * TXS + x] = block_sample<TXS>(src, a.H, a.W, blk / a.cols, blk % a.cols, y, x);
  }
  for (int i = tid; i < 32 * L; i += kThreads) {
    const int b = i / L, blk = min(blk0 + b, nblk - 1);
    ext[i] = border_sample<TXS>(src, a.H, a.W, blk / a.cols, blk % a.cols, base, i % L);
  }
  for (int i = tid; i < TXS; i += kThreads) smw[i] = table[a.n_var + i];
  __syncthreads();
  for (int i = tid; i < 32 * (LZ - 1); i += kThreads)
    ezs[(i / (LZ - 1)) * LZ + i % (LZ - 1)] = edge_pair<TXS>(ext + (i / (LZ - 1)) * L, i % (LZ - 1));
  __syncthreads();

  const int m = blockIdx.y * kWarps + warp;
  if (m >= a.n_modes) return;  // warp-uniform; no barrier follows
  const int* e = ext + lane * L;
  const uint32_t* ez = ezs + lane * LZ;
  const int dc = dc_value<TXS>(e, maxv);
  const int desc = __ldg(table + m);
  const uint32_t* taps = reinterpret_cast<const uint32_t*>(table) + a.n_var + TXS + (desc >> 4) * N2;
  const int* s = smp + lane * SS;
  float r[N2];
  switch (desc & 15) {
    case kDC: residual<TXS, kDC>(r, s, e, ez, smw, taps, dc, maxv); break;
    case kV: residual<TXS, kV>(r, s, e, ez, smw, taps, dc, maxv); break;
    case kH: residual<TXS, kH>(r, s, e, ez, smw, taps, dc, maxv); break;
    case kSmooth: residual<TXS, kSmooth>(r, s, e, ez, smw, taps, dc, maxv); break;
    case kSmoothV: residual<TXS, kSmoothV>(r, s, e, ez, smw, taps, dc, maxv); break;
    case kSmoothH: residual<TXS, kSmoothH>(r, s, e, ez, smw, taps, dc, maxv); break;
    case kPaeth: residual<TXS, kPaeth>(r, s, e, ez, smw, taps, dc, maxv); break;
    default: residual<TXS, kDir>(r, s, e, ez, smw, taps, dc, maxv); break;
  }

  // c = vec(r) @ kron(M, M)^T, KG coefficients a pass; each coefficient
  // sums j = 0 .. N2 - 1 by FMA from 0, as the plain version's GEMM
  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
  for (int k0 = 0; k0 < N2; k0 += KG) {
    float c[KG];
#pragma unroll
    for (int q = 0; q < KG; ++q) c[q] = 0.f;
#pragma unroll
    for (int j = 0; j < N2; ++j) {
#pragma unroll
      for (int q = 0; q < KG; q += 4) {
        const float4 w = *reinterpret_cast<const float4*>(bs + j * N2 + k0 + q);  // one address for the warp
        c[q] = __fmaf_rn(r[j], w.x, c[q]);
        c[q + 1] = __fmaf_rn(r[j], w.y, c[q + 1]);
        c[q + 2] = __fmaf_rn(r[j], w.z, c[q + 2]);
        c[q + 3] = __fmaf_rn(r[j], w.w, c[q + 3]);
      }
    }
#pragma unroll
    for (int q = 0; q < KG; ++q) quantize(c[q], k0 + q == 0, a, acc);
  }
  const int blk = blk0 + lane;
  if (blk < nblk) store_costs(a, acc, acc[0], m, blk, nblk, dist_out, rate_out);
}

template <int TXS>
struct QuantLarge {  // txs >= 16: a team a (block, mode) pair, a thread a 4x4 tile
  static constexpr int N2 = TXS * TXS, L = 4 * TXS + 1, LZ = 4 * TXS + 3;
  static constexpr int TG = TXS / 4;            // 4x4 tiles a row
  static constexpr int TT = TG * TG;            // threads a team
  static constexpr int NT = kThreads / TT;      // teams a CTA
  static constexpr int Q = TXS > 32 ? 5 : 3;    // err^2, nonzeros, log2 terms (and sum c^2, kept c^2)
  static constexpr int TS = TXS + 4;            // row stride of t1 transposed (16-byte rows)
  // dynamic shared memory in 4-byte words, per team: the residual (row
  // major), t1 = M r transposed, ext1, the packed edge pairs, the DC sum,
  // the warp sums; then M^T and the smooth weights
  static constexpr int kRes = 0;
  static constexpr int kT1 = kRes + N2;
  static constexpr int kExt = kT1 + TXS * TS;
  static constexpr int kEz = kExt + (L + 3) / 4 * 4;
  static constexpr int kDc = kEz + (LZ + 3) / 4 * 4;
  static constexpr int kRed = kDc + 4;
  static constexpr int kTeam = kRed + (Q * (TT > 32 ? TT / 32 : 1) + 3) / 4 * 4;
  static constexpr int kMt = NT * kTeam;
  static constexpr int kSmw = kMt + N2;
  static constexpr int kWords = kSmw + TXS;
};

// The sums of Q quantities over each team of TT consecutive threads, into
// the team's first thread, by a fixed tree: halves within each warp (xor
// shuffles), then halves over the team's warp sums. Every thread calls it.
template <int TT, int Q>
__device__ __forceinline__ void team_sums(float* v, float* red) {
  constexpr int WIDTH = TT < 32 ? TT : 32;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int o = WIDTH / 2; o > 0; o >>= 1) v[q] = __fadd_rn(v[q], __shfl_xor_sync(0xffffffffu, v[q], o));
  if constexpr (TT > 32) {
    constexpr int W = TT / 32;
    const int w = (threadIdx.x % TT) >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) red[q * W + w] = v[q];
    }
    __syncthreads();
    if (threadIdx.x % TT == 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float s[W];
#pragma unroll
        for (int i = 0; i < W; ++i) s[i] = red[q * W + i];
#pragma unroll
        for (int h = W / 2; h > 0; h >>= 1)
#pragma unroll
          for (int i = 0; i < h; ++i) s[i] = __fadd_rn(s[i], s[i + h]);
        v[q] = s[0];
      }
    }
  }
}

// A team thread's 16 residual samples of block (br, bc) under a mode of
// kind KIND, into the team's row-major residual: sample i = tt + TT q; its
// tap word at the tile-order position (rdsearch_device._tile_order).
template <int TXS, int KIND>
__device__ __forceinline__ void residual_team(float* res, const int* __restrict__ src, const RdQuantArgs& a, int br,
                                              int bc, const int* e, const uint32_t* ez, const int* smw,
                                              const uint32_t* __restrict__ taps, int dc, int maxv) {
  constexpr int TT = (TXS / 4) * (TXS / 4), TW = TXS / 8;
  const int tt = threadIdx.x % TT;
#pragma unroll 4
  for (int q = 0; q < 16; ++q) {
    const int i = tt + TT * q, y = i / TXS, x = i % TXS;
    const uint32_t tap =
        KIND == kDir ? __ldg(taps + ((y % 8) * 8 + x % 8) * TW * TW + (y / 8) * TW + x / 8) : 0u;
    res[i] = float(block_sample<TXS>(src, a.H, a.W, br, bc, y, x) -
                   predict<TXS, KIND>(e, ez, smw, tap, dc, y, x, maxv));
  }
}

template <int TXS>
__device__ __forceinline__ void quant_large(float* sm, const int* __restrict__ src, const RdQuantArgs& a,
                                            const int* __restrict__ table, const float* __restrict__ basis,
                                            float* __restrict__ dist_out, float* __restrict__ rate_out) {
  using S = QuantLarge<TXS>;
  constexpr int N2 = S::N2, L = S::L, LZ = S::LZ, TG = S::TG, TT = S::TT, NT = S::NT, Q = S::Q, TS = S::TS;
  constexpr int KEEP = TXS > 32 ? 32 : TXS;  // the spec codes no coefficient beyond 32
  const int tid = threadIdx.x, team = tid / TT, tt = tid % TT;
  float* res = sm + team * S::kTeam + S::kRes;
  float* t1 = sm + team * S::kTeam + S::kT1;
  int* ext = reinterpret_cast<int*>(sm + team * S::kTeam + S::kExt);
  uint32_t* ez = reinterpret_cast<uint32_t*>(sm + team * S::kTeam + S::kEz);
  int* dcs = reinterpret_cast<int*>(sm + team * S::kTeam + S::kDc);
  float* red = sm + team * S::kTeam + S::kRed;
  float* mt = sm + S::kMt;
  int* smw = reinterpret_cast<int*>(sm + S::kSmw);

  const int nblk = a.rows * a.cols, npairs = nblk * a.n_modes;
  const int base = 1 << (a.bd - 1), maxv = (1 << a.bd) - 1;
  // pairs mode by mode: the teams of a warp mostly share the mode's kind
  const int pair = blockIdx.x * NT + team, pc = min(pair, npairs - 1);
  const int m = pc / nblk, blk = pc % nblk, br = blk / a.cols, bc = blk % a.cols;

  for (int i = tid; i < N2; i += kThreads) mt[i] = __ldg(basis + (i % TXS) * TXS + i / TXS);  // M^T[k][r] = M[r][k]
  for (int i = tid; i < TXS; i += kThreads) smw[i] = table[a.n_var + i];
  if (tt == 0) dcs[0] = 0;
  __syncthreads();
  for (int i = tt; i < L; i += TT) {
    const int v = border_sample<TXS>(src, a.H, a.W, br, bc, base, i);
    ext[i] = v;
    if ((i >= 1 && i <= TXS) || (i > 2 * TXS && i <= 3 * TXS)) atomicAdd(dcs, v);  // DC's sum: integers
  }
  __syncthreads();
  for (int j = tt; j < LZ - 1; j += TT) ez[j] = edge_pair<TXS>(ext, j);
  __syncthreads();
  const int dc = clampi((dcs[0] + TXS) >> ilog2(2 * TXS), maxv);
  const int desc = __ldg(table + m);
  const uint32_t* taps = reinterpret_cast<const uint32_t*>(table) + a.n_var + TXS + (desc >> 4) * N2;
  switch (desc & 15) {
    case kDC: residual_team<TXS, kDC>(res, src, a, br, bc, ext, ez, smw, taps, dc, maxv); break;
    case kV: residual_team<TXS, kV>(res, src, a, br, bc, ext, ez, smw, taps, dc, maxv); break;
    case kH: residual_team<TXS, kH>(res, src, a, br, bc, ext, ez, smw, taps, dc, maxv); break;
    case kSmooth: residual_team<TXS, kSmooth>(res, src, a, br, bc, ext, ez, smw, taps, dc, maxv); break;
    case kSmoothV: residual_team<TXS, kSmoothV>(res, src, a, br, bc, ext, ez, smw, taps, dc, maxv); break;
    case kSmoothH: residual_team<TXS, kSmoothH>(res, src, a, br, bc, ext, ez, smw, taps, dc, maxv); break;
    case kPaeth: residual_team<TXS, kPaeth>(res, src, a, br, bc, ext, ez, smw, taps, dc, maxv); break;
    default: residual_team<TXS, kDir>(res, src, a, br, bc, ext, ez, smw, taps, dc, maxv); break;
  }
  __syncthreads();

  const int rg = tt / TG, cg = tt % TG;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // t1[r][col] = sum over k of M[r][k] res[k][col], r = 4 rg + i, col = 4 cg + j
#pragma unroll 8
  for (int k = 0; k < TXS; ++k) {
    const float4 mv = *reinterpret_cast<const float4*>(mt + k * TXS + 4 * rg);
    const float4 rv = *reinterpret_cast<const float4*>(res + k * TXS + 4 * cg);
    const float mm[4] = {mv.x, mv.y, mv.z, mv.w}, rr[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(mm[i], rr[j], acc[i][j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(t1 + (4 * cg + j) * TS + 4 * rg) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
  __syncthreads();
  // c[r][d] = sum over k of t1[r][k] M^T[k][d], r = 4 rg + i, d = 4 cg + j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < TXS; ++k) {
    const float4 tv = *reinterpret_cast<const float4*>(t1 + k * TS + 4 * rg);
    const float4 mv = *reinterpret_cast<const float4*>(mt + k * TXS + 4 * cg);
    const float tt4[4] = {tv.x, tv.y, tv.z, tv.w}, mm[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(tt4[i], mm[j], acc[i][j]);
  }

  float q[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) q[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * rg + i, d = 4 * cg + j;
      const float c = acc[i][j];
      const bool kept = r < KEEP && d < KEEP;
      if constexpr (TXS > 32) {
        const float sq = __fmul_rn(c, c);
        q[3] = __fadd_rn(q[3], sq);
        if (kept) q[4] = __fadd_rn(q[4], sq);
      }
      if (kept) quantize(c, r == 0 && d == 0, a, q);
    }
  team_sums<TT, Q>(q, red);
  if (tt == 0 && pair < npairs) {
    float dist = q[0];
    if constexpr (TXS > 32) dist = __fadd_rn(dist, __fsub_rn(q[3], q[4]));
    store_costs(a, q, dist, m, blk, nblk, dist_out, rate_out);
  }
}

template <int TXS>
__global__ void __launch_bounds__(kThreads, TXS <= 8 ? 2 : 3)
    rd_quant_kernel(const int* __restrict__ src, const RdQuantArgs a, const int* __restrict__ table,
                    const float* __restrict__ basis, float* __restrict__ dist_out, float* __restrict__ rate_out) {
  extern __shared__ __align__(16) float qsm[];
  if constexpr (TXS <= 8)
    quant_small<TXS>(qsm, src, a, table, basis, dist_out, rate_out);
  else
    quant_large<TXS>(qsm, src, a, table, basis, dist_out, rate_out);
}

template <int PX>
int launch_satd(const RdSatdArgs& a, const int* src, const int* table, float* satd_out, float* delta_out,
                cudaStream_t stream) {
  using S = SatdShape<PX>;
  const int bytes = S::kWords * 4;
  const cudaError_t e = cudaFuncSetAttribute(rd_satd_kernel<PX>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const int grid = (a.rows * a.cols + S::NB - 1) / S::NB;
  rd_satd_kernel<PX><<<grid, kThreads, bytes, stream>>>(src, a, table, satd_out, delta_out);
  return cudaGetLastError();
}

template <int TXS>
int launch_quant(const RdQuantArgs& a, const int* src, const int* table, const float* basis, float* dist_out,
                 float* rate_out, cudaStream_t stream) {
  int bytes;
  dim3 grid;
  if constexpr (TXS <= 8) {
    bytes = QuantSmall<TXS>::kWords * 4;
    grid = dim3((a.rows * a.cols + 31) / 32, (a.n_modes + kWarps - 1) / kWarps);
  } else {
    using S = QuantLarge<TXS>;
    bytes = S::kWords * 4;
    grid = dim3((a.rows * a.cols * a.n_modes + S::NT - 1) / S::NT);
  }
  const cudaError_t e = cudaFuncSetAttribute(rd_quant_kernel<TXS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  rd_quant_kernel<TXS><<<grid, kThreads, bytes, stream>>>(src, a, table, basis, dist_out, rate_out);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. The satd rows of one block size px (n_modes x
// rows*cols floats at satd_out) and, when n_dir > 0, its delta rows (n_dir x
// rows*cols at delta_out), on `stream`. args: RdSatdArgs; src: (H, W)
// int32; table: rdsearch_device._kernel_table. Returns cudaGetLastError()
// of the launch.
extern "C" int avt_rd_satd(const void* args, int px, const void* src, const void* table, void* satd_out,
                           void* delta_out, void* stream) {
  const RdSatdArgs& a = *static_cast<const RdSatdArgs*>(args);
  if (a.n_modes < 1 || a.n_modes > kMaxModes || a.n_dir < 0 || a.n_dir > kMaxModes ||
      (a.n_dir > 0 && delta_out == nullptr) || a.n_var < a.n_modes + kDeltas * a.n_dir || a.n_var > kMaxVar ||
      a.rows * px < a.H || a.cols * px < a.W)
    return cudaErrorInvalidValue;
  for (int d = 0; d < a.n_dir; ++d)
    if (a.dir_src[d] < -1 || a.dir_src[d] >= a.n_modes) return cudaErrorInvalidValue;
  const int* s = static_cast<const int*>(src);
  const int* t = static_cast<const int*>(table);
  float* so = static_cast<float*>(satd_out);
  float* dlt = static_cast<float*>(delta_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (px) {
    case 8: return launch_satd<8>(a, s, t, so, dlt, st);
    case 16: return launch_satd<16>(a, s, t, so, dlt, st);
    case 32: return launch_satd<32>(a, s, t, so, dlt, st);
    case 64: return launch_satd<64>(a, s, t, so, dlt, st);
    default: return cudaErrorInvalidValue;
  }
}

// C interface for ctypes. The dist and rate rows of one transform size txs
// (n_modes x rows*cols floats each), on `stream`. args: RdQuantArgs;
// basis: kron(M, M)^T (txs^2 x txs^2) for txs <= 8, else M (txs x txs),
// 16-byte aligned. Returns cudaGetLastError() of the launch.
extern "C" int avt_rd_quant(const void* args, int txs, const void* src, const void* table, const void* basis,
                            void* dist_out, void* rate_out, void* stream) {
  const RdQuantArgs& a = *static_cast<const RdQuantArgs*>(args);
  if (a.n_modes < 1 || a.n_modes > a.n_var || a.rows * txs < a.H || a.cols * txs < a.W ||
      reinterpret_cast<uintptr_t>(basis) % 16 != 0)
    return cudaErrorInvalidValue;
  const int* s = static_cast<const int*>(src);
  const int* t = static_cast<const int*>(table);
  const float* m = static_cast<const float*>(basis);
  float* d = static_cast<float*>(dist_out);
  float* r = static_cast<float*>(rate_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (txs) {
    case 4: return launch_quant<4>(a, s, t, m, d, r, st);
    case 8: return launch_quant<8>(a, s, t, m, d, r, st);
    case 16: return launch_quant<16>(a, s, t, m, d, r, st);
    case 32: return launch_quant<32>(a, s, t, m, d, r, st);
    case 64: return launch_quant<64>(a, s, t, m, d, r, st);
    default: return cudaErrorInvalidValue;
  }
}
