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
//     with __f*_rn (nvcc contracts nothing), and the sums are fixed trees.
//
// What bounds it on an H100 SXM. A 768x512 frame at speed 6 reads 1.5 MB and
// writes 1.6 MB of tables (about 1 us at 3.35 TB/s); the work is some 0.6 G
// int32 operations (prediction, residual, 8x8 Hadamard, absolute sums) and
// 1.4 GFLOP fp32 (the separable DCTs, the quantizer and the bit model):
// tens of microseconds. The eager formulation moves each table through device
// memory about ten times (the 56-variant bank at px = 32 alone writes 88 MB).
//
// Design: one block's samples and its border stay in shared memory while
// every variant is predicted and transformed there; nothing but the tables
// is written to device memory.
//   - avt_rd_satd, templated on px in {8, 16, 32, 64}: a CTA takes one block
//     (four at px = 8) and one group of variants: the candidate modes
//     (blockIdx.y = 0, the satd rows) or one directional mode's seven angle
//     deltas (blockIdx.y = 1 + d, one delta row). Eight lanes take one 8x8
//     Hadamard tile, a lane one row of it: prediction, residual and the row
//     butterflies in registers, the column butterflies by xor shuffles
//     across the eight lanes, then the absolute sum; the tile sums meet in
//     shared memory.
//   - avt_rd_quant, templated on txs in {4, 8, 16, 32, 64}: a CTA takes one
//     block (16 at txs = 4, 4 at txs = 8) and walks the candidate modes (or
//     one mode a CTA when the grid is small), one mode's residual at a time
//     in shared memory. txs <= 8: one dot of length txs^2 a coefficient with
//     the Kronecker basis, as the plain version; txs >= 16: M r, then
//     (M r) M^T, with M and M^T in shared memory; at txs = 64 the dropped
//     energy is sum(c^2) - sum(c[:32, :32]^2), as the plain version.
//   - The predictions come from host-built tables (rdsearch_device.
//     _kernel_table): per variant a kind (DC, V, H, the smooths, Paeth: their
//     formulas; directional: a two-tap table of ext1 columns and a weight in
//     1/32 derived from the same _dir_index_tables the plain version's G is).
//   - ext1 = [corner, above(2px), left(2px)] is read from the plane with the
//     coordinates clamped to it, which is the reference's replicated pad; the
//     first block row and column see 1 << (bd - 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxModes = 16;   // candidate modes a program (13 at most)
constexpr int kDeltas = 7;      // angle deltas a directional mode: 0, -3, -2, -1, 1, 2, 3
constexpr int kSatdThreads = 128;
constexpr int kQuantThreads = 256;
constexpr int kQuantWarps = kQuantThreads / 32;

// Variant kinds of the host table (rdsearch_device._KINDS).
enum Kind : int { kDC = 0, kV, kH, kSmooth, kSmoothV, kSmoothH, kPaeth, kDir };

// Both structs are mirrored by ctypes.Structure classes in
// codec/av1/rdsearch_device.py.
struct RdSatdArgs {
  int H, W, rows, cols, bd;
  int n_modes;          // candidate modes: table variants 0 .. n_modes - 1, the satd rows
  int n_dir;            // directional modes: variants n_modes + 7 d + k, the delta rows
  int n_var;            // variants in the table
  int bits[kMaxModes];  // (lam_x16 * bits) >> 4 of each candidate mode
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

// Sample j (row-major) of block (br, bc).
template <int PX>
__device__ __forceinline__ int block_sample(const int* __restrict__ src, int H, int W, int br, int bc, int j) {
  return src[min(br * PX + j / PX, H - 1) * W + min(bc * PX + j % PX, W - 1)];
}

// DC_PRED of each of NB blocks, one warp a block: (sum of above[0..PX) and
// left[0..PX) + PX) >> log2(2 PX), clipped, which is floor(ext1 @ G).
template <int PX, int NB>
__device__ __forceinline__ void dc_values(const int* ext, int* dcv, int maxv) {
  constexpr int L = 4 * PX + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = warp; b < NB; b += blockDim.x >> 5) {
    int s = 0;
    for (int i = lane; i < PX; i += 32) s += ext[b * L + 1 + i] + ext[b * L + 2 * PX + 1 + i];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) dcv[b] = clampi((s + PX) >> ilog2(2 * PX), maxv);
  }
}

// One sample of one variant, equal to clip(floor(ext1 @ G), 0, maxv) of the
// plain version (Paeth: its formula, unclipped).
template <int PX>
__device__ __forceinline__ int predict(int kind, const int* e, const int* smw, const uint32_t* __restrict__ taps,
                                       int dc, int y, int x, int maxv) {
  switch (kind) {
    case kDC:
      return dc;
    case kV:
      return clampi(e[1 + x], maxv);
    case kH:
      return clampi(e[2 * PX + 1 + y], maxv);
    case kSmooth: {
      const int wy = smw[y], wx = smw[x];
      return clampi((wy * e[1 + x] + (256 - wy) * e[3 * PX] + wx * e[2 * PX + 1 + y] + (256 - wx) * e[PX] + 256) >> 9,
                    maxv);
    }
    case kSmoothV: {
      const int wy = smw[y];
      return clampi((wy * e[1 + x] + (256 - wy) * e[3 * PX] + 128) >> 8, maxv);
    }
    case kSmoothH: {
      const int wx = smw[x];
      return clampi((wx * e[2 * PX + 1 + y] + (256 - wx) * e[PX] + 128) >> 8, maxv);
    }
    case kPaeth: {
      const int a = e[1 + x], l = e[2 * PX + 1 + y], c = e[0];
      const int b = a + l - c, pa = abs(b - a), pl = abs(b - l), pc = abs(b - c);
      return (pa <= pl && pa <= pc) ? a : (pl <= pc ? l : c);
    }
    default: {  // directional: two taps of ext1, the weight of the second in 1/32
      const uint32_t t = __ldg(taps + y * PX + x);
      const int c0 = t & 511, c1 = (t >> 9) & 511, s = t >> 18;
      return clampi((e[c0] * (32 - s) + e[c1] * s + 16) >> 5, maxv);
    }
  }
}

// ------------------------------------------------------------ avt_rd_satd

template <int PX>
__global__ void __launch_bounds__(kSatdThreads)
    rd_satd_kernel(const int* __restrict__ src, const RdSatdArgs a, const int* __restrict__ table,
                   float* __restrict__ satd_out, float* __restrict__ delta_out) {
  constexpr int NB = PX == 8 ? 4 : 1;  // blocks a CTA
  constexpr int TW = PX / 8;           // 8x8 Hadamard tiles a block row
  constexpr int T = TW * TW;
  constexpr int L = 4 * PX + 1;
  __shared__ int smp[NB][PX * PX];
  __shared__ int ext[NB][L];
  __shared__ int smw[PX];
  __shared__ int dcv[NB];
  __shared__ int sums[NB][kMaxModes];

  const int nblk = a.rows * a.cols, blk0 = blockIdx.x * NB;
  const int group = blockIdx.y;  // 0: the candidate modes; 1 + d: directional mode d's deltas
  const int v0 = group == 0 ? 0 : a.n_modes + kDeltas * (group - 1);
  const int nv = group == 0 ? a.n_modes : kDeltas;
  const int base = 1 << (a.bd - 1), maxv = (1 << a.bd) - 1;

  for (int i = threadIdx.x; i < NB * PX * PX; i += blockDim.x) {
    const int b = i / (PX * PX), blk = min(blk0 + b, nblk - 1);
    smp[b][i % (PX * PX)] = block_sample<PX>(src, a.H, a.W, blk / a.cols, blk % a.cols, i % (PX * PX));
  }
  for (int i = threadIdx.x; i < NB * L; i += blockDim.x) {
    const int b = i / L, blk = min(blk0 + b, nblk - 1);
    ext[b][i % L] = border_sample<PX>(src, a.H, a.W, blk / a.cols, blk % a.cols, base, i % L);
  }
  for (int i = threadIdx.x; i < PX; i += blockDim.x) smw[i] = table[a.n_var + i];
  for (int i = threadIdx.x; i < NB * kMaxModes; i += blockDim.x) sums[i / kMaxModes][i % kMaxModes] = 0;
  __syncthreads();
  dc_values<PX, NB>(&ext[0][0], dcv, maxv);
  __syncthreads();

  // Units of eight lanes: (block, variant, tile), a lane one tile row. The
  // loop runs whole warps, so every lane reaches the shuffles; lanes past
  // the last unit repeat it and add nothing.
  const int lane = threadIdx.x & 31, row = lane & 7;
  const int groups = NB * nv * T;
  const uint32_t* taps0 = reinterpret_cast<const uint32_t*>(table) + a.n_var + PX;
  for (int u0 = threadIdx.x & ~31; u0 < 8 * groups; u0 += blockDim.x) {
    const bool live = u0 + lane < 8 * groups;
    const int g = min((u0 + lane) >> 3, groups - 1);
    const int t = g % T, v = (g / T) % nv, b = g / (T * nv);
    const int desc = __ldg(table + v0 + v);
    const uint32_t* taps = taps0 + (desc >> 4) * PX * PX;
    const int y = (t / TW) * 8 + row, x0 = (t % TW) * 8;
    int r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      r[k] = smp[b][y * PX + x0 + k] - predict<PX>(desc & 15, ext[b], smw, taps, dcv[b], y, x0 + k, maxv);
#pragma unroll
    for (int s = 1; s < 8; s <<= 1)  // the row transform: three butterfly stages
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (!(k & s)) {
          const int p = r[k], q = r[k | s];
          r[k] = p + q;
          r[k | s] = p - q;
        }
#pragma unroll
    for (int s = 1; s < 8; s <<= 1)  // the column transform, across the unit's lanes
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int o = __shfl_xor_sync(0xffffffffu, r[k], s);
        r[k] = (row & s) ? o - r[k] : r[k] + o;
      }
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += abs(r[k]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if (live && row == 0) atomicAdd(&sums[b][v], acc);
  }
  __syncthreads();

  if (group == 0) {  // satd rows: SATD // 16 + the mode's lambda-scaled bits
    for (int i = threadIdx.x; i < NB * nv; i += blockDim.x) {
      const int b = i / nv, m = i % nv, blk = blk0 + b;
      if (blk < nblk) satd_out[m * nblk + blk] = __int2float_rn(sums[b][m] / 16 + a.bits[m]);
    }
  } else {  // delta row: the first argmin over (0, -3, -2, -1, 1, 2, 3)
    for (int b = threadIdx.x; b < NB; b += blockDim.x) {
      const int blk = blk0 + b;
      if (blk >= nblk) continue;
      int best = 0, cost = sums[b][0] / 16;
      for (int k = 1; k < kDeltas; ++k)
        if (sums[b][k] / 16 < cost) {
          cost = sums[b][k] / 16;
          best = k;
        }
      delta_out[(group - 1) * nblk + blk] = float(best == 0 ? 0 : (best <= 3 ? best - 4 : best - 3));
    }
  }
}

// ----------------------------------------------------------- avt_rd_quant

template <int TXS>
struct QuantShape {
  static constexpr int NB = TXS <= 8 ? kQuantThreads / (TXS * TXS) : 1;  // blocks a CTA
  static constexpr int N2 = TXS * TXS;
  static constexpr int G = NB > 1 ? N2 : kQuantThreads;  // threads of one block
  static constexpr int L = 4 * TXS + 1;
  // dynamic shared memory in 4-byte words: samples, residuals, M r, the
  // basis (kron(M, M)^T, or M and M^T), ext1, smooth weights, DC values, and
  // the reduction's warp sums
  static constexpr int kSmp = 0;
  static constexpr int kRes = kSmp + NB * N2;
  static constexpr int kT1 = kRes + NB * N2;
  static constexpr int kBasis = kT1 + (TXS >= 16 ? N2 : 0);
  static constexpr int kExt = kBasis + (TXS <= 8 ? N2 * N2 : 2 * N2);
  static constexpr int kSmw = kExt + NB * L;
  static constexpr int kDc = kSmw + TXS;
  static constexpr int kRed = kDc + NB;
  static constexpr int kWords = kRed + 5 * kQuantWarps;
};

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

// The sums of Q quantities over each group of G consecutive threads, into
// the group's first thread, by a fixed tree: halves within each warp (xor
// shuffles), then halves over the group's warp sums. Every thread calls it.
template <int G, int Q>
__device__ __forceinline__ void group_sums(float* v, float* scratch) {
  constexpr int WIDTH = G < 32 ? G : 32;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int o = WIDTH / 2; o > 0; o >>= 1) v[q] = __fadd_rn(v[q], __shfl_xor_sync(0xffffffffu, v[q], o));
  if constexpr (G > 32) {
    constexpr int W = G / 32;
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) scratch[q * kQuantWarps + warp] = v[q];
    }
    __syncthreads();
    if (threadIdx.x % G == 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float s[W];
#pragma unroll
        for (int w = 0; w < W; ++w) s[w] = scratch[q * kQuantWarps + warp + w];
#pragma unroll
        for (int h = W / 2; h > 0; h >>= 1)
#pragma unroll
          for (int w = 0; w < h; ++w) s[w] = __fadd_rn(s[w], s[w + h]);
        v[q] = s[0];
      }
    }
  }
}

template <int TXS>
__global__ void __launch_bounds__(kQuantThreads)
    rd_quant_kernel(const int* __restrict__ src, const RdQuantArgs a, const int* __restrict__ table,
                    const float* __restrict__ basis, float* __restrict__ dist_out, float* __restrict__ rate_out) {
  using S = QuantShape<TXS>;
  constexpr int NB = S::NB, N2 = S::N2, G = S::G, L = S::L;
  constexpr int KEEP = TXS > 32 ? 32 : TXS;  // the spec codes no coefficient beyond 32
  constexpr int Q = TXS > 32 ? 5 : 3;        // err^2, nonzeros, log2 terms (and sum c^2, kept c^2)
  extern __shared__ float sm[];
  int* smp = reinterpret_cast<int*>(sm + S::kSmp);
  float* res = sm + S::kRes;
  float* t1 = sm + S::kT1;
  float* bs = sm + S::kBasis;
  int(*ext)[L] = reinterpret_cast<int(*)[L]>(sm + S::kExt);
  int* smw = reinterpret_cast<int*>(sm + S::kSmw);
  int* dcv = reinterpret_cast<int*>(sm + S::kDc);
  float* red = sm + S::kRed;

  const int nblk = a.rows * a.cols, blk0 = blockIdx.x * NB;
  const int base = 1 << (a.bd - 1), maxv = (1 << a.bd) - 1;
  for (int i = threadIdx.x; i < NB * N2; i += blockDim.x) {
    const int b = i / N2, blk = min(blk0 + b, nblk - 1);
    smp[i] = block_sample<TXS>(src, a.H, a.W, blk / a.cols, blk % a.cols, i % N2);
  }
  for (int i = threadIdx.x; i < NB * L; i += blockDim.x) {
    const int b = i / L, blk = min(blk0 + b, nblk - 1);
    ext[b][i % L] = border_sample<TXS>(src, a.H, a.W, blk / a.cols, blk % a.cols, base, i % L);
  }
  if constexpr (TXS <= 8) {
    for (int i = threadIdx.x; i < N2 * N2; i += blockDim.x) bs[i] = __ldg(basis + i);
  } else {
    for (int i = threadIdx.x; i < N2; i += blockDim.x) {
      const float m = __ldg(basis + i);
      bs[i] = m;                                  // M[r][k]
      bs[N2 + (i % TXS) * TXS + i / TXS] = m;     // M^T[k][r]
    }
  }
  for (int i = threadIdx.x; i < TXS; i += blockDim.x) smw[i] = table[a.n_var + i];
  __syncthreads();
  dc_values<TXS, NB>(&ext[0][0], dcv, maxv);
  __syncthreads();

  const uint32_t* taps0 = reinterpret_cast<const uint32_t*>(table) + a.n_var + TXS;
  for (int m = blockIdx.y; m < a.n_modes; m += gridDim.y) {
    const int desc = __ldg(table + m);
    const uint32_t* taps = taps0 + (desc >> 4) * N2;
    for (int i = threadIdx.x; i < NB * N2; i += blockDim.x) {
      const int b = i / N2, j = i % N2;
      res[i] = float(smp[i] - predict<TXS>(desc & 15, ext[b], smw, taps, dcv[b], j / TXS, j % TXS, maxv));
    }
    __syncthreads();

    float acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = 0.f;
    if constexpr (TXS <= 8) {  // c = vec(r) @ kron(M, M)^T, a thread a coefficient
      const int b = threadIdx.x / N2, k = threadIdx.x % N2;
      float c = 0.f;
#pragma unroll 16
      for (int j = 0; j < N2; ++j) c = __fmaf_rn(res[b * N2 + j], bs[j * N2 + k], c);
      quantize(c, k == 0, a, acc);
    } else {
      for (int i = threadIdx.x; i < N2; i += blockDim.x) {  // t1 = M r
        const int r = i / TXS, col = i % TXS;
        float s = 0.f;
#pragma unroll 16
        for (int k = 0; k < TXS; ++k) s = __fmaf_rn(bs[r * TXS + k], res[k * TXS + col], s);
        t1[i] = s;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < N2; i += blockDim.x) {  // c = t1 M^T
        const int r = i / TXS, d = i % TXS;
        float c = 0.f;
#pragma unroll 16
        for (int k = 0; k < TXS; ++k) c = __fmaf_rn(t1[r * TXS + k], bs[N2 + k * TXS + d], c);
        const bool kept = r < KEEP && d < KEEP;
        if constexpr (TXS > 32) {
          const float sq = __fmul_rn(c, c);
          acc[3] = __fadd_rn(acc[3], sq);
          if (kept) acc[4] = __fadd_rn(acc[4], sq);
        }
        if (kept) quantize(c, i == 0, a, acc);
      }
    }
    group_sums<G, Q>(acc, red);
    if (threadIdx.x % G == 0) {
      const int blk = blk0 + threadIdx.x / G;
      if (blk < nblk) {
        float dist = acc[0];
        if constexpr (TXS > 32) dist = __fadd_rn(dist, __fsub_rn(acc[3], acc[4]));
        dist_out[m * nblk + blk] = dist;
        rate_out[m * nblk + blk] =
            __fadd_rn(__fadd_rn(__fmul_rn(acc[1], a.nz), __fmul_rn(acc[2], a.mag)), a.txb);
      }
    }
    __syncthreads();  // res, t1 and the warp sums are the next mode's
  }
}

template <int PX>
int launch_satd(const RdSatdArgs& a, const int* src, const int* table, float* satd_out, float* delta_out,
                cudaStream_t stream) {
  constexpr int NB = PX == 8 ? 4 : 1;
  const dim3 grid((a.rows * a.cols + NB - 1) / NB, 1 + a.n_dir);
  rd_satd_kernel<PX><<<grid, kSatdThreads, 0, stream>>>(src, a, table, satd_out, delta_out);
  return cudaGetLastError();
}

template <int TXS>
int launch_quant(const RdQuantArgs& a, const int* src, const int* table, const float* basis, float* dist_out,
                 float* rate_out, cudaStream_t stream) {
  using S = QuantShape<TXS>;
  const int bytes = S::kWords * 4;
  const cudaError_t e = cudaFuncSetAttribute(rd_quant_kernel<TXS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const int ctas = (a.rows * a.cols + S::NB - 1) / S::NB;
  // one CTA walks every mode when the blocks fill the card; else one mode a CTA
  const dim3 grid(ctas, ctas >= 1024 ? 1 : a.n_modes);
  rd_quant_kernel<TXS><<<grid, kQuantThreads, bytes, stream>>>(src, a, table, basis, dist_out, rate_out);
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
  if (a.n_modes < 1 || a.n_modes > kMaxModes || a.n_dir < 0 || (a.n_dir > 0 && delta_out == nullptr) ||
      a.n_var < a.n_modes + kDeltas * a.n_dir || a.rows * px < a.H || a.cols * px < a.W)
    return cudaErrorInvalidValue;
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
// basis: kron(M, M)^T (txs^2 x txs^2) for txs <= 8, else M (txs x txs).
// Returns cudaGetLastError() of the launch.
extern "C" int avt_rd_quant(const void* args, int txs, const void* src, const void* table, const void* basis,
                            void* dist_out, void* rate_out, void* stream) {
  const RdQuantArgs& a = *static_cast<const RdQuantArgs*>(args);
  if (a.n_modes < 1 || a.n_modes > a.n_var || a.rows * txs < a.H || a.cols * txs < a.W)
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
