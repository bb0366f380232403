// Native entropy fast path: msac range coder + tile level coding.
//
// Bit-exact C++ implementation of the Python reference
// (libavif_tpu/models/av1/msac.py + libavif_tpu/codec/entropy.py); tests
// enforce byte-identical output both ways. This plays the role of the
// hand-tuned entropy loops the reference delegates to libaom/dav1d
// (SURVEY.md §2.2) — original implementation, not a copy.
//
// Encoder "low" is conceptually an arbitrary-precision integer (carry
// propagation is free in the Python reference). Here it is a byte buffer
// (finalized high bits) + a 64-bit window of in-flight low bits; additions
// carry into the buffer at most once per symbol.
//
// Build: g++ -O3 -shared -fPIC msac.cc -o _msac.so  (see native/__init__.py)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int EC_PROB_SHIFT = 6;
constexpr int EC_MIN_PROB = 4;
constexpr uint32_t PROB_TOP = 1u << 15;

constexpr int kSpeed[17] = {0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2};

inline int bit_length(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

void update_cdf(uint16_t* icdf, int val, int nsymbs) {
  int count = icdf[nsymbs];
  int rate = 3 + (count > 15) + (count > 31) + kSpeed[nsymbs];
  uint32_t tmp = PROB_TOP;
  for (int i = 0; i < nsymbs - 1; ++i) {
    if (i == val) tmp = 0;
    uint32_t c = icdf[i];
    if (tmp < c)
      icdf[i] = static_cast<uint16_t>(c - ((c - tmp) >> rate));
    else
      icdf[i] = static_cast<uint16_t>(c + ((tmp - c) >> rate));
  }
  if (count < 32) icdf[nsymbs] = static_cast<uint16_t>(count + 1);
}

void uniform_icdf(uint16_t* icdf, int n) {
  for (int i = 0; i < n - 1; ++i)
    icdf[i] = static_cast<uint16_t>(PROB_TOP - ((i + 1) * PROB_TOP) / n);
  icdf[n - 1] = 0;
  icdf[n] = 0;
}

// ----------------------------------------------------------------- encoder

class Encoder {
 public:
  void symbol(int s, uint16_t* icdf, int n, bool adapt = true) {
    uint32_t r8 = rng_ >> 8;
    uint32_t v_prev, v_cur;
    if (s == 0) {
      v_prev = rng_;
    } else {
      v_prev = ((r8 * (icdf[s - 1] >> EC_PROB_SHIFT)) >> 1) +
               EC_MIN_PROB * (n - s);
    }
    v_cur = ((r8 * (icdf[s] >> EC_PROB_SHIFT)) >> 1) +
            EC_MIN_PROB * (n - 1 - s);
    add_low(rng_ - v_prev);
    rng_ = v_prev - v_cur;
    renorm();
    if (adapt) update_cdf(icdf, s, n);
  }

  void bit(int b) {
    uint32_t half = ((rng_ >> 8) << 7) + EC_MIN_PROB;
    if (b) {
      add_low(rng_ - half);
      rng_ = half;
    } else {
      rng_ -= half;
    }
    renorm();
  }

  void literal(uint32_t value, int bits) {
    for (int i = bits - 1; i >= 0; --i) bit((value >> i) & 1);
  }

  void golomb(uint32_t level) {
    uint32_t x = level + 1;
    int length = bit_length(x);
    for (int i = 0; i < length - 1; ++i) bit(0);
    for (int i = length - 1; i >= 0; --i) bit((x >> i) & 1);
  }

  // Serialize: the spec-terminated code in [low, low+rng), MSB-first —
  // code is the unique value with code % 2^15 == 2^14 (always present:
  // rng >= 2^15), which yields the trailing '1 then zeros' pattern at
  // bit index total_shift that libaom's
  // check_trailing_bits_after_symbol_coder enforces. strip=true drops
  // trailing zero bytes (own-format convention: the decoder zero-pads);
  // strip=false keeps the full code (spec payloads — dav1d treats
  // running out of bytes mid-tile as corruption).
  std::vector<uint8_t> finish(bool strip = true) {
    return finalize_bigint(total_shift_ + 15, strip);
  }

  int64_t total_shift() const { return total_shift_; }

 private:
  // Byte-wise big-int finalize of the exact Python algorithm: left-align
  // `low` into nbytes, round its low 15 bits up to 0x4000 (carry into
  // bit 15 when they exceed it), strip trailing zero bytes. O(nbytes);
  // the invariant low + rng <= 2^(15+total_shift) guarantees the carry
  // never overflows past the top byte.
  std::vector<uint8_t> finalize_bigint(int64_t nbits, bool strip = true) {
    const int wb = wbits_;
    const size_t nbytes = static_cast<size_t>((nbits + 7) / 8);
    const int pad = static_cast<int>(nbytes * 8 - nbits);  // 0..7 low zeros
    std::vector<uint8_t> out(nbytes, 0);
    // low, left-aligned: buf_ bytes, then the window's wb bits, then pad.
    std::memcpy(out.data(), buf_.data(), buf_.size());
    uint64_t tail = window_ << pad;  // wb + pad <= 62 bits
    int tail_bits = wb + pad;
    for (size_t i = nbytes; tail_bits > 0 && i > buf_.size();) {
      --i;
      out[i] = static_cast<uint8_t>(tail & 0xFF);
      tail >>= 8;
      tail_bits -= 8;
    }
    // r = low % 2^15 (buffer holds low << pad: bits pad..pad+14).
    uint64_t r = 0;
    for (int b = 0; b < 15; ++b) {
      const size_t k = static_cast<size_t>(pad + b);
      r |= static_cast<uint64_t>((out[nbytes - 1 - (k >> 3)] >> (k & 7)) & 1)
           << b;
    }
    // Clear the low pad+15 bits, then set bit pad+14 (code tail 0x4000).
    const size_t nclear = static_cast<size_t>(pad) + 15;
    const size_t full = nclear >> 3;
    for (size_t i = 0; i < full && i < nbytes; ++i) out[nbytes - 1 - i] = 0;
    if ((nclear & 7) && full < nbytes)
      out[nbytes - 1 - full] &= static_cast<uint8_t>(0xFF << (nclear & 7));
    {
      const size_t k = static_cast<size_t>(pad) + 14;
      out[nbytes - 1 - (k >> 3)] |= static_cast<uint8_t>(1u << (k & 7));
    }
    if (r > (1ull << 14)) {
      // rounding up crossed 2^15: code = low - r + 2^15 + 2^14
      const size_t k = static_cast<size_t>(pad) + 15;
      uint64_t carry = 1ull << (k & 7);
      size_t i = nbytes - 1 - (k >> 3);
      while (carry) {
        const uint64_t v = out[i] + carry;
        out[i] = static_cast<uint8_t>(v & 0xFF);
        carry = v >> 8;
        if (i == 0) break;
        --i;
      }
    }
    if (strip) {
      // strip trailing zero bytes; decoder zero-pads
      while (out.size() > 1 && out.back() == 0) out.pop_back();
    }
    if (out.empty()) out.push_back(0);
    return out;
  }

  void add_low(uint32_t x) {
    window_ += x;
    if (wbits_ < 64 && (window_ >> wbits_)) {
      // carry into finalized bytes
      window_ &= (wbits_ == 64) ? ~0ull : ((1ull << wbits_) - 1);
      for (int i = static_cast<int>(buf_.size()) - 1; i >= 0; --i) {
        if (++buf_[i] != 0) break;  // stop when no wraparound
      }
    }
  }

  void renorm() {
    int d = 16 - bit_length(rng_);
    if (d) {
      rng_ <<= d;
      window_ <<= d;
      wbits_ += d;
      total_shift_ += d;
      while (wbits_ >= 40) {
        int top = wbits_ - 8;
        buf_.push_back(static_cast<uint8_t>((window_ >> top) & 0xFF));
        window_ &= (1ull << top) - 1;
        wbits_ = top;
      }
    }
  }

  std::vector<uint8_t> buf_;
  uint64_t window_ = 0;
  // `low` needs 15 + total_shift bits (invariant low + rng <= 2^(15+ts));
  // the window starts with the 15 fractional bits, all zero.
  int wbits_ = 15;
  uint32_t rng_ = PROB_TOP;
  int64_t total_shift_ = 0;
};

// ----------------------------------------------------------------- decoder

class Decoder {
 public:
  Decoder(const uint8_t* data, int size) : data_(data), nbits_(int64_t(size) * 8) {
    for (int i = 0; i < 15; ++i) dif_ = (dif_ << 1) | next_bit();
  }

  int symbol(uint16_t* icdf, int n, bool adapt = true) {
    uint32_t r8 = rng_ >> 8;
    uint32_t dif = dif_;
    uint32_t v_prev = rng_;
    int s = 0;
    uint32_t v_cur;
    for (;;) {
      v_cur = ((r8 * (icdf[s] >> EC_PROB_SHIFT)) >> 1) +
              EC_MIN_PROB * (n - 1 - s);
      if (dif < rng_ - v_cur) break;
      v_prev = v_cur;
      ++s;
    }
    dif_ = dif - (rng_ - v_prev);
    rng_ = v_prev - v_cur;
    renorm();
    if (adapt) update_cdf(icdf, s, n);
    return s;
  }

  int bit() {
    uint32_t half = ((rng_ >> 8) << 7) + EC_MIN_PROB;
    int b;
    if (dif_ >= rng_ - half) {
      dif_ -= rng_ - half;
      rng_ = half;
      b = 1;
    } else {
      rng_ -= half;
      b = 0;
    }
    renorm();
    return b;
  }

  uint32_t literal(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i) v = (v << 1) | bit();
    return v;
  }

  // returns -1 on overflow (hostile stream)
  int64_t golomb() {
    int length = 1;
    while (bit() == 0) {
      if (++length > 32) return -1;
    }
    uint64_t x = 1;
    for (int i = 0; i < length - 1; ++i) x = (x << 1) | bit();
    return static_cast<int64_t>(x - 1);
  }

 private:
  int next_bit() {
    int64_t p = bitpos_++;
    if (p >= nbits_) return 0;
    return (data_[p >> 3] >> (7 - (p & 7))) & 1;
  }

  void renorm() {
    int d = 16 - bit_length(rng_);
    while (d-- > 0) {
      rng_ <<= 1;
      dif_ = ((dif_ << 1) | next_bit()) & 0x7FFFFFFF;
    }
  }

  const uint8_t* data_;
  int64_t nbits_;
  int64_t bitpos_ = 0;
  uint32_t rng_ = PROB_TOP;
  uint32_t dif_ = 0;
};

// ------------------------------------------------------------- tile coding

constexpr int N_MODES = 13;
constexpr int N_BASE_CTX = 3;
constexpr int N_TX = 5;

int eob_classes(int n) { return bit_length(n * n - 1) + 1; }

void zigzag_flat(int n, std::vector<int>& out) {
  out.clear();
  out.reserve(n * n);
  for (int d = 0; d < 2 * n - 1; ++d) {
    int lo = d - n + 1 > 0 ? d - n + 1 : 0;
    int hi = d < n - 1 ? d : n - 1;
    if (d % 2 == 0) {
      for (int r = hi; r >= lo; --r) out.push_back(r * n + (d - r));
    } else {
      for (int r = lo; r <= hi; ++r) out.push_back(r * n + (d - r));
    }
  }
}

// Trained initial inverse-CDFs — must mirror entropy.py _INIT_* exactly.
constexpr uint16_t kInitMode[N_MODES + 1] = {27197, 22610, 19661, 18678,
                                             17039, 16056, 14746, 13763,
                                             12452, 7209,  4588,  2294,
                                             0,     0};
constexpr uint16_t kInitAllZero[3] = {22938, 0, 0};
constexpr uint16_t kInitTx[N_TX + 1] = {9830, 7209, 4588, 1966, 0, 0};
// v2 coefficient model (FRAME_MAGIC 0x59) — must mirror entropy.py:
// 3 position classes x 3 neighbor-magnitude classes for base, {1,2,3+}
// at the eob position, 4-step base-range ladder, adaptive DC sign.
constexpr int BR_STEPS = 4;
constexpr uint16_t kInitBase[9][5] = {
    {26214, 19661, 16384, 0, 0}, {22938, 16384, 11469, 0, 0},
    {19661, 13107, 8192, 0, 0},
    {16384, 9175, 5898, 0, 0},   {13107, 7373, 4588, 0, 0},
    {9830, 5243, 3277, 0, 0},
    {6554, 1638, 655, 0, 0},     {5243, 1966, 983, 0, 0},
    {4588, 2294, 1311, 0, 0},
};
constexpr uint16_t kInitBaseEob[N_BASE_CTX][4] = {
    {16384, 8192, 0, 0},
    {11469, 4915, 0, 0},
    {8192, 3277, 0, 0},
};
constexpr uint16_t kInitBr[N_BASE_CTX][5] = {
    {16384, 8192, 4096, 0, 0},
    {13107, 6554, 3277, 0, 0},
    {11469, 5734, 2867, 0, 0},
};
constexpr uint16_t kInitDcSign[3] = {16384, 0, 0};

struct TileCdfs {
  std::vector<uint16_t> mode, allzero, tx, eobcls, dcsign;
  std::vector<uint16_t> base[9];
  std::vector<uint16_t> base_eob[N_BASE_CTX];
  std::vector<uint16_t> br[N_BASE_CTX];
  explicit TileCdfs(int n) {
    mode.assign(kInitMode, kInitMode + N_MODES + 1);
    allzero.assign(kInitAllZero, kInitAllZero + 3);
    tx.assign(kInitTx, kInitTx + N_TX + 1);
    dcsign.assign(kInitDcSign, kInitDcSign + 3);
    int ec = eob_classes(n);
    eobcls.resize(ec + 1);
    uniform_icdf(eobcls.data(), ec);
    for (int i = 0; i < 9; ++i) base[i].assign(kInitBase[i], kInitBase[i] + 5);
    for (int i = 0; i < N_BASE_CTX; ++i) {
      base_eob[i].assign(kInitBaseEob[i], kInitBaseEob[i] + 4);
      br[i].assign(kInitBr[i], kInitBr[i] + 5);
    }
  }
};

inline int base_ctx(int k, int n) { return k == 0 ? 0 : (k < n ? 1 : 2); }

inline int mag_ctx(const int* cache, int k, int nn) {
  int s = k + 1 < nn ? cache[k + 1] : 0;
  if (k + 2 < nn) s += cache[k + 2];
  s = (s + 1) >> 1;
  return s > 2 ? 2 : s;
}

}  // namespace

extern "C" {

// Returns bytes written, or -1 if out_cap insufficient. tx_types may be
// null (lossless: no transform symbols are coded).
long avt_encode_tile(const int32_t* levels, const int32_t* modes,
                     const int32_t* tx_types, int rb, int cb, int n,
                     uint8_t* out, long out_cap) {
  Encoder enc;
  TileCdfs cdfs(n);
  std::vector<int> scan;
  zigzag_flat(n, scan);
  int ec = eob_classes(n);
  int nn = n * n;
  std::vector<int32_t> row(nn);
  for (long b = 0; b < long(rb) * cb; ++b) {
    enc.symbol(modes[b], cdfs.mode.data(), N_MODES);
    const int32_t* blk = levels + b * nn;
    int eob = 0;
    for (int k = 0; k < nn; ++k) {
      row[k] = blk[scan[k]];
      if (row[k]) eob = k + 1;
    }
    if (eob == 0) {
      enc.symbol(0, cdfs.allzero.data(), 2);
      continue;
    }
    enc.symbol(1, cdfs.allzero.data(), 2);
    if (tx_types != nullptr) enc.symbol(tx_types[b], cdfs.tx.data(), N_TX);
    int cls = bit_length(eob - 1);
    enc.symbol(cls, cdfs.eobcls.data(), ec);
    if (cls >= 2) enc.literal(eob - 1 - (1 << (cls - 1)), cls - 1);
    std::vector<int> cache(nn, 0);
    for (int k = eob - 1; k >= 0; --k) {
      int32_t v = row[k];
      uint32_t a = v < 0 ? -v : v;
      int pctx = base_ctx(k, n);
      if (k == eob - 1) {
        enc.symbol((a < 3 ? int(a) : 3) - 1, cdfs.base_eob[pctx].data(), 3);
      } else {
        int mctx = mag_ctx(cache.data(), k, nn);
        enc.symbol(a < 3 ? int(a) : 3, cdfs.base[pctx * 3 + mctx].data(), 4);
      }
      if (a >= 3) {
        uint32_t rem = a - 3;
        for (int i = 0; i < BR_STEPS; ++i) {
          int s = rem < 3 ? int(rem) : 3;
          enc.symbol(s, cdfs.br[pctx].data(), 4);
          rem -= s;
          if (s < 3) break;
        }
        if (a >= uint32_t(3 + 3 * BR_STEPS)) enc.golomb(a - 3 - 3 * BR_STEPS);
      }
      if (a) {
        if (k == 0)
          enc.symbol(v < 0 ? 1 : 0, cdfs.dcsign.data(), 2);
        else
          enc.bit(v < 0 ? 1 : 0);
      }
      cache[k] = a < 3 ? int(a) : 3;
    }
  }
  std::vector<uint8_t> payload = enc.finish();
  if (long(payload.size()) > out_cap) return -1;
  std::memcpy(out, payload.data(), payload.size());
  return long(payload.size());
}

// Returns 0, or <0 on malformed stream. tx_out may be null (no tx
// symbols in the stream).
int avt_decode_tile(const uint8_t* data, long size, int rb, int cb, int n,
                    int32_t* levels_out, int32_t* modes_out,
                    int32_t* tx_out) {
  Decoder dec(data, int(size));
  TileCdfs cdfs(n);
  std::vector<int> scan;
  zigzag_flat(n, scan);
  int ec = eob_classes(n);
  int nn = n * n;
  std::memset(levels_out, 0, sizeof(int32_t) * size_t(rb) * cb * nn);
  if (tx_out) std::memset(tx_out, 0, sizeof(int32_t) * size_t(rb) * cb);
  for (long b = 0; b < long(rb) * cb; ++b) {
    modes_out[b] = dec.symbol(cdfs.mode.data(), N_MODES);
    if (dec.symbol(cdfs.allzero.data(), 2) == 0) continue;
    if (tx_out) tx_out[b] = dec.symbol(cdfs.tx.data(), N_TX);
    int cls = dec.symbol(cdfs.eobcls.data(), ec);
    int eob;
    if (cls >= 2)
      eob = (1 << (cls - 1)) + int(dec.literal(cls - 1)) + 1;
    else
      eob = cls + 1;
    if (eob > nn) eob = nn;
    int32_t* blk = levels_out + b * nn;
    std::vector<int> cache(nn, 0);
    for (int k = eob - 1; k >= 0; --k) {
      int pctx = base_ctx(k, n);
      int a;
      if (k == eob - 1) {
        a = dec.symbol(cdfs.base_eob[pctx].data(), 3) + 1;
      } else {
        int mctx = mag_ctx(cache.data(), k, nn);
        a = dec.symbol(cdfs.base[pctx * 3 + mctx].data(), 4);
      }
      if (a >= 3) {
        for (int i = 0; i < BR_STEPS; ++i) {
          int s = dec.symbol(cdfs.br[pctx].data(), 4);
          a += s;
          if (s < 3) break;
        }
        if (a == 3 + 3 * BR_STEPS) {
          int64_t g = dec.golomb();
          if (g < 0) return -2;
          if (g > (1 << 24)) g = 1 << 24;  // hostile-stream clamp
          a += int(g);
        }
      }
      if (a) {
        int sign = k == 0 ? dec.symbol(cdfs.dcsign.data(), 2) : dec.bit();
        blk[scan[k]] = sign ? -a : a;
      }
      cache[k] = a < 3 ? a : 3;
    }
  }
  return 0;
}

// Raw coder entry points for cross-checking against the Python reference.
long avt_selftest_roundtrip(const int32_t* symbols, long count, int nsymbs,
                            uint8_t* buf, long cap) {
  Encoder enc;
  std::vector<uint16_t> cdf(nsymbs + 1);
  uniform_icdf(cdf.data(), nsymbs);
  for (long i = 0; i < count; ++i) enc.symbol(int(symbols[i]), cdf.data(), nsymbs);
  std::vector<uint8_t> payload = enc.finish();
  if (long(payload.size()) > cap) return -1;
  std::memcpy(buf, payload.data(), payload.size());
  Decoder dec(payload.data(), int(payload.size()));
  std::vector<uint16_t> cdf2(nsymbs + 1);
  uniform_icdf(cdf2.data(), nsymbs);
  for (long i = 0; i < count; ++i) {
    if (dec.symbol(cdf2.data(), nsymbs) != symbols[i]) return -2 - i;
  }
  return long(payload.size());
}

}  // extern "C"

// ===================================================================
// Spec-AV1 coefficient reader fast path (codec/av1/decode.py _coeffs,
// from the eob_pt symbol through signs/golomb tails). Bit-identical to
// the Python reference: the msac state [rng, dif, bitpos] hands off
// both ways and CDF rows adapt in place.

namespace {

struct SpecDec {
  const uint8_t* data;
  int64_t nbits;
  int64_t bitpos;
  uint32_t rng;
  uint32_t dif;
};

inline int spec_next_bit(SpecDec* s) {
  int64_t p = s->bitpos++;
  if (p >= s->nbits) return 0;
  return (s->data[p >> 3] >> (7 - (p & 7))) & 1;
}

// d MSB-first bits starting at bitpos (zero-padded past the end) in one
// 32-bit load when the window is fully inside the buffer — the decoder
// state trajectory is identical to d spec_next_bit() calls.
inline uint32_t spec_next_bits(SpecDec* s, int d) {
  int64_t p = s->bitpos;
  s->bitpos = p + d;
  if (p + 32 <= s->nbits) {
    const uint8_t* b = s->data + (p >> 3);
    uint32_t w = (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
                 (uint32_t(b[2]) << 8) | uint32_t(b[3]);
    return (w << (p & 7)) >> (32 - d);
  }
  uint32_t v = 0;
  for (int i = 0; i < d; ++i) {
    int64_t q = p + i;
    int bit = q < s->nbits ? (s->data[q >> 3] >> (7 - (q & 7))) & 1 : 0;
    v = (v << 1) | bit;
  }
  return v;
}

inline void spec_renorm(SpecDec* s) {
  int d = 16 - bit_length(s->rng);
  if (d <= 0) return;
  s->rng <<= d;
  // dif < rng <= 0xFFFF before the shift, so (dif << d) stays below
  // 2^31 and the historical per-step 0x7FFFFFFF mask is a no-op.
  s->dif = (s->dif << d) | spec_next_bits(s, d);
}

inline int spec_symbol(SpecDec* s, uint16_t* icdf, int n, int adapt) {
  uint32_t r8 = s->rng >> 8;
  uint32_t dif = s->dif;
  uint32_t v_prev = s->rng;
  int sym = 0;
  uint32_t v_cur;
  for (;;) {
    v_cur = ((r8 * (uint32_t(icdf[sym]) >> EC_PROB_SHIFT)) >> 1) +
            EC_MIN_PROB * uint32_t(n - 1 - sym);
    if (dif < s->rng - v_cur) break;
    v_prev = v_cur;
    ++sym;
  }
  s->dif = dif - (s->rng - v_prev);
  s->rng = v_prev - v_cur;
  spec_renorm(s);
  if (adapt) update_cdf(icdf, sym, n);
  return sym;
}

inline int spec_bit(SpecDec* s) {
  uint32_t half = ((s->rng >> 8) << 7) + EC_MIN_PROB;
  int bit;
  if (s->dif >= s->rng - half) {
    s->dif -= s->rng - half;
    s->rng = half;
    bit = 1;
  } else {
    s->rng -= half;
    bit = 0;
  }
  spec_renorm(s);
  return bit;
}

inline int64_t spec_golomb(SpecDec* s) {
  int length = 1;
  while (spec_bit(s) == 0) {
    if (++length > 32) return -1;
  }
  int64_t x = 1;
  for (int i = 0; i < length - 1; ++i) x = (x << 1) | spec_bit(s);
  return x - 1;
}

constexpr int SPEC_TX_2D = 0, SPEC_TX_VERT = 1, SPEC_TX_HORZ = 2;

inline int spec_base_ctx(const int32_t* lev, int lstride, int row, int col,
                         int pos, int tx_class, int txw, int txh) {
  auto L = [&](int r, int c) { return lev[r * lstride + c]; };
  auto m3 = [](int v) { return v < 3 ? v : 3; };
  int mag = m3(L(row, col + 1)) + m3(L(row + 1, col));
  if (tx_class == SPEC_TX_2D) {
    mag += m3(L(row + 1, col + 1)) + m3(L(row, col + 2)) + m3(L(row + 2, col));
    int ctx = (mag + 1) >> 1;
    if (ctx > 4) ctx = 4;
    if (pos == 0) return 0;
    if (txw > txh && col < 2) return 16 + ctx;
    if (txh > txw && row < 2) return 11 + ctx;
    if (row + col < 2) return ctx + 1;
    if (row + col < 4) return 5 + ctx + 1;
    return 21 + ctx;
  }
  if (tx_class == SPEC_TX_VERT) {
    mag += m3(L(row + 2, col)) + m3(L(row + 3, col)) + m3(L(row + 4, col));
  } else {
    mag += m3(L(row, col + 2)) + m3(L(row, col + 3)) + m3(L(row, col + 4));
  }
  int ctx = (mag + 1) >> 1;
  if (ctx > 4) ctx = 4;
  int d = tx_class == SPEC_TX_VERT ? row : col;
  if (d == 0) return 26 + ctx;
  if (d == 1) return 31 + ctx;
  return 36 + ctx;
}

inline int spec_br_ctx(const int32_t* lev, int lstride, int row, int col,
                       int pos, int tx_class) {
  auto L = [&](int r, int c) { return lev[r * lstride + c]; };
  int mag = L(row, col + 1) + L(row + 1, col);
  if (tx_class == SPEC_TX_2D) {
    mag += L(row + 1, col + 1);
    mag = (mag + 1) >> 1;
    if (mag > 6) mag = 6;
    if (pos == 0) return mag;
    return mag + ((row < 2 && col < 2) ? 7 : 14);
  }
  if (tx_class == SPEC_TX_VERT) {
    mag += L(row + 2, col);
    mag = (mag + 1) >> 1;
    if (mag > 6) mag = 6;
    if (pos == 0) return mag;
    return mag + (row == 0 ? 7 : 14);
  }
  mag += L(row, col + 2);
  mag = (mag + 1) >> 1;
  if (mag > 6) mag = 6;
  if (pos == 0) return mag;
  return mag + (col == 0 ? 7 : 14);
}

// Shared coefficient-read loop (the body of avt_spec_coeffs; also the
// front half of the fused avt_spec_txb). Returns eob (>0) or <0 on a
// malformed stream.
static long spec_coeffs_impl(
    SpecDec* sdp, int adapt,
    uint16_t* eob_cdf, int eob_nsym,
    uint16_t* eob_extra, long eob_extra_stride,
    uint16_t* base_eob, long base_eob_stride,
    uint16_t* base, long base_stride,
    uint16_t* br, long br_stride,
    uint16_t* dc_sign_row,
    const int32_t* scan, int n_coeff, int cw, int ch, int bwl,
    int txw, int txh, int tx_class,
    int64_t* quant, int32_t* out_flags) {
  SpecDec& sd = *sdp;

  int eob_pt = spec_symbol(&sd, eob_cdf, eob_nsym, adapt) + 1;
  int eob = eob_pt < 3 ? eob_pt : (1 << (eob_pt - 2)) + 1;
  if (eob_pt >= 3) {
    int eshift = eob_pt - 3;
    int extra = spec_symbol(&sd, eob_extra + (eob_pt - 3) * eob_extra_stride,
                            2, adapt);
    if (extra) eob += 1 << eshift;
    for (int i = 1; i < eob_pt - 2; ++i) {
      if (spec_bit(&sd)) eob += 1 << (eshift - i);
    }
  }
  if (eob > n_coeff) eob = n_coeff;

  const int lstride = cw + 4;
  // fixed per-thread scratch: a heap vector here costs an alloc+free
  // per transform block
  static thread_local int32_t lev_buf[(32 + 4) * (32 + 4)];
  std::memset(lev_buf, 0, size_t(ch + 4) * lstride * sizeof(int32_t));
  int32_t* const lev = lev_buf;
  for (int si = eob - 1; si >= 0; --si) {
    int pos = scan[si];
    int row = pos >> bwl, col = pos & (cw - 1);
    int64_t level;
    if (si == eob - 1) {
      int ctx_e = si == 0 ? 0 : (si <= n_coeff / 8 ? 1 : (si <= n_coeff / 4 ? 2 : 3));
      level = spec_symbol(&sd, base_eob + ctx_e * base_eob_stride, 3, adapt) + 1;
    } else {
      int ctx_b = spec_base_ctx(lev, lstride, row, col, pos, tx_class,
                                txw, txh);
      level = spec_symbol(&sd, base + ctx_b * base_stride, 4, adapt);
    }
    if (level > 2) {  // NUM_BASE_LEVELS
      int br_ctx = spec_br_ctx(lev, lstride, row, col, pos, tx_class);
      for (int i = 0; i < 4; ++i) {
        int k = spec_symbol(&sd, br + br_ctx * br_stride, 4, adapt);
        level += k;
        if (k < 3) break;
      }
    }
    lev[row * lstride + col] = level < 127 ? int32_t(level) : 127;
    quant[pos] = level;
  }

  int dc_sign_neg = 0;
  int64_t culsum = 0;
  for (int si = 0; si < eob; ++si) {
    int pos = scan[si];
    if (quant[pos] != 0) {
      int sign;
      if (si == 0) {
        sign = spec_symbol(&sd, dc_sign_row, 2, adapt);
        dc_sign_neg = sign;
      } else {
        sign = spec_bit(&sd);
      }
      if (quant[pos] > 14) {  // NUM_BASE_LEVELS + COEFF_BASE_RANGE
        int64_t g = spec_golomb(&sd);
        if (g < 0) return -2;
        quant[pos] += g;
      }
      culsum += quant[pos];
      if (sign) quant[pos] = -quant[pos];
    }
  }
  int32_t cul = culsum < 63 ? int32_t(culsum) : 63;  // COEFF_CONTEXT_MASK
  if (quant[0] != 0) cul |= dc_sign_neg ? 64 : 128;
  out_flags[0] = cul;
  out_flags[1] = dc_sign_neg;
  return eob;
}

}  // namespace

extern "C" {

// Returns eob (>0), or <0 on malformed stream (golomb overflow).
// state: int64[3] = {rng, dif, bitpos}, updated in place.
// out_flags: int32[2] = {cul | dc-sign bits, dc_sign_neg}.
long avt_spec_coeffs(
    const uint8_t* data, long nbits, int64_t* state, int adapt,
    uint16_t* eob_cdf, int eob_nsym,
    uint16_t* eob_extra, long eob_extra_stride,
    uint16_t* base_eob, long base_eob_stride,
    uint16_t* base, long base_stride,
    uint16_t* br, long br_stride,
    uint16_t* dc_sign_row,
    const int32_t* scan, int n_coeff, int cw, int ch, int bwl,
    int txw, int txh, int tx_class,
    int64_t* quant, int32_t* out_flags) {
  SpecDec sd;
  sd.data = data;
  sd.nbits = nbits;
  sd.rng = uint32_t(state[0]);
  sd.dif = uint32_t(state[1]);
  sd.bitpos = state[2];
  long eob = spec_coeffs_impl(
      &sd, adapt, eob_cdf, eob_nsym, eob_extra, eob_extra_stride,
      base_eob, base_eob_stride, base, base_stride, br, br_stride,
      dc_sign_row, scan, n_coeff, cw, ch, bwl, txw, txh, tx_class,
      quant, out_flags);
  if (eob < 0) return eob;
  state[0] = sd.rng;
  state[1] = sd.dif;
  state[2] = sd.bitpos;
  return eob;
}

}  // extern "C"

// ===================================================================
// Inverse transforms (AV1 §7.13): stage-exact integer butterflies.
// Faithful port of codec/av1/transforms.py (the Python reference stays
// the arbiter; tests/test_native_transforms.py enforces bit-identity).
// Tables are injected from Python (avt_tx_init) so both sides share one
// source of truth for cospi/sinpi.
// ===================================================================

namespace avt_tx {

static int64_t COSPI[64];
static int64_t SINPI[5];
static const int COS_BIT = 12;
static const int64_t NEW_SQRT2 = 5793;

template <typename T>
static inline T rnd(T x, int b) { return (x + (1LL << (b - 1))) >> b; }
template <typename T>
static inline T hbtf(int64_t w0, T i0, int64_t w1, T i1) {
  return rnd(w0 * i0 + w1 * i1, COS_BIT);
}

template <typename T>
static void idct4(const T* x, T* r) {
  const int64_t* c = COSPI;
  T s0 = hbtf(c[32], x[0], c[32], x[2]);
  T s1 = hbtf(c[32], x[0], -c[32], x[2]);
  T s2 = hbtf(c[48], x[1], -c[16], x[3]);
  T s3 = hbtf(c[16], x[1], c[48], x[3]);
  r[0] = s0 + s3; r[1] = s1 + s2; r[2] = s1 - s2; r[3] = s0 - s3;
}

template <typename T>
static void idct8(const T* x, T* r) {
  const int64_t* c = COSPI;
  T xe[4] = {x[0], x[2], x[4], x[6]}, e[4];
  idct4(xe, e);
  T s4 = hbtf(c[56], x[1], -c[8], x[7]);
  T s7 = hbtf(c[8], x[1], c[56], x[7]);
  T s5 = hbtf(c[24], x[5], -c[40], x[3]);
  T s6 = hbtf(c[40], x[5], c[24], x[3]);
  T t4 = s4 + s5, t5 = s4 - s5, t6 = -s6 + s7, t7 = s6 + s7;
  T u5 = hbtf(-c[32], t5, c[32], t6);
  T u6 = hbtf(c[32], t5, c[32], t6);
  T o[4] = {t4, u5, u6, t7};
  for (int i = 0; i < 4; i++) { r[i] = e[i] + o[3 - i]; r[7 - i] = e[i] - o[3 - i]; }
}

template <typename T>
static void idct16(const T* x, T* r) {
  const int64_t* c = COSPI;
  T xe[8], e[8];
  for (int i = 0; i < 8; i++) xe[i] = x[2 * i];
  idct8(xe, e);
  T s8 = hbtf(c[60], x[1], -c[4], x[15]);
  T s15 = hbtf(c[4], x[1], c[60], x[15]);
  T s9 = hbtf(c[28], x[9], -c[36], x[7]);
  T s14 = hbtf(c[36], x[9], c[28], x[7]);
  T s10 = hbtf(c[44], x[5], -c[20], x[11]);
  T s13 = hbtf(c[20], x[5], c[44], x[11]);
  T s11 = hbtf(c[12], x[13], -c[52], x[3]);
  T s12 = hbtf(c[52], x[13], c[12], x[3]);
  T t8 = s8 + s9, t9 = s8 - s9, t10 = -s10 + s11, t11 = s10 + s11;
  T t12 = s12 + s13, t13 = s12 - s13, t14 = -s14 + s15, t15 = s14 + s15;
  T u9 = hbtf(-c[16], t9, c[48], t14);
  T u14 = hbtf(c[48], t9, c[16], t14);
  T u10 = hbtf(-c[48], t10, -c[16], t13);
  T u13 = hbtf(-c[16], t10, c[48], t13);
  T v8 = t8 + t11, v9 = u9 + u10, v10 = u9 - u10, v11 = t8 - t11;
  T v12 = t15 - t12, v13 = u14 - u13, v14 = u14 + u13, v15 = t15 + t12;
  T w10 = hbtf(-c[32], v10, c[32], v13);
  T w13 = hbtf(c[32], v10, c[32], v13);
  T w11 = hbtf(-c[32], v11, c[32], v12);
  T w12 = hbtf(c[32], v11, c[32], v12);
  T o[8] = {v8, v9, w10, w11, w12, w13, v14, v15};
  for (int i = 0; i < 8; i++) { r[i] = e[i] + o[7 - i]; r[15 - i] = e[i] - o[7 - i]; }
}

template <typename T>
static void idct32(const T* x, T* r) {
  const int64_t* c = COSPI;
  T xe[16], e[16];
  for (int i = 0; i < 16; i++) xe[i] = x[2 * i];
  idct16(xe, e);
  T s[16];
  s[0] = hbtf(c[62], x[1], -c[2], x[31]);  s[15] = hbtf(c[2], x[1], c[62], x[31]);
  s[1] = hbtf(c[30], x[17], -c[34], x[15]); s[14] = hbtf(c[34], x[17], c[30], x[15]);
  s[2] = hbtf(c[46], x[9], -c[18], x[23]);  s[13] = hbtf(c[18], x[9], c[46], x[23]);
  s[3] = hbtf(c[14], x[25], -c[50], x[7]);  s[12] = hbtf(c[50], x[25], c[14], x[7]);
  s[4] = hbtf(c[54], x[5], -c[10], x[27]);  s[11] = hbtf(c[10], x[5], c[54], x[27]);
  s[5] = hbtf(c[22], x[21], -c[42], x[11]); s[10] = hbtf(c[42], x[21], c[22], x[11]);
  s[6] = hbtf(c[38], x[13], -c[26], x[19]); s[9] = hbtf(c[26], x[13], c[38], x[19]);
  s[7] = hbtf(c[6], x[29], -c[58], x[3]);   s[8] = hbtf(c[58], x[29], c[6], x[3]);
  static const int p3[8][2] = {{0,1},{3,2},{4,5},{7,6},{8,9},{11,10},{12,13},{15,14}};
  T t[16];
  for (int k = 0; k < 8; k++) {
    int a = p3[k][0], b = p3[k][1];
    t[a] = s[a] + s[b]; t[b] = s[a] - s[b];
  }
  T u[16];
  for (int i = 0; i < 16; i++) u[i] = t[i];
  u[1] = hbtf(-c[8], t[1], c[56], t[14]);   u[14] = hbtf(c[56], t[1], c[8], t[14]);
  u[2] = hbtf(-c[56], t[2], -c[8], t[13]);  u[13] = hbtf(-c[8], t[2], c[56], t[13]);
  u[5] = hbtf(-c[40], t[5], c[24], t[10]);  u[10] = hbtf(c[24], t[5], c[40], t[10]);
  u[6] = hbtf(-c[24], t[6], -c[40], t[9]);  u[9] = hbtf(-c[40], t[6], c[24], t[9]);
  static const int p5[8][2] = {{0,3},{1,2},{7,4},{6,5},{8,11},{9,10},{15,12},{14,13}};
  T v[16];
  for (int k = 0; k < 8; k++) {
    int a = p5[k][0], b = p5[k][1];
    v[a] = u[a] + u[b]; v[b] = u[a] - u[b];
  }
  T w[16];
  for (int i = 0; i < 16; i++) w[i] = v[i];
  w[2] = hbtf(-c[16], v[2], c[48], v[13]);  w[13] = hbtf(c[48], v[2], c[16], v[13]);
  w[3] = hbtf(-c[16], v[3], c[48], v[12]);  w[12] = hbtf(c[48], v[3], c[16], v[12]);
  w[4] = hbtf(-c[48], v[4], -c[16], v[11]); w[11] = hbtf(-c[16], v[4], c[48], v[11]);
  w[5] = hbtf(-c[48], v[5], -c[16], v[10]); w[10] = hbtf(-c[16], v[5], c[48], v[10]);
  static const int p7[8][2] = {{0,7},{1,6},{2,5},{3,4},{15,8},{14,9},{13,10},{12,11}};
  T p[16];
  for (int k = 0; k < 8; k++) {
    int a = p7[k][0], b = p7[k][1];
    p[a] = w[a] + w[b]; p[b] = w[a] - w[b];
  }
  T q[16];
  for (int i = 0; i < 16; i++) q[i] = p[i];
  static const int p8[4][2] = {{4,11},{5,10},{6,9},{7,8}};
  for (int k = 0; k < 4; k++) {
    int a = p8[k][0], b = p8[k][1];
    q[a] = hbtf(-c[32], p[a], c[32], p[b]);
    q[b] = hbtf(c[32], p[a], c[32], p[b]);
  }
  for (int i = 0; i < 16; i++) { r[i] = e[i] + q[15 - i]; r[31 - i] = e[i] - q[15 - i]; }
}

template <typename T>
static void idct64(const T* x, T* r) {
  const int64_t* c = COSPI;
  T xe[32], e[32];
  for (int i = 0; i < 32; i++) xe[i] = x[2 * i];
  idct32(xe, e);
  static const int order[32] = {1,33,17,49,9,41,25,57,5,37,21,53,13,45,29,61,
                                3,35,19,51,11,43,27,59,7,39,23,55,15,47,31,63};
  T s[32];
  for (int k = 0; k < 16; k++) {
    int j = order[k];
    T lo = x[j];
    T hi = x[64 - j];
    int64_t cj = c[j];
    s[k] = hbtf(c[64 - j], lo, -cj, hi);
    s[31 - k] = hbtf(cj, lo, c[64 - j], hi);
  }
  T t[32];
  for (int g = 0; g < 8; g++) {
    int a = 4 * g;
    t[a] = s[a] + s[a + 1];     t[a + 1] = s[a] - s[a + 1];
    t[a + 3] = s[a + 3] + s[a + 2]; t[a + 2] = s[a + 3] - s[a + 2];
  }
  T u[32];
  for (int i = 0; i < 32; i++) u[i] = t[i];
  static const int st4[4][2] = {{4,60},{36,28},{20,44},{52,12}};
  for (int g = 0; g < 4; g++) {
    int a1 = st4[g][0], a2 = st4[g][1];
    int i = 4 * g + 1, j = 31 - i;
    u[i] = hbtf(-c[a1], t[i], c[a2], t[j]);
    u[j] = hbtf(c[a2], t[i], c[a1], t[j]);
    i = 4 * g + 2; j = 31 - i;
    u[i] = hbtf(-c[a2], t[i], -c[a1], t[j]);
    u[j] = hbtf(-c[a1], t[i], c[a2], t[j]);
  }
  T v[32];
  for (int g = 0; g < 4; g++) {
    int a = 8 * g;
    v[a + 0] = u[a + 0] + u[a + 3]; v[a + 3] = u[a + 0] - u[a + 3];
    v[a + 1] = u[a + 1] + u[a + 2]; v[a + 2] = u[a + 1] - u[a + 2];
    v[a + 7] = u[a + 7] + u[a + 4]; v[a + 4] = u[a + 7] - u[a + 4];
    v[a + 6] = u[a + 6] + u[a + 5]; v[a + 5] = u[a + 6] - u[a + 5];
  }
  T w[32];
  for (int i = 0; i < 32; i++) w[i] = v[i];
  static const int st6[2][3] = {{0, 8, 56}, {8, 40, 24}};
  for (int bi = 0; bi < 2; bi++) {
    int base = st6[bi][0];
    int64_t a1 = c[st6[bi][1]], a2 = c[st6[bi][2]];
    for (int i = base + 2; i <= base + 3; i++) {
      int j = 31 - i;
      w[i] = hbtf(-a1, v[i], a2, v[j]);
      w[j] = hbtf(a2, v[i], a1, v[j]);
    }
    for (int i = base + 4; i <= base + 5; i++) {
      int j = 31 - i;
      w[i] = hbtf(-a2, v[i], -a1, v[j]);
      w[j] = hbtf(-a1, v[i], a2, v[j]);
    }
  }
  T p[32];
  for (int g = 0; g < 4; g++) {
    int a = 8 * g;
    if (g % 2 == 0) {
      for (int i = 0; i < 4; i++) {
        p[a + i] = w[a + i] + w[a + 7 - i];
        p[a + 7 - i] = w[a + i] - w[a + 7 - i];
      }
    } else {
      for (int i = 0; i < 4; i++) {
        p[a + 7 - i] = w[a + 7 - i] + w[a + i];
        p[a + i] = w[a + 7 - i] - w[a + i];
      }
    }
  }
  T q[32];
  for (int i = 0; i < 32; i++) q[i] = p[i];
  for (int i = 4; i <= 7; i++) {
    int j = 31 - i;
    q[i] = hbtf(-c[16], p[i], c[48], p[j]);
    q[j] = hbtf(c[48], p[i], c[16], p[j]);
  }
  for (int i = 8; i <= 11; i++) {
    int j = 31 - i;
    q[i] = hbtf(-c[48], p[i], -c[16], p[j]);
    q[j] = hbtf(-c[16], p[i], c[48], p[j]);
  }
  T rr[32];
  for (int i = 0; i < 8; i++) {
    rr[i] = q[i] + q[15 - i];        rr[15 - i] = q[i] - q[15 - i];
    rr[31 - i] = q[31 - i] + q[16 + i]; rr[16 + i] = q[31 - i] - q[16 + i];
  }
  T f[32];
  for (int i = 0; i < 32; i++) f[i] = rr[i];
  for (int i = 8; i < 16; i++) {
    int j = 31 - i;
    f[i] = hbtf(-c[32], rr[i], c[32], rr[j]);
    f[j] = hbtf(c[32], rr[i], c[32], rr[j]);
  }
  for (int i = 0; i < 32; i++) { r[i] = e[i] + f[31 - i]; r[63 - i] = e[i] - f[31 - i]; }
}

template <typename T>
static void iadst4(const T* x, T* r) {
  const int64_t* sp = SINPI;
  T s0 = sp[1] * x[0];
  T s1 = sp[2] * x[0];
  T s2 = sp[3] * x[1];
  T s3 = sp[4] * x[2];
  T s4 = sp[1] * x[2];
  T s5 = sp[2] * x[3];
  T s6 = sp[4] * x[3];
  T a7 = x[0] - x[2];
  T b7 = a7 + x[3];
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = sp[3] * b7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  T x0 = s0 + s3, x1 = s1 + s3, x2 = s2, x3 = s0 + s1 - s3;
  r[0] = rnd(x0, COS_BIT); r[1] = rnd(x1, COS_BIT);
  r[2] = rnd(x2, COS_BIT); r[3] = rnd(x3, COS_BIT);
}

template <typename T>
static void iadst8(const T* x, T* r) {
  const int64_t* c = COSPI;
  T s0 = x[7], s1 = x[0], s2 = x[5], s3 = x[2];
  T s4 = x[3], s5 = x[4], s6 = x[1], s7 = x[6];
  T t0 = hbtf(c[4], s0, c[60], s1);
  T t1 = hbtf(c[60], s0, -c[4], s1);
  T t2 = hbtf(c[20], s2, c[44], s3);
  T t3 = hbtf(c[44], s2, -c[20], s3);
  T t4 = hbtf(c[36], s4, c[28], s5);
  T t5 = hbtf(c[28], s4, -c[36], s5);
  T t6 = hbtf(c[52], s6, c[12], s7);
  T t7 = hbtf(c[12], s6, -c[52], s7);
  T u0 = t0 + t4, u4 = t0 - t4;
  T u1 = t1 + t5, u5 = t1 - t5;
  T u2 = t2 + t6, u6 = t2 - t6;
  T u3 = t3 + t7, u7 = t3 - t7;
  T v4 = hbtf(c[16], u4, c[48], u5);
  T v5 = hbtf(c[48], u4, -c[16], u5);
  T v6 = hbtf(-c[48], u6, c[16], u7);
  T v7 = hbtf(c[16], u6, c[48], u7);
  T w0 = u0 + u2, w2 = u0 - u2;
  T w1 = u1 + u3, w3 = u1 - u3;
  T w4 = v4 + v6, w6 = v4 - v6;
  T w5 = v5 + v7, w7 = v5 - v7;
  T y2 = hbtf(c[32], w2, c[32], w3);
  T y3 = hbtf(c[32], w2, -c[32], w3);
  T y6 = hbtf(c[32], w6, c[32], w7);
  T y7 = hbtf(c[32], w6, -c[32], w7);
  r[0] = w0; r[1] = -w4; r[2] = y6; r[3] = -y2;
  r[4] = y3; r[5] = -y7; r[6] = w5; r[7] = -w1;
}

template <typename T>
static void iadst16(const T* x, T* r) {
  const int64_t* c = COSPI;
  T s[16] = {x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6],
                   x[7], x[8], x[5], x[10], x[3], x[12], x[1], x[14]};
  T t[16];
  for (int i = 0; i < 8; i++) {
    int a = 2 + 8 * i;
    t[2 * i] = hbtf(c[a], s[2 * i], c[64 - a], s[2 * i + 1]);
    t[2 * i + 1] = hbtf(c[64 - a], s[2 * i], -c[a], s[2 * i + 1]);
  }
  T u[16];
  for (int i = 0; i < 8; i++) {
    u[i] = t[i] + t[i + 8];
    u[i + 8] = t[i] - t[i + 8];
  }
  T v[16];
  for (int i = 0; i < 16; i++) v[i] = u[i];
  v[8] = hbtf(c[8], u[8], c[56], u[9]);
  v[9] = hbtf(c[56], u[8], -c[8], u[9]);
  v[10] = hbtf(c[40], u[10], c[24], u[11]);
  v[11] = hbtf(c[24], u[10], -c[40], u[11]);
  v[12] = hbtf(-c[56], u[12], c[8], u[13]);
  v[13] = hbtf(c[8], u[12], c[56], u[13]);
  v[14] = hbtf(-c[24], u[14], c[40], u[15]);
  v[15] = hbtf(c[40], u[14], c[24], u[15]);
  T w[16];
  for (int i = 0; i < 4; i++) {
    w[i] = v[i] + v[i + 4];
    w[i + 4] = v[i] - v[i + 4];
    w[i + 8] = v[i + 8] + v[i + 12];
    w[i + 12] = v[i + 8] - v[i + 12];
  }
  T y[16];
  for (int i = 0; i < 16; i++) y[i] = w[i];
  for (int bi = 0; bi < 2; bi++) {
    int base = bi ? 12 : 4;
    y[base] = hbtf(c[16], w[base], c[48], w[base + 1]);
    y[base + 1] = hbtf(c[48], w[base], -c[16], w[base + 1]);
    y[base + 2] = hbtf(-c[48], w[base + 2], c[16], w[base + 3]);
    y[base + 3] = hbtf(c[16], w[base + 2], c[48], w[base + 3]);
  }
  T z[16];
  for (int i = 0; i < 2; i++)
    for (int j = 0; j < 2; j++) {
      int b = 8 * i + 4 * j;
      z[b] = y[b] + y[b + 2];
      z[b + 1] = y[b + 1] + y[b + 3];
      z[b + 2] = y[b] - y[b + 2];
      z[b + 3] = y[b + 1] - y[b + 3];
    }
  T o[16];
  for (int i = 0; i < 16; i++) o[i] = z[i];
  for (int b = 2; b < 16; b += 4) {
    o[b] = hbtf(c[32], z[b], c[32], z[b + 1]);
    o[b + 1] = hbtf(c[32], z[b], -c[32], z[b + 1]);
  }
  r[0] = o[0]; r[1] = -o[8]; r[2] = o[12]; r[3] = -o[4];
  r[4] = o[6]; r[5] = -o[14]; r[6] = o[10]; r[7] = -o[2];
  r[8] = o[3]; r[9] = -o[11]; r[10] = o[15]; r[11] = -o[7];
  r[12] = o[5]; r[13] = -o[13]; r[14] = o[9]; r[15] = -o[1];
}

template <typename T>
static void iidentity(const T* x, T* r, int n) {
  if (n == 4) { for (int i = 0; i < 4; i++) r[i] = rnd(x[i] * NEW_SQRT2, 12); return; }
  if (n == 8) { for (int i = 0; i < 8; i++) r[i] = x[i] * 2; return; }
  if (n == 16) { for (int i = 0; i < 16; i++) r[i] = rnd(x[i] * 2 * NEW_SQRT2, 12); return; }
  for (int i = 0; i < n; i++) r[i] = x[i] * 4;
}

// kind: 0 dct, 1 adst, 2 identity
template <typename T>
static void txfm1d(int kind, const T* x, T* r, int n) {
  if (kind == 0) {
    switch (n) {
      case 4: idct4(x, r); return;
      case 8: idct8(x, r); return;
      case 16: idct16(x, r); return;
      case 32: idct32(x, r); return;
      default: idct64(x, r); return;
    }
  }
  if (kind == 1) {
    switch (n) {
      case 4: iadst4(x, r); return;
      case 8: iadst8(x, r); return;
      default: iadst16(x, r); return;
    }
  }
  iidentity(x, r, n);
}

}  // namespace avt_tx

extern "C" {

void avt_tx_init(const int64_t* cospi64, const int64_t* sinpi5) {
  for (int i = 0; i < 64; i++) avt_tx::COSPI[i] = cospi64[i];
  for (int i = 0; i < 5; i++) avt_tx::SINPI[i] = sinpi5[i];
}

// dq: (ch, cw) int32 row-major (ch=min(txh,32), cw=min(txw,32));
// out: (txh, txw) int32. row_kind/col_kind: 0 dct / 1 adst / 2 identity.
// 4 int64 lanes (GCC vector extension): the 1-D kernels are templated
// over the lane type, so one instantiation computes 4 independent rows
// or columns per call with identical elementwise arithmetic (the
// Python reference in codec/av1/transforms.py stays the bit-exactness
// arbiter). Memory interfacing goes through memcpy — `mid` is only
// 8-byte aligned.
typedef int64_t txv4 __attribute__((vector_size(32)));

void avt_inverse_transform(const int32_t* dq, int txw, int txh,
                           int row_kind, int col_kind, int flip_lr,
                           int flip_ud, int row_shift, int col_shift,
                           int rect_scale, int bd, int32_t* out) {
  using namespace avt_tx;
  int cw = txw < 32 ? txw : 32;
  int ch = txh < 32 ? txh : 32;
  static thread_local int64_t full[64 * 64];
  static thread_local int64_t mid[64 * 64];
  memset(full, 0, sizeof(int64_t) * ch * txw);  // only rows < ch are read
  // typical blocks carry coefficients only in the top rows: rows whose
  // inputs are all zero transform to zero (linearity), so skip their 1-D
  // row pass entirely (dav1d's eob-height pruning)
  int nzh = 0;
  for (int i = 0; i < ch; i++) {
    int any = 0;
    for (int j = 0; j < cw; j++) {
      int64_t v = dq[i * cw + j];
      if (v) {
        any = 1;
        if (rect_scale) v = (v * 2896 + 2048) >> 12;
        full[i * txw + j] = v;
      }
    }
    if (any) nzh = i + 1;
  }
  const int64_t rng = 1LL << (bd + 7);
  // row pass, 4 rows per kernel call (lanes = rows). Rounding nzh up to
  // a multiple of 4 only adds all-zero rows, whose outputs are zero by
  // linearity — exactly what the pruned path would have written.
  int nzh4 = (nzh + 3) & ~3;
  if (nzh4 > ch) nzh4 = ch;  // ch is 4/8/16/32, always a multiple of 4
  static thread_local txv4 rin[64], rout[64];
  for (int i = 0; i < nzh4; i += 4) {
    const int64_t* r0 = full + (i + 0) * txw;
    const int64_t* r1 = full + (i + 1) * txw;
    const int64_t* r2 = full + (i + 2) * txw;
    const int64_t* r3 = full + (i + 3) * txw;
    for (int j = 0; j < txw; j++) rin[j] = (txv4){r0[j], r1[j], r2[j], r3[j]};
    txfm1d(row_kind, rin, rout, txw);
    for (int j = 0; j < txw; j++) {
      txv4 v = row_shift ? rnd(rout[j], row_shift) : rout[j];
      v = v < -rng ? (txv4){-rng, -rng, -rng, -rng} : v;
      v = v > rng - 1 ? (txv4){rng - 1, rng - 1, rng - 1, rng - 1} : v;
      for (int k = 0; k < 4; k++) mid[(i + k) * txw + j] = v[k];
    }
  }
  if (nzh4 < txh) memset(mid + nzh4 * txw, 0, sizeof(int64_t) * (txh - nzh4) * txw);
  // column pass, 4 adjacent columns per call (contiguous lane loads;
  // txw is 4/8/16/32/64, never a remainder)
  for (int j = 0; j < txw; j += 4) {
    for (int i = 0; i < txh; i++)
      __builtin_memcpy(&rin[i], mid + (long)i * txw + j, sizeof(txv4));
    txfm1d(col_kind, rin, rout, txh);
    for (int i = 0; i < txh; i++) {
      txv4 v = rnd(rout[i], col_shift);
      int oi = flip_ud ? (txh - 1 - i) : i;
      int32_t* orow = out + (long)oi * txw;
      if (flip_lr) {
        for (int k = 0; k < 4; k++) orow[txw - 1 - (j + k)] = (int32_t)v[k];
      } else {
        for (int k = 0; k < 4; k++) orow[j + k] = (int32_t)v[k];
      }
    }
  }
}

}  // extern "C"

extern "C" {

// Fused transform-block decode (decode.py _transform_block non-skip
// path): txb_skip + optional tx-type symbol + coefficient reads +
// dequant (§7.12.3, optional quantizer matrix) + inverse transform
// (§7.13) + clip-add of the prediction into the int32 frame plane.
// One ctypes crossing per transform block.
//
// params (int32[24]):
//  [0] adapt       [1] eob_nsym   [2] n_coeff    [3] cw
//  [4] ch          [5] bwl        [6] txw        [7] txh
//  [8] dcq         [9] acq       [10] dq_shift  [11] cmax
// [12] qm_stride  [13] row_shift [14] col_shift [15] rect_scale
// [16] bd         [17] fstride   [18] txtype_nsym (0 => fixed type)
// [19] fixed_tx_type             [20] qm_max_txtype (qm if type < this)
// [21] eob_extra_stride [22] base_eob_stride [23] base_stride+ (see call)
// strides[4] (int64): eob_extra, base_eob, base, br.
// itx_tab: int32[ntypes*5] = {row_kind, col_kind, flip_lr, flip_ud,
// tx_class} per tx type. out_flags: {cul, tx_type, eob}.
// Returns eob (0 = all_zero, frame <- pred), <0 on malformed stream.
// phase profiling (LIBAVIF_TPU_PROFILE=1; avt_spec_tile prints): cycles
// in coefficient symbol decode vs inverse transform, per thread
static thread_local unsigned long long avt_prof_coef_cy = 0;
static thread_local unsigned long long avt_prof_itx_cy = 0;
static inline unsigned long long avt_rdtsc() {
#if defined(__x86_64__) || defined(__i386__)
  return __builtin_ia32_rdtsc();
#else
  return 0;
#endif
}

long avt_spec_txb(
    const uint8_t* data, long nbits, int64_t* state,
    const int32_t* params, const int64_t* strides,
    uint16_t* txb_skip_cdf,
    uint16_t* txtype_cdf, const int32_t* txtype_inv,
    uint16_t* eob_cdf_2d, uint16_t* eob_cdf_1d,
    uint16_t* eob_extra, uint16_t* base_eob, uint16_t* base, uint16_t* br,
    uint16_t* dc_sign_row,
    const int32_t* scan_2d, const int32_t* scan_mrow, const int32_t* scan_mcol,
    const int32_t* itx_tab,
    const int32_t* qmat,
    const int32_t* pred,
    int32_t* frame,
    int32_t* out_flags) {
  const int adapt = params[0], eob_nsym = params[1], n_coeff = params[2];
  const int cw = params[3], ch = params[4], bwl = params[5];
  const int txw = params[6], txh = params[7];
  const int dcq = params[8], acq = params[9];
  const int dq_shift = params[10], cmax = params[11];
  const int qm_stride = params[12];
  const int row_shift = params[13], col_shift = params[14];
  const int rect_scale = params[15], bd = params[16];
  const long fstride = params[17];
  const int txtype_nsym = params[18], fixed_tx_type = params[19];
  const int qm_max_txtype = params[20];

  SpecDec sd;
  sd.data = data;
  sd.nbits = nbits;
  sd.rng = uint32_t(state[0]);
  sd.dif = uint32_t(state[1]);
  sd.bitpos = state[2];

  const int32_t maxv = (1 << bd) - 1;
  int all_zero = spec_symbol(&sd, txb_skip_cdf, 2, adapt);
  if (all_zero) {
    for (int i = 0; i < txh; ++i) {
      int32_t* fr = frame + (long)i * fstride;
      const int32_t* pr = pred + (long)i * txw;
      for (int j = 0; j < txw; ++j) fr[j] = pr[j];
    }
    state[0] = sd.rng;
    state[1] = sd.dif;
    state[2] = sd.bitpos;
    out_flags[0] = 0;
    out_flags[1] = fixed_tx_type;
    out_flags[2] = 0;
    return 0;
  }

  int tx_type = fixed_tx_type;
  if (txtype_nsym > 0) {
    int sym = spec_symbol(&sd, txtype_cdf, txtype_nsym, adapt);
    tx_type = txtype_inv[sym];
  }
  const int32_t* it = itx_tab + tx_type * 5;
  const int row_kind = it[0], col_kind = it[1];
  const int flip_lr = it[2], flip_ud = it[3], tx_class = it[4];
  const int32_t* scan =
      tx_class == SPEC_TX_2D ? scan_2d
                             : (tx_class == SPEC_TX_VERT ? scan_mrow : scan_mcol);
  uint16_t* eob_cdf = tx_class == SPEC_TX_2D ? eob_cdf_2d : eob_cdf_1d;

  static thread_local int64_t quant[32 * 32];
  for (int i = 0; i < n_coeff; ++i) quant[i] = 0;
  unsigned long long c0 = avt_rdtsc();
  long eob = spec_coeffs_impl(
      &sd, adapt, eob_cdf, eob_nsym, eob_extra, strides[0],
      base_eob, strides[1], base, strides[2], br, strides[3],
      dc_sign_row, scan, n_coeff, cw, ch, bwl, txw, txh, tx_class,
      quant, out_flags);
  avt_prof_coef_cy += avt_rdtsc() - c0;
  if (eob < 0) return eob;
  state[0] = sd.rng;
  state[1] = sd.dif;
  state[2] = sd.bitpos;
  out_flags[1] = tx_type;
  out_flags[2] = int32_t(eob);

  const int32_t* qm = (qmat && tx_type < qm_max_txtype) ? qmat : nullptr;
  static thread_local int32_t dq[32 * 32];
  for (int i = 0; i < ch * cw; ++i) dq[i] = 0;
  for (int si = 0; si < eob; ++si) {
    int pos = scan[si];
    int64_t v = quant[pos];
    if (!v) continue;
    int row = pos >> bwl, col = pos & (cw - 1);
    int64_t qv = pos == 0 ? dcq : acq;
    if (qm) qv = (qv * qm[row * qm_stride + col] + 16) >> 5;
    int64_t a = v < 0 ? -v : v;
    int64_t mag = ((a * qv) & 0xFFFFFF) >> dq_shift;
    if (mag > cmax) mag = cmax;
    dq[row * cw + col] = int32_t(v < 0 ? -mag : mag);
  }

  static thread_local int32_t res[64 * 64];
  unsigned long long i0 = avt_rdtsc();
  avt_inverse_transform(dq, txw, txh, row_kind, col_kind, flip_lr, flip_ud,
                        row_shift, col_shift, rect_scale, bd, res);
  avt_prof_itx_cy += avt_rdtsc() - i0;
  for (int i = 0; i < txh; ++i) {
    int32_t* fr = frame + (long)i * fstride;
    const int32_t* pr = pred + (long)i * txw;
    const int32_t* rr = res + (long)i * txw;
    for (int j = 0; j < txw; ++j) {
      int32_t v = pr[j] + rr[j];
      fr[j] = v < 0 ? 0 : (v > maxv ? maxv : v);
    }
  }
  return eob;
}

}  // extern "C"

// ===================================================================
// Native msac encoder handle (spec-AV1 encode path): the same Encoder
// class the own-format tile coder uses (bit-identical to the Python
// MsacEncoder — tests/test_native_entropy.py), exposed per-symbol for
// mode syntax plus a fused per-transform-block call for coefficients.
// ===================================================================

extern "C" {

void* avt_enc_new() { return new Encoder(); }

void avt_enc_free(void* h) { delete static_cast<Encoder*>(h); }

void avt_enc_symbol(void* h, uint16_t* icdf, int n, int s, int adapt) {
  static_cast<Encoder*>(h)->symbol(s, icdf, n, adapt != 0);
}

void avt_enc_bit(void* h, int b) { static_cast<Encoder*>(h)->bit(b); }

void avt_enc_literal(void* h, uint32_t value, int bits) {
  static_cast<Encoder*>(h)->literal(value, bits);
}

void avt_enc_golomb(void* h, uint32_t level) {
  static_cast<Encoder*>(h)->golomb(level);
}

// Returns the payload size; writes up to `cap` bytes into out. When the
// buffer is too small nothing is written (call again with the returned
// size). strip: see Encoder::finish.
long avt_enc_finish(void* h, uint8_t* out, long cap, int strip) {
  std::vector<uint8_t> v = static_cast<Encoder*>(h)->finish(strip != 0);
  if ((long)v.size() <= cap) std::memcpy(out, v.data(), v.size());
  return (long)v.size();
}

// Fused encode-side transform block: writes txb_skip + optional tx-type
// + the whole coefficient syntax (eob, base levels, br, signs, golomb
// tails) with the same CDF adaptation the decoder applies, then runs
// dequant + inverse transform + clip-add so the encoder's recon equals
// the decoder's bit-exactly. `levels` are signed quantized
// coefficients in position order (levels[pos], pos as in scan).
// params layout matches avt_spec_txb, with params[18] = txtype_nsym,
// params[19] = fixed (actual) tx type, params[21] = txtype symbol
// value to write when txtype_nsym > 0.
// out_flags: {cul | dc-sign bits}. Returns eob (0 = all-zero block).
long avt_spec_txb_enc(
    void* h,
    const int32_t* params, const int64_t* strides,
    uint16_t* txb_skip_cdf,
    uint16_t* txtype_cdf,
    uint16_t* eob_cdf_2d, uint16_t* eob_cdf_1d,
    uint16_t* eob_extra, uint16_t* base_eob, uint16_t* base, uint16_t* br,
    uint16_t* dc_sign_row,
    const int32_t* scan_2d, const int32_t* scan_mrow, const int32_t* scan_mcol,
    const int32_t* itx_tab,
    const int32_t* qmat,
    const int64_t* levels,
    const int32_t* pred,
    int32_t* frame,
    int32_t* out_flags) {
  Encoder& enc = *static_cast<Encoder*>(h);
  const int adapt = params[0], eob_nsym = params[1], n_coeff = params[2];
  const int cw = params[3], ch = params[4], bwl = params[5];
  const int txw = params[6], txh = params[7];
  const int dcq = params[8], acq = params[9];
  const int dq_shift = params[10], cmax = params[11];
  const int qm_stride = params[12];
  const int row_shift = params[13], col_shift = params[14];
  const int rect_scale = params[15], bd = params[16];
  const long fstride = params[17];
  const int txtype_nsym = params[18], tx_type = params[19];
  const int qm_max_txtype = params[20];
  const int txtype_sym = params[21];
  const bool ad = adapt != 0;

  const int32_t* it = itx_tab + tx_type * 5;
  const int tx_class = it[4];
  const int32_t* scan =
      tx_class == SPEC_TX_2D ? scan_2d
                             : (tx_class == SPEC_TX_VERT ? scan_mrow : scan_mcol);

  int eob = 0;
  for (int si = n_coeff - 1; si >= 0; --si) {
    if (levels[scan[si]] != 0) {
      eob = si + 1;
      break;
    }
  }
  const int32_t maxv = (1 << bd) - 1;
  enc.symbol(eob == 0 ? 1 : 0, txb_skip_cdf, 2, ad);
  if (eob == 0) {
    for (int i = 0; i < txh; ++i) {
      int32_t* fr = frame + (long)i * fstride;
      const int32_t* pr = pred + (long)i * txw;
      for (int j = 0; j < txw; ++j) fr[j] = pr[j];
    }
    out_flags[0] = 0;
    return 0;
  }
  if (txtype_nsym > 0) enc.symbol(txtype_sym, txtype_cdf, txtype_nsym, ad);

  // eob_pt + extra bits (§5.11.42 ordering, mirrored from the decoder)
  int eob_pt = eob <= 2 ? eob : bit_length(uint32_t(eob - 1)) + 1;
  uint16_t* eob_cdf = tx_class == SPEC_TX_2D ? eob_cdf_2d : eob_cdf_1d;
  enc.symbol(eob_pt - 1, eob_cdf, eob_nsym, ad);
  if (eob_pt >= 3) {
    int rem = eob - ((1 << (eob_pt - 2)) + 1);
    int eshift = eob_pt - 3;
    enc.symbol((rem >> eshift) & 1, eob_extra + (eob_pt - 3) * strides[0], 2, ad);
    for (int i = 1; i < eob_pt - 2; ++i) enc.bit((rem >> (eshift - i)) & 1);
  }

  // base levels + br, reverse scan, identical ctx model to the decoder
  const int lstride = cw + 4;
  static thread_local int32_t lev[36 * 36];
  for (int i = 0; i < (ch + 4) * lstride; ++i) lev[i] = 0;
  for (int si = eob - 1; si >= 0; --si) {
    int pos = scan[si];
    int row = pos >> bwl, col = pos & (cw - 1);
    int64_t v = levels[pos];
    int64_t lv = v < 0 ? -v : v;
    if (si == eob - 1) {
      int ctx_e = si == 0 ? 0 : (si <= n_coeff / 8 ? 1 : (si <= n_coeff / 4 ? 2 : 3));
      enc.symbol(int(lv < 3 ? lv : 3) - 1, base_eob + ctx_e * strides[1], 3, ad);
    } else {
      int ctx_b = spec_base_ctx(lev, lstride, row, col, pos, tx_class, txw, txh);
      enc.symbol(int(lv < 3 ? lv : 3), base + ctx_b * strides[2], 4, ad);
    }
    if (lv > 2) {  // NUM_BASE_LEVELS
      int br_ctx = spec_br_ctx(lev, lstride, row, col, pos, tx_class);
      int64_t rem = lv - 3;
      for (int i = 0; i < 4; ++i) {
        int k = int(rem < 3 ? rem : 3);
        enc.symbol(k, br + br_ctx * strides[3], 4, ad);
        rem -= k;
        if (k < 3) break;
      }
    }
    int64_t decoded = lv < 15 ? lv : 15;  // pre-golomb magnitude
    lev[row * lstride + col] = int32_t(decoded < 127 ? decoded : 127);
  }

  // signs (forward) + golomb tails
  int dc_sign_neg = 0;
  int64_t culsum = 0;
  for (int si = 0; si < eob; ++si) {
    int pos = scan[si];
    int64_t v = levels[pos];
    if (v == 0) continue;
    int64_t lv = v < 0 ? -v : v;
    int sign = v < 0 ? 1 : 0;
    if (si == 0) {
      enc.symbol(sign, dc_sign_row, 2, ad);
      dc_sign_neg = sign;
    } else {
      enc.bit(sign);
    }
    if (lv > 14) enc.golomb(uint32_t(lv - 15));
    culsum += lv;
  }
  int32_t cul = culsum < 63 ? int32_t(culsum) : 63;
  if (levels[0] != 0) cul |= dc_sign_neg ? 64 : 128;
  out_flags[0] = cul;

  // recon: dequant + inverse transform + clip-add (same integer path
  // as the fused decoder call, so encoder recon == decoder recon)
  const int32_t* qm = (qmat && tx_type < qm_max_txtype) ? qmat : nullptr;
  static thread_local int32_t dq[32 * 32];
  for (int i = 0; i < ch * cw; ++i) dq[i] = 0;
  for (int si = 0; si < eob; ++si) {
    int pos = scan[si];
    int64_t v = levels[pos];
    if (!v) continue;
    int row = pos >> bwl, col = pos & (cw - 1);
    int64_t qv = pos == 0 ? dcq : acq;
    if (qm) qv = (qv * qm[row * qm_stride + col] + 16) >> 5;
    int64_t a = v < 0 ? -v : v;
    int64_t mag = ((a * qv) & 0xFFFFFF) >> dq_shift;
    if (mag > cmax) mag = cmax;
    dq[row * cw + col] = int32_t(v < 0 ? -mag : mag);
  }
  const int32_t* itx = itx_tab + tx_type * 5;
  static thread_local int32_t res[64 * 64];
  avt_inverse_transform(dq, txw, txh, itx[0], itx[1], itx[2], itx[3],
                        row_shift, col_shift, rect_scale, bd, res);
  for (int i = 0; i < txh; ++i) {
    int32_t* fr = frame + (long)i * fstride;
    const int32_t* pr = pred + (long)i * txw;
    const int32_t* rr = res + (long)i * txw;
    for (int j = 0; j < txw; ++j) {
      int32_t v = pr[j] + rr[j];
      fr[j] = v < 0 ? 0 : (v > maxv ? maxv : v);
    }
  }
  return eob;
}

}  // extern "C"

#include "tile_walk.inc"
#include "cdef.inc"
