// xbit_oracle — scalar CPU reference for the quantized-weight ops, with software
// IEEE-754 half-precision rounding.
//
// Role: the numeric oracle the kernels are verified against, exactly the role
// the reference's CPU simulator plays for its CUDA kernels (cpp_simulate.cc:29-59
// hand-rolls half<->float conversion so GPU fp16 rounding is reproduced on the
// host; :88-250 re-implements the kernels as scalar loops).  This is a fresh
// implementation — plain per-element loops over the *format definition*, not a
// port of any kernel's thread structure.
//
// Exposed as a C ABI consumed via ctypes (xbitops/utils/cpp_oracle.py).
//
// Numerics contract (matches the reference's fused __hfma2 path,
// unpack_weight_2_to_7.cu:64,75):
//   sz      = fp16(scale * (zero + add_zero_bias))     (one fp16 rounding)
//   w       = fp16(float(wq) * float(scale) - float(sz))  (fma: round once)
//   gemv    : products in fp32, accumulated in fp32, output rounded to fp16
//             (the reference's strict f32-accumulation variant, gemv_w4a16_c32.cu)

#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// Software IEEE-754 binary16 <-> binary32 (round-to-nearest-even).
// ---------------------------------------------------------------------------

float half_bits_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;  // +/- 0
    } else {
      // subnormal: normalize
      int shift = 0;
      while (!(man & 0x400)) {
        man <<= 1;
        ++shift;
      }
      man &= 0x3FF;
      // subnormal value = man/2^10 * 2^-14; after normalizing by `shift` the
      // unbiased exponent is -14 - shift, i.e. biased 127 - 14 - shift.
      bits = sign | ((uint32_t)(127 - 14 - shift) << 23) | (man << 13);
    }
  } else if (exp == 0x1F) {
    bits = sign | 0x7F800000u | (man << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t float_to_half_bits(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
  uint32_t man = x & 0x7FFFFFu;
  if (((x >> 23) & 0xFF) == 0xFF) {  // inf / nan
    return (uint16_t)(sign | 0x7C00u | (man ? 0x200u : 0));
  }
  if (exp >= 0x1F) return (uint16_t)(sign | 0x7C00u);  // overflow -> inf
  if (exp <= 0) {
    // subnormal or underflow: shift mantissa (with implicit bit) right
    if (exp < -10) return (uint16_t)sign;  // rounds to zero
    man |= 0x800000u;
    int shift = 14 - exp;  // 13 (normal) + (1 - exp)
    uint32_t half_man = man >> shift;
    uint32_t rem = man & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half_man & 1))) ++half_man;
    return (uint16_t)(sign | half_man);
  }
  uint32_t half_man = man >> 13;
  uint32_t rem = man & 0x1FFFu;
  uint16_t out = (uint16_t)(sign | ((uint32_t)exp << 10) | half_man);
  if (rem > 0x1000u || (rem == 0x1000u && (out & 1))) ++out;  // RNE (may carry into exp)
  return out;
}

float round_f16(float f) { return half_bits_to_float(float_to_half_bits(f)); }

// ---------------------------------------------------------------------------
// GPTQ bit extraction (format spec, SURVEY §2 "Quantization format"):
// qweight int32[ceil(K*bits/32), N] packs along K; qzeros packs along N.
// ---------------------------------------------------------------------------

inline uint32_t extract_bits(const uint32_t* words, int64_t stride, int64_t lane,
                             int64_t idx, int bits) {
  int64_t bitpos = idx * (int64_t)bits;
  int64_t wi = bitpos >> 5;
  int off = (int)(bitpos & 31);
  uint32_t mask = (bits == 32) ? 0xFFFFFFFFu : ((1u << bits) - 1u);
  uint32_t v = (words[wi * stride + lane] >> off) & mask;
  if (off + bits > 32) {
    v |= (words[(wi + 1) * stride + lane] << (32 - off)) & mask;
  }
  return v;
}

}  // namespace

extern "C" {

// Dequantize GPTQ-format weights to fp16 (bit pattern output).
// qweight: int32[ceil(K*bits/32) * N] row-major; scales_f16: uint16[G * N];
// qzeros: int32[G * ceil(N*bits/32)]; out_f16: uint16[K * N].
// g_idx: optional int32[K] per-row group map (act-order); pass nullptr otherwise.
void xbit_dequant_f16(const uint32_t* qweight, const uint16_t* scales_f16,
                      const uint32_t* qzeros, const int32_t* g_idx, int64_t K,
                      int64_t N, int bits, int group_size, int add_zero_bias,
                      uint16_t* out_f16) {
  int64_t zstride = (N * bits + 31) / 32;
  for (int64_t k = 0; k < K; ++k) {
    int64_t g = g_idx ? (int64_t)g_idx[k] : k / group_size;
    for (int64_t n = 0; n < N; ++n) {
      uint32_t wq = extract_bits(qweight, N, n, k, bits);
      uint32_t zq = extract_bits(qzeros + g * zstride, 1, 0, n, bits);
      float s = half_bits_to_float(scales_f16[g * N + n]);
      float sz = round_f16(s * (float)(zq + (uint32_t)add_zero_bias));
      float w = (float)wq * s - sz;  // exact in f32 for fp16 operands -> fma
      out_f16[k * N + n] = float_to_half_bits(w);
    }
  }
}

// Fused dequant + GEMM: a_f16[M, K] @ W[K, N] -> out_f16[M, N].
// Products and accumulation in fp32 (reference's strict variant,
// gemv_w4a16_c32.cu:124-143), single fp16 rounding at the end.
void xbit_gemv_f16(const uint16_t* a_f16, const uint32_t* qweight,
                   const uint16_t* scales_f16, const uint32_t* qzeros,
                   const int32_t* g_idx, int64_t M, int64_t K, int64_t N, int bits,
                   int group_size, int add_zero_bias, uint16_t* out_f16) {
  int64_t zstride = (N * bits + 31) / 32;
  for (int64_t m = 0; m < M; ++m) {
    for (int64_t n = 0; n < N; ++n) {
      float acc = 0.0f;
      for (int64_t k = 0; k < K; ++k) {
        int64_t g = g_idx ? (int64_t)g_idx[k] : k / group_size;
        uint32_t wq = extract_bits(qweight, N, n, k, bits);
        uint32_t zq = extract_bits(qzeros + g * zstride, 1, 0, n, bits);
        float s = half_bits_to_float(scales_f16[g * N + n]);
        float sz = round_f16(s * (float)(zq + (uint32_t)add_zero_bias));
        float w = (float)wq * s - sz;
        acc += half_bits_to_float(a_f16[m * K + k]) * w;
      }
      out_f16[m * N + n] = float_to_half_bits(acc);
    }
  }
}

// Fused dequant + GEMM with fp16 ACCUMULATION chains — the reference's
// SHIPPED kernel semantics (gemv_w4a16_pt.cu:115-124): the weight
// dequantizes through a half-precision fma (__hfma2(wq, s, -sz) -> fp16
// rounding), products accumulate through half-precision fma chains of 8
// (__hfma2(a, w, acc)), and chain results accumulate in fp32
// (gemv_w4a16_pt.cu:123-124).  This is the comparator for the reference's
// fp16-accum tolerance gate (rel 1.001 AND abs 4e-4, gemv_w4a16.cu:406-407).
void xbit_gemv_f16acc(const uint16_t* a_f16, const uint32_t* qweight,
                      const uint16_t* scales_f16, const uint32_t* qzeros,
                      const int32_t* g_idx, int64_t M, int64_t K, int64_t N,
                      int bits, int group_size, int add_zero_bias,
                      uint16_t* out_f16) {
  int64_t zstride = (N * bits + 31) / 32;
  for (int64_t m = 0; m < M; ++m) {
    for (int64_t n = 0; n < N; ++n) {
      float acc32 = 0.0f;
      for (int64_t k0 = 0; k0 < K; k0 += 8) {
        uint16_t acc16 = 0;  // fp16 accumulator for one 8-product chain
        int64_t kend = k0 + 8 < K ? k0 + 8 : K;
        for (int64_t k = k0; k < kend; ++k) {
          int64_t g = g_idx ? (int64_t)g_idx[k] : k / group_size;
          uint32_t wq = extract_bits(qweight, N, n, k, bits);
          uint32_t zq = extract_bits(qzeros + g * zstride, 1, 0, n, bits);
          float s = half_bits_to_float(scales_f16[g * N + n]);
          float sz = round_f16(s * (float)(zq + (uint32_t)add_zero_bias));
          // __hfma2(wq, s, -sz): fused in-register, one fp16 rounding
          float w = round_f16((float)wq * s - sz);
          // __hfma2(a, w, acc): fused product+add, one fp16 rounding
          float fma = half_bits_to_float(a_f16[m * K + k]) * w +
                      half_bits_to_float(acc16);
          acc16 = float_to_half_bits(fma);
        }
        acc32 += half_bits_to_float(acc16);
      }
      out_f16[m * N + n] = float_to_half_bits(acc32);
    }
  }
}

// Pack integer values (< 2^bits) into GPTQ words along the leading axis.
// vals: uint8[K * N] -> qweight: int32[ceil(K*bits/32) * N].  (Tooling parity
// check for formats.gptq_pack.)
void xbit_pack(const uint8_t* vals, int64_t K, int64_t N, int bits,
               uint32_t* out_words) {
  int64_t words = (K * bits + 31) / 32;
  std::memset(out_words, 0, (size_t)(words * N) * 4);
  for (int64_t k = 0; k < K; ++k) {
    int64_t bitpos = k * (int64_t)bits;
    int64_t wi = bitpos >> 5;
    int off = (int)(bitpos & 31);
    for (int64_t n = 0; n < N; ++n) {
      uint64_t v = vals[k * N + n];
      out_words[wi * N + n] |= (uint32_t)((v << off) & 0xFFFFFFFFu);
      if (off + bits > 32) {
        out_words[(wi + 1) * N + n] |= (uint32_t)(v >> (32 - off));
      }
    }
  }
}

// Round-trip helpers so Python tests can pin the fp16 emulation itself.
float xbit_half_to_float(uint16_t h) { return half_bits_to_float(h); }
uint16_t xbit_float_to_half(float f) { return float_to_half_bits(f); }

}  // extern "C"
