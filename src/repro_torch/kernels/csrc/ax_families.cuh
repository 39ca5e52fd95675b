// The approximate multiplier families of src/repro_torch/core/multipliers.py
// (and src/repro/core/multipliers.py:120-292) as device functions, bit for
// bit.  A multiplier is its kernel descriptor: a family code and two integer
// parameters, passed at launch, so a new multiplier is a new argument value
// and not a new build.
//
// Lanes follow XLA's uint32/int32 semantics: every product is the low 32
// bits (uint32 arithmetic wraps; no signed overflow), a logical shift by 32
// or more gives 0 (C++ leaves it undefined, so shl32/shr32 guard it), clz is
// __clz, and a negation is 0u - p in uint32 (int32 -p is undefined at
// INT_MIN).  Signed members wrap the unsigned core in the sign-magnitude
// envelope; `exact` and `lut` take the operands as they are.
#pragma once

#include <stdint.h>

namespace axf {

enum Family : int {
  kExact = 0,        // ()
  kTrunc = 1,        // (ka, kb): zero the low ka bits of A, kb of B
  kPerforate = 2,    // (rowmask, -): p = A * (B & ~rowmask)
  kBrokenArray = 3,  // (v, h): sum_{i >= h} b_i ((A << i) & ~(2^v - 1))
  kMitchell = 4,     // (ta, tb): log multiplier, F = 16 fraction bits
  kDrum = 5,         // (ka, kb): segmenting multiplier
  kLut = 6,          // table[(a8 << 8) | b8], 65536 int32 lanes
};

struct Mult {
  int family;
  int bits;
  int is_signed;
  int p0;
  int p1;
};

__device__ __forceinline__ uint32_t shl32(uint32_t x, int s) {
  return s >= 32 ? 0u : (s <= 0 ? x : x << s);
}

__device__ __forceinline__ uint32_t shr32(uint32_t x, int s) {
  return s >= 32 ? 0u : (s <= 0 ? x : x >> s);
}

__device__ __forceinline__ uint32_t low_mask(int k) {
  return k >= 32 ? 0xFFFFFFFFu : (1u << k) - 1u;
}

// index of the leading one of max(x, 1)
__device__ __forceinline__ int msb(uint32_t x) { return 31 - __clz(x > 1u ? x : 1u); }

__device__ __forceinline__ uint32_t mitchell(uint32_t au, uint32_t bu, int ta, int tb) {
  constexpr int F = 16;
  const int ka = msb(au);
  const int kb = msb(bu);
  uint32_t fa = shr32(shl32(au - shl32(1u, ka), F), ka);
  uint32_t fb = shr32(shl32(bu - shl32(1u, kb), F), kb);
  if (ta > 0) fa &= ~low_mask(ta);
  if (tb > 0) fb &= ~low_mask(tb);
  const uint32_t fsum = fa + fb;
  const uint32_t carry = fsum >> F;                     // 1 if fa + fb >= 1
  const int kk = ka + kb + static_cast<int>(carry);
  const uint32_t mant = fsum + shl32(1u - carry, F);
  const uint32_t lsh = static_cast<uint32_t>(kk - F > 0 ? kk - F : 0);
  const uint32_t rsh = static_cast<uint32_t>(F - kk > 0 ? F - kk : 0);
  const uint32_t p = shr32(shl32(mant, lsh), rsh);
  return (au == 0u || bu == 0u) ? 0u : p;
}

__device__ __forceinline__ uint32_t drum_segment(uint32_t x, int k, int* sh) {
  const int s = msb(x) - (k - 1);
  *sh = s > 0 ? s : 0;
  const uint32_t seg = shr32(x, *sh);
  return *sh > 0 ? (seg | 1u) : seg;
}

__device__ __forceinline__ uint32_t drum(uint32_t au, uint32_t bu, int ka, int kb) {
  int sha, shb;
  const uint32_t sa = drum_segment(au, ka, &sha);
  const uint32_t sb = drum_segment(bu, kb, &shb);
  const uint32_t p = shl32(sa * sb, sha + shb);
  return (au == 0u || bu == 0u) ? 0u : p;
}

// the unsigned core of the closed-form families
__device__ __forceinline__ uint32_t core(const Mult& m, uint32_t au, uint32_t bu) {
  switch (m.family) {
    case kTrunc:
      return (au & ~low_mask(m.p0)) * (bu & ~low_mask(m.p1));
    case kPerforate:
      return au * (bu & ~static_cast<uint32_t>(m.p0));
    case kBrokenArray: {
      const uint32_t cmask = ~low_mask(m.p0);
      uint32_t acc = 0u;
      for (int i = m.p1; i < m.bits; ++i) acc += ((bu >> i) & 1u) * (shl32(au, i) & cmask);
      return acc;
    }
    case kMitchell:
      return mitchell(au, bu, m.p0, m.p1);
    case kDrum:
      return drum(au, bu, m.p0, m.p1);
    default:
      return au * bu;
  }
}

// m(a, b) as a uint32 lane (the int32 bits for a signed multiplier)
__device__ __forceinline__ uint32_t mul(const Mult& m, int32_t a, int32_t b,
                                        const int32_t* __restrict__ table) {
  if (m.family == kExact) return static_cast<uint32_t>(a) * static_cast<uint32_t>(b);
  if (m.family == kLut)
    return static_cast<uint32_t>(__ldg(table + (((a & 0xFF) << 8) | (b & 0xFF))));
  if (!m.is_signed) return core(m, static_cast<uint32_t>(a), static_cast<uint32_t>(b));
  const bool na = a < 0;
  const bool nb = b < 0;
  const uint32_t ma = na ? 0u - static_cast<uint32_t>(a) : static_cast<uint32_t>(a);
  const uint32_t mb = nb ? 0u - static_cast<uint32_t>(b) : static_cast<uint32_t>(b);
  const uint32_t p = core(m, ma, mb);
  return na != nb ? 0u - p : p;
}

// the precise product's lane: the low 32 bits of a * b
__device__ __forceinline__ uint32_t exact_product(int32_t a, int32_t b) {
  return static_cast<uint32_t>(a) * static_cast<uint32_t>(b);
}

// |approx - precise| as a uint32 lane, ordered by a signed compare for a
// signed multiplier (src/repro/core/metrics.py:23)
__device__ __forceinline__ uint32_t abs_err(uint32_t approx, uint32_t precise, int is_signed) {
  const bool big = is_signed ? static_cast<int32_t>(approx) >= static_cast<int32_t>(precise)
                             : approx >= precise;
  return big ? approx - precise : precise - approx;
}

}  // namespace axf
