// The approximate multiplier families of src/repro_torch/core/multipliers.py
// (and src/repro/core/multipliers.py:120-292) as inline functions, bit for
// bit, callable on the card and, compiled as plain C++, on the host.
//
// A multiplier reaches a kernel as its descriptor: a family code and two
// integer parameters.  The family and the signedness are fixed at compile
// time: dispatch() picks a family type such as Trunc<true> from the
// descriptor, a broken array also by its number of masked rows.  The
// parameters stay launch arguments (Params), so every multiplier of a
// family shares one instantiation and a new multiplier is a new argument
// value, not a new build.
//
// Each family type F has the same interface:
//   F::X F::prep_x(v, p)   the per-value work of v in the role of x
//   F::Y F::prep_y(v, p)   the per-value work of v in the role of y
//   uint32_t F::combine(F::X, F::Y, p)   m(x, y), the per-pair work
// so a sweep computes each value's preps once and only combine() per pair.
//
// Lanes follow XLA's uint32/int32 semantics: every product is the low 32
// bits (uint32 arithmetic wraps; no signed overflow), a logical shift by 32
// or more gives 0 (C++ leaves it undefined, so shl32/shr32 guard it), clz is
// __clz, and a negation is 0u - p in uint32 (int32 -p is undefined at
// INT_MIN).  Signed members wrap the unsigned core in the sign-magnitude
// envelope; `exact` and `lut` take the operands as they are.  Operands lie
// in the multiplier's own range (|v| < 2^bits, bits <= 16).
#pragma once

#include <stdint.h>

#include <utility>

#ifndef __CUDACC__
// plain C++ (the host rehearsal): the CUDA qualifiers mean nothing
#include <math.h>
#define __host__
#define __device__
#define __forceinline__ inline __attribute__((always_inline))
#endif

#define AXF_HD __host__ __device__ __forceinline__

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

struct Params {
  int bits;
  int p0;
  int p1;
  const int32_t* table;  // the 65536 int32 lanes of a `lut` multiplier
};

AXF_HD int clz32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __clz(x);
#else
  return x ? __builtin_clz(x) : 32;
#endif
}

AXF_HD int32_t load_lane(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

AXF_HD uint32_t shl32(uint32_t x, int s) {
  return s >= 32 ? 0u : (s <= 0 ? x : x << s);
}

AXF_HD uint32_t shr32(uint32_t x, int s) {
  return s >= 32 ? 0u : (s <= 0 ? x : x >> s);
}

AXF_HD uint32_t low_mask(int k) {
  return k >= 32 ? 0xFFFFFFFFu : (1u << k) - 1u;
}

// index of the leading one of max(x, 1)
AXF_HD int msb(uint32_t x) { return 31 - clz32(x > 1u ? x : 1u); }

AXF_HD uint32_t drum_segment(uint32_t x, int k, int* sh) {
  const int s = msb(x) - (k - 1);
  *sh = s > 0 ? s : 0;
  const uint32_t seg = shr32(x, *sh);
  return *sh > 0 ? (seg | 1u) : seg;
}

// shifts by s >= 0 where s >= 32 gives 0: one funnel shift on the card
AXF_HD uint32_t shl_clamp(uint32_t x, int s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_lc(0u, x, static_cast<uint32_t>(s));
#else
  return s >= 32 ? 0u : x << s;
#endif
}

AXF_HD uint32_t shr_clamp(uint32_t x, int s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_rc(x, 0u, static_cast<uint32_t>(s));
#else
  return s >= 32 ? 0u : x >> s;
#endif
}

// the sign-magnitude envelope, per value: |v| and the sign as a factor
// (1 or -1 mod 2^32) or a mask (0 or ~0)
template <bool S>
AXF_HD uint32_t magnitude(int32_t v) {
  return S && v < 0 ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
}

template <bool S>
AXF_HD uint32_t sign_factor(int32_t v) {
  return S && v < 0 ? 0xFFFFFFFFu : 1u;
}

template <bool S>
AXF_HD uint32_t sign_mask(int32_t v) {
  return S && v < 0 ? 0xFFFFFFFFu : 0u;
}

// The families with their per-value work split off.  Every product below
// is mod 2^32, so a sign factor folded into both operands' preps gives the
// signed product: (sx |x|)(sy |y|) = sx sy |x||y|.

// Its errors are all zero, so the sweep's signedness (the order of its
// error compare, |v|) changes nothing: one type serves both.
struct Exact {
  static constexpr int kFamily = kExact;
  static constexpr bool kSigned = false;
  static constexpr int kRows = -1;
  static constexpr int kMinBlocks = 4;
  struct X {
    uint32_t v;
  };
  using Y = X;
  static AXF_HD X prep_x(int32_t v, const Params&) { return X{static_cast<uint32_t>(v)}; }
  static AXF_HD Y prep_y(int32_t v, const Params&) { return Y{static_cast<uint32_t>(v)}; }
  static AXF_HD uint32_t combine(X x, Y y, const Params&) { return x.v * y.v; }
};

// table[(a8 << 8) | b8]: the index halves are per value, the load per pair.
// S is only the operands' signedness, which orders the sweep's error compare:
// a table may hold any int32, so the two types are two kernels.
template <bool S>
struct Lut {
  static constexpr int kFamily = kLut;
  static constexpr bool kSigned = S;
  static constexpr int kRows = -1;
  static constexpr int kMinBlocks = 4;
  struct X {
    uint32_t hi;
  };
  struct Y {
    uint32_t lo;
  };
  static AXF_HD X prep_x(int32_t v, const Params&) {
    return X{(static_cast<uint32_t>(v) & 0xFFu) << 8};
  }
  static AXF_HD Y prep_y(int32_t v, const Params&) {
    return Y{static_cast<uint32_t>(v) & 0xFFu};
  }
  static AXF_HD uint32_t combine(X x, Y y, const Params& m) {
    return static_cast<uint32_t>(load_lane(m.table + (x.hi | y.lo)));
  }
};

// (|x| & ~(2^ka - 1)) (|y| & ~(2^kb - 1)), signs folded into the masked values
template <bool S>
struct Trunc {
  static constexpr int kFamily = kTrunc;
  static constexpr bool kSigned = S;
  static constexpr int kRows = -1;
  static constexpr int kMinBlocks = 4;
  struct X {
    uint32_t m;
  };
  using Y = X;
  static AXF_HD X prep_x(int32_t v, const Params& p) {
    return X{sign_factor<S>(v) * (magnitude<S>(v) & ~low_mask(p.p0))};
  }
  static AXF_HD Y prep_y(int32_t v, const Params& p) {
    return Y{sign_factor<S>(v) * (magnitude<S>(v) & ~low_mask(p.p1))};
  }
  static AXF_HD uint32_t combine(X x, Y y, const Params&) { return x.m * y.m; }
};

// x (|y| & ~rowmask): x as it is (its sign is its own), y masked and signed
template <bool S>
struct Perforate {
  static constexpr int kFamily = kPerforate;
  static constexpr bool kSigned = S;
  static constexpr int kRows = -1;
  static constexpr int kMinBlocks = 4;
  struct X {
    uint32_t m;
  };
  using Y = X;
  static AXF_HD X prep_x(int32_t v, const Params&) { return X{static_cast<uint32_t>(v)}; }
  static AXF_HD Y prep_y(int32_t v, const Params& p) {
    return Y{sign_factor<S>(v) * (magnitude<S>(v) & ~static_cast<uint32_t>(p.p0))};
  }
  static AXF_HD uint32_t combine(X x, Y y, const Params&) { return x.m * y.m; }
};

// The broken array in closed form.  Row i >= v keeps (x << i) whole, so the
// rows from max(h, v) up sum to x * (y & ~(2^max(h, v) - 1)); the R = ROWS
// = max(0, min(v, bits) - h) masked rows h <= i < v remain, each
// y_i ((x & ~(2^(v - i) - 1)) << i).  With yl = |y| >> h and
// xm[r] = (|x| & ~(2^(v - h - r) - 1)) << h, row h + r is (yl & 2^r) xm[r]:
// one multiply and R masked rows per pair.  For a signed multiplier sx is
// folded into x's words and sy into y's high part; the rows' sum is
// multiplied by sy.
template <bool S, int ROWS>
struct BrokenArray {
  static constexpr int kFamily = kBrokenArray;
  static constexpr bool kSigned = S;
  static constexpr int kRows = ROWS;
  static constexpr int kMinBlocks = ROWS > 3 ? 3 : 4;
  struct X {
    uint32_t m;
    uint32_t xm[ROWS > 0 ? ROWS : 1];
  };
  struct Y {
    uint32_t hi;
    uint32_t yl;
    uint32_t sign;
  };
  static AXF_HD X prep_x(int32_t v, const Params& p) {
    const uint32_t sx = sign_factor<S>(v), mag = magnitude<S>(v);
    X x;
    x.m = sx * mag;
    x.xm[0] = 0u;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) x.xm[r] = sx * shl32(mag & ~low_mask(p.p0 - p.p1 - r), p.p1);
    return x;
  }
  static AXF_HD Y prep_y(int32_t v, const Params& p) {
    const uint32_t mag = magnitude<S>(v);
    const int top = p.p0 > p.p1 ? p.p0 : p.p1;
    return Y{sign_factor<S>(v) * (mag & ~low_mask(top)), shr32(mag, p.p1), sign_factor<S>(v)};
  }
  static AXF_HD uint32_t combine(X x, Y y, const Params&) {
    uint32_t rows = 0u;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) rows += (y.yl & (1u << r)) * x.xm[r];
    return x.m * y.hi + (S ? rows * y.sign : rows);
  }
};

// Mitchell: per value the leading-one index less F/2 and the masked F-bit
// fraction, so the product's exponent is x.k + y.k + carry = kk - F; a zero
// operand gets k = -64 and fraction 0, which shifts the product out (no
// zero test per pair).  The mantissa fsum + (1 - carry) 2^F is fsum | 2^F
// (fsum < 2^(F+1), and bit F is set when carry is).  The sign is applied to
// the product.
template <bool S>
struct Mitchell {
  static constexpr int kFamily = kMitchell;
  static constexpr bool kSigned = S;
  static constexpr int kRows = -1;
  static constexpr int kMinBlocks = 4;
  static constexpr int F = 16;
  struct X {
    int32_t k;
    uint32_t frac;
    uint32_t sign;
  };
  using Y = X;
  static AXF_HD X log_frac(int32_t v, int t) {
    const uint32_t mag = magnitude<S>(v);
    const int k = msb(mag);
    uint32_t frac = shr32(shl32(mag - shl32(1u, k), F), k);
    if (t > 0) frac &= ~low_mask(t);
    return mag == 0u ? X{-64, 0u, 0u} : X{k - F / 2, frac, sign_mask<S>(v)};
  }
  static AXF_HD X prep_x(int32_t v, const Params& p) { return log_frac(v, p.p0); }
  static AXF_HD Y prep_y(int32_t v, const Params& p) { return log_frac(v, p.p1); }
  static AXF_HD uint32_t combine(X x, Y y, const Params&) {
    const uint32_t fsum = x.frac + y.frac;
    const int e = x.k + y.k + static_cast<int>(fsum >> F);   // kk - F
    const uint32_t mant = fsum | (1u << F);
    const uint32_t p = shr_clamp(shl_clamp(mant, e > 0 ? e : 0), e < 0 ? -e : 0);
    if constexpr (!S) return p;
    const uint32_t neg = x.sign ^ y.sign;
    return (p ^ neg) - neg;
  }
};

// DRUM: per value the segment (sign folded in) and its shift; a zero
// operand has segment 0, so its product is 0 without a test
template <bool S>
struct Drum {
  static constexpr int kFamily = kDrum;
  static constexpr bool kSigned = S;
  static constexpr int kRows = -1;
  static constexpr int kMinBlocks = 4;
  struct X {
    uint32_t seg;
    int32_t sh;
  };
  using Y = X;
  static AXF_HD X segment(int32_t v, int k) {
    int sh;
    const uint32_t seg = drum_segment(magnitude<S>(v), k, &sh);
    return X{sign_factor<S>(v) * seg, sh};
  }
  static AXF_HD X prep_x(int32_t v, const Params& p) { return segment(v, p.p0); }
  static AXF_HD Y prep_y(int32_t v, const Params& p) { return segment(v, p.p1); }
  static AXF_HD uint32_t combine(X x, Y y, const Params&) {
    return shl_clamp(x.seg * y.seg, x.sh + y.sh);
  }
};

// BrokenArray has a type for every number of masked rows a width of at
// most 16 bits gives
constexpr int kMaxRows = 16;

// the masked rows of a broken array (v, h) at `bits`
AXF_HD int broken_rows(int bits, int v, int h) {
  const int top = v < bits ? v : bits;
  return top - h > 0 ? top - h : 0;
}

template <bool S, class Fn, int... R>
bool dispatch_rows(int rows, Fn& fn, std::integer_sequence<int, R...>) {
  return ((rows == R ? (fn(BrokenArray<S, R>{}), true) : false) || ...);
}

// the compile-time family of a descriptor: calls fn(F{}) with the family
// type and returns true, or returns false for an unknown family or a
// broken array of more than kMaxRows masked rows
template <bool S, class Fn>
bool dispatch_signed(int family, const Params& p, Fn& fn) {
  switch (family) {
    case kExact: fn(Exact{}); return true;
    case kTrunc: fn(Trunc<S>{}); return true;
    case kPerforate: fn(Perforate<S>{}); return true;
    case kMitchell: fn(Mitchell<S>{}); return true;
    case kDrum: fn(Drum<S>{}); return true;
    case kLut: fn(Lut<S>{}); return true;
    case kBrokenArray:
      return dispatch_rows<S>(broken_rows(p.bits, p.p0, p.p1), fn,
                              std::make_integer_sequence<int, kMaxRows + 1>{});
    default:
      return false;
  }
}

template <class Fn>
bool dispatch(int family, int is_signed, const Params& p, Fn&& fn) {
  return is_signed ? dispatch_signed<true>(family, p, fn) : dispatch_signed<false>(family, p, fn);
}

}  // namespace axf
