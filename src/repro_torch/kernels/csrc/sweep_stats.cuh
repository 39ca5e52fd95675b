// The per-pair arithmetic of the tuning sweep (tuning_sweep.cu): the error
// of both operand orders against the exact product, the 18 row statistics
// they feed, and the combine of two partial statistics.  Inline functions
// for the card and, compiled as plain C++, for the host rehearsal
// (tests/test_torch_sweep_host.py), so both run the same code.
#pragma once

#include "ax_families.cuh"

namespace sweep {

// a block's threads, and the columns staged per pass (tuning_sweep.cu)
constexpr int kThreads = 256;
constexpr int kTile = 512;

// float32 terms are summed over at most this many consecutive pairs
// before they join the float64 row sum (error bound in tuning_sweep.cu)
constexpr int kGroup = 8;

AXF_HD float fmul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

AXF_HD float fdiv_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

AXF_HD float fadd_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

AXF_HD float u2f_rn(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __uint2float_rn(x);
#else
  return static_cast<float>(x);
#endif
}

// Row statistics of the three error surfaces E0, E1, min(E0, E1) of one
// row over some columns: exact integer sums, the float64 sums of float32
// terms.
struct Acc {
  uint32_t lo[3], hi[3], mx[3];
  int32_t cnt[3];
  double sq[3], rel[3];
};

// float32 partial sums of the current group of at most kGroup pairs
struct Group {
  float sq[3], rel[3];
};

AXF_HD void clear(Acc& s) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.lo[k] = s.hi[k] = s.mx[k] = 0u;
    s.cnt[k] = 0;
    s.sq[k] = s.rel[k] = 0.0;
  }
}

AXF_HD void clear(Group& g) {
#pragma unroll
  for (int k = 0; k < 3; ++k) g.sq[k] = g.rel[k] = 0.0f;
}

// a group's float32 partials join the float64 row sums
AXF_HD void flush(Acc& s, Group& g) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.sq[k] += static_cast<double>(g.sq[k]);
    s.rel[k] += static_cast<double>(g.rel[k]);
  }
  clear(g);
}

// s += o: the combine of two partials of one row (the float64 additions in
// the caller's order)
AXF_HD void merge(Acc& s, const Acc& o) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.lo[k] += o.lo[k];
    s.hi[k] += o.hi[k];
    s.mx[k] = o.mx[k] > s.mx[k] ? o.mx[k] : s.mx[k];
    s.cnt[k] += o.cnt[k];
    s.sq[k] += o.sq[k];
    s.rel[k] += o.rel[k];
  }
}

// A value as the sweep uses it: the operand, |v| as float32 (exact) and its
// preps in the roles of x and y.  16-byte aligned for vector loads from
// shared memory.
template <class F>
struct alignas(16) Val {
  int32_t v;
  float f;
  typename F::X x;
  typename F::Y y;
};

template <class F>
AXF_HD Val<F> make_val(int32_t v, const axf::Params& p) {
  Val<F> r;
  r.v = v;
  const uint32_t mag = F::kSigned && v < 0 ? 0u - static_cast<uint32_t>(v)
                                           : static_cast<uint32_t>(v);
  r.f = u2f_rn(mag);
  r.x = F::prep_x(v, p);
  r.y = F::prep_y(v, p);
  return r;
}

// |approx - precise| as a uint32 lane, ordered by a signed compare for a
// signed multiplier (src/repro/core/metrics.py:23)
template <bool S>
AXF_HD uint32_t abs_err(uint32_t approx, uint32_t precise) {
  const bool big = S ? static_cast<int32_t>(approx) >= static_cast<int32_t>(precise)
                     : approx >= precise;
  return big ? approx - precise : precise - approx;
}

AXF_HD void add_int(Acc& s, int k, uint32_t e) {
  s.lo[k] += e & 0xFFFFu;
  s.hi[k] += e >> 16;
  s.mx[k] = e > s.mx[k] ? e : s.mx[k];
  s.cnt[k] += e != 0u;
}

// One pair (a, b): E0 = |m(a,b) - ab|, E1 = |m(b,a) - ab| and their minimum
// into the integer statistics, their float32 terms e*e and e / max(|ab|, 1)
// into the group.  |ab| as float32 is the rounded product of the exact
// float32 magnitudes (|ab| < 2^32, so it is the rounding of the exact
// product, as the plain version converts it).  The minimum's terms are a
// select of the first two: both terms rise with e.
template <class F>
AXF_HD void pair(Acc& s, Group& g, const Val<F>& a, const Val<F>& b, const axf::Params& p) {
  const uint32_t x = static_cast<uint32_t>(a.v) * static_cast<uint32_t>(b.v);
  const uint32_t e0 = abs_err<F::kSigned>(F::combine(a.x, b.y, p), x);
  const uint32_t e1 = abs_err<F::kSigned>(F::combine(b.x, a.y, p), x);
  const bool first = e0 < e1;
  add_int(s, 0, e0);
  add_int(s, 1, e1);
  add_int(s, 2, first ? e0 : e1);
  const float den = fmaxf(fmul_rn(a.f, b.f), 1.0f);
  const float f0 = u2f_rn(e0);
  const float f1 = u2f_rn(e1);
  const float q0 = fmul_rn(f0, f0);
  const float q1 = fmul_rn(f1, f1);
  const float r0 = fdiv_rn(f0, den);
  const float r1 = fdiv_rn(f1, den);
  g.sq[0] = fadd_rn(g.sq[0], q0);
  g.sq[1] = fadd_rn(g.sq[1], q1);
  g.sq[2] = fadd_rn(g.sq[2], first ? q0 : q1);
  g.rel[0] = fadd_rn(g.rel[0], r0);
  g.rel[1] = fadd_rn(g.rel[1], r1);
  g.rel[2] = fadd_rn(g.rel[2], first ? r0 : r1);
}

// Row a against the columns first, first + step, ... < end of `cols`, in
// groups of kGroup pairs (the last group may be shorter).
template <class F>
AXF_HD void columns(Acc& s, const Val<F>& a, const Val<F>* cols, int first, int end,
                    int step, const axf::Params& p) {
  Group g;
  clear(g);
  int c = first;
  for (; c + (kGroup - 1) * step < end; c += kGroup * step) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) pair<F>(s, g, a, cols[c + k * step], p);
    flush(s, g);
  }
  if (c < end) {
    for (; c < end; c += step) pair<F>(s, g, a, cols[c], p);
    flush(s, g);
  }
}

}  // namespace sweep
