// Component-level SWAPPER tuning sweep for Hopper (sm_90a).  Replaces the
// Pallas TPU kernel tuning_sweep_pallas of src/repro/kernels/tuning_sweep.py
// (body _sweep_kernel, row statistics _row_stats_tuple).
//
// Over the full vals x vals operand grid it computes, for every row a, six
// statistics of each of three error surfaces, E0 = |m(a,b) - ab|,
// E1 = |m(b,a) - ab| and the oracle min(E0, E1):
//
//   lo, hi  exact sums of the low and high 16-bit limbs of the error (uint32)
//   mx      the row maximum (uint32)          cnt  nonzero count (int32)
//   sq      sum of float32 e * e              rel  sum of float32 e / max(|ab|, 1)
//
// The multiplier is evaluated in device code from its kernel descriptor
// (ax_families.cuh): a family code and two parameters at launch, with a
// 65536-entry int32 table in device memory for `lut`.  No product table: at
// 12 and 16 bits the grid has 2^24 and 2^32 pairs.
//
// Design (simple first): one thread owns one row a and keeps its 18
// accumulators in registers; the b values are staged through shared memory
// in chunks of the block's width, and a loop inside the block covers all N
// columns, where Pallas revisited a b-tile grid axis with the row sums
// initialised at j == 0.  Rows past N are masked.  Each row is written once,
// so no reduction crosses blocks and every result is the same run to run.
//  - The integer sums are exact: a row of N <= 65536 limbs of at most 65535
//    sums below 2^32 in uint32, as the Pallas kernel relied on.
//  - Each float32 term is rounded as XLA rounds it (an IEEE product and an
//    IEEE division, __fmul_rn / __fdiv_rn, which nvcc never contracts into
//    an FMA), and the terms are summed in float64 and rounded to float32
//    once: the nearest float32 to the exact sum of the float32 terms, as the
//    plain version computes it.  The order of the float64 additions is the
//    only difference from it.
//
// What bounds it on an H100: operations.  The bytes are 4N in and 72N out;
// each of the N^2 pairs costs the parts of two multiplier evaluations that
// depend on both operands, the exact product, two absolute errors and the
// minimum, and 18 statistic updates (6 integer and float operations each):
// integer work on the int32 lanes, float work on the float32 lanes, no
// tensor-core form.  The work on one operand (envelope, msb, segment,
// fraction, masks) is O(N), but this design repeats it for every pair.  At
// N = 65536 one thread per row gives 512 blocks of 128 threads, four per SM;
// at 8 and 12 bits (N = 256, 4096) the card is mostly idle, which costs
// microseconds.  Later levers: hoisting the one-operand work out of the
// column loop (the a side once per thread, the b side once per value into
// shared memory), splitting the b axis across blocks at small N with a
// deterministic second pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ax_families.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 65536;

struct RowStats {
  uint32_t lo, hi, mx;
  int32_t cnt;
  double sq, rel;
};

__device__ __forceinline__ void add(RowStats& s, uint32_t e, float den) {
  s.lo += e & 0xFFFFu;
  s.hi += e >> 16;
  s.mx = e > s.mx ? e : s.mx;
  s.cnt += e != 0u;
  const float ef = __uint2float_rn(e);
  s.sq += static_cast<double>(__fmul_rn(ef, ef));
  s.rel += static_cast<double>(__fdiv_rn(ef, den));
}

// outputs: u (3 surfaces, 3 stats lo/hi/mx, n) uint32 lanes in int64;
// cnt (3, n) int32; f (3 surfaces, 2 stats sq/rel, n) float32
__global__ void __launch_bounds__(kThreads)
tuning_sweep_kernel(const int32_t* __restrict__ vals, int n, axf::Mult m,
                    const int32_t* __restrict__ table, int64_t* __restrict__ u,
                    int32_t* __restrict__ cnt, float* __restrict__ f) {
  __shared__ int32_t bs[kThreads];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < n;
  const int32_t a = live ? vals[row] : 0;
  RowStats s[3] = {};
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    bs[threadIdx.x] = j < n ? vals[j] : 0;
    __syncthreads();
    const int cols = n - j0 < kThreads ? n - j0 : kThreads;
    if (live) {
      for (int c = 0; c < cols; ++c) {
        const int32_t b = bs[c];
        const uint32_t x = axf::exact_product(a, b);
        const uint32_t e0 = axf::abs_err(axf::mul(m, a, b, table), x, m.is_signed);
        const uint32_t e1 = axf::abs_err(axf::mul(m, b, a, table), x, m.is_signed);
        const float xa = m.is_signed ? fabsf(__int2float_rn(static_cast<int32_t>(x)))
                                     : __uint2float_rn(x);
        const float den = fmaxf(xa, 1.0f);
        add(s[0], e0, den);
        add(s[1], e1, den);
        add(s[2], e0 < e1 ? e0 : e1, den);
      }
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    u[(k * 3 + 0) * n + row] = s[k].lo;
    u[(k * 3 + 1) * n + row] = s[k].hi;
    u[(k * 3 + 2) * n + row] = s[k].mx;
    cnt[k * n + row] = s[k].cnt;
    f[(k * 2 + 0) * n + row] = __double2float_rn(s[k].sq);
    f[(k * 2 + 1) * n + row] = __double2float_rn(s[k].rel);
  }
}

}  // namespace

// Returns a cudaError_t code (0 on success).  `vals` is a device array of n
// int32 operand values (any order, 1 <= n <= 65536); `table` is the device
// table of a `lut` multiplier (65536 int32 lanes) and may be null for the
// closed-form families.  Launches on `stream` and does not synchronise.
extern "C" int tuning_sweep_launch(const void* vals, const void* table, void* u,
                                   void* cnt, void* f, int n, int bits,
                                   int is_signed, int family, int p0, int p1,
                                   void* stream) {
  if (n <= 0 || n > kMaxN || bits <= 0 || bits > 16 || family < axf::kExact ||
      family > axf::kLut || (family == axf::kLut && table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const axf::Mult m{family, bits, is_signed, p0, p1};
  const dim3 grid((n + kThreads - 1) / kThreads);
  tuning_sweep_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(vals), n, m, static_cast<const int32_t*>(table),
      static_cast<int64_t*>(u), static_cast<int32_t*>(cnt), static_cast<float*>(f));
  return static_cast<int>(cudaGetLastError());
}
