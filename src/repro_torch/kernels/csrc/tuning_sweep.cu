// Component-level SWAPPER tuning sweep for Hopper (sm_90a).  Replaces the
// Pallas TPU kernel tuning_sweep_pallas of src/repro/kernels/tuning_sweep.py:90
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
// The multiplier is evaluated from its kernel descriptor (ax_families.cuh):
// the family and signedness pick a compiled instantiation, the two
// parameters and, for `lut`, a 65536-entry int32 table in device memory
// are launch arguments.  One build covers every multiplier.  The per-pair
// arithmetic lives in sweep_stats.cuh, which the host rehearsal compiles too;
// this file holds the staging, the split and the combine.
//
// What bounds it on an H100: operations.  The bytes are 4N in and 72N out;
// each of the N^2 pairs (2^32 at 16 bits) costs two multiplier combines, the
// exact product, two absolute errors, the minimum and 18 statistic updates:
// int32 work at 64 lanes per SM per clock, float32 work at 128, and the
// conversions and the reciprocal of each division on the 16-per-clock
// conversion pipe.  The levers:
//  - Family and signedness at compile time (and, for the broken array, its
//    number of masked rows, 0 to 16): no run-time switch in the pair loop.
//  - Each family's per-value work leaves the pair loop (ax_families.cuh):
//    masks with the sign folded in (trunc, perforate), DRUM's signed segment
//    and shift, Mitchell's leading one and fraction, and the broken array's
//    closed form, x * y_high plus one masked row per kept row below v (3
//    for mul16s_bam_v4_h1, where the loop form evaluated 15 rows).  What
//    remains per pair is one multiply for trunc and perforate, three
//    operations for DRUM, about ten for Mitchell.
//  - A block of 256 threads owns R rows (R = 32, 16, ..., 1, chosen by the
//    wrapper so that the grid has at least two blocks per SM) and splits
//    the columns 256/R ways: thread t takes row t % R and every (256/R)-th
//    column of each staged tile from t / R on.  At N = 65536 that is 2048
//    blocks of 8 warps; at N = 4096, 512; at N = 256, one row per block.
//    A warp of 32 rows reads one column at a time from shared memory, a
//    broadcast.  Registers are capped at 64 (four blocks, 32 warps per SM),
//    at 85 (three blocks) for broken arrays of more than 3 masked rows: the
//    18 statistics take 30 of them, and ptxas spills a few bytes rather
//    than give up a block.
//  - The columns are staged per tile in shared memory with their per-value
//    work done once (Val: the operand, |v| as float32, its preps as x and
//    as y); a row's own Val sits in registers.
//  - The float path: |ab| as float32 is the product of the two staged
//    magnitudes (no conversion), the third surface's terms are selects of
//    the first two (no conversion, no division), and a float64 addition
//    happens once per group of kGroup = 8 pairs, not once per term.
//
// The combine is in a fixed order, so every run gives the same bits: within
// a warp the lanes of one row add pairwise by __shfl_down_sync at offsets
// 16, 8, ..., R; then thread r < R adds the 8 warps' partials of row r in
// warp order.  The integer sums are exact in any order: a row of N <= 65536
// limbs of at most 65535 sums below 2^32 in uint32, whatever the split.
//
// Float error bound.  Each float32 term is rounded as the plain version
// rounds it (__fmul_rn, __fdiv_rn, round-to-nearest conversions, no FMA
// contraction).  The terms are non-negative.  A group sums at most 8 of
// them in float32: relative error at most 7 * 2^-24; the float64 sum of the
// groups adds under 2^-40, and the final rounding to float32 2^-24.  The
// plain version sums the same terms in float64 and rounds once (2^-24).
// The two results differ by at most about 9 * 2^-24 = 5.4e-7 relative,
// inside the 1e-6 of the contract (PERF.md section 2); more than 8 terms
// per group would not be.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_stats.cuh"

namespace {

using sweep::kThreads;
using sweep::kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 65536;

template <class F>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int tile = kTile * static_cast<int>(sizeof(sweep::Val<F>));
  constexpr int part = kWarps * 32 * static_cast<int>(sizeof(sweep::Acc));
  return tile > part ? tile : part;
}

__device__ __forceinline__ void shfl_merge(sweep::Acc& s, int off) {
  sweep::Acc o;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.lo[k] = __shfl_down_sync(0xFFFFFFFFu, s.lo[k], off);
    o.hi[k] = __shfl_down_sync(0xFFFFFFFFu, s.hi[k], off);
    o.mx[k] = __shfl_down_sync(0xFFFFFFFFu, s.mx[k], off);
    o.cnt[k] = __shfl_down_sync(0xFFFFFFFFu, s.cnt[k], off);
    o.sq[k] = __shfl_down_sync(0xFFFFFFFFu, s.sq[k], off);
    o.rel[k] = __shfl_down_sync(0xFFFFFFFFu, s.rel[k], off);
  }
  sweep::merge(s, o);
}

// outputs: u (3 surfaces, 3 stats lo/hi/mx, n) uint32 lanes in int64;
// cnt (3, n) int32; f (3 surfaces, 2 stats sq/rel, n) float32
template <class F>
__global__ void __launch_bounds__(kThreads, F::kMinBlocks)
tuning_sweep_kernel(const int32_t* __restrict__ vals, int n, int rshift, axf::Params p,
                    int64_t* __restrict__ u, int32_t* __restrict__ cnt,
                    float* __restrict__ f) {
  static_assert(smem_bytes<F>() <= 48 * 1024, "static shared memory is capped at 48 KiB");
  __shared__ __align__(16) unsigned char smem[smem_bytes<F>()];
  sweep::Val<F>* tile = reinterpret_cast<sweep::Val<F>*>(smem);
  const int t = threadIdx.x;
  const int rows = 1 << rshift;
  const int r = t & (rows - 1);
  const int split = t >> rshift;
  const int splits = kThreads >> rshift;
  const int row = blockIdx.x * rows + r;
  const bool live = row < n;
  const sweep::Val<F> a = sweep::make_val<F>(live ? vals[row] : 0, p);
  sweep::Acc s;
  sweep::clear(s);
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int cols = n - j0 < kTile ? n - j0 : kTile;
    for (int c = t; c < cols; c += kThreads) tile[c] = sweep::make_val<F>(vals[j0 + c], p);
    __syncthreads();
    if (live) sweep::columns<F>(s, a, tile, split, cols, splits, p);
    __syncthreads();
  }
  // the fixed-order combine: lanes of one row within the warp, then warps
  for (int off = 16; off >= rows; off >>= 1) shfl_merge(s, off);
  sweep::Acc* part = reinterpret_cast<sweep::Acc*>(smem);
  const int lane = t & 31;
  if (lane < rows) part[(t >> 5) * 32 + lane] = s;
  __syncthreads();
  if (t >= rows || !live) return;
  sweep::Acc tot = part[t];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) sweep::merge(tot, part[w * 32 + t]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    u[(k * 3 + 0) * n + row] = tot.lo[k];
    u[(k * 3 + 1) * n + row] = tot.hi[k];
    u[(k * 3 + 2) * n + row] = tot.mx[k];
    cnt[k * n + row] = tot.cnt[k];
    f[(k * 2 + 0) * n + row] = __double2float_rn(tot.sq[k]);
    f[(k * 2 + 1) * n + row] = __double2float_rn(tot.rel[k]);
  }
}

}  // namespace

// Returns a cudaError_t code (0 on success).  `vals` is a device array of n
// int32 operand values of the multiplier's range, which the closed forms
// assume (any order, 1 <= n <= 65536); `table` is the device table of a `lut` multiplier
// (65536 int32 lanes) and may be null for the closed-form families; a block
// owns 2^rshift rows (0 <= rshift <= 5).  Launches on `stream` and does not
// synchronise.
extern "C" int tuning_sweep_launch(const void* vals, const void* table, void* u,
                                   void* cnt, void* f, int n, int bits,
                                   int is_signed, int family, int p0, int p1, int rshift,
                                   void* stream) {
  if (n <= 0 || n > kMaxN || bits <= 0 || bits > 16 || rshift < 0 || rshift > 5 ||
      (family == axf::kLut && table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const axf::Params p{bits, p0, p1, static_cast<const int32_t*>(table)};
  const dim3 grid((n + (1 << rshift) - 1) >> rshift);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  axf::dispatch(family, is_signed, p, [&](auto fam) {
    using F = decltype(fam);
    tuning_sweep_kernel<F><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(vals), n, rshift, p, static_cast<int64_t*>(u),
        static_cast<int32_t*>(cnt), static_cast<float*>(f));
    rc = static_cast<int>(cudaGetLastError());
  });
  return rc;
}
