// Approximate 8-bit matmul with the SWAPPER swap fused ahead of every
// product, for Hopper (sm_90a).  Replaces two Pallas TPU kernels of
// src/repro/kernels/ax_matmul.py: ax_matmul_pallas (:168, one static swap)
// and ax_matmul_grid_pallas (:253, a swap triple per output tile, read at
// run time).
//
//   C[m, n] = sum_k m(swap_t(A[m, k], B[k, n]))      (int32, wraps mod 2^32)
//
// t is the (op_is_a, bit, value) triple of the logical (bm, bn) tile that
// holds (m, n): passed at launch (ax_matmul_launch), or read by each block
// from a (gm, gn, 3) int32 device grid (ax_matmul_grid_launch).  The grid
// stays on the device: a new policy is a new tensor value, nothing is
// rebuilt and the host never reads it.  The swap mask is
// ((src >> bit) & 1) == value on the sign-extended operand, bit clamped to
// 31 as an unsigned amount; a value other than 0 or 1 never matches
// (NoSwap).
//
// Two routes, one API.  The wrapper picks the route on the host from the
// multiplier and the operand type alone (never from a tensor value, never
// after a failed build or launch):
//
// Route T (tensor cores) takes the separable multipliers, m(a, b) =
// f(a) * g(b) with f, g fitting the operand type (trunc*, perf*).  The
// multiplier reaches the kernel as a 256-entry table, byte 0 f(v), byte 1
// g(v).  Every swapped product is then an exact int8 GEMM over a 2K-deep
// stacked inner dimension (src/repro/quant/ax.py:1-25):
//   decision on A:  [s*g(A) | (1-s)*f(A)] @ [f(B); g(B)]
//   decision on B:  [g(A) | f(A)] @ [s*f(B); (1-s)*g(B)]
//   NoSwap:         [0 | f(A)] @ [f(B); g(B)]
// Each K step of 64 bytes stages the raw A and B tiles with cp.async
// (16-byte chunks, a ring of 3 stages); a transform pass looks each byte up
// in the table (replicated once per lane, so a warp's 32 lookups hit 32
// banks), applies the masks and writes both limbs K-major into shared
// memory (a 4 x 4 byte transpose by byte_perm, since ldmatrix.trans does
// not transpose 8-bit data), swizzled by 16-byte chunk so that the
// transform's stores and ldmatrix's loads are free of bank conflicts; then
// mma.sync.m16n8k32 (s8 or u8, int32 accumulation without .satfinite, so
// sums wrap as the plain version's do).  On an H100 this route is bounded
// by the int8 weight bytes (K * N over 3.35 TB/s) at decode and, at large
// M, by the tensor-core rate over the 2K-deep product (2 * M * 2K * N over
// 1,979 TOP/s); the design streams every weight byte once per call through
// a card-filling grid and keeps the product on the tensor cores, and what
// holds it above the bound is the instruction throughput of the transform
// (about a dozen instructions per B byte: lookup, transpose, swizzled
// store), not the memory or the tensor cores.
//
// Route C (CUDA cores) takes every other multiplier (Mitchell, DRUM, broken
// array, exact, LUT circuits): its 256 x 256 product table of 16-bit
// entries sits in shared memory (128 KiB, one block per SM) and every
// product is a gather; the triple of each element's logical tile is decoded
// once into registers.  It is bounded by the weight bytes at decode and by
// the M * K * N gathers at prefill.  The design fills the card (the split
// of K below; at M < 8 the idle row slots of a block split each K step
// too) and stages with cp.async; what holds it above the bound is the
// gather throughput of the one 8-warp block an SM can hold beside the table.
//
// For both routes the CUDA block tile is decoupled from the logical
// (bm, bn) tile: a block covers 128 columns and up to 128 rows (route T:
// all M <= 128 rows, so B is read from device memory once per call whatever
// bm the tile mode sets), and K is split across blocks so that the grid has
// at least about 2 x 132 blocks (4 x 132 for route T at M <= 32) at every
// main-path shape: at decode every SM streams B.  Partial sums of a split K
// are added with integer atomicAdd into an output the wrapper zeroed;
// addition mod 2^32 is associative and commutative, so the bits do not
// depend on the order in which blocks finish.  With one split route T
// stores its sums directly.
//
// Per-tile triples in route T: an A-side triple is a per-row mask, so rows
// of several logical row tiles share one pass; a B-side triple needs the B
// limbs of its own mask, one pass per distinct B-side triple in the block.
// A block whose columns cross logical column tiles with different triples
// runs its passes once per column tile, with the B limbs outside the tile
// zeroed.  Passes add into the same accumulators (every element gets its
// products from exactly one pass), so any grid is exact.
//
// Optional tile_hist output (gm, gn, 2, hist_width) int32: per output tile
// the set-magnitude-bit counts and the negative count of its A rows and of
// its B columns over all of K.  Counted once per row tile and once per
// column tile by two small kernels (into a zeroed workspace), then
// broadcast to the (gm, gn) layout by a third.
//
// K must be a multiple of bk (callers pad K, so a circuit with m(0, 0) != 0
// sums the same pad products as the TPU); past K nothing is summed.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;                 // K bytes per pipeline stage
constexpr int kBN = 128;                // columns per block
constexpr int kLimbRow = 2 * kBK;       // one limb row: [limb 1 | limb 2]
constexpr int kStages = 3;
constexpr int kTableBytes = 65536 * 2;
constexpr int kMaxBlock = 128;          // largest logical bm, bn, bk
constexpr int kMaxHist = 17;            // bits <= 16, plus the sign
constexpr int kOperandBits = 8;
constexpr int kCounts = kOperandBits + 1;
constexpr int kRepBytes = 256 * 32 * 2;  // a byte table replicated per lane

struct Params {
  int M, N, K, bm, bn, gn;     // gn: columns of the logical tile grid
  int operand_signed, table_signed;
  int op_is_a, bit, value;     // the static triple (cfg == nullptr)
  int nm_order, splits, slots, atomic, vec;
};

__device__ __forceinline__ int ext(uint32_t byte, int operand_signed) {
  return operand_signed ? static_cast<int>(static_cast<int8_t>(byte))
                        : static_cast<int>(byte);
}

// The swap decision of one logical tile, packed: 0 never swaps (NoSwap);
// otherwise kind << 8 | bit << 1 | value, kind 1 deciding on A, 2 on B.
__device__ __forceinline__ int swap_code(int op, int bit, int value) {
  if (value != 0 && value != 1) return 0;
  const int b = static_cast<unsigned>(bit) > 31u ? 31 : bit;
  return ((op != 0 ? 1 : 2) << 8) | (b << 1) | value;
}

__device__ __forceinline__ int tile_code(const int32_t* cfg, const Params& p,
                                         int ti, int tj) {
  if (cfg == nullptr) return swap_code(p.op_is_a, p.bit, p.value);
  const int32_t* t = cfg + (static_cast<size_t>(ti) * p.gn + tj) * 3;
  return swap_code(__ldg(t), __ldg(t + 1), __ldg(t + 2));
}

__device__ __forceinline__ int code_kind(int c) { return c >> 8; }

// Does the sign-extended operand v satisfy the decision of code c?
__device__ __forceinline__ bool code_hit(int c, int v) {
  return c != 0 && ((v >> ((c >> 1) & 31)) & 1) == (c & 1);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raw B tile: 64 rows of 128 bytes; 16-byte chunk c of row k is stored at
// chunk c ^ swz_raw(k), so the transform's column reads hit 32 banks.
__device__ __forceinline__ int swz_raw(int k) { return (k >> 1) & 6; }

__device__ __forceinline__ uint32_t raw_b_word(const uint8_t* bs, int k, int nw) {
  return *reinterpret_cast<const uint32_t*>(
      bs + k * kBN + ((((nw >> 2) ^ swz_raw(k)) << 4) | ((nw & 3) << 2)));
}

// Stage one K step: A rows [m0, m0 + arows) x 64 bytes (row stride 64) and
// B 64 x 128 bytes; zeros past M, N and K.  16-byte cp.async when the
// operands allow it (vec: K and N multiples of 16, aligned pointers), else
// byte loads.
__device__ __forceinline__ void stage_tiles(uint8_t* as, uint8_t* bs, const uint8_t* a,
                            const uint8_t* b, const Params& p, int m0,
                            int arows, int n0, int k0, int tid) {
  if (p.vec) {
    for (int i = tid; i < arows * 4; i += kThreads) {
      const int r = i >> 2, c = i & 3;
      const int gm = m0 + r, gk = k0 + c * 16;
      const bool ok = gm < p.M && gk < p.K;
      cp_async16(as + r * kBK + c * 16,
                 ok ? a + static_cast<size_t>(gm) * p.K + gk : a, ok);
    }
    for (int i = tid; i < kBK * 8; i += kThreads) {
      const int r = i >> 3, c = i & 7;
      const int gk = k0 + r, gn = n0 + c * 16;
      const bool ok = gk < p.K && gn < p.N;
      cp_async16(bs + r * kBN + ((c ^ swz_raw(r)) << 4),
                 ok ? b + static_cast<size_t>(gk) * p.N + gn : b, ok);
    }
  } else {
    for (int i = tid; i < arows * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      as[i] = gm < p.M && gk < p.K ? a[static_cast<size_t>(gm) * p.K + gk] : 0;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gk = k0 + r, gn = n0 + c;
      bs[r * kBN + ((((c >> 4) ^ swz_raw(r)) << 4) | (c & 15))] =
          gk < p.K && gn < p.N ? b[static_cast<size_t>(gk) * p.N + gn] : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Route T
// ---------------------------------------------------------------------------

// Limb rows (A: m, B: n) of 128 bytes, 16-byte chunk c (limb c / 4, K words
// 4 * (c % 4) ..) stored at chunk c ^ swz_limb(r): conflict-free both for
// the transform's stores and for ldmatrix's 8-row reads.
__device__ __forceinline__ int swz_limb(int r) { return (r ^ (r >> 2)) & 7; }

__device__ __forceinline__ int limb_off(int r, int chunk) {
  return r * kLimbRow + ((chunk ^ swz_limb(r)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

template <bool U8>
__device__ __forceinline__ void mma_k32(uint32_t (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  if (U8) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

template <int MT>
struct TShape {
  static constexpr int BM = 16 * MT;               // rows per block
  static constexpr int WM = MT >= 4 ? 2 : 1;       // warps along M
  static constexpr int WN = kWarps / WM;           // warps along N
  static constexpr int WMT = MT / WM;              // m16 tiles per warp
  static constexpr int WNT = kBN / 8 / WN;         // n8 tiles per warp
  static constexpr bool kRepA = MT >= 4;           // A lookups bank-replicated
  static constexpr int kRawA = BM * kBK;
  static constexpr int kStage = kRawA + kBK * kBN;
  static constexpr int kLimbA = kStages * kStage;  // offsets into smem
  static constexpr int kLimbB = kLimbA + BM * kLimbRow;
  static constexpr int kRepB = kLimbB + kBN * kLimbRow;
  static constexpr int kFg = kRepB + kRepBytes;
  static constexpr int kRowCode = kFg + (kRepA ? kRepBytes : 256 * 4);
  static constexpr int kFirst = kRowCode + BM * 4;
  static constexpr int kBytes = kFirst + BM * 4;
};

// A byte lookup in a table replicated once per lane: entry v of lane l at
// 16-bit slot 32 * v + l, so the 32 lanes of a warp read 32 banks (a
// single 256-entry table would put 8 entries in each bank).
__device__ __forceinline__ uint32_t rep_lookup(const uint16_t* rep, uint32_t v, int lane) {
  return rep[(v << 5) | lane];
}

// One pass of route T over the block's K range: the B limbs from `rep_b`
// (columns outside [lo, hi) zeroed), the A limbs of each row from its code
// (pass_b: rows whose code is bcode get [g | f], the others nothing; else
// A-side rows get [s*g | (1-s)*f], NoSwap rows [0 | f], B-side rows
// nothing), summed into acc.
template <int MT, bool U8>
__device__ __forceinline__ void t_pass(uint32_t (&acc)[TShape<MT>::WMT][TShape<MT>::WNT][4],
                       unsigned char* smem, const uint8_t* a, const uint8_t* b,
                       const Params& p, int m0, int rows, int n0, int kt0,
                       int kt1, bool pass_b, int bcode, int lo, int hi) {
  using S = TShape<MT>;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / S::WN, wn = warp % S::WN;
  uint8_t* limb_a = smem + S::kLimbA;
  uint8_t* limb_b = smem + S::kLimbB;
  const uint16_t* rep_b = reinterpret_cast<const uint16_t*>(smem + S::kRepB);
  const int* row_code = reinterpret_cast<const int*>(smem + S::kRowCode);
  const int n = kt1 - kt0;
  // the A limbs' f | g << 8 lookup (replicated from 64 rows per block up)
  auto fga = [&](uint32_t v) -> uint32_t {
    if (S::kRepA) return rep_lookup(reinterpret_cast<const uint16_t*>(smem + S::kFg), v, lane);
    return reinterpret_cast<const uint32_t*>(smem + S::kFg)[v];
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n)
      stage_tiles(smem + s * S::kStage, smem + s * S::kStage + S::kRawA, a, b, p,
                  m0, S::BM, n0, (kt0 + s) * kBK, tid);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; the limbs of step i - 1 are consumed
    {
      const int s = (i + kStages - 1) % kStages;
      if (i + kStages - 1 < n)
        stage_tiles(smem + s * S::kStage, smem + s * S::kStage + S::kRawA, a, b, p,
                    m0, S::BM, n0, (kt0 + i + kStages - 1) * kBK, tid);
      cp_async_commit();
    }
    const uint8_t* as = smem + (i % kStages) * S::kStage;
    const uint8_t* bs = as + S::kRawA;
    const int k0 = (kt0 + i) * kBK;

    // B limbs: thread unit = 4 K rows x 4 columns, transposed to K-major
    // one column at a time (few live registers beside the accumulators)
    for (int u = tid; u < kBK * kBN / 16; u += kThreads) {
      const int w = u >> 5, l = u & 31;
      const int kq = ((w & 3) << 2) | (l >> 3);
      const int nw = ((w >> 2) << 3) | (l & 7);
      uint32_t raw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) raw[r] = raw_b_word(bs, 4 * kq + r, nw);
      const int w4 = (kq & 3) << 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * nw + j;
        const uint32_t t01 = __byte_perm(rep_lookup(rep_b, (raw[0] >> (8 * j)) & 0xFF, l),
                                         rep_lookup(rep_b, (raw[1] >> (8 * j)) & 0xFF, l),
                                         0x5140);
        const uint32_t t23 = __byte_perm(rep_lookup(rep_b, (raw[2] >> (8 * j)) & 0xFF, l),
                                         rep_lookup(rep_b, (raw[3] >> (8 * j)) & 0xFF, l),
                                         0x5140);
        const bool keep = col >= lo && col < hi;
        *reinterpret_cast<uint32_t*>(limb_b + limb_off(col, kq >> 2) + w4) =
            keep ? __byte_perm(t01, t23, 0x5410) : 0u;
        *reinterpret_cast<uint32_t*>(limb_b + limb_off(col, 4 + (kq >> 2)) + w4) =
            keep ? __byte_perm(t01, t23, 0x7632) : 0u;
      }
    }
    // A limbs (rows past M are left as they are: their outputs are dropped),
    // four bytes at a time: the decision bit of each byte, widened to a
    // byte mask, splits [g | f] between the limbs
    for (int u = tid; u < rows * (kBK / 4); u += kThreads) {
      const int r = u >> 4, kq = u & 15;
      const uint32_t raw = *reinterpret_cast<const uint32_t*>(as + r * kBK + 4 * kq);
      const int rc = row_code[r];
      const int mode = pass_b ? (rc == bcode ? 2 : 0) : (code_kind(rc) == 2 ? 0 : 1);
      const int valid = p.K - (k0 + 4 * kq);     // bytes of this word inside K
      uint32_t x1 = 0u, x2 = 0u;
      if (mode != 0 && valid > 0) {
        const uint32_t t01 = __byte_perm(fga(raw & 0xFF), fga((raw >> 8) & 0xFF), 0x5140);
        const uint32_t t23 = __byte_perm(fga((raw >> 16) & 0xFF), fga(raw >> 24), 0x5140);
        const uint32_t f4 = __byte_perm(t01, t23, 0x5410);
        const uint32_t g4 = __byte_perm(t01, t23, 0x7632);
        uint32_t hit = 0xFFFFFFFFu;              // mode 2: [g | f] whole
        if (mode == 1) {                         // A-side or NoSwap rows
          int bit = (rc >> 1) & 31;
          if (p.operand_signed && bit > 7) bit = 7;   // the sign-extended bits
          uint32_t bits = bit > 7 ? 0u : (raw >> bit) & 0x01010101u;
          if ((rc & 1) == 0) bits ^= 0x01010101u;
          if (rc == 0) bits = 0u;
          hit = (bits << 8) - bits;              // 0xFF where the byte swaps
        }
        const uint32_t in_k = valid >= 4 ? 0xFFFFFFFFu : (1u << (8 * valid)) - 1u;
        x1 = g4 & hit & in_k;
        x2 = f4 & ~hit & in_k;
        if (mode == 2) x2 = f4 & in_k;
      }
      const int w4 = (kq & 3) << 2;
      *reinterpret_cast<uint32_t*>(limb_a + limb_off(r, kq >> 2) + w4) = x1;
      *reinterpret_cast<uint32_t*>(limb_a + limb_off(r, 4 + (kq >> 2)) + w4) = x2;
    }
    __syncthreads();

    // the stacked product: 4 k32 steps over [limb 1 | limb 2]
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t bf[S::WNT][2];
#pragma unroll
      for (int t = 0; t < S::WNT; t += 2) {
        const int col = (wn * S::WNT + t + ((lane >> 4) & 1)) * 8 + (lane & 7);
        uint32_t r4[4];
        ldmatrix_x4(r4, limb_b + limb_off(col, 2 * s + ((lane >> 3) & 1)));
        bf[t][0] = r4[0];
        bf[t][1] = r4[1];
        bf[t + 1][0] = r4[2];
        bf[t + 1][1] = r4[3];
      }
#pragma unroll
      for (int tm = 0; tm < S::WMT; ++tm) {
        uint32_t af[4];
        const int row = (wm * S::WMT + tm) * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldmatrix_x4(af, limb_a + limb_off(row, 2 * s + (lane >> 4)));
#pragma unroll
        for (int tn = 0; tn < S::WNT; ++tn) mma_k32<U8>(acc[tm][tn], af, bf[tn][0], bf[tn][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and the limbs are free for the next pass
}

__device__ __forceinline__ void put(int32_t* out, const Params& p, int r, int c,
                                    uint32_t v) {
  if (r < p.M && c < p.N) {
    int32_t* o = out + static_cast<size_t>(r) * p.N + c;
    if (p.atomic) atomicAdd(o, static_cast<int32_t>(v));
    else *o = static_cast<int32_t>(v);
  }
}

template <int MT, bool U8>
__global__ void __launch_bounds__(kThreads, MT <= 2 ? 3 : 2)
route_t_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
               const uint32_t* __restrict__ fg_table, int32_t* __restrict__ out,
               const int32_t* __restrict__ cfg, Params p) {
  using S = TShape<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* rep_b = reinterpret_cast<uint16_t*>(smem + S::kRepB);
  int* row_code = reinterpret_cast<int*>(smem + S::kRowCode);
  int* first = reinterpret_cast<int*>(smem + S::kFirst);
  const int tid = threadIdx.x;

  const int tiles_m = (p.M + S::BM - 1) / S::BM;
  const int tiles_n = (p.N + kBN - 1) / kBN;
  const int tm = p.nm_order ? blockIdx.x % tiles_m : blockIdx.x / tiles_n;
  const int tn = p.nm_order ? blockIdx.x / tiles_m : blockIdx.x % tiles_n;
  const int m0 = tm * S::BM, n0 = tn * kBN;
  const int rows = min(S::BM, p.M - m0), cols = min(kBN, p.N - n0);
  const int kt_all = (p.K + kBK - 1) / kBK;
  const int kps = (kt_all + p.splits - 1) / p.splits;
  const int kt0 = blockIdx.y * kps, kt1 = min(kt_all, kt0 + kps);

  if (S::kRepA) {
    uint16_t* rep_a = reinterpret_cast<uint16_t*>(smem + S::kFg);
    for (int i = tid; i < 256 * 32; i += kThreads) rep_a[i] = __ldg(fg_table + (i >> 5));
  } else {
    uint32_t* fg = reinterpret_cast<uint32_t*>(smem + S::kFg);
    for (int i = tid; i < 256; i += kThreads) fg[i] = __ldg(fg_table + i);
  }

  // logical tiles met by the block; is each row's triple the same across
  // the block's column tiles?
  const int ti0 = m0 / p.bm, ti1 = (m0 + rows - 1) / p.bm;
  const int tj0 = n0 / p.bn, tj1 = (n0 + cols - 1) / p.bn;
  const int nti = ti1 - ti0 + 1, ntj = tj1 - tj0 + 1;
  bool same = true;
  if (cfg != nullptr)
    for (int i = tid; i < nti * ntj; i += kThreads) {
      const int ti = ti0 + i / ntj, tj = tj0 + i % ntj;
      same = same && tile_code(cfg, p, ti, tj) == tile_code(cfg, p, ti, tj0);
    }
  const bool uniform = __syncthreads_and(same);

  uint32_t acc[S::WMT][S::WNT][4];
#pragma unroll
  for (int i = 0; i < S::WMT; ++i)
#pragma unroll
    for (int j = 0; j < S::WNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0u;

  const int nseg = uniform ? 1 : ntj;
  for (int seg = 0; seg < nseg; ++seg) {
    const int tj = tj0 + seg;
    const int lo = uniform ? 0 : max(0, tj * p.bn - n0);
    const int hi = uniform ? kBN : min(kBN, (tj + 1) * p.bn - n0);
    bool any_a = false;
    for (int r = tid; r < rows; r += kThreads) {
      const int c = tile_code(cfg, p, (m0 + r) / p.bm, tj);
      row_code[r] = c;
      any_a = any_a || code_kind(c) != 2;
    }
    // first[t]: row tile ti0 + t opens a B-side pass (its code is B-side and
    // no earlier row tile of the block has the same one)
    for (int t = tid; t < nti; t += kThreads) {
      const int c = tile_code(cfg, p, ti0 + t, tj);
      bool f = code_kind(c) == 2;
      for (int u = 0; u < t && f; ++u) f = tile_code(cfg, p, ti0 + u, tj) != c;
      first[t] = f ? c : -1;
    }
    if (__syncthreads_or(any_a)) {
      for (int i = tid; i < 256 * 32; i += kThreads) rep_b[i] = __ldg(fg_table + (i >> 5));
      __syncthreads();
      t_pass<MT, U8>(acc, smem, a, b, p, m0, rows, n0, kt0, kt1, false, 0, lo, hi);
    }
    for (int t = 0; t < nti; ++t) {
      const int bcode = first[t];
      if (bcode < 0) continue;
      for (int i = tid; i < 256 * 32; i += kThreads) {
        const uint32_t v = i >> 5, e = __ldg(fg_table + v);
        rep_b[i] = code_hit(bcode, ext(v, p.operand_signed)) ? e & 0xFFu : e & 0xFF00u;
      }
      __syncthreads();
      t_pass<MT, U8>(acc, smem, a, b, p, m0, rows, n0, kt0, kt1, true, bcode, lo, hi);
    }
    __syncthreads();  // row_code and first are rewritten by the next segment
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / S::WN, wn = warp % S::WN;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < S::WMT; ++i)
#pragma unroll
    for (int j = 0; j < S::WNT; ++j) {
      const int r = m0 + (wm * S::WMT + i) * 16 + g;
      const int c = n0 + (wn * S::WNT + j) * 8 + 2 * t4;
      put(out, p, r, c, acc[i][j][0]);
      put(out, p, r, c + 1, acc[i][j][1]);
      put(out, p, r + 8, c, acc[i][j][2]);
      put(out, p, r + 8, c + 1, acc[i][j][3]);
    }
}

// ---------------------------------------------------------------------------
// Route C
// ---------------------------------------------------------------------------

// Thread layout: 32 column quads (4 columns each) x 8 slots; `slots` of
// them (p.slots) hold rows, the other 8 / slots split each K step, so a
// decode M of 4 still keeps every thread busy.  Each thread owns RC rows
// (slot + slots * j) of its 4 columns.
template <int RC>
struct CShape {
  static constexpr int kRawA = 8 * RC * kBK;   // rows of the largest slot count
  static constexpr int kStage = kRawA + kBK * kBN;
  static constexpr int kBytes = kTableBytes + kStages * kStage;
};

template <int RC>
__global__ void __launch_bounds__(kThreads, 1)
route_c_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
               const int16_t* __restrict__ table, int32_t* __restrict__ out,
               const int32_t* __restrict__ cfg, Params p) {
  using S = CShape<RC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int16_t* tbl = reinterpret_cast<const int16_t*>(smem);
  uint8_t* ring = smem + kTableBytes;
  const int tid = threadIdx.x;
  const int RS = p.slots, KS = kWarps / p.slots;
  const int BM = RS * RC;

  const int tiles_m = (p.M + BM - 1) / BM;
  const int tiles_n = (p.N + kBN - 1) / kBN;
  const int tm = p.nm_order ? blockIdx.x % tiles_m : blockIdx.x / tiles_n;
  const int tn = p.nm_order ? blockIdx.x / tiles_m : blockIdx.x % tiles_n;
  const int m0 = tm * BM, n0 = tn * kBN;
  const int kt_all = (p.K + kBK - 1) / kBK;
  const int kps = (kt_all + p.splits - 1) / p.splits;
  const int kt0 = blockIdx.y * kps, kt1 = min(kt_all, kt0 + kps);
  const int n = kt1 - kt0;

  {
    const uint4* src = reinterpret_cast<const uint4*>(table);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < kTableBytes / 16; i += kThreads) dst[i] = __ldg(src + i);
  }
  const int q = tid & 31, slot = tid >> 5;
  const int rs = slot % RS, ks = slot / RS;
  // the decision of each owned element, decoded once: swap when bit `sh`
  // of (on_a ? a : b) equals `vv` (2: never)
  int sh[RC][4], vv[RC][4];
  bool on_a[RC][4];
#pragma unroll
  for (int j = 0; j < RC; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = m0 + rs + RS * j, col = n0 + 4 * q + c;
      const int code = r < p.M && col < p.N ? tile_code(cfg, p, r / p.bm, col / p.bn) : 0;
      on_a[j][c] = code_kind(code) == 1;
      sh[j][c] = (code >> 1) & 31;
      vv[j][c] = code == 0 ? 2 : (code & 1);
    }
  const uint32_t tmask = p.table_signed ? 0xFFFFFFFFu : 0xFFFFu;
  uint32_t acc[RC][4];
#pragma unroll
  for (int j = 0; j < RC; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0u;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n)
      stage_tiles(ring + s * S::kStage, ring + s * S::kStage + S::kRawA, a, b, p, m0,
                  BM, n0, (kt0 + s) * kBK, tid);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed (and the table, at i == 0)
    {
      const int s = (i + kStages - 1) % kStages;
      if (i + kStages - 1 < n)
        stage_tiles(ring + s * S::kStage, ring + s * S::kStage + S::kRawA, a, b, p,
                    m0, BM, n0, (kt0 + i + kStages - 1) * kBK, tid);
      cp_async_commit();
    }
    const uint8_t* as = ring + (i % kStages) * S::kStage;
    const uint8_t* bs = as + S::kRawA;
    const int k0 = (kt0 + i) * kBK;
    for (int g4 = ks; g4 < kBK / 4; g4 += KS) {
      const int valid = p.K - (k0 + 4 * g4);
      if (valid <= 0) break;
      uint32_t aw[RC], bw[4];
#pragma unroll
      for (int j = 0; j < RC; ++j)
        aw[j] = *reinterpret_cast<const uint32_t*>(as + (rs + RS * j) * kBK + 4 * g4);
#pragma unroll
      for (int r = 0; r < 4; ++r) bw[r] = raw_b_word(bs, 4 * g4 + r, q);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r >= valid) break;                         // past K: nothing summed
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t b8 = (bw[r] >> (8 * c)) & 0xFF;
          const int bv = ext(b8, p.operand_signed);
#pragma unroll
          for (int j = 0; j < RC; ++j) {
            const uint32_t a8 = (aw[j] >> (8 * r)) & 0xFF;
            const int av = ext(a8, p.operand_signed);
            const int src = on_a[j][c] ? av : bv;
            const bool sel = ((src >> sh[j][c]) & 1) == vv[j][c];
            const uint32_t idx = sel ? (b8 << 8) | a8 : (a8 << 8) | b8;
            acc[j][c] += static_cast<uint32_t>(static_cast<int>(tbl[idx])) & tmask;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < RC; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) put(out, p, m0 + rs + RS * j, n0 + 4 * q + c, acc[j][c]);
}

// ---------------------------------------------------------------------------
// tile_hist: counts per row tile and per column tile, then the broadcast
// ---------------------------------------------------------------------------

__device__ __forceinline__ void count_bits(int v, int (&cnt)[kCounts]) {
  const int mag = v < 0 ? -v : v;
#pragma unroll
  for (int s = 0; s < kOperandBits; ++s) cnt[s] += (mag >> s) & 1;
  cnt[kOperandBits] += v < 0;
}

// One block per A row; its counts go to the row's tile.
__global__ void __launch_bounds__(kThreads)
hist_rows_kernel(const uint8_t* __restrict__ a, int K, int bm, int operand_signed,
                 int* __restrict__ cnt_a) {
  __shared__ int s_cnt[kCounts];
  const int r = blockIdx.x, tid = threadIdx.x;
  if (tid < kCounts) s_cnt[tid] = 0;
  int c[kCounts] = {};
  for (int k = tid; k < K; k += kThreads)
    count_bits(ext(a[static_cast<size_t>(r) * K + k], operand_signed), c);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kCounts; ++s) {
    const int v = __reduce_add_sync(0xFFFFFFFFu, c[s]);
    if ((tid & 31) == 0 && v) atomicAdd(&s_cnt[s], v);
  }
  __syncthreads();
  if (tid < kCounts && s_cnt[tid]) atomicAdd(&cnt_a[(r / bm) * kCounts + tid], s_cnt[tid]);
}

// One thread per B column over a K chunk (blockIdx.y); counts gathered per
// column tile in shared memory (a block's 256 columns meet at most 256).
__global__ void __launch_bounds__(kThreads)
hist_cols_kernel(const uint8_t* __restrict__ b, int N, int K, int bn, int k_chunk,
                 int operand_signed, int* __restrict__ cnt_b) {
  __shared__ int s_cnt[kThreads * kCounts];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kThreads;
  const int col = c0 + tid;
  const int tile0 = c0 / bn;
  const int ntiles = (min(N, c0 + kThreads) - 1) / bn - tile0 + 1;
  for (int i = tid; i < ntiles * kCounts; i += kThreads) s_cnt[i] = 0;
  __syncthreads();
  if (col < N) {
    int c[kCounts] = {};
    const int k1 = min(K, static_cast<int>(blockIdx.y + 1) * k_chunk);
    for (int k = static_cast<int>(blockIdx.y) * k_chunk; k < k1; ++k)
      count_bits(ext(b[static_cast<size_t>(k) * N + col], operand_signed), c);
    int* dst = s_cnt + (col / bn - tile0) * kCounts;
#pragma unroll
    for (int s = 0; s < kCounts; ++s)
      if (c[s]) atomicAdd(dst + s, c[s]);
  }
  __syncthreads();
  for (int i = tid; i < ntiles * kCounts; i += kThreads)
    if (s_cnt[i]) atomicAdd(&cnt_b[tile0 * kCounts + i], s_cnt[i]);
}

// hist[ti][tj][0] = counts of row tile ti, hist[ti][tj][1] = of column tile
// tj; position hist_width - 1 holds the negative count, positions >= 8 below
// it are zero (no set bit of an 8-bit magnitude).
__global__ void hist_write_kernel(const int* __restrict__ cnt_a,
                                  const int* __restrict__ cnt_b,
                                  int32_t* __restrict__ hist, int gm, int gn, int hw) {
  const size_t total = static_cast<size_t>(gm) * gn * 2 * hw;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int s = static_cast<int>(i % hw);
    const int side = static_cast<int>((i / hw) % 2);
    const size_t tile = i / (2 * hw);
    const int* c = side ? cnt_b + (tile % gn) * kCounts : cnt_a + (tile / gn) * kCounts;
    hist[i] = s == hw - 1 ? c[kOperandBits] : (s < kOperandBits ? c[s] : 0);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_kernel(void (*kern)(const uint8_t*, const uint8_t*, const T*, int32_t*,
                                       const int32_t*, Params),
                          dim3 grid, int smem, cudaStream_t stream, const uint8_t* a,
                          const uint8_t* b, const void* table, int32_t* out,
                          const int32_t* cfg, const Params& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(a, b, static_cast<const T*>(table), out, cfg, p);
  return cudaGetLastError();
}

bool pow2_le8(int v) { return v == 1 || v == 2 || v == 4 || v == 8; }

// route 0 (T): `tile` m16 tiles per block; route 1 (C): `tile` rows per
// thread and `slots` row slots.  `splits` blocks share each output tile's
// K; `atomic` (the output zeroed by the caller) is required whenever more
// than one block or slot adds into an element.
int launch_any(const void* a, const void* b, const void* table, const void* fg,
               const void* cfg, void* out, void* hist, void* work, int M, int N, int K,
               int bm, int bn, int bk, int operand_signed, int table_signed, int op_is_a,
               int bit, int value, int hist_width, int nm_order, int route, int tile,
               int slots, int splits, int atomic, int vec, void* stream) {
  const bool shapes_ok = M > 0 && N > 0 && K > 0 && bm > 0 && bn > 0 && bk > 0 &&
                         bm <= kMaxBlock && bn <= kMaxBlock && bk <= kMaxBlock &&
                         K % bk == 0 && splits >= 1 && splits <= 65535 && pow2_le8(tile);
  const bool route_ok =
      (route == 0 && fg != nullptr) ||
      (route == 1 && table != nullptr && pow2_le8(slots));
  const bool needs_atomic = splits > 1 || (route == 1 && slots < kWarps);
  const bool vec_ok = !vec || (K % 16 == 0 && N % 16 == 0 &&
                               reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                               reinterpret_cast<uintptr_t>(b) % 16 == 0);
  const bool hist_ok = hist_width == 0 ||
                       (hist_width > kOperandBits && hist_width <= kMaxHist &&
                        hist != nullptr && work != nullptr);
  if (!shapes_ok || !route_ok || (needs_atomic && !atomic) || !vec_ok || !hist_ok ||
      (cfg == nullptr && (bit < 0 || bit > 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gm = (M + bm - 1) / bm;
  const int gn = (N + bn - 1) / bn;
  const Params p{M, N, K, bm, bn, gn, operand_signed, table_signed, op_is_a, bit, value,
                 nm_order, splits, slots, atomic, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  int32_t* po = static_cast<int32_t*>(out);
  const int32_t* pc = static_cast<const int32_t*>(cfg);
  const int rows = route == 0 ? 16 * tile : slots * tile;
  const dim3 grid(((M + rows - 1) / rows) * ((N + kBN - 1) / kBN), splits);
  cudaError_t err;
  if (route == 0) {
#define AX_T(MT)                                                                      \
  err = operand_signed                                                                \
            ? launch_kernel(route_t_kernel<MT, false>, grid, TShape<MT>::kBytes, s, pa, \
                            pb, fg, po, pc, p)                                        \
            : launch_kernel(route_t_kernel<MT, true>, grid, TShape<MT>::kBytes, s, pa,  \
                            pb, fg, po, pc, p)
    if (tile == 1) AX_T(1);
    else if (tile == 2) AX_T(2);
    else if (tile == 4) AX_T(4);
    else AX_T(8);
#undef AX_T
  } else {
#define AX_C(RC) \
  err = launch_kernel(route_c_kernel<RC>, grid, CShape<RC>::kBytes, s, pa, pb, table, po, pc, p)
    if (tile == 1) AX_C(1);
    else if (tile == 2) AX_C(2);
    else if (tile == 4) AX_C(4);
    else AX_C(8);
#undef AX_C
  }
  if (err != cudaSuccess || hist_width == 0) return static_cast<int>(err);

  int* cnt_a = static_cast<int*>(work);  // (gm + gn) x kCounts, zeroed
  int* cnt_b = cnt_a + gm * kCounts;
  hist_rows_kernel<<<M, kThreads, 0, s>>>(pa, K, bm, operand_signed, cnt_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int bx = (N + kThreads - 1) / kThreads;
  const int want_y = (1024 + bx - 1) / bx;
  const int k_chunk = (K + std::min(K, want_y) - 1) / std::min(K, want_y);
  hist_cols_kernel<<<dim3(bx, (K + k_chunk - 1) / k_chunk), kThreads, 0, s>>>(
      pb, N, K, bn, k_chunk, operand_signed, cnt_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(gm) * gn * 2 * hist_width;
  const int wblocks = static_cast<int>(std::min<size_t>((total + kThreads - 1) / kThreads, 4096));
  hist_write_kernel<<<wblocks, kThreads, 0, s>>>(cnt_a, cnt_b, static_cast<int32_t*>(hist),
                                                 gm, gn, hist_width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points return a cudaError_t code (0 on success).  Pointers are
// device pointers: `table` the 65536 16-bit products (route C), `fg` the
// 256 f | g << 8 words (route T), `work` (gm + gn) x 9 zeroed int32 when
// hist_width > 0 (`hist` and `work` may be null otherwise).  The wrapper
// chooses route, tile, slots, splits, atomic and vec from the multiplier
// and the shapes (kernels/ax_matmul.py::plan).

// One (op_is_a, bit, value) swap triple for every output tile.
extern "C" int ax_matmul_launch(const void* a, const void* b, const void* table,
                                const void* fg, void* out, void* hist, void* work, int M,
                                int N, int K, int bm, int bn, int bk, int operand_signed,
                                int table_signed, int op_is_a, int bit, int value,
                                int hist_width, int nm_order, int route, int tile,
                                int slots, int splits, int atomic, int vec, void* stream) {
  return launch_any(a, b, table, fg, nullptr, out, hist, work, M, N, K, bm, bn, bk,
                    operand_signed, table_signed, op_is_a, bit, value, hist_width,
                    nm_order, route, tile, slots, splits, atomic, vec, stream);
}

// `cfg` is a contiguous (ceil(M/bm), ceil(N/bn), 3) int32 device grid of
// swap triples; element (m, n) applies cfg[m / bm][n / bn].
extern "C" int ax_matmul_grid_launch(const void* a, const void* b, const void* table,
                                     const void* fg, const void* cfg, void* out, void* hist,
                                     void* work, int M, int N, int K, int bm, int bn, int bk,
                                     int operand_signed, int table_signed, int hist_width,
                                     int nm_order, int route, int tile, int slots,
                                     int splits, int atomic, int vec, void* stream) {
  if (cfg == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any(a, b, table, fg, cfg, out, hist, work, M, N, K, bm, bn, bk,
                    operand_signed, table_signed, 0, 0, 2, hist_width, nm_order, route,
                    tile, slots, splits, atomic, vec, stream);
}
