// Approximate 8-bit matmul with the SWAPPER swap fused ahead of every
// product, for Hopper (sm_90a).  Replaces two Pallas TPU kernels of
// src/repro/kernels/ax_matmul.py: ax_matmul_pallas (one static swap) and
// ax_matmul_grid_pallas (a swap triple per output tile, read at run time).
//
//   C[m, n] = sum_k T[swap_t(A[m, k], B[k, n])]      (int32, wraps mod 2^32)
//
// The multiplier is its 256 x 256 product table T over the operand type's
// values, built on the host from the multiplier's closed form and stored
// as 16-bit entries (int16 for signed products, uint16 for unsigned): one
// kernel covers every family and every LUT circuit.  The swap decision t is
// an (op_is_a, bit, value) triple (value 2 never matches, i.e. NoSwap):
// passed at launch by ax_matmul_launch, or, with the GRID template flag
// (ax_matmul_grid_launch), read by each block from a (gm, gn, 3) int32
// device grid at its own tile (ti, tj).  The grid stays on the device, so a
// new policy is a new tensor value: nothing is rebuilt and the host never
// reads it.  The swap mask is ((src >> bit) & 1) == value on the
// sign-extended operand, with bit clamped to 31 as an unsigned amount (an
// arithmetic shift by 32 or more fills with the sign, as XLA's does); the
// adaptive policy only produces bits below the multiplier's width.
//
// Design (simple first): one thread block per (bm, bn) output tile, the K
// reduction as a loop inside the block (Pallas revisited a K grid axis
// instead).  The 128 KiB table sits in shared memory for the whole block;
// each K step stages the (bm, bk) A tile and the (bk, bn) B tile through
// shared memory.  256 threads: thread t owns column t % 128 of the tile and
// every second row starting at t / 128, with one uint32 accumulator per
// row in registers (uint32 gives the mod-2^32 wrap of JAX's int32 sum
// without signed-overflow UB).  Rows and columns past M and N are staged
// as zeros and never written; K must be a multiple of bk (callers pad K,
// so a circuit with m(0, 0) != 0 sums the same pad products as the TPU).
//
// What bounds it on an H100: the int8 weight bytes (K * N) and the M*K*N
// approximate products, which are CUDA-core integer work (a shared-memory
// gather per product), not tensor-core work.  At decode M the bytes set the
// bound, at prefill M the products; this first kernel is far from both,
// limited by the table gathers.  The grid variant shares the K loop, the
// staging and the histogram, and adds one 12-byte triple load per block.
// Later levers: closed forms in a few integer operations in place of the
// gather (trunc as two masks and a multiply, __clz for Mitchell and DRUM),
// wider loads, and for separable families the int8 tensor-core GEMM.
//
// Optional tile_hist output (gm, gn, 2, hist_width) int32: per output tile
// the set-magnitude-bit counts and the negative count of its A rows and of
// its B columns over all of K, counted while the tiles are staged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;                    // columns per tile = max bn
constexpr int kRowGroups = kThreads / kCols;  // 2
constexpr int kMaxBlock = 128;
constexpr int kTableBytes = 65536 * 2;
constexpr int kMaxHist = 17;                  // bits <= 16, plus the sign
constexpr int kOperandBits = 8;               // magnitudes of 8-bit operands

__device__ __forceinline__ int ext(uint8_t v, int operand_signed) {
  return operand_signed ? static_cast<int>(static_cast<int8_t>(v))
                        : static_cast<int>(v);
}

__device__ __forceinline__ void count_bits(int v, int* cnt) {
  const int mag = v < 0 ? -v : v;
#pragma unroll
  for (int s = 0; s < kOperandBits; ++s) cnt[s] += (mag >> s) & 1;
  cnt[kOperandBits] += v < 0;
}

template <int J, bool HIST, bool GRID>
__global__ void __launch_bounds__(kThreads)
ax_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                 const int16_t* __restrict__ table, int32_t* __restrict__ out,
                 int32_t* __restrict__ hist, const int32_t* __restrict__ cfg,
                 int M, int N, int K, int bm, int bn, int bk,
                 int operand_signed, int table_signed, int op_is_a, int bit,
                 int value, int hist_width, int nm_order) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* tbl = reinterpret_cast<int16_t*>(smem);
  uint8_t* as = smem + kTableBytes;  // (bm, bk)
  uint8_t* bs = as + bm * bk;        // (bk, bn)
  __shared__ int hist_s[2][kOperandBits + 1];

  const int ti = nm_order ? blockIdx.x : blockIdx.y;
  const int tj = nm_order ? blockIdx.y : blockIdx.x;
  const int m0 = ti * bm;
  const int n0 = tj * bn;
  const int tid = threadIdx.x;
  const int col = tid % kCols;
  const int rg = tid / kCols;
  const int gn_tiles = (N + bn - 1) / bn;
  if (GRID) {
    const int32_t* t = cfg + (static_cast<size_t>(ti) * gn_tiles + tj) * 3;
    op_is_a = t[0];
    bit = t[1];
    value = t[2];
  }
  bit = static_cast<unsigned>(bit) > 31u ? 31 : bit;

  {
    const uint4* src = reinterpret_cast<const uint4*>(table);
    uint4* dst = reinterpret_cast<uint4*>(tbl);
    for (int i = tid; i < kTableBytes / 16; i += kThreads) dst[i] = src[i];
  }
  int cnt_a[kOperandBits + 1];
  int cnt_b[kOperandBits + 1];
  if (HIST) {
#pragma unroll
    for (int s = 0; s <= kOperandBits; ++s) cnt_a[s] = cnt_b[s] = 0;
    if (tid < 2 * (kOperandBits + 1)) (&hist_s[0][0])[tid] = 0;
  }

  uint32_t acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0u;

  for (int k0 = 0; k0 < K; k0 += bk) {
    __syncthreads();  // the previous step's tiles are consumed
    for (int i = tid; i < bm * bk; i += kThreads) {
      const int r = i / bk;
      const int c = i - r * bk;
      const int gm = m0 + r;
      const uint8_t v = gm < M ? a[static_cast<size_t>(gm) * K + k0 + c] : 0;
      as[i] = v;
      if (HIST) count_bits(ext(v, operand_signed), cnt_a);
    }
    for (int i = tid; i < bk * bn; i += kThreads) {
      const int r = i / bn;
      const int c = i - r * bn;
      const int gn = n0 + c;
      const uint8_t v = gn < N ? b[static_cast<size_t>(k0 + r) * N + gn] : 0;
      bs[i] = v;
      if (HIST) count_bits(ext(v, operand_signed), cnt_b);
    }
    __syncthreads();
    if (col < bn) {
      for (int k = 0; k < bk; ++k) {
        const int bv = ext(bs[k * bn + col], operand_signed);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int r = rg + kRowGroups * j;
          if (r < bm) {
            const int av = ext(as[r * bk + k], operand_signed);
            const int src = op_is_a ? av : bv;
            const bool sel = ((src >> bit) & 1) == value;
            const int aa = sel ? bv : av;
            const int bb = sel ? av : bv;
            const int t = tbl[((aa & 0xFF) << 8) | (bb & 0xFF)];
            acc[j] += table_signed ? static_cast<uint32_t>(t)
                                   : static_cast<uint32_t>(static_cast<uint16_t>(t));
          }
        }
      }
    }
  }

  const int gn = n0 + col;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int r = rg + kRowGroups * j;
    const int gm = m0 + r;
    if (r < bm && col < bn && gm < M && gn < N)
      out[static_cast<size_t>(gm) * N + gn] = static_cast<int32_t>(acc[j]);
  }

  if (HIST) {
#pragma unroll
    for (int s = 0; s <= kOperandBits; ++s) {
      if (cnt_a[s]) atomicAdd(&hist_s[0][s], cnt_a[s]);
      if (cnt_b[s]) atomicAdd(&hist_s[1][s], cnt_b[s]);
    }
    __syncthreads();
    int32_t* h = hist + (static_cast<size_t>(ti) * gn_tiles + tj) * 2 * hist_width;
    for (int i = tid; i < 2 * hist_width; i += kThreads) {
      const int row = i / hist_width;
      const int s = i - row * hist_width;
      int v = 0;
      if (s == hist_width - 1) v = hist_s[row][kOperandBits];
      else if (s < kOperandBits) v = hist_s[row][s];
      h[i] = v;  // positions >= 8 hold no set bit of an 8-bit magnitude
    }
  }
}

template <int J, bool HIST, bool GRID>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const uint8_t* a, const uint8_t* b, const int16_t* table,
                   int32_t* out, int32_t* hist, const int32_t* cfg, int M,
                   int N, int K, int bm, int bn, int bk, int operand_signed,
                   int table_signed, int op_is_a, int bit, int value,
                   int hist_width, int nm_order) {
  auto kern = ax_matmul_kernel<J, HIST, GRID>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(a, b, table, out, hist, cfg, M, N, K,
                                         bm, bn, bk, operand_signed,
                                         table_signed, op_is_a, bit, value,
                                         hist_width, nm_order);
  return cudaGetLastError();
}

template <bool HIST, bool GRID>
cudaError_t dispatch_rows(int bm, dim3 grid, size_t smem, cudaStream_t stream,
                          const uint8_t* a, const uint8_t* b,
                          const int16_t* table, int32_t* out, int32_t* hist,
                          const int32_t* cfg, int M, int N, int K, int bn,
                          int bk, int operand_signed, int table_signed,
                          int op_is_a, int bit, int value, int hist_width,
                          int nm_order) {
  const int rows = (bm + kRowGroups - 1) / kRowGroups;  // rows per thread
#define AX_LAUNCH(JJ)                                                        \
  return launch<JJ, HIST, GRID>(grid, smem, stream, a, b, table, out, hist,  \
                                cfg, M, N, K, bm, bn, bk, operand_signed,    \
                                table_signed, op_is_a, bit, value,           \
                                hist_width, nm_order)
  if (rows <= 1) AX_LAUNCH(1);
  if (rows <= 2) AX_LAUNCH(2);
  if (rows <= 4) AX_LAUNCH(4);
  if (rows <= 8) AX_LAUNCH(8);
  if (rows <= 16) AX_LAUNCH(16);
  if (rows <= 32) AX_LAUNCH(32);
  AX_LAUNCH(64);
#undef AX_LAUNCH
}

template <bool GRID>
int launch_any(const void* a, const void* b, const void* table, void* out,
               void* hist, const void* cfg, int M, int N, int K, int bm, int bn,
               int bk, int operand_signed, int table_signed, int op_is_a,
               int bit, int value, int hist_width, int nm_order, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      bm > kMaxBlock || bn > kMaxBlock || bk > kMaxBlock || K % bk != 0 ||
      (!GRID && (bit < 0 || bit > 31)) || (GRID && cfg == nullptr) ||
      hist_width < 0 || hist_width > kMaxHist ||
      (hist_width > 0 && (hist == nullptr || hist_width <= kOperandBits)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gm = (M + bm - 1) / bm;
  const int gn = (N + bn - 1) / bn;
  const dim3 grid = nm_order ? dim3(gm, gn) : dim3(gn, gm);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kTableBytes + static_cast<size_t>(bm) * bk +
                      static_cast<size_t>(bk) * bn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  const int16_t* pt = static_cast<const int16_t*>(table);
  int32_t* po = static_cast<int32_t*>(out);
  int32_t* ph = static_cast<int32_t*>(hist);
  const int32_t* pc = static_cast<const int32_t*>(cfg);
  cudaError_t err =
      hist_width > 0
          ? dispatch_rows<true, GRID>(bm, grid, smem, s, pa, pb, pt, po, ph,
                                      pc, M, N, K, bn, bk, operand_signed,
                                      table_signed, op_is_a, bit, value,
                                      hist_width, nm_order)
          : dispatch_rows<false, GRID>(bm, grid, smem, s, pa, pb, pt, po, ph,
                                       pc, M, N, K, bn, bk, operand_signed,
                                       table_signed, op_is_a, bit, value,
                                       hist_width, nm_order);
  return static_cast<int>(err);
}

}  // namespace

// Both entry points return a cudaError_t code (0 on success).  Pointers are
// device pointers; `table` holds 65536 16-bit entries and is 16-byte
// aligned; `hist` may be null when hist_width is 0.

// One (op_is_a, bit, value) swap triple for every output tile.
extern "C" int ax_matmul_launch(const void* a, const void* b, const void* table,
                                void* out, void* hist, int M, int N, int K,
                                int bm, int bn, int bk, int operand_signed,
                                int table_signed, int op_is_a, int bit,
                                int value, int hist_width, int nm_order,
                                void* stream) {
  return launch_any<false>(a, b, table, out, hist, nullptr, M, N, K, bm, bn,
                           bk, operand_signed, table_signed, op_is_a, bit,
                           value, hist_width, nm_order, stream);
}

// `cfg` is a contiguous (ceil(M/bm), ceil(N/bn), 3) int32 device grid of
// swap triples; output tile (ti, tj) applies cfg[ti][tj].
extern "C" int ax_matmul_grid_launch(const void* a, const void* b,
                                     const void* table, const void* cfg,
                                     void* out, void* hist, int M, int N,
                                     int K, int bm, int bn, int bk,
                                     int operand_signed, int table_signed,
                                     int hist_width, int nm_order,
                                     void* stream) {
  return launch_any<true>(a, b, table, out, hist, cfg, M, N, K, bm, bn, bk,
                          operand_signed, table_signed, 0, 0, 2, hist_width,
                          nm_order, stream);
}
