// Tensor-core tile of the Hopper dense kernels (dense_tc.cu): 8-bit
// operands staged in shared memory
// (bit planes decoded four values per lane op, decode_word),
// nvcuda::wmma 16x16x16 products with int32 accumulators, and the
// accumulator tile written back through shared memory.
//
// A CTA of 128 threads (4 warps, 2 x 2) owns one ROWS x COLS output tile
// (64 x 64, or 32 x 32 for the dense GeMM's small products) and loops
// over the depth itself, BK values per step; each warp keeps a
// (ROWS/2) x (COLS/2) block of the tile as int32 accumulator fragments
// of 16 x 16.  An operand tile is stored as BK / 16 slabs of 16 depth
// values, each row 16 bytes, so every 16 x 16 fragment starts on a
// 256-byte boundary (wmma wants 256-bit aligned fragment pointers) and
// both operands load with ldm = 16: A row-major (row r, depth d at
// r*16 + d), B column-major (depth d, column c at c*16 + d).  Values past
// an operand's rows or depth are staged as 0 and contribute nothing.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

#include "lowbit_core.cuh"   // Mode, Planes, lowbit_error_string

namespace tc {

using namespace nvcuda;

constexpr int BM = 64;            // output rows per CTA (the largest tile)
constexpr int BN = 64;            // output columns per CTA
constexpr int BK = 128;           // depth values per step
constexpr int BKW = BK / 32;      // depth words of bit planes per step
constexpr int KS = BK / 16;       // 16-deep slabs per step
constexpr int THREADS = 128;      // 4 warps, 2 x 2 over the tile

template <typename T, int ROWS> struct alignas(128) Operand {
  T v[KS][ROWS][16];
};

// The operand tiles of a step, and afterwards the accumulator tile in
// their place (every warp passes a __syncthreads() before the switch);
// accumulator rows padded by 4 ints.
template <typename T, int ROWS = BM, int COLS = BN> struct alignas(128) Smem {
  union {
    struct {
      Operand<T, ROWS> a;
      Operand<T, COLS> b;
    } in;
    int c[ROWS][COLS + 4];
  };
};

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

// Accumulator fragments of one warp: (ROWS/2) x (COLS/2) in 16 x 16.
template <int ROWS, int COLS> struct Frags {
  static constexpr int I = ROWS / 32, J = COLS / 32;
  static_assert(I >= 1 && J >= 1 && I * 32 == ROWS && J * 32 == COLS,
                "tile must divide");
};

template <int FI, int FJ>
__device__ __forceinline__ void zero_acc(Acc (&acc)[FI][FJ]) {
#pragma unroll
  for (int i = 0; i < FI; ++i)
#pragma unroll
    for (int j = 0; j < FJ; ++j) wmma::fill_fragment(acc[i][j], 0);
}

// acc += the staged A slab x B slab products of this warp's block (warp
// row wr, warp column wc of the 2 x 2 arrangement).
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void mma_step(
    const Smem<T, ROWS, COLS>& s, int wr, int wc,
    Acc (&acc)[Frags<ROWS, COLS>::I][Frags<ROWS, COLS>::J]) {
  constexpr int FI = Frags<ROWS, COLS>::I, FJ = Frags<ROWS, COLS>::J;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[FI];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb[FJ];
#pragma unroll
    for (int i = 0; i < FI; ++i)
      wmma::load_matrix_sync(fa[i], &s.in.a.v[ks][wr * (ROWS / 2) + i * 16][0], 16);
#pragma unroll
    for (int j = 0; j < FJ; ++j)
      wmma::load_matrix_sync(fb[j], &s.in.b.v[ks][wc * (COLS / 2) + j * 16][0], 16);
#pragma unroll
    for (int i = 0; i < FI; ++i)
#pragma unroll
      for (int j = 0; j < FJ; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// Write the accumulators into s.c.  Call after the last step's trailing
// __syncthreads(); s.c is complete after the __syncthreads() here.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void store_acc(
    Smem<T, ROWS, COLS>& s, int wr, int wc,
    const Acc (&acc)[Frags<ROWS, COLS>::I][Frags<ROWS, COLS>::J]) {
  constexpr int FI = Frags<ROWS, COLS>::I, FJ = Frags<ROWS, COLS>::J;
#pragma unroll
  for (int i = 0; i < FI; ++i)
#pragma unroll
    for (int j = 0; j < FJ; ++j)
      wmma::store_matrix_sync(
          &s.c[wr * (ROWS / 2) + i * 16][wc * (COLS / 2) + j * 16], acc[i][j],
          COLS + 4, wmma::mem_row_major);
  __syncthreads();
}

// Bits 0..3 of n as four bytes of 0 or 1 (bit i -> byte i): the four
// shifted copies n, n<<7, n<<14, n<<21 do not overlap, so nothing carries.
__device__ __forceinline__ uint32_t expand4(uint32_t n) {
  return ((n & 0xfu) * 0x00204081u) & 0x01010101u;
}

// Decode one bit-plane word into its 32 +-1/0 int8 values — ternary
// (plus, minus) -> plus - minus, binary bit b -> 1 - 2b — zeroed where
// live has no bit: values 0..15 as one 16-byte store to lo, 16..31 to hi.
// Four values per 32-bit lane op (__vsub4 is a per-byte subtraction).
template <bool TERNARY>
__device__ __forceinline__ void decode_word(uint32_t plus, uint32_t minus,
                                            uint32_t live, int8_t* lo,
                                            int8_t* hi) {
  uint32_t q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t p = expand4(plus >> (4 * i));
    uint32_t v;
    if constexpr (TERNARY)
      v = __vsub4(p, expand4(minus >> (4 * i)));
    else
      v = __vsub4(0x01010101u, p << 1);
    q[i] = v & (expand4(live >> (4 * i)) * 0xffu);
  }
  *reinterpret_cast<uint4*>(lo) = make_uint4(q[0], q[1], q[2], q[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(q[4], q[5], q[6], q[7]);
}

// eq. (2) on the accumulator tile: out[gm, gn] = acc * row[gm * row_stride]
// * col[gn] (+ bias[gn]), each step rounded on its own in the reference's
// order (row_stride 0: one per-tensor scale).  Ragged edges are masked.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void store_scaled(const Smem<T, ROWS, COLS>& s,
                                             int m0, int n0, int m, int n,
                                             const float* __restrict__ row,
                                             int row_stride,
                                             const float* __restrict__ col,
                                             const float* __restrict__ bias,
                                             float* __restrict__ out) {
  for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
    const int r = i / COLS, c = i % COLS;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= m || gn >= n) continue;
    float y = __fmul_rn(__fmul_rn(__int2float_rn(s.c[r][c]),
                                  __ldg(row + static_cast<size_t>(gm) * row_stride)),
                        __ldg(col + gn));
    if (bias != nullptr) y = __fadd_rn(y, __ldg(bias + gn));
    out[static_cast<size_t>(gm) * n + gn] = y;
  }
}

}  // namespace tc
