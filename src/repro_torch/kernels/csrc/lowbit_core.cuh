// Popcount core shared by the Hopper low-bit kernels (lowbit_gemm.cu,
// lowbit_conv.cu; dense_tc.cu takes the tables and the copies): the
// per-word products of the three modes, the register-tile
// multiply-accumulate, the eq. (6) / eq. (2) epilogue, cp.async helpers,
// the implicit-im2col tables, and popcount_body, the CTA loop that both
// popcount kernels run.
//
// Bit planes are 32-bit words, LSB first (depth k = 32*w + i is bit i of
// word w).  A CTA of 256 threads owns ROWS x COLS output tiles (16, 32 or
// 64 square) and loops over the depth words itself, BK words per step
// staged in shared memory; each thread keeps a TM x TN block of int32
// counts in registers.  A word past the depth is staged as 0 on both
// operands, which contributes 0 in every mode (BNN: 0 ^ 0; TNN: no bit
// set; TBN: a+ = a- = 0 forces z+ = b & ~b = 0 and z- = ~b & b = 0).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lowbit {

constexpr int BM = 64;        // the conv's tile, and the GeMM's largest
constexpr int BN = 64;
constexpr int BK = 32;        // depth words staged per step
constexpr int THREADS = 256;
constexpr int TX = 16;        // threads along n; THREADS / TX along m
constexpr int TY = THREADS / TX;
constexpr int RESIDENT_A_BYTES = 64 * 1024;   // A held for the whole depth

// Outputs per thread of a ROWS x COLS tile.
template <int ROWS, int COLS> struct Tiling {
  static constexpr int TM = ROWS / TY, TN = COLS / TX;
  static_assert(TM >= 1 && TN >= 1 && TM * TY == ROWS && TN * TX == COLS,
                "tile must divide");
};

enum Mode : int { BNN = 0, TNN = 1, TBN = 2 };

template <int MODE> struct Planes {
  static constexpr int A = MODE == BNN ? 1 : 2;   // activation planes
  static constexpr int B = MODE == TNN ? 2 : 1;   // weight planes
};

// Signed contribution of one word: BNN the XOR popcount (finalized by
// eq. (6) in the epilogue), TNN eq. (7), TBN the Table I identities.
template <int MODE>
__device__ __forceinline__ int product(uint32_t ap, uint32_t am, uint32_t bp,
                                       uint32_t bm) {
  if constexpr (MODE == BNN) {
    return __popc(ap ^ bp);
  } else if constexpr (MODE == TNN) {
    return __popc((ap & bp) | (am & bm)) - __popc((ap & bm) | (am & bp));
  } else {
    const uint32_t nb = ~bp;
    return __popc((ap | bp) & (am | nb)) - __popc((ap | nb) & (am | bp));
  }
}

// acc[i][j] += sum over the wn staged words of product(A row, B column),
// for rows ty + TY*i and columns tx + TX*j of the tile.  a0/a1 and b0/b1
// are depth-major planes ([word][row], rows padded by one word so a
// warp's reads and the transposing stores hit distinct banks) starting at
// the step's first word; one-plane operands pass the same plane twice.
template <int MODE, int ROWS, int COLS>
__device__ __forceinline__ void mac_tile(
    const uint32_t (*a0)[ROWS + 1], const uint32_t (*a1)[ROWS + 1],
    const uint32_t (*b0)[COLS + 1], const uint32_t (*b1)[COLS + 1], int wn,
    int ty, int tx,
    int (&acc)[Tiling<ROWS, COLS>::TM][Tiling<ROWS, COLS>::TN]) {
  constexpr int TM = Tiling<ROWS, COLS>::TM, TN = Tiling<ROWS, COLS>::TN;
#pragma unroll 4
  for (int w = 0; w < wn; ++w) {
    uint32_t ap[TM], am[TM], bp[TN], bm[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      ap[i] = a0[w][ty + TY * i];
      am[i] = a1[w][ty + TY * i];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      bp[j] = b0[w][tx + TX * j];
      bm[j] = b1[w][tx + TX * j];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] += product<MODE>(ap[i], am[i], bp[j], bm[j]);
  }
}

// Finalize and write the thread's outputs.  BNN: k_valid - 2*acc
// (eq. (6)).  FUSED: eq. (2) as acc * row * col (+ bias), each step
// rounded on its own, in the reference's order; row is read at
// row[gm * row_stride] (stride 0: one per-tensor scale).  Otherwise the
// int32 count is written.
template <int MODE, bool FUSED, int ROWS, int COLS>
__device__ __forceinline__ void store_tile(
    const int (&acc)[Tiling<ROWS, COLS>::TM][Tiling<ROWS, COLS>::TN], int m0,
    int n0, int ty, int tx, int m, int n, int k_valid,
    const float* __restrict__ row, int row_stride,
    const float* __restrict__ col, const float* __restrict__ bias,
    void* out) {
  constexpr int TM = Tiling<ROWS, COLS>::TM, TN = Tiling<ROWS, COLS>::TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + TY * i;
    if (gm >= m) continue;
    float rs = 0.f;
    if constexpr (FUSED) rs = __ldg(row + static_cast<size_t>(gm) * row_stride);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + TX * j;
      if (gn >= n) continue;
      int v = acc[i][j];
      if constexpr (MODE == BNN) v = k_valid - 2 * v;
      const size_t o = static_cast<size_t>(gm) * n + gn;
      if constexpr (FUSED) {
        float y = __fmul_rn(__fmul_rn(__int2float_rn(v), rs), __ldg(col + gn));
        if (bias != nullptr) y = __fadd_rn(y, __ldg(bias + gn));
        static_cast<float*>(out)[o] = y;
      } else {
        static_cast<int*>(out)[o] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Asynchronous copies (sm_80+) and the implicit-im2col tables shared by
// the popcount body and dense_tc.cu
// ---------------------------------------------------------------------------

// Copy 4 bytes global -> shared without passing through registers; with
// valid == false nothing is read and the word is zero-filled.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// The same for 16 bytes (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Per-CTA tables of an implicit-im2col conv over packed activation planes
// (B, Hp, Wp, cw) — the padded input, one word per 32 channels:
//   off[gk]   word offset of depth word gk = (dy*KW + dx)*cw + wi from a
//             patch's top-left word: (dy*Wp + dx)*cw + wi;
//   base[r]   word index of the top-left word of tile row r's patch, 0 for
//             rows past m (a valid address whose products are never
//             stored).
// The A word of (row r, depth word gk) is planes[base[r] + off[gk]]: one
// 4-byte load, no bounds check, no quantization.
template <int ROWS>
__device__ __forceinline__ void conv_tables(int* off, int* base, int words,
                                            int cw, int KW, int Wp, int Hp,
                                            int stride, int OH, int OW,
                                            int m0, int m) {
  for (int c = threadIdx.x; c < words; c += blockDim.x) {
    const int p = c / cw, wi = c - p * cw;
    const int dy = p / KW, dx = p - dy * KW;
    off[c] = (dy * Wp + dx) * cw + wi;
  }
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const int gm = m0 + r;
    int v = 0;
    if (gm < m) {
      const int b = gm / (OH * OW), rem = gm - b * (OH * OW);
      const int oh = rem / OW, ow = rem - oh * OW;
      v = ((b * Hp + oh * stride) * Wp + ow * stride) * cw;
    }
    base[r] = v;
  }
}

// ---------------------------------------------------------------------------
// The CTA body of both popcount kernels (lowbit_gemm_kernel,
// lowbit_conv_kernel)
// ---------------------------------------------------------------------------

// A words held per plane: the whole depth when resident, else a ring of
// two steps.
__host__ __device__ constexpr int held_a_words(int words, int resident) {
  return resident ? words : 2 * BK;
}

// Dynamic shared memory of popcount_body, in bytes: the A tile
// [NA][held][ROWS + 1], the B ring [2][NB][BK][COLS + 1], then the tables
// off[words] and base[ROWS].
template <int MODE, int ROWS, int COLS>
__host__ __device__ constexpr size_t body_smem_bytes(int words, int resident) {
  return 4 * (static_cast<size_t>(Planes<MODE>::A) *
                  held_a_words(words, resident) * (ROWS + 1) +
              2 * Planes<MODE>::B * BK * (COLS + 1) + words + ROWS);
}

// Where the tables start in that memory: off[words], then base[ROWS].  The
// kernel fills them (conv_tables) and syncs before popcount_body.
template <int MODE, int ROWS, int COLS>
__device__ __forceinline__ int* body_tables(uint32_t* smem, int words,
                                            int resident) {
  return reinterpret_cast<int*>(
      smem + Planes<MODE>::A * held_a_words(words, resident) * (ROWS + 1) +
      2 * Planes<MODE>::B * BK * (COLS + 1));
}

// One CTA: row block blockIdx.x against column blocks
// [blockIdx.y * blocks_per_cta, +blocks_per_cta) of n, over `words` depth
// words.  The A word of (row r, depth word gk) is a[base[r] + off[gk]]
// (body_tables); B rows are (n, words) row-major.
//   * The A tile is staged ONCE for the whole depth (resident) and reused
//     by every column block the CTA owns; depths too deep for that stream
//     A through a two-slot ring, re-staged per column block.
//   * Staging is 4-byte cp.async into the depth-major tiles mac_tile reads
//     conflict-free, one group per step, double-buffered: the copies of
//     step t+1 are in flight while step t runs the popcount loop.  Each
//     loop is sized to the step's words, so no thread idles on a short
//     depth.
//   * Then eq. (6) for BNN and, FUSED, eq. (2) with row[gm * row_stride]
//     (stride 0: one per-tensor scale) in store_tile; otherwise int32.
template <int MODE, bool FUSED, int ROWS, int COLS>
__device__ __forceinline__ void popcount_body(
    uint32_t* smem, const uint32_t* __restrict__ a0,
    const uint32_t* __restrict__ a1, int m, const uint32_t* __restrict__ b0,
    const uint32_t* __restrict__ b1, int n, int words, int k_valid,
    int blocks_per_cta, int resident, const float* __restrict__ row,
    int row_stride, const float* __restrict__ col,
    const float* __restrict__ bias, void* out) {
  constexpr int NA = Planes<MODE>::A, NB = Planes<MODE>::B;
  constexpr int TM = Tiling<ROWS, COLS>::TM, TN = Tiling<ROWS, COLS>::TN;
  const int ka = held_a_words(words, resident);
  uint32_t* s_a = smem;                                 // [NA][ka][ROWS + 1]
  uint32_t* s_b = s_a + NA * ka * (ROWS + 1);           // [2][NB][BK][COLS + 1]
  const int* s_off = body_tables<MODE, ROWS, COLS>(smem, words, resident);
  const int* s_base = s_off + words;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * ROWS;
  const int nblk = (n + COLS - 1) / COLS;
  const int nb0 = blockIdx.y * blocks_per_cta;
  const int nb_end = min(nblk, nb0 + blocks_per_cta);
  const int ks = (words + BK - 1) / BK;
  const int steps = (nb_end - nb0) * ks;

  // Issue the copies of step t (column block nb0 + t / ks, depth step t % ks)
  // as one cp.async group: A (every step when streaming, the first column
  // block's steps when resident) and the B rows into buffer t & 1.
  auto stage = [&](int t) {
    const int nb = nb0 + t / ks, k0 = (t % ks) * BK;
    const int wn = min(BK, words - k0);
    if (!resident || nb == nb0) {
      const int slot = resident ? k0 : (t & 1) * BK;
      for (int i = tid; i < ROWS * wn; i += THREADS) {
        const int c = i / ROWS, r = i % ROWS;
        const int src = s_base[r] + s_off[k0 + c];
        cp_async4(s_a + (slot + c) * (ROWS + 1) + r, a0 + src, true);
        if constexpr (NA == 2)
          cp_async4(s_a + (ka + slot + c) * (ROWS + 1) + r, a1 + src, true);
      }
    }
    uint32_t* sb = s_b + (t & 1) * NB * BK * (COLS + 1);
    const int n0 = nb * COLS;
    for (int i = tid; i < COLS * wn; i += THREADS) {
      const int r = i / wn, c = i - r * wn;
      const bool ok = n0 + r < n;
      const size_t off = ok ? static_cast<size_t>(n0 + r) * words + k0 + c : 0;
      cp_async4(sb + c * (COLS + 1) + r, b0 + off, ok);
      if constexpr (NB == 2)
        cp_async4(sb + (BK + c) * (COLS + 1) + r, b1 + off, ok);
    }
    cp_async_commit();
  };

  using ARow = const uint32_t (*)[ROWS + 1];
  using BRow = const uint32_t (*)[COLS + 1];
  int acc[TM][TN] = {};
  if (steps > 0) stage(0);
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kstep = t % ks, k0 = kstep * BK;
    const int slot = resident ? k0 : (t & 1) * BK;
    const uint32_t* sb = s_b + (t & 1) * NB * BK * (COLS + 1);
    mac_tile<MODE, ROWS, COLS>(
        reinterpret_cast<ARow>(s_a + slot * (ROWS + 1)),
        reinterpret_cast<ARow>(s_a + ((NA - 1) * ka + slot) * (ROWS + 1)),
        reinterpret_cast<BRow>(sb),
        reinterpret_cast<BRow>(sb + (NB - 1) * BK * (COLS + 1)),
        min(BK, words - k0), ty, tx, acc);
    if (kstep == ks - 1) {
      const int nb = nb0 + t / ks;
      store_tile<MODE, FUSED, ROWS, COLS>(acc, m0, nb * COLS, ty, tx, m, n,
                                          k_valid, row, row_stride, col, bias,
                                          out);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0;
    }
    __syncthreads();
  }
}

}  // namespace lowbit

namespace lowbit_host {

// Column blocks per CTA for a conv of m_blocks row blocks and nblk column
// blocks: a CTA loops over its blocks with the A tile staged once, so all
// of cout in one CTA when the row blocks alone fill the card (4 CTAs per
// SM); otherwise the columns are split into as few groups as reach that.
inline int conv_blocks_per_cta(int m_blocks, int nblk) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  const long long target = 4LL * sms;
  long long groups = (target + m_blocks - 1) / m_blocks;
  if (groups < 1) groups = 1;
  if (groups > nblk) groups = nblk;
  return static_cast<int>((nblk + groups - 1) / groups);
}

// Raise a kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB; false when the card cannot give that much.
template <typename Kernel>
inline bool allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return true;
  if (bytes > 227 * 1024) return false;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes)) == cudaSuccess;
}

// The launch of popcount_body over an m x n product of `words` depth words
// in ROWS x COLS tiles: the grid, column blocks per CTA, whether A stays
// resident, and the dynamic shared memory.  reuse_a: a CTA loops over
// column blocks with its A tile staged once (conv_blocks_per_cta), as the
// conv does, whose A is a gather; otherwise one column block per CTA, as
// the GeMM does: its A rows are contiguous and cheap to stage again, and
// more CTAs balance the card better (measured on the CNN's im2col GeMMs).
struct Plan {
  dim3 grid;
  int per_cta, resident;
  size_t smem;
};

template <int MODE, int ROWS, int COLS>
inline Plan popcount_plan(int m, int n, int words, bool reuse_a) {
  using namespace lowbit;
  const int m_blocks = (m + ROWS - 1) / ROWS, nblk = (n + COLS - 1) / COLS;
  Plan p;
  p.per_cta = reuse_a ? conv_blocks_per_cta(m_blocks, nblk) : 1;
  p.grid = dim3(m_blocks, (nblk + p.per_cta - 1) / p.per_cta);
  p.resident = static_cast<size_t>(Planes<MODE>::A) * words * (ROWS + 1) * 4 <=
               RESIDENT_A_BYTES;
  p.smem = body_smem_bytes<MODE, ROWS, COLS>(words, p.resident);
  return p;
}

}  // namespace lowbit_host


extern "C" const char* lowbit_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
