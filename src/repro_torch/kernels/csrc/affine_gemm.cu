// u8 and u4 GeMM for Hopper (sm_90a): the raw unsigned accumulator
// A_q @ B_q in int32, the first term of the paper's eq. (3) — the
// gemmlowp-style U8 and U4 baselines of Table III.
//
// Replaces the Pallas kernels of the JAX package:
//   int8_matmul_pallas  (kernels/int8_matmul.py)  -> affine_gemm_kernel<false, TILE>
//   int4_matmul_pallas  (kernels/int4_matmul.py)  -> affine_gemm_kernel<true, TILE>
//
// u8: A (m, k) and B (k, n) uint8, row-major.  u4: the nibble-packed
// operands of int4_matmul.pack_nibbles_rows / _cols — A (m, k2) with
// element 2t in the low nibble of byte t along k, B (k2, n) packed the
// same way along k (axis 0); the depth is 2*k2 (an odd logical depth is
// padded with a 0 nibble on both sides).  The zero-point terms of eq. (3)
// are rank-1 and stay outside, in PyTorch, as the reference applies them
// outside Pallas.  The accumulators wrap modulo 2^32, as XLA's int32 dot
// does.
//
// What bounds it on this card.  At the paper's GEMM_GRID shapes (m <= 360,
// n <= 96, k <= 512) the operations (2*m*n*k at 1,979 TOP/s int8) and the
// bytes (A and B once, the int32 output once, at 3.35 TB/s) each take well
// under a microsecond: a call is bound by latency — how many CTAs share
// the work and how long each waits on its loads.  At the CNN's im2col GeMM
// shapes (m up to 262,144, k up to 1,152) the bytes bind, over half of
// them the int32 output.  Neither comes near the tensor rate, so the
// products are mma.sync m16n8k32 u8 -> s32 (wgmma would pay only where the
// tensor rate binds).
//
// The design.  CTA = TILE x TILE outputs, 4 warps of 2 x 2; TILE 64 where
// the grid fills the card and 32 where it would not, chosen by the caller
// (_matmul_common.gemm_tile over AFFINE_TILES).  A CTA owns one column
// block and walks row blocks (as many CTAs as the card holds at once,
// spread over the column blocks), KSTEP = 128 depth values per step.
//   * B arrives (k, n) row-major, but the tensor cores want each column's
//     depth values contiguous, and ldmatrix.trans moves 16-bit elements
//     only.  So the CTA transposes B in registers once, for every row
//     block it walks (KC_MAX = 1,152 depth values at a time; a deeper
//     product restages B chunk by chunk for each row block): a thread
//     reads 4-byte words (4 columns) from 16 consecutive rows of B, turns
//     four 4 x 4 byte blocks with __byte_perm and writes each column's 16
//     depth values as one 16-byte store.  Column groups are permuted
//     within their four (b_pos) so that the eight threads of a store phase
//     hit eight bank groups; ldmatrix reads them back wherever they lie.
//     B at an address or width (n % 4 != 0) that a 4-byte word does not
//     fit is read byte by byte; columns past n are 0.
//   * A streams through a 4-slot cp.async ring, three steps ahead of the
//     products: 16-byte runs of a row, eight neighbouring threads on eight
//     rows so that a warp reads whole 32-byte sectors and a store phase
//     lands on distinct bank groups.  The copy width (16, 8 or 4 bytes,
//     else bytes) is the widest the row stride and the base pointer allow,
//     checked in the launcher; a run that crosses the depth's end is read
//     byte by byte and filled with zeros.
//   * u4 reads every packed byte once and never unpacks A in shared
//     memory: ldmatrix loads the packed runs, and a lane's word (depths
//     8q..8q+7 of its row) splits into its low nibbles (the even depths)
//     and its high nibbles (the odd depths), four values per lane op
//     (w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F), which fill the A registers
//     of k slots 4q.. and 16+4q.. .  The B staging splits B's packed words
//     the same way — a packed row holds two adjacent depths, so its low
//     nibbles go to an even-depth slab and its high ones to an odd-depth
//     slab — and the products see both operands in the same depth order.
//   * The accumulators go straight from the registers to device memory
//     (8-byte stores where n is even).
// Tried and dropped (slower on the card than this design at the CNN
// shapes, the diagonal or both): the parent's wmma tile loop with
// 16-byte staging and the next step's A and B prefetched into registers;
// mma.sync with B transposed every step from registers; a cp.async ring
// for B's rows as well as A's, transposed in shared memory; a 3- or
// 6-slot ring; one row block per CTA, or twice the CTAs the card holds.
// Not tried: wgmma, TMA, and a split of k across the CTA's warps.

#include "lowbit_core.cuh"   // cp.async helpers, lowbit_error_string

namespace affine {

constexpr int THREADS = 128;         // 4 warps, 2 x 2 over the tile

// The 4 bytes at p byte by byte, 0 past cols.
__device__ __forceinline__ uint32_t load_bytes4(const uint8_t* p, int cols) {
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < cols) w |= static_cast<uint32_t>(__ldg(p + i)) << (8 * i);
  return w;
}

// The 16 bytes at p byte by byte, 0 past avail (one word at a time,
// shifted in from the top: a rolled loop keeps the registers of this rare
// path to one word's bytes).
__device__ __forceinline__ uint4 load_bytes16(const uint8_t* p, int avail) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
  for (int q = 0; q < 16; q += 4) v = make_uint4(v.y, v.z, v.w, load_bytes4(p + q, avail - q));
  return v;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}

// 4 x 4 byte transpose: r[i] holds columns 0..3 of depth i; c[j] gets
// depths 0..3 of column j.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&c)[4]) {
  const uint32_t x0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t x1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t y0 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t y1 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(x0, x1, 0x5410);
  c[1] = __byte_perm(x0, x1, 0x7632);
  c[2] = __byte_perm(y0, y1, 0x5410);
  c[3] = __byte_perm(y0, y1, 0x7632);
}

constexpr int KSTEP = 128;           // depth values per step
constexpr int SLABS = KSTEP / 16;     // 16-deep slabs per step
constexpr int STAGES = 4;             // slots of A's cp.async ring
constexpr int KC_MAX = 1152;          // depth of B a CTA holds at once

// The CTA's work split and its shared memory (byte offsets), 16-byte rows
// throughout:
//   ring A  STAGES slots of A's runs, [run][row][16], which the products
//           read as they are (u8: a run is 16 depth values, one slab; u4:
//           32 depth values, packed);
//   slab B  B transposed for kc depth values (the launch's chunk), 16
//           depth values per slab, [slab][b_pos(column)][16]: u8 slab s
//           holds depths 16s..16s+15 in order; u4 slabs 2s and 2s+1 hold
//           the even and the odd depths of 32s..32s+31, the order in
//           which the products unpack A's nibbles.
template <bool U4, int TILE> struct AffinePlan {
  static constexpr int CPR = U4 ? KSTEP / 32 : KSTEP / 16;  // A runs per row
  static constexpr int A_RUNS = TILE * CPR;
  static constexpr int PA = (A_RUNS + THREADS - 1) / THREADS;
  // a warp's block of the tile: MI x NJ products of 16 x 8 outputs
  static constexpr int MI = TILE / 32, NJ = TILE / 16;
  static constexpr int A_SLOT = A_RUNS * 16;
  static constexpr int SLAB_B = STAGES * A_SLOT;
  static constexpr size_t bytes(int kc) { return SLAB_B + static_cast<size_t>(kc) * TILE; }
  static_assert(TILE % 32 == 0 && A_RUNS % 8 == 0, "2 x 2 warps, 8 rows per phase");
};

// The slab row of B column c: columns 4g..4g+3 stay in their group of
// four, permuted by (c / 8) % 4, so that the transpose's 16-byte stores
// (eight neighbouring threads, each its own group of four) hit eight
// distinct bank groups; ldmatrix takes any row order, so the products
// read the columns back where they are.
__device__ __forceinline__ int b_pos(int c) {
  return (c & ~3) | ((c & 3) ^ ((c >> 3) & 3));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 32 u8, row-major) x b (32 x 8 u8, column-major), int32
// accumulators wrapping modulo 2^32.
__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B's columns n0..n0+TILE-1 at depths c0..c0+kc-1 into slab B, transposed:
// a unit is 4 columns x 16 rows of B, read as 16 words of 4 columns and
// turned by four 4 x 4 byte transposes into four 16-byte column runs of
// one slab (u4: 16 packed rows, 32 depth values; their low nibbles, the
// even depths, go to one slab and their high nibbles, the odd depths, to
// the next).  Rows past the depth and columns past n are 0.
template <bool U4, int TILE>
__device__ __forceinline__ void stage_b(uint8_t* slab_b, const uint8_t* __restrict__ b,
                                        int n, int kb, int n0, int c0, int kc,
                                        bool vec4) {
  const int units = TILE / 4 * (U4 ? kc / 32 : kc / 16);
#pragma unroll 2
  for (int i = threadIdx.x; i < units; i += THREADS) {
    const int cg = i % (TILE / 4), g16 = i / (TILE / 4);   // 16 rows of B
    const int gn = n0 + 4 * cg, row0 = (U4 ? c0 / 2 : c0) + 16 * g16;
    const int rows = gn < n ? min(16, kb - row0) : 0;
    const uint8_t* p = b + static_cast<size_t>(row0) * n + gn;
    uint32_t w[16];     // rows 0..15 of the unit, 4 columns each
    if (vec4) {         // n % 4 == 0: gn < n means all four columns exist
#pragma unroll
      for (int d = 0; d < 16; ++d)
        w[d] = d < rows ? __ldg(reinterpret_cast<const uint32_t*>(p + d * n)) : 0u;
    } else {
#pragma unroll
      for (int d = 0; d < 16; ++d) w[d] = d < rows ? load_bytes4(p + d * n, n - gn) : 0u;
    }
#pragma unroll
    for (int half = 0; half < (U4 ? 2 : 1); ++half) {
      uint32_t t4[4][4];   // t4[g][q]: rows 4g..4g+3 of column q
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        uint32_t rows4[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          rows4[q] = U4 ? (w[4 * g + q] >> (4 * half)) & 0x0F0F0F0Fu : w[4 * g + q];
        transpose4(rows4, t4[g]);
      }
      const int slab = U4 ? 2 * g16 + half : g16;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<uint4*>(slab_b + (slab * TILE + b_pos(4 * cg + q)) * 16) =
            make_uint4(t4[0][q], t4[1][q], t4[2][q], t4[3][q]);
    }
  }
}

// A CTA owns column block blockIdx.x and the row blocks blockIdx.y,
// blockIdx.y + gridDim.y, ...; its steps run over them in order, KSTEP
// depth values each.  B is staged kc depth values at a time: once for all
// of the CTA's row blocks when kc covers the depth, else chunk by chunk
// for each row block.
template <bool U4, int TILE>
__global__ void __launch_bounds__(THREADS)
affine_gemm_kernel(const uint8_t* __restrict__ a,
                   const uint8_t* __restrict__ b, int m, int n, int k,
                   int kc, int vec_a, int vec4_b, int* __restrict__ out) {
  using P = AffinePlan<U4, TILE>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * TILE;
  // bytes along the depth of one A row and rows of B: k (u8), k / 2 (u4)
  const int kb = U4 ? k / 2 : k;
  const int kstep = U4 ? KSTEP / 2 : KSTEP;     // of them per step
  const int ksteps = (k + KSTEP - 1) / KSTEP, chunk_steps = kc / KSTEP;
  const bool resident = chunk_steps >= ksteps;
  const int m_blocks = (m + TILE - 1) / TILE;
  const int total = (m_blocks - blockIdx.y + gridDim.y - 1) / gridDim.y * ksteps;

  // Step t's A runs into ring slot t % STAGES as one cp.async group (an
  // empty group past the last step), zeros past the operand.  Eight
  // neighbouring threads take eight rows, so a warp reads whole 32-byte
  // sectors.
  auto issue = [&](int t) {
    if (t < total) {
      const int m0 = (blockIdx.y + t / ksteps * gridDim.y) * TILE;
      const int off0 = t % ksteps * kstep;
      uint8_t* ra = smem + (t % STAGES) * P::A_SLOT;
      // the whole slot at once: every row and 16-byte run inside A
      const bool fast = vec_a == 16 && m0 + TILE <= m && off0 + kstep <= kb;
#pragma unroll
      for (int j = 0; j < P::PA; ++j) {
        const int i = tid + j * THREADS;
        if (P::A_RUNS % THREADS != 0 && i >= P::A_RUNS) break;
        const int c = (i >> 3) % P::CPR, r = (i >> 3) / P::CPR * 8 + (i & 7);
        const int gm = m0 + r, off = off0 + 16 * c;
        uint8_t* dst = ra + (c * TILE + r) * 16;
        const uint8_t* src = a + static_cast<size_t>(gm) * kb + off;
        if (fast) {
          lowbit::cp_async16(dst, src, true);
        } else if (gm >= m) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        } else if (kb - off >= 16 && vec_a == 16) {
          lowbit::cp_async16(dst, src, true);
        } else if (kb - off >= 16 && vec_a == 8) {
          cp_async8(dst, src);
          cp_async8(dst + 8, src + 8);
        } else if (kb - off >= 16 && vec_a == 4) {
#pragma unroll
          for (int q = 0; q < 16; q += 4) lowbit::cp_async4(dst + q, src + q, true);
        } else {   // synchronous: a plain store, visible after the next barrier
          *reinterpret_cast<uint4*>(dst) = load_bytes16(src, kb - off);
        }
      }
    }
    lowbit::cp_async_commit();
  };

  // Warp (wr, wc) of 2 x 2 owns rows wr * TILE/2.. and columns
  // wc * TILE/2.. of the tile: MI x NJ blocks of 16 x 8 outputs.
  const int wm = (warp >> 1) * (TILE / 2), wn = (warp & 1) * (TILE / 2);
  // ldmatrix x4 row addresses of this lane: matrix q = lane / 8, row
  // lane % 8.  A: rows +8 for odd q, the next slab for q >= 2; B: the
  // next slab for odd q, columns +8 for q >= 2.
  const int q4 = lane >> 3, l8 = lane & 7;
  const int a_row = wm + l8 + 8 * (q4 & 1), a_slab = q4 >> 1;
  const int b_col = wn + l8 + 8 * (q4 >> 1), b_slab = q4 & 1;
  int acc[P::MI][P::NJ][4] = {};

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);
  for (int t = 0; t < total; ++t) {
    const int ks = t % ksteps;
    lowbit::cp_async_wait<STAGES - 2>();     // this thread's runs of step t
    // B's next chunk, while the ring's copies are in flight
    if (ks % chunk_steps == 0 && (!resident || t == 0)) {
      __syncthreads();                       // step t - 1's products are done
      stage_b<U4, TILE>(smem + P::SLAB_B, b, n, kb, n0, ks * KSTEP,
                        min(kc, (ksteps - ks) * KSTEP), vec4_b != 0);
    }
    __syncthreads();                         // every thread's runs and slabs
    issue(t + STAGES - 1);                   // into the slot of step t - 1
    const uint8_t* sa = smem + (t % STAGES) * P::A_SLOT;
    const uint8_t* sb = smem + P::SLAB_B + (ks % chunk_steps) * SLABS * TILE * 16;
    // one product of 32 depth values: B's slabs kk, kk + 1
    auto mma32 = [&](const uint32_t (&fa)[P::MI][4], int kk) {
      uint32_t fb[P::NJ / 2][4];
#pragma unroll
      for (int j = 0; j < P::NJ / 2; ++j)
        ldmatrix_x4(fb[j], sb + ((kk + b_slab) * TILE + b_pos(b_col + 16 * j)) * 16);
#pragma unroll
      for (int i = 0; i < P::MI; ++i)
#pragma unroll
        for (int j = 0; j < P::NJ; ++j)
          mma_u8(acc[i][j], fa[i], fb[j / 2][2 * (j & 1)], fb[j / 2][2 * (j & 1) + 1]);
    };
    if constexpr (U4) {
      // one ldmatrix x4 per 16 rows: packed runs r and r + 1 (64 depth
      // values), a lane's word holding depths 8q..8q+7 (q = lane % 4) of
      // its row: the low nibbles, depths 8q, 8q+2, .., sit in the A
      // register of k slots 4q..4q+3 and the high nibbles in that of
      // slots 16+4q..; B's even/odd slabs match
#pragma unroll
      for (int r = 0; r < SLABS / 2; r += 2) {
        uint32_t w[P::MI][4], fa0[P::MI][4], fa1[P::MI][4];
#pragma unroll
        for (int i = 0; i < P::MI; ++i) {
          ldmatrix_x4(w[i], sa + ((r + a_slab) * TILE + a_row + 16 * i) * 16);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t(&f)[4] = h ? fa1[i] : fa0[i];
            f[0] = w[i][2 * h] & 0x0F0F0F0Fu;
            f[1] = w[i][2 * h + 1] & 0x0F0F0F0Fu;
            f[2] = (w[i][2 * h] >> 4) & 0x0F0F0F0Fu;
            f[3] = (w[i][2 * h + 1] >> 4) & 0x0F0F0F0Fu;
          }
        }
        mma32(fa0, 2 * r);
        mma32(fa1, 2 * r + 2);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < SLABS; kk += 2) {
        uint32_t fa[P::MI][4];
#pragma unroll
        for (int i = 0; i < P::MI; ++i)
          ldmatrix_x4(fa[i], sa + ((kk + a_slab) * TILE + a_row + 16 * i) * 16);
        mma32(fa, kk);
      }
    }
    if (ks == ksteps - 1) {
      // The row block's accumulators straight to device memory: c0, c1 at
      // (row lane / 4, columns 2 * (lane % 4) + 0, 1) of a 16 x 8 block,
      // c2, c3 eight rows below; one 8-byte store per pair where n is even
      // (the row of out is then 8-byte aligned).
      const int m0 = (blockIdx.y + t / ksteps * gridDim.y) * TILE;
#pragma unroll
      for (int i = 0; i < P::MI; ++i)
#pragma unroll
        for (int j = 0; j < P::NJ; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gm = m0 + wm + 16 * i + (lane >> 2) + 8 * h;
            const int gn = n0 + wn + 8 * j + 2 * (lane & 3);
            int* o = out + static_cast<size_t>(gm) * n + gn;
            if (gm < m && gn < n) {
              if (n % 2 == 0) {
                *reinterpret_cast<int2*>(o) = make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
              } else {
                o[0] = acc[i][j][2 * h];
                if (gn + 1 < n) o[1] = acc[i][j][2 * h + 1];
              }
            }
            acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0;
          }
    }
  }
  lowbit::cp_async_wait<0>();
}

// The widest copy (16, 8, 4 or 1 bytes) that every row of an operand
// starting at p with a row stride of `stride` bytes allows.
inline int copy_width(const void* p, int stride) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p) | static_cast<uintptr_t>(stride);
  return bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : 1;
}

// SMs of the current device, read once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  return sms;
}

// Launch one instantiation: B's chunk kc (the depth rounded up to KSTEP,
// at most KC_MAX), the shared memory it needs, and row blocks shared out
// so that the CTAs the card holds at once (by the occupancy calculator,
// read once per chunk size) have one each where there are enough.  The
// kernel's dynamic shared-memory limit is raised once, to what the
// largest chunk needs, so that no launch lowers it under another's.
template <bool U4, int TILE>
int launch(const uint8_t* a, const uint8_t* b, int m, int n, int k, int* out,
           cudaStream_t st) {
  using P = AffinePlan<U4, TILE>;
  const int kc = min((k + KSTEP - 1) / KSTEP * KSTEP, KC_MAX);
  const size_t bytes = P::bytes(kc);
  static int per_sm[KC_MAX / KSTEP + 1] = {};
  int& slots = per_sm[kc / KSTEP];
  if (slots == 0) {
    cudaError_t e = cudaFuncSetAttribute(affine_gemm_kernel<U4, TILE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(P::bytes(KC_MAX)));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&slots, affine_gemm_kernel<U4, TILE>,
                                                        THREADS, bytes);
    if (e != cudaSuccess || slots <= 0) {
      slots = 0;
      cudaGetLastError();          // not left for the next launch to report
      return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidValue);
    }
  }
  const int m_blocks = (m + TILE - 1) / TILE, n_blocks = (n + TILE - 1) / TILE;
  const int want = (slots * sm_count() + n_blocks - 1) / n_blocks;   // >= 1
  const dim3 grid(n_blocks, m_blocks < want ? m_blocks : want);
  const int wa = copy_width(a, U4 ? k / 2 : k);
  affine_gemm_kernel<U4, TILE><<<grid, THREADS, bytes, st>>>(
      a, b, m, n, k, kc, wa, copy_width(b, n) >= 4, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace affine

// u4: 0 for u8 operands a (m, k), b (k, n); 1 for nibble-packed operands
// a (m, k2), b (k2, n) with k = 2*k2.  tile 64 or 32 (the square CTA
// tile).  out (m, n) int32, row-major, 8-byte aligned.  Returns
// cudaGetLastError() after the launch (or the error that kept it from
// launching).
extern "C" int affine_gemm_launch(int u4, const void* a, const void* b, int m,
                                  int n, int k, int tile, void* out,
                                  void* stream) {
  using namespace affine;
  if (m <= 0 || n <= 0 || k <= 0 || (u4 && k % 2) || (tile != 64 && tile != 32) ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  auto* po = static_cast<int*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (u4)
    return tile == 64 ? launch<true, 64>(pa, pb, m, n, k, po, st)
                      : launch<true, 32>(pa, pb, m, n, k, po, st);
  return tile == 64 ? launch<false, 64>(pa, pb, m, n, k, po, st)
                    : launch<false, 32>(pa, pb, m, n, k, po, st);
}
