// attention_tc.cuh — the bf16 tensor-core attention bodies for Hopper
// (sm_90a): the forward and the two backward kernels, templated on where the
// Q and K tiles come from.
//
//  * SPARSE = false (dense attention, flash_attention.cu): TMA copies Q and K
//    tiles into swizzled shared memory, like V and dO.
//  * SPARSE = true (FlashSFA, flash_sfa_tc.cu): Q and K arrive as top-k codes
//    and are densified by the block's threads into the same swizzled layout
//    TMA would write (Tile<D, ROWS>, hopper.cuh), the counterpart of the TPU
//    kernels' _densify_block / _unpack in VMEM before the MXU. From there on
//    every product is the dense one. V and dO still come by TMA.
//
// One schedule serves both, as the TPU's `sparse`-parametrised _bwd_impl:
//  * forward: one block of two warpgroups per (bh, 128-query tile), 64 rows
//    each; 64-key tiles in a 2-stage ring. S = Q.K^T in the SS form; online
//    softmax in registers (a row's statistics live in 4 lanes of a quad);
//    P.V in the RS form, P fed from S's accumulator registers.
//  * backward: two kernels, each output tile with one owner (no atomics, a
//    deterministic result). dK/dV: one warpgroup per (bh, 64-key tile),
//    walking query tiles from the diagonal; S^T = K.Q^T and dP^T = V.dO^T
//    (SS), P^T and dS^T in registers, dV += P^T.dO and dK += dS^T.Q (RS).
//    dQ: one warpgroup per (bh, 64-query tile) over the key tiles up to the
//    causal edge; S = Q.K^T, dP = dO.V^T, dQ += dS.K.
// P and dS are f32 values, not inputs: each is split into hi = bf16(x) and
// lo = bf16(x - hi), and two wgmmas accumulate hi and lo into the same f32
// registers (~16 bits of P and dS). Q, K, V and dO are bf16 inputs, exact.
//
// The densify (SPARSE). Each code is packed by the wrapper's pack kernel as
// one 32-bit word, idx << 16 | bf16 bits of the value (0 where idx is
// outside [0, d)), so a tile's codes are 4-byte words that cp.async can
// stage one tile ahead. A few neighbouring lanes of one warp own a row of
// the tile, each a share of its columns: they stage the row's k codes
// themselves (cp.async, then __syncwarp), each zeroes its columns and
// stores, without a branch, the bf16 bits of the codes that fall in them at
// their swizzled addresses, so no other thread touches them and only the
// one barrier per tile that the ring has anyway stands between a densify
// and the wgmma that reads it. Repeated indices store the f32 sum
// of their codes, rounded once to bf16, the same value as the TPU's
// iota-compare densify; the codes rtopk and proj_rtopk emit have distinct
// indices with zero-valued padding, so the tile holds the inputs exactly.
// (Owning 8 columns per thread and comparing all k indices against them,
// the TPU's iota-compare, costs 8k compare-adds per 16 bytes: on the card
// it made the kernels 2.2-2.9x slower than their dense counterparts;
// PERF.md, PR 16.) The
// densify writes through the generic proxy and wgmma reads through the
// async proxy: fence.proxy.async, then a barrier, before the first wgmma
// that reads the tile.
//
// Head widths (Width<D>). The dense kernels take D in {32, 64, 128}, the
// sparse ones also 80 and 256:
//  * 80: tiles of 96 columns (hopper::tile_width; three 64-byte swizzle
//    spans), whose columns 80-95 hold zeros (TMA's fill past V's and dO's
//    real width, the densify's zeroing). S and dP run 5 k-steps over the
//    real columns; P.V, dQ, dK and dV run at N = 96 (Mma<96>) and every
//    store writes the 80 real columns.
//  * 256: two warpgroups of a block own the same 64 rows, each one
//    128-column half of every output accumulator (O; dQ; dK and dV), so
//    each holds the d 128 body's accumulators (one warpgroup holding all
//    256 columns would need 128 more registers for O alone, past 255). Each
//    computes the whole S (and dP) itself over 16 k-steps, with no exchange
//    between the two: the scores are computed twice, ~1.5x the forward's
//    ideal operations. The forward walks 64-query blocks, the backward's
//    blocks have 256 threads, and the densify gives a row 4 lanes.
//
// Sparse extras:
//  * block skip (forward): a level map (bh, ceil(nq/64), ceil(nk/64)) at the
//    warpgroup's 64-row tile; each warpgroup reads the level of its rows
//    (at d 256 both warpgroups of a block share one row of the map),
//    uniform over its threads, so wgmma never diverges: 0 skip, 1 the closed form of
//    a zero-overlap tile from the tile's V row sum (scores all exactly 0),
//    2 compute. A key tile is loaded and densified only when some warpgroup
//    of the block computes it. A null map computes every tile.
//  * emits (backward dQ and dK, from the dense f32 accumulator, as the TPU's
//    _unpack): 0 dense rows masked to each row's stored coordinates; 1
//    compact, the value at each of the k stored indices; 2 compact2, the
//    same on the RoPE pair closure below rot_dim. The compact emits stage
//    the accumulator through shared memory and gather per row, so compact
//    equals the dense emit gathered, bit for bit.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::Mma;
using hopper::Tile;

constexpr int kTile = 64;            // rows of one warpgroup; keys per K/V tile
constexpr int kWG = 128;             // threads of a warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The accumulator entry i of m64nN (see hopper.cuh): its row within the
// warpgroup's 64 and its column.
__device__ __forceinline__ int acc_row(int i) {
  const int lane = threadIdx.x % 32;
  return 16 * ((threadIdx.x % kWG) / 32) + lane / 4 + 8 * ((i % 4) / 2);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + (i % 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The shapes of a head of D columns: its tiles' width W, the SPLIT
// warpgroups that share a block's rows and the N columns of every output
// accumulator each owns (the header comment).
template <int D>
struct Width {
  static constexpr int W = hopper::tile_width(D);
  static constexpr int SPLIT = W > 128 ? 2 : 1;
  static constexpr int N = W / SPLIT;
  static constexpr int COLS = N < D ? N : D;        // of them, real columns
  static constexpr int THREADS = SPLIT * kWG;       // a backward block
  static constexpr int LANES = THREADS / kTile;     // densify lanes of a 64-row tile
  static constexpr int LANE_BITS = LANES == 2 ? 1 : 2;
};

// S (64 x 64 f32) = A rows [a_r0, a_r0 + 64) of tile A . B^T (B's 64 rows),
// both K-major over the D real columns of their W-wide tiles: the SS form,
// D / 16 k-steps.
template <int D, int ROWS_A>
__device__ __forceinline__ void mma_abt(float (&s)[32], uint32_t a, int a_r0, uint32_t b) {
  constexpr int W = Width<D>::W;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Mma<64>::ss(s, Tile<W, ROWS_A>::kmajor(a, a_r0, kk), Tile<W, kTile>::kmajor(b, 0, kk),
                kk > 0);
}

// X (64 x 64 f32, an accumulator) split into bf16 hi + lo A fragments
struct Split {
  uint32_t hi[4][4], lo[4][4];
  __device__ __forceinline__ explicit Split(const float (&x)[32]) {
    hopper::split_frags(x, hi, lo);
  }
};

// C (64 x N) += X . B = X_hi . B + X_lo . B, with B the N columns of a
// (64, W) tile from `b` (Tile::column) on as the MN-major operand: the RS
// form, 8 k16 steps.
template <int W, int N>
__device__ __forceinline__ void mma_xb(float (&c)[N / 2], const Split& x, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = Tile<W, kTile>::mnmajor(b, kk);
    Mma<N>::rs(c, x.hi[kk], db, 1);
    Mma<N>::rs(c, x.lo[kk], db, 1);
  }
}

// Store a warpgroup's 64 x N accumulator of columns [c0, c0 + N) (times
// per-row factors) as bf16 rows r0 + (0..63) of a (.., D) matrix: rows < n
// and the real columns (< D) only.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[Width<D>::N / 2],
                                           size_t row_base, int r0, int n, int c0, float f0,
                                           float f1) {
#pragma unroll
  for (int i = 0; i < Width<D>::COLS / 2; i += 2) {
    const int r = r0 + acc_row(i);
    if (r < n) {
      const float f = (i % 4) < 2 ? f0 : f1;
      *reinterpret_cast<__nv_bfloat162*>(out + (row_base + r) * D + c0 + acc_col(i)) =
          __floats2bfloat162_rn(acc[i] * f, acc[i + 1] * f);
    }
  }
}

// ---- the sparse side: codes, their staging and the densify ------------------

// One side's top-k codes: (bh, n, k) packed words (idx << 16 | bf16 bits,
// 0 where idx is outside [0, d)) for the densify, and the int32 indices as
// given for the emits.
struct Codes {
  const uint32_t* packed;
  const int32_t* idx;
  int k;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// the densify's generic-proxy stores, made visible to wgmma's async proxy
// (a barrier must follow before the product)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Q neighbouring lanes of one warp densify one row of a tile: lane `part`
// owns the row's columns [part * D / Q, (part + 1) * D / Q). The Q lanes
// stage the row's k packed codes themselves (cp.async into cs + r * (k + 1),
// a padded stride, each lane a share), wait for their own copies and
// __syncwarp, so no block barrier separates staging from densify. Nothing
// is staged for a row at or past n.
template <int Q>
__device__ __forceinline__ void stage_row(uint32_t* cs, const uint32_t* packed,
                                          size_t head_row0, int row, int n, int k, int r,
                                          int part) {
  if (row >= n) return;
  const uint32_t* src = packed + (head_row0 + row) * k;
  uint32_t* dst = cs + r * (k + 1);
#pragma unroll 1
  for (int u = part; u < k; u += Q) cp_async4(dst + u, src + u);
}

// every lane's staged codes have landed and are visible to its warp
__device__ __forceinline__ void staged_wait() {
  cp_async_wait_all();
  __syncwarp();
}

// The staged codes of row r (see stage_row)
__device__ __forceinline__ const uint32_t* staged_row(const uint32_t* cs, int r, int k) {
  return cs + r * (k + 1);
}

// shared-memory stores by 32-bit address (the fence after the densify
// orders them before the wgmma that reads them)
__device__ __forceinline__ void sts_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr), "r"(0u));
}
__device__ __forceinline__ void sts_u16(uint32_t addr, uint32_t bits) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(static_cast<unsigned short>(bits)));
}

// Densify lane `part`'s columns of row r of the bf16 tile Tile<D, ROWS> at
// `tile` from the row's k packed codes (shared or global memory), exactly
// as TMA would write the dense row: 16-byte unit j of row r of column chunk
// c at c * ROWS * SW + r * SW + 16 j, swizzled (bits 4.. of the offset XOR
// bits 7..; chunks are whole 1024-byte swizzle atoms, so the XOR is the
// row's alone). Q neighbouring lanes of one warp share a row, lane `part`
// owning columns [part * D / Q, (part + 1) * D / Q). The lane zeroes its
// columns, loads the row's codes eight at a time into registers and stores,
// without a branch, the bf16 bits of each code that falls in its columns:
// no other lane writes them, so there is no race and no barrier between the
// two. Where an index repeats in the lane's columns (rtopk never emits one,
// but padding's (0, 0) codes and other callers may), fewer columns than
// hits were marked, and each hit column is stored again with the f32 sum of
// all its codes, rounded once; a code outside [0, d) was packed as (0, 0)
// and adds nothing. A row that is not `valid` (past n) stays zero.
template <int D, int ROWS, int Q>
__device__ __forceinline__ void densify_part(uint8_t* tile, int r, int part,
                                             const uint32_t* codes, int k, bool valid) {
  using T = Tile<D, ROWS>;
  constexpr int COLS = D / Q;               // this lane's columns
  static_assert(COLS % 8 == 0 && COLS <= 64, "a lane owns whole 16-byte units, <= 64 columns");
  using Bits = typename std::conditional<(COLS > 32), uint64_t, uint32_t>::type;
  constexpr int SPAN = T::SW / 16;          // 16-byte units of a row inside one chunk
  const uint32_t row = hopper::smem_u32(tile) + r * T::SW;
  const uint32_t swz = (T::SW == 128 ? (r & 7) : ((r >> 1) & 3)) << 4;
  auto at = [&](uint32_t col) {
    return row + (col / T::CHUNK) * ROWS * T::SW + (((col % T::CHUNK) * 2) ^ swz);
  };
  const int j0 = part * (COLS / 8);
#pragma unroll
  for (int j = j0; j < j0 + COLS / 8; ++j)
    sts_zero16(row + (j / SPAN) * ROWS * T::SW + (((j % SPAN) * 16) ^ swz));
  if (!valid) return;
  const uint32_t c0 = part * COLS;
  Bits seen = 0;                            // the lane's columns hit
  int hits = 0;
#pragma unroll 1
  for (int u0 = 0; u0 < k; u0 += 8) {
    uint32_t p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) p[e] = u0 + e < k ? codes[u0 + e] : 0xFFFFFFFFu;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t col = p[e] >> 16;
      const uint32_t c = col - c0;                      // wraps below the lane's columns
      const bool in = c < static_cast<uint32_t>(COLS);  // never for the 0xFFFF.. past k
      seen |= in ? Bits(1) << c : Bits(0);
      hits += in;
      if (in) sts_u16(at(col), p[e]);
    }
  }
  if (__popcll(static_cast<unsigned long long>(seen)) == hits) return;
#pragma unroll 1
  for (int u = 0; u < k; ++u) {
    const uint32_t col = codes[u] >> 16;
    if (col - c0 >= static_cast<uint32_t>(COLS)) continue;
    float x = 0.0f;
    for (int v = 0; v < k; ++v) {
      const uint32_t q = codes[v];
      if ((q >> 16) == col) x += __uint_as_float(q << 16);
    }
    sts_u16(at(col), __bfloat16_as_ushort(__float2bfloat16(x)));
  }
}

// The P.V / dQ / dK-dV products read their A fragments from registers
// asynchronously: after a densify placed between their issue and their
// wait, these keep the fragments' registers allocated (and untouched) until
// the wait.
__device__ __forceinline__ void keep(const Split& x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" ::"r"(x.hi[kk][r]), "r"(x.lo[kk][r]));
}

// dQ or dK of one warpgroup's rows [r0, r0 + 64) and columns [c0, c0 + N)
// from its f32 accumulator (the TPU's _unpack). emit 0: dense rows, zero off
// each row's stored coordinates (_support_mask); 1: compact (n, k), the
// value at each stored index (_gather_support; 0 for an index outside [0,
// D)); 2: compact2 (n, 2k) on the pair closure below rot_dim
// (_pair_closure_gather). idx: the head's (n, k) indices at head_row0. The
// compact emits stage the accumulators of the block's warpgroups (their
// column halves, at d 256) in `scratch` (64 x (W + 1) f32 of shared memory
// that no one reads any more) and must be called by the whole block.
template <int D>
__device__ void emit_grad(bf16* out, const float (&acc)[Width<D>::N / 2], size_t head_row0,
                          int r0, int n, int c0, const int32_t* idx, int k, int emit, int rot_dim,
                          float* scratch) {
  constexpr int N = Width<D>::N;
  if (emit == 0) {
    // the stored coordinates of this thread's two rows as bits: columns
    // c0 + [0, 64) and c0 + [64, N)
    uint64_t lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lo[h] = hi[h] = 0ull;
      const int r = r0 + acc_row(2 * h);
      if (r < n) {
        const int32_t* ids = idx + (head_row0 + r) * k;
#pragma unroll 1
        for (int u = 0; u < k; ++u) {
          const int id = ids[u];
          const int c = id - c0;
          if (c >= 0 && c < 64 && id < D) lo[h] |= 1ull << c;
          if (c >= 64 && c < N && id < D) hi[h] |= 1ull << (c - 64);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < Width<D>::COLS / 2; i += 2) {
      const int r = r0 + acc_row(i);
      if (r < n) {
        const int c = acc_col(i);                       // even: c and c + 1 share a word
        const uint64_t word = 8 * (i / 4) < 64 ? lo[(i % 4) / 2] : hi[(i % 4) / 2];
        const float x0 = (word >> (c & 63)) & 1ull ? acc[i] : 0.0f;
        const float x1 = (word >> ((c + 1) & 63)) & 1ull ? acc[i + 1] : 0.0f;
        *reinterpret_cast<__nv_bfloat162*>(out + (head_row0 + r) * D + c0 + c) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
    return;
  }
  constexpr int LD = Width<D>::W + 1;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) scratch[acc_row(i) * LD + c0 + acc_col(i)] = acc[i];
  __syncthreads();
  const int width = emit == 1 ? k : 2 * k;
#pragma unroll 1
  for (int t = threadIdx.x; t < kTile * k; t += Width<D>::THREADS) {
    const int rr = t / k, u = t % k;
    const int r = r0 + rr;
    if (r >= n) continue;
    const int id = idx[(head_row0 + r) * k + u];
    const float g = (id >= 0 && id < D) ? scratch[rr * LD + id] : 0.0f;
    bf16* o = out + (head_row0 + r) * width;
    if (emit == 1) {
      o[u] = __float2bfloat16(g);
    } else {
      const bool odd = id >= 0 && id < rot_dim && (id & 1);
      o[u] = __float2bfloat16(odd ? 0.0f : g);
      o[k + u] = __float2bfloat16(odd ? g : 0.0f);
    }
  }
}

// Level 1 of the block-skip map: the key tile's scores are all exactly 0, so
// the online-softmax update has the closed form m' = max(m, 0),
// o' = o e^(m - m') + e^(-m') vsum, l' = l e^(m - m') + 64 e^(-m') (log2
// units here; each of a row's 4 threads holds a quarter of l). The
// accumulator holds columns [c0, c0 + N) of O (d 256: a warpgroup's half);
// a padding column (at or past D: d 80's 80-95) reads no vsum.
template <int D, int N>
__device__ __forceinline__ void closed_form(float (&o)[N / 2], float (&m)[2], float (&l)[2],
                                            const float* vsum_row, int c0) {
  float corr[2], e[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], 0.0f);
    corr[h] = exp2f(m[h] - m_new);
    e[h] = exp2f(-m_new);
    m[h] = m_new;
    l[h] = l[h] * corr[h] + (kTile / 4) * e[h];
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int c = c0 + acc_col(i);
    const float v = (Width<D>::W == D || c < D) ? vsum_row[c] : 0.0f;
    o[i] = o[i] * corr[(i % 4) / 2] + e[(i % 4) / 2] * v;
  }
}

// ---- the forward --------------------------------------------------------------

// SPARSE at d <= 64 asks for two blocks an SM (at most 128 registers a
// thread): one block's densify then overlaps the other's products
// (PERF.md, PR 16). A block: two warpgroups over 128 query rows, 64 each;
// at d 256 over 64 rows, a column half of O each (Width).
template <int D, bool SPARSE>
__global__ void __launch_bounds__(2 * kWG, (SPARSE && D <= 64) ? 2 : 1)
flash_attention_tc_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap, Codes qc, Codes kc,
                              const int32_t* __restrict__ level, const float* __restrict__ vsum,
                              bf16* __restrict__ out, float* __restrict__ lse, int nq, int nk,
                              float scale, int causal) {
  constexpr int W = Width<D>::W, N = Width<D>::N, SPLIT = Width<D>::SPLIT;
  constexpr int QROWS = 2 * kTile / SPLIT;   // the block's query rows
  constexpr int QL = 2 * kWG / QROWS;        // SPARSE: lanes densifying a Q row (2 or 4)
  constexpr int QL_BITS = QL == 2 ? 1 : 2;
  // the block-skip map: FlashSFA's alone
  if constexpr (!SPARSE) level = nullptr;
  using TQ = Tile<W, QROWS>;
  using TK = Tile<W, kTile>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar[3];   // Q; K/V stage 0, 1 (SPARSE: V only)
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ks = qs + TQ::BYTES;              // 2 stages
  uint8_t* vs = ks + 2 * TK::BYTES;          // 2 stages
  uint32_t* cs = reinterpret_cast<uint32_t*>(vs + 2 * TK::BYTES);  // SPARSE: a key tile's codes
  // SPARSE with a level map: both warpgroups' rows of it
  uint8_t* lv = reinterpret_cast<uint8_t*>(cs + kTile * (kc.k + 1));

  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int bh = blockIdx.x;
  const int tiles = (nq + QROWS - 1) / QROWS;
  const int q0 = (causal ? tiles - 1 - static_cast<int>(blockIdx.y) : blockIdx.y) * QROWS;
  const int wrow = SPLIT == 1 ? kTile : 0;   // row offset from one warpgroup to the next
  const int r0 = q0 + wg * wrow;             // this warpgroup's first row
  const int c0 = SPLIT == 1 ? 0 : wg * N;    // and first column of O
  const int k_end = causal ? min(nk, q0 + QROWS) : nk;
  const int ntiles = (k_end + kTile - 1) / kTile;
  const int wg_tiles = ((causal ? min(nk, r0 + kTile) : nk) + kTile - 1) / kTile;

  // SPARSE: warpgroup w's level of key tile t, uniform over its threads
  // (its rows' row of the map: w at one warpgroup a row tile, 0 at d 256)
  const int nqb = (nq + kTile - 1) / kTile, nkb = (nk + kTile - 1) / kTile;
  auto level_of = [&](int w, int t) {
    const int rw = q0 + w * wrow;
    if (t * kTile >= (causal ? min(nk, rw + kTile) : nk)) return 0;
    return level == nullptr ? 2 : static_cast<int>(lv[(w * wrow / kTile) * nkb + t]);
  };
  if (SPARSE && level != nullptr) {          // the block's two rows of the map, into shared memory
    for (int i = tid; i < 2 * nkb; i += 2 * kWG) {
      const int qt = q0 / kTile + i / nkb;
      lv[i] = qt < nqb ? static_cast<uint8_t>(
                             level[(static_cast<size_t>(bh) * nqb + qt) * nkb + i % nkb])
                       : 0;
    }
  }
  // the first key tile at or after t that some warpgroup computes
  auto next_loaded = [&](int t) {
    while (t < ntiles && level_of(0, t) != 2 && level_of(1, t) != 2) ++t;
    return t;
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  int t_next = 0;                            // SPARSE: the next key tile to load
  const int krow = tid >> 2, kpart = tid & 3;  // SPARSE: 4 lanes densify a K row
  if constexpr (!SPARSE) {
    if (tid == 0) {
      hopper::mbar_expect_tx(&bar[0], TQ::BYTES);
      TQ::load(qs, &qmap, &bar[0], q0, bh);
      hopper::mbar_expect_tx(&bar[1], 2 * TK::BYTES);
      TK::load(ks, &kmap, &bar[1], 0, bh);
      TK::load(vs, &vmap, &bar[1], 0, bh);
    }
  } else {
    t_next = next_loaded(0);
    if (t_next < ntiles) {
      if (tid == 0) {
        hopper::mbar_expect_tx(&bar[1], TK::BYTES);
        TK::load(vs, &vmap, &bar[1], t_next * kTile, bh);
      }
      stage_row<4>(cs, kc.packed, static_cast<size_t>(bh) * nk, t_next * kTile + krow, nk,
                   kc.k, krow, kpart);
    }
    // Q: QL lanes a row, straight from the codes
    const int qrow = tid >> QL_BITS;
    densify_part<W, QROWS, QL>(qs, qrow, tid & (QL - 1),
                               qc.packed + (static_cast<size_t>(bh) * nq + q0 + qrow) * qc.k,
                               qc.k, q0 + qrow < nq);
    if (t_next < ntiles) {
      staged_wait();
      densify_part<W, kTile, 4>(ks, krow, kpart, staged_row(cs, krow, kc.k), kc.k,
                                t_next * kTile + krow < nk);
    }
    fence_proxy_async();
    __syncthreads();
  }

  const float sl2 = scale * kLog2e;
  float o[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};    // running max (log2 units), rows h = 0, 1
  float l[2] = {0.0f, 0.0f};              // this thread's share of the row sums
  const uint32_t qa = hopper::smem_u32(qs);
  if constexpr (!SPARSE) hopper::mbar_wait(&bar[0], 0);

  int loaded = 0;                           // SPARSE: key tiles loaded so far (ring position)
  for (int t = 0; t < ntiles; ++t) {
    int st, use, lvl = 2;
    if constexpr (SPARSE) {
      lvl = level_of(wg, t);
      const float* vsum_row = vsum + (static_cast<size_t>(bh) * nkb + t) * D;
      if (t != t_next) {                    // no warpgroup computes this tile: nothing loads
        if (lvl == 1) closed_form<D, N>(o, m, l, vsum_row, c0);
        continue;
      }
      st = loaded & 1;
      use = loaded;
      if (loaded > 0) __syncthreads();      // the last tile is consumed; this one is densified
      t_next = next_loaded(t + 1);
      if (t_next < ntiles) {
        if (tid == 0) {
          hopper::mbar_expect_tx(&bar[1 + (st ^ 1)], TK::BYTES);
          TK::load(vs + (st ^ 1) * TK::BYTES, &vmap, &bar[1 + (st ^ 1)], t_next * kTile, bh);
        }
        stage_row<4>(cs, kc.packed, static_cast<size_t>(bh) * nk, t_next * kTile + krow, nk,
                     kc.k, krow, kpart);
      }
      if (lvl == 1) closed_form<D, N>(o, m, l, vsum_row, c0);
    } else {
      st = t & 1;
      use = t;
      if (t > 0) __syncthreads();            // tile t - 1 (stage st ^ 1) is consumed
      if (tid == 0 && t + 1 < ntiles) {
        hopper::mbar_expect_tx(&bar[1 + (st ^ 1)], 2 * TK::BYTES);
        TK::load(ks + (st ^ 1) * TK::BYTES, &kmap, &bar[1 + (st ^ 1)], (t + 1) * kTile, bh);
        TK::load(vs + (st ^ 1) * TK::BYTES, &vmap, &bar[1 + (st ^ 1)], (t + 1) * kTile, bh);
      }
      if (t >= wg_tiles) continue;           // all of this tile is past the warpgroup's rows
    }
    // SPARSE: densify the next loaded key tile into the free stage; with
    // products to run, while P.V is in flight
    auto densify_next = [&]() {
      if (t_next < ntiles) {
        staged_wait();
        densify_part<W, kTile, 4>(ks + (st ^ 1) * TK::BYTES, krow, kpart,
                                  staged_row(cs, krow, kc.k), kc.k, t_next * kTile + krow < nk);
        fence_proxy_async();
      }
    };
    if (lvl == 2) {
      hopper::mbar_wait(&bar[1 + st], (use >> 1) & 1);
      const int k0 = t * kTile;

      float s[32];
      hopper::wgmma_fence();
      mma_abt<D, QROWS>(s, qa, wg * wrow, hopper::smem_u32(ks + st * TK::BYTES));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      const bool edge = k0 + kTile > nk || (causal && k0 + kTile - 1 > r0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * sl2;
        if (edge) {
          const int key = k0 + acc_col(i);
          if (key >= nk || (causal && key > r0 + acc_row(i))) x = -INFINITY;
        }
        s[i] = x;
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
      }
      float corr[2], base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        base[h] = m_new == -INFINITY ? 0.0f : m_new;
        corr[h] = exp2f(m[h] - base[h]);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = exp2f(s[i] - base[(i % 4) / 2]);
        l[(i % 4) / 2] += s[i];
      }
      hopper::fence_regs(o);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) o[i] *= corr[(i % 4) / 2];

      const Split p(s);
      hopper::wgmma_fence();
      mma_xb<W, N>(o, p, hopper::smem_u32(vs + st * TK::BYTES) + TK::column(c0));
      hopper::wgmma_commit();
      if constexpr (SPARSE) densify_next();
      hopper::wgmma_wait<0>();
      if constexpr (SPARSE) keep(p);
      hopper::fence_regs(o);
    } else if constexpr (SPARSE) {
      densify_next();
    }
    if constexpr (SPARSE) ++loaded;
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = fmaxf(quad_sum(l[h]), 1e-30f);
    inv[h] = 1.0f / sum;
    const int r = r0 + acc_row(2 * h);
    if (lse != nullptr && c0 == 0 && tid % 4 == 0 && r < nq)
      lse[static_cast<size_t>(bh) * nq + r] = (m[h] + log2f(sum)) * kLn2;
  }
  store_rows<D>(out, o, static_cast<size_t>(bh) * nq, r0, nq, c0, inv[0], inv[1]);
}

// ---- the backward ------------------------------------------------------------

// dQ: one warpgroup per (bh, 64-query tile), over the key tiles up to the
// causal edge (at d 256 two, a column half of dQ each). Shared: Q, dO, then
// K and V in two stages (SPARSE: and one key tile's codes).
template <int D, bool SPARSE>
__global__ void __launch_bounds__(Width<D>::THREADS, 1)
attention_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap dmap, Codes qc, Codes kc,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dq, int nq, int nk, float scale, int causal,
                           int emit, int rot_dim) {
  constexpr int W = Width<D>::W, N = Width<D>::N, RL = Width<D>::LANES;
  using T = Tile<W, kTile>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar[3];   // Q + dO; K/V stage 0, 1 (SPARSE: dO; V)
  uint8_t* qs = align1024(smem_raw);
  uint8_t* dos = qs + T::BYTES;
  uint8_t* ks = dos + T::BYTES;              // 2 stages
  uint8_t* vs = ks + 2 * T::BYTES;           // 2 stages
  uint32_t* cs = reinterpret_cast<uint32_t*>(vs + 2 * T::BYTES);  // SPARSE: a key tile's codes

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int tiles = (nq + kTile - 1) / kTile;
  const int q0 = (causal ? tiles - 1 - static_cast<int>(blockIdx.y) : blockIdx.y) * kTile;
  const int k_end = causal ? min(nk, q0 + kTile) : nk;
  const int ntiles = (k_end + kTile - 1) / kTile;
  constexpr int LOADS = SPARSE ? 1 : 2;      // TMA tiles per barrier
  // SPARSE: RL lanes (2, 4 at d 256) densify a row
  const int row = tid >> Width<D>::LANE_BITS, part = tid & (RL - 1);
  const int c0 = Width<D>::SPLIT == 1 ? 0 : (tid / kWG) * N;   // the warpgroup's first column

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar[0], LOADS * T::BYTES);
    if (!SPARSE) T::load(qs, &qmap, &bar[0], q0, bh);
    T::load(dos, &dmap, &bar[0], q0, bh);
    hopper::mbar_expect_tx(&bar[1], LOADS * T::BYTES);
    if (!SPARSE) T::load(ks, &kmap, &bar[1], 0, bh);
    T::load(vs, &vmap, &bar[1], 0, bh);
  }
  if constexpr (SPARSE) {
    stage_row<RL>(cs, kc.packed, static_cast<size_t>(bh) * nk, row, nk, kc.k, row, part);
    densify_part<W, kTile, RL>(qs, row, part,
                               qc.packed + (static_cast<size_t>(bh) * nq + q0 + row) * qc.k,
                               qc.k, q0 + row < nq);
    staged_wait();
    densify_part<W, kTile, RL>(ks, row, part, staged_row(cs, row, kc.k), kc.k, row < nk);
    fence_proxy_async();
    __syncthreads();
  }

  const float sl2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + acc_row(2 * h);
    const size_t at = static_cast<size_t>(bh) * nq + min(r, nq - 1);
    lse2[h] = lse[at] * kLog2e;
    dl[h] = delta[at];
  }
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  const uint32_t qa = hopper::smem_u32(qs), da = hopper::smem_u32(dos);
  hopper::mbar_wait(&bar[0], 0);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t > 0) __syncthreads();
    if (tid == 0 && t + 1 < ntiles) {
      hopper::mbar_expect_tx(&bar[1 + (st ^ 1)], LOADS * T::BYTES);
      if (!SPARSE) T::load(ks + (st ^ 1) * T::BYTES, &kmap, &bar[1 + (st ^ 1)], (t + 1) * kTile, bh);
      T::load(vs + (st ^ 1) * T::BYTES, &vmap, &bar[1 + (st ^ 1)], (t + 1) * kTile, bh);
    }
    if constexpr (SPARSE) {
      if (t + 1 < ntiles)
        stage_row<RL>(cs, kc.packed, static_cast<size_t>(bh) * nk, (t + 1) * kTile + row, nk,
                      kc.k, row, part);
    }
    hopper::mbar_wait(&bar[1 + st], (t >> 1) & 1);
    const int k0 = t * kTile;
    const uint32_t ka = hopper::smem_u32(ks + st * T::BYTES);

    float s[32], dp[32];
    hopper::wgmma_fence();
    mma_abt<D, kTile>(s, qa, 0, ka);
    mma_abt<D, kTile>(dp, da, 0, hopper::smem_u32(vs + st * T::BYTES));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    const bool edge = k0 + kTile > nk || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i % 4) / 2;
      float p = exp2f(fmaf(s[i], sl2, -lse2[h]));
      if (edge) {
        const int key = k0 + acc_col(i);
        if (key >= nk || (causal && key > q0 + acc_row(i))) p = 0.0f;
      }
      s[i] = p * (dp[i] - dl[h]) * scale;   // dS
    }
    const Split ds(s);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    mma_xb<W, N>(acc, ds, ka + T::column(c0));
    hopper::wgmma_commit();
    if constexpr (SPARSE) {
      if (t + 1 < ntiles) {                  // the next key tile, while dQ's products run
        staged_wait();
        densify_part<W, kTile, RL>(ks + (st ^ 1) * T::BYTES, row, part,
                                   staged_row(cs, row, kc.k), kc.k, (t + 1) * kTile + row < nk);
        fence_proxy_async();
      }
    }
    hopper::wgmma_wait<0>();
    if constexpr (SPARSE) keep(ds);
    hopper::fence_regs(acc);
  }
  if constexpr (SPARSE) {
    __syncthreads();                         // every product is done: K/V stages are scratch
    emit_grad<D>(dq, acc, static_cast<size_t>(bh) * nq, q0, nq, c0, qc.idx, qc.k, emit,
                 rot_dim, reinterpret_cast<float*>(ks));
  } else {
    store_rows<D>(dq, acc, static_cast<size_t>(bh) * nq, q0, nq, c0, 1.0f, 1.0f);
  }
}

// dK/dV: one warpgroup per (bh, 64-key tile), over the query tiles from the
// causal diagonal (at d 256 two, a column half of dK and dV each). Shared:
// K, V, then Q and dO in two stages (SPARSE: and one query tile's codes),
// and each query tile's LSE and D.
template <int D, bool SPARSE>
__global__ void __launch_bounds__(Width<D>::THREADS, 1)
attention_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap dmap, Codes qc, Codes kc,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int nq, int nk,
                            float scale, int causal, int emit, int rot_dim) {
  constexpr int W = Width<D>::W, N = Width<D>::N, RL = Width<D>::LANES;
  using T = Tile<W, kTile>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar[3];   // K + V; Q/dO stage 0, 1 (SPARSE: V; dO)
  __shared__ float lse_s[2][kTile], dl_s[2][kTile];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + T::BYTES;
  uint8_t* qs = vs + T::BYTES;               // 2 stages
  uint8_t* dos = qs + 2 * T::BYTES;          // 2 stages
  uint32_t* cs = reinterpret_cast<uint32_t*>(dos + 2 * T::BYTES);  // SPARSE: a query tile's codes

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;         // the diagonal's tiles are the longest: y = 0 first
  const int q_first = causal ? k0 : 0;
  const int ntiles = q_first < nq ? (nq - q_first + kTile - 1) / kTile : 0;
  constexpr int LOADS = SPARSE ? 1 : 2;      // TMA tiles per barrier
  // SPARSE: RL lanes (2, 4 at d 256) densify a row
  const int row = tid >> Width<D>::LANE_BITS, part = tid & (RL - 1);
  const int c0 = Width<D>::SPLIT == 1 ? 0 : (tid / kWG) * N;   // the warpgroup's first column

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar[0], LOADS * T::BYTES);
    if (!SPARSE) T::load(ks, &kmap, &bar[0], k0, bh);
    T::load(vs, &vmap, &bar[0], k0, bh);
    if (ntiles > 0) {
      hopper::mbar_expect_tx(&bar[1], LOADS * T::BYTES);
      if (!SPARSE) T::load(qs, &qmap, &bar[1], q_first, bh);
      T::load(dos, &dmap, &bar[1], q_first, bh);
    }
  }
  if constexpr (SPARSE) {
    if (ntiles > 0)
      stage_row<RL>(cs, qc.packed, static_cast<size_t>(bh) * nq, q_first + row, nq, qc.k, row,
                    part);
    densify_part<W, kTile, RL>(ks, row, part,
                               kc.packed + (static_cast<size_t>(bh) * nk + k0 + row) * kc.k,
                               kc.k, k0 + row < nk);
    if (ntiles > 0) {
      staged_wait();
      densify_part<W, kTile, RL>(qs, row, part, staged_row(cs, row, qc.k), qc.k,
                                 q_first + row < nq);
    }
    fence_proxy_async();
    __syncthreads();
  }
  // each query tile's LSE (log2 units) and D: thread i < 64 holds row i of
  // the next tile and stores it ahead of the barrier that opens the tile
  const size_t stat0 = static_cast<size_t>(bh) * nq;
  float lse_next = 0.0f, dl_next = 0.0f;
  if (tid < kTile && q_first + tid < nq) {
    lse_next = lse[stat0 + q_first + tid] * kLog2e;
    dl_next = delta[stat0 + q_first + tid];
  }

  const float sl2 = scale * kLog2e;
  float dka[N / 2], dva[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dka[i] = dva[i] = 0.0f;
  const uint32_t ka = hopper::smem_u32(ks), va = hopper::smem_u32(vs);
  hopper::mbar_wait(&bar[0], 0);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    const int q0 = q_first + t * kTile;
    if (tid < kTile) {                       // stage st was last read two tiles ago
      lse_s[st][tid] = lse_next;
      dl_s[st][tid] = dl_next;
    }
    __syncthreads();                         // tile t - 1 is consumed; this tile's stats are in
    if (tid == 0 && t + 1 < ntiles) {
      hopper::mbar_expect_tx(&bar[1 + (st ^ 1)], LOADS * T::BYTES);
      if (!SPARSE) T::load(qs + (st ^ 1) * T::BYTES, &qmap, &bar[1 + (st ^ 1)], q0 + kTile, bh);
      T::load(dos + (st ^ 1) * T::BYTES, &dmap, &bar[1 + (st ^ 1)], q0 + kTile, bh);
    }
    if constexpr (SPARSE) {
      if (t + 1 < ntiles)
        stage_row<RL>(cs, qc.packed, static_cast<size_t>(bh) * nq, q0 + kTile + row, nq, qc.k,
                      row, part);
    }
    if (tid < kTile && t + 1 < ntiles && q0 + kTile + tid < nq) {
      lse_next = lse[stat0 + q0 + kTile + tid] * kLog2e;
      dl_next = delta[stat0 + q0 + kTile + tid];
    }
    hopper::mbar_wait(&bar[1 + st], (t >> 1) & 1);
    const uint32_t qa = hopper::smem_u32(qs + st * T::BYTES);
    const uint32_t da = hopper::smem_u32(dos + st * T::BYTES);

    float s[32], dp[32];                     // S^T and dP^T: rows keys, columns queries
    hopper::wgmma_fence();
    mma_abt<D, kTile>(s, ka, 0, qa);
    mma_abt<D, kTile>(dp, va, 0, da);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    const bool edge = q0 + kTile > nq || (causal && q0 < k0 + kTile);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i);
      float p = exp2f(fmaf(s[i], sl2, -lse_s[st][c]));
      if (edge) {
        const int qi = q0 + c;
        if (qi >= nq || (causal && k0 + acc_row(i) > qi)) p = 0.0f;
      }
      s[i] = p;                                        // P^T
      dp[i] = p * (dp[i] - dl_s[st][c]) * scale;       // dS^T
    }
    const Split pt(s), dst(dp);
    hopper::fence_regs(dva);
    hopper::fence_regs(dka);
    hopper::wgmma_fence();
    mma_xb<W, N>(dva, pt, da + T::column(c0));
    mma_xb<W, N>(dka, dst, qa + T::column(c0));
    hopper::wgmma_commit();
    // SPARSE: densify the next query tile into the free stage, while the
    // products run where the registers allow (at d 128 the two accumulators
    // and the fragments they read leave no room: after them)
    auto densify_next = [&]() {
      if (t + 1 < ntiles) {
        staged_wait();
        densify_part<W, kTile, RL>(qs + (st ^ 1) * T::BYTES, row, part,
                                   staged_row(cs, row, qc.k), qc.k, q0 + kTile + row < nq);
        fence_proxy_async();
      }
    };
    constexpr bool kOverlap = SPARSE && D <= 64;
    if constexpr (kOverlap) densify_next();
    hopper::wgmma_wait<0>();
    if constexpr (kOverlap) {
      keep(pt);
      keep(dst);
    }
    hopper::fence_regs(dva);
    hopper::fence_regs(dka);
    if constexpr (SPARSE && !kOverlap) densify_next();
  }
  const size_t rows = static_cast<size_t>(bh) * nk;
  store_rows<D>(dv, dva, rows, k0, nk, c0, 1.0f, 1.0f);
  if constexpr (SPARSE) {
    __syncthreads();                         // every product is done: Q/dO stages are scratch
    emit_grad<D>(dk, dka, rows, k0, nk, c0, kc.idx, kc.k, emit, rot_dim,
                 reinterpret_cast<float*>(qs));
  } else {
    store_rows<D>(dk, dka, rows, k0, nk, c0, 1.0f, 1.0f);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
