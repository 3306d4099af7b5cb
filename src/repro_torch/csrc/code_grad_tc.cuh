// code_grad_tc.cuh — the tensor-core bodies of the compact code-gradient
// consumers (bf16 codes): dx = S.W^T and dW^T = S^T.x with each code tile
// densified in shared memory, their pack kernel, launchers and C entry
// points, instantiated by two sources at the head dims each lists in
// CODE_GRAD_TC_DIMS (defined before the include) so that the two compile
// in parallel: code_grad.cu at d in {32, 64, 128}, code_grad_wide.cu at 80
// (hubert-xlarge) and 256 (paligemma-3b). They replace the TPU kernels
// repro/kernels/code_grad.py::code_grad_dx (_dx_kernel) and ::code_grad_dw
// (_dw_kernel); the contract and the CUDA-core bodies are code_grad.cu's.
// Also the ordered sum of dW's token splits, which the CUDA-core dW shares.
#pragma once

#include <type_traits>

#include "hopper.cuh"

#ifndef CODE_GRAD_TC_DIMS
#error "define CODE_GRAD_TC_DIMS (the head dims this source instantiates) before the include"
#endif

namespace {

// out[e] = sum_s part[s][e], s in order
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  size_t count, int splits) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float v = 0.0f;
  for (int s = 0; s < splits; ++s) v += part[static_cast<size_t>(s) * count + e];
  out[e] = v;
}

// ---- dW on the tensor cores (bf16) -------------------------------------------
//
// dW^T (H.d x m) = S^T (H.d x n) . x (n x m), S the densified codes of all
// heads side by side: one GEMM whose reduction is the token axis.
//  * A pack kernel first reads each (head, token) row of kw codes once and
//    resolves its repeated indices: the first occurrence of an index in
//    [0, d) gets the word index << 16 | bf16 hi of the f32 sum (in code
//    order) of the row's codes at that index, and lo = bf16(sum - hi) where
//    the sum is not a bf16 (~16 bits of a summed duplicate, an f32 value
//    that is not an input); every other code gets no index. Codes without a
//    duplicate are bf16 inputs, exact in hi. The dense kernel then stores
//    each word as it comes, so its per-chunk densify is one store per code
//    where comparing a row's codes against each other in the kernel cost
//    O(kw^2) per row in every one of the m / 128 blocks that reads it.
//  * A block owns 128 feature rows (128 / d heads; at d 80 one head in rows
//    0-79, rows 80-127 zero; at d 256 a head's 128-feature half, two blocks
//    densifying their own features from the same packed rows: DwRows) by
//    128 columns of m, two warpgroups of 64 feature rows each, and walks its token split in
//    chunks of 64 tokens (four k16 steps). A = the chunk's S^T, 128 feature
//    rows x 64 token columns, densified by all 256 threads (d / 32 a code
//    row, each a share of its words) into the swizzled K-major layout TMA
//    would write (hopper::Tile<64, 128>), hi and lo in two tiles; every
//    (feature, token) cell has one writer. B = the x chunk, 64 token rows x
//    128 columns, by TMA (zero fill past n and m), the MN-major operand of
//    Mma<128>::ss_mn. The lo products run only if the pack kernel found a
//    nonzero lo anywhere in the call (the codes rtopk emits repeat only
//    zero-valued padding, whose sums are exact): the chunk loop exists
//    twice, with and without them, and the choice is made once. A wgmma
//    under a branch ptxas cannot prove uniform is serialized (C7520, 0.10
//    ms on the path below), and choosing per chunk behind a __shfl_sync'd
//    flag ran slower on the card than always running both products.
//  * Per chunk c: the products of c are issued; each warpgroup waits for
//    its products of c - 1 and zeroes its half of their S stage (16-byte
//    stores); one barrier; the x tile and packed rows of chunk c + 3 are
//    issued (TMA; cp.async, each row's 16-byte pieces shared by its
//    threads); chunk c + 1 is densified into the zeroed stage;
//    fence.proxy.async, one barrier. So the products of c run while c + 1
//    is densified, and c + 1's are issued before c's are done.
// x is read once per feature tile (6 times for gpt2-small's 12 heads of
// 64), from L2 after the first. At kw 32 a chunk's packed rows are twice
// kw 16's (12,288 bytes a stage at d 128, 24,576 at d 64: 181,280 and
// 230,432 bytes of shared memory in all). Each split writes its partial, and
// sum_splits_kernel adds the splits in order: no atomics, a deterministic
// result.
// Bound on the H100: operations, 2 d flops per (token, column, head) on the
// tensor cores (the lo products, where they run, double what the body
// runs).

constexpr int kTcRows = 128;     // feature rows of a block: two warpgroups of 64
constexpr int kTcCols = 128;     // columns of m of a block: the wgmma N
constexpr int kTcTok = 64;       // tokens of a chunk: four k16 steps
constexpr int kTcStages = 4;     // x tiles and packed rows: chunks c .. c + 3
constexpr int kTcThreads = 256;
constexpr uint32_t kNoIndex = 0xFFFF0000u;   // a packed word that stores nothing
using STile = hopper::Tile<kTcTok, kTcRows>;   // S^T chunk: feature rows x token columns
using XTile = hopper::Tile<kTcCols, kTcTok>;   // x chunk: token rows x 128 columns of m

// The (d, kw) the tensor-core bodies take: d in {32, 64, 80, 128, 256}
// with kw in {8, 16}, and kw 32 (the RoPE pair closure at k 16) at every d
// but 32. At d 32 a dW chunk holds 256 packed rows, and four stages of
// 32-wide rows with the S^T and x tiles need 328,736 bytes of shared
// memory, over the 232,448 a block may use: that shape runs the CUDA-core
// bodies. Each source builds the d of its CODE_GRAD_TC_DIMS.
constexpr bool tc_shape(int d, int kw) {
  return (d == 32 || d == 64 || d == 80 || d == 128 || d == 256) &&
         (kw == 8 || kw == 16 || (kw == 32 && d != 32));
}

// dW's block of kTcRows feature rows at head dim D: a head takes SLOT rows
// of it (D, or all kTcRows where D does not divide them: 80 in 128 rows,
// rows 80-127 zero; 256 in two blocks of 128), HPB heads a block, BPH
// blocks a head
template <int D>
struct DwRows {
  static constexpr int SLOT = D <= kTcRows && kTcRows % D == 0 ? D : kTcRows;
  static constexpr int HPB = kTcRows / SLOT;
  static constexpr int BPH = (D + kTcRows - 1) / kTcRows;
};
// dx's step of F head features at head dim D: 64 where it divides D, else
// 32 (80: three steps, features 80-95 zero); STEPS a head
template <int D>
struct DxSteps {
  static constexpr int F = D % 64 == 0 ? 64 : 32;
  static constexpr int STEPS = (D + F - 1) / F;
};

__device__ __forceinline__ void sts_u16(uint32_t addr, unsigned short bits) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(bits));
}
__device__ __forceinline__ void sts_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr), "r"(0u));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the densify's generic-proxy stores, made visible to wgmma's async proxy
// (a barrier must follow before the product)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// BYTES (4, 8 or a multiple of 16) bytes at p, aligned to min(16, BYTES),
// as 32-bit words
template <int BYTES>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[BYTES / 4]) {
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = q.x;
      w[4 * i + 1] = q.y;
      w[4 * i + 2] = q.z;
      w[4 * i + 3] = q.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    w[0] = q.x;
    w[1] = q.y;
  } else {
    static_assert(BYTES == 4, "4, 8 or a multiple of 16 bytes");
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// codes (rows, KW) -> words (rows, KW) uint32 and lo (rows, KW) bf16 bits,
// one thread a row: see the note above; *lo_any (zeroed by the caller)
// becomes 1 if any lo is nonzero
template <int KW>
__global__ void pack_dw_codes_kernel(const __nv_bfloat16* __restrict__ vals,
                                     const int32_t* __restrict__ idx, uint32_t* __restrict__ words,
                                     uint16_t* __restrict__ lo, int* __restrict__ lo_any,
                                     long long rows, int d) {
  uint32_t mine = 0;   // some row of this thread has a nonzero lo
  for (long long row = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       row < rows; row += static_cast<long long>(gridDim.x) * blockDim.x) {
    uint32_t iw[KW], vw[KW / 2];
    load_words<KW * 4>(idx + row * KW, iw);
    load_words<KW * 2>(vals + row * KW, vw);
    int id[KW];
    float v[KW];
#pragma unroll
    for (int u = 0; u < KW; ++u) {
      const int x = static_cast<int>(iw[u]);
      id[u] = x >= 0 && x < d ? x : -1;
      v[u] = __uint_as_float(u % 2 ? vw[u / 2] & 0xffff0000u : vw[u / 2] << 16);
    }
    uint32_t ow[KW], ol[KW / 2];
#pragma unroll
    for (int u = 0; u < KW / 2; ++u) ol[u] = 0;
#pragma unroll
    for (int u = 0; u < KW; ++u) {
      bool first = id[u] >= 0;
#pragma unroll
      for (int w = 0; w < u; ++w) first = first && id[w] != id[u];
      float sum = v[u];   // the f32 sum of the index's codes, in code order
#pragma unroll
      for (int w = u + 1; w < KW; ++w)
        if (id[w] == id[u]) sum = __fadd_rn(sum, v[w]);
      const __nv_bfloat16 h = __float2bfloat16_rn(sum);
      const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(__fsub_rn(sum, __bfloat162float(h))));
      ow[u] = first ? (static_cast<uint32_t>(id[u]) << 16) | __bfloat16_as_ushort(h) : kNoIndex;
      ol[u / 2] |= (first ? l : 0u) << (16 * (u % 2));
    }
#pragma unroll
    for (int i = 0; i < KW / 4; ++i)
      reinterpret_cast<uint4*>(words + row * KW)[i] =
          make_uint4(ow[4 * i], ow[4 * i + 1], ow[4 * i + 2], ow[4 * i + 3]);
#pragma unroll
    for (int i = 0; i < KW / 8; ++i) {
      reinterpret_cast<uint4*>(lo + row * KW)[i] =
          make_uint4(ol[4 * i], ol[4 * i + 1], ol[4 * i + 2], ol[4 * i + 3]);
      mine |= ol[4 * i] | ol[4 * i + 1] | ol[4 * i + 2] | ol[4 * i + 3];
    }
  }
  if (__syncthreads_or(mine != 0) && threadIdx.x == 0) atomicOr(lo_any, 1);
}

// byte offset of cell (row r, column c) of a swizzled bf16 tile with C <= 64
// columns a row, one swizzle span (hopper::Tile<C, ROWS>: 128-byte rows and
// swizzle for C = 64, 64-byte for C = 32; the tile sits on a 1024-byte
// boundary). dW's S^T tile is cell<64>(feature row, token).
template <int C>
__device__ __forceinline__ uint32_t cell(int r, int c) {
  constexpr int SW = C * 2;
  static_assert(SW == 64 || SW == 128, "one swizzle span of 64 or 128 bytes a row");
  const uint32_t swz = (SW == 128 ? (r & 7) : ((r >> 1) & 3)) << 4;
  return r * SW + ((c * 2) ^ swz);
}

template <int D, int KW>
__global__ void __launch_bounds__(kTcThreads, 1)
code_grad_dw_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                       const uint32_t* __restrict__ words, const uint16_t* __restrict__ lo_bits,
                       const int* __restrict__ lo_any, float* __restrict__ part, int nh,
                       int ntok, int m, int split_len) {
  static_assert(KW % 8 == 0, "a packed row is whole 16-byte pieces of lo bits");
  using Rows = DwRows<D>;
  constexpr int ROWS = kTcTok * Rows::HPB;       // (token, head) code rows of a chunk
  constexpr int P = kTcThreads / ROWS;           // threads a row (d / 32)
  constexpr int U = KW / P;                      // words of a thread's share
  constexpr int PIECES = KW / 8 + KW / 4;        // 16-byte pieces of a row: lo, words
  constexpr int CSTAGE = ROWS * KW * 6;          // bytes of a chunk's packed rows
  static_assert(KW % P == 0, "a row's words share out evenly");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_hi = base;                              // 2 stages of S^T, hi
  uint8_t* s_lo = s_hi + 2 * STile::BYTES;           // 2 stages of S^T, lo
  uint8_t* xs = s_lo + 2 * STile::BYTES;             // kTcStages x tiles
  uint8_t* codes = xs + kTcStages * XTile::BYTES;    // kTcStages x (ROWS, KW) lo, words
  uint64_t* bar = reinterpret_cast<uint64_t*>(codes + kTcStages * CSTAGE);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // the block's heads from head0 on, their features from fo on
  const int head0 = Rows::BPH == 1 ? blockIdx.x * Rows::HPB : blockIdx.x / Rows::BPH;
  const int fo = Rows::BPH == 1 ? 0 : (blockIdx.x % Rows::BPH) * kTcRows;
  const int m0 = blockIdx.y * kTcCols;
  const int t_begin = blockIdx.z * split_len;
  const int t_end = min(ntok, t_begin + split_len);
  const int nc = t_end > t_begin ? (t_end - t_begin + kTcTok - 1) / kTcTok : 0;
  // packed row r = (token slot wt, head slot hs), share sh of its words
  const int r = tid % ROWS;
  const int sh = tid / ROWS;
  const int wt = r % kTcTok;
  const int hs = r / kTcTok;
  const int head = head0 + hs;
  auto live = [&](int c) {
    return head < nh && c < nc && t_begin + c * kTcTok + wt < t_end;
  };
  auto codes_of = [&](int c) { return codes + (c % kTcStages) * CSTAGE; };

  for (int o = tid * 16; o < 4 * STile::BYTES; o += kTcThreads * 16)
    sts_zero16(hopper::smem_u32(s_hi) + o);
  if (tid == 0) {
    for (int i = 0; i < kTcStages; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // chunk c's x tile (thread 0) and packed rows (a row's threads share its
  // pieces); one commit group per chunk and thread, empty or not
  auto load = [&](int c) {
    if (tid == 0 && c < nc) {
      uint8_t* dst = xs + (c % kTcStages) * XTile::BYTES;
      uint64_t* b = &bar[c % kTcStages];
      hopper::mbar_expect_tx(b, XTile::BYTES);
#pragma unroll
      for (int ch = 0; ch < XTile::CHUNKS; ++ch)
        hopper::tma_load_3d(dst + ch * kTcTok * XTile::SW, &xmap, b, m0 + ch * XTile::CHUNK,
                            t_begin + c * kTcTok, 0);
    }
    if (live(c)) {
      const size_t row = (static_cast<size_t>(head) * ntok + t_begin + c * kTcTok + wt) * KW;
      const uint32_t cs = hopper::smem_u32(codes_of(c));
      for (int q = sh; q < PIECES; q += P) {
        if (q < KW / 8)
          cp_async16(cs + (r * KW + 8 * q) * 2, lo_bits + row + 8 * q);
        else
          cp_async16(cs + ROWS * KW * 2 + (r * KW + 4 * (q - KW / 8)) * 4,
                     words + row + 4 * (q - KW / 8));
      }
    }
    cp_async_commit();
  };
  // the thread's share of chunk c's packed row into S stage c & 1
  auto scatter = [&](int c) {
    if (!live(c)) return;
    uint32_t w[U], l[(U + 1) / 2];
    load_words<U * 4>(codes_of(c) + ROWS * KW * 2 + (r * KW + sh * U) * 4, w);
    load_words<U * 2>(codes_of(c) + (r * KW + sh * U) * 2, l);
    const uint32_t hi = hopper::smem_u32(s_hi + (c & 1) * STile::BYTES);
    const uint32_t lo = hopper::smem_u32(s_lo + (c & 1) * STile::BYTES);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t id = w[u] >> 16;
      const uint32_t f = id - fo;              // no index (0xFFFF) or another block's: >= SLOT
      if (f < static_cast<uint32_t>(Rows::SLOT) && id < static_cast<uint32_t>(D)) {
        const uint32_t off = cell<kTcTok>(hs * Rows::SLOT + f, wt);
        sts_u16(hi + off, static_cast<unsigned short>(w[u] & 0xffffu));
        const uint32_t lb = (l[u / 2] >> (16 * (u % 2))) & 0xffffu;
        if (lb != 0) sts_u16(lo + off, static_cast<unsigned short>(lb));
      }
    }
  };
  // this warpgroup's 64 rows of S stage st zeroed, hi (and lo)
  auto zero_half = [&](int st, auto with_lo) {
    const uint32_t o = st * STile::BYTES + wg * (STile::BYTES / 2) + (tid % 128) * 16;
#pragma unroll
    for (int k = 0; k < STile::BYTES / 2; k += 128 * 16) {
      sts_zero16(hopper::smem_u32(s_hi) + o + k);
      if constexpr (decltype(with_lo)::value) sts_zero16(hopper::smem_u32(s_lo) + o + k);
    }
  };

  for (int c = 0; c < kTcStages - 1; ++c) load(c);
  cp_async_wait<kTcStages - 2>();
  __syncthreads();
  scatter(0);
  fence_proxy_async();
  __syncthreads();
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  hopper::fence_regs(acc);
  // the chunks, with the lo products (with_lo true) or without: one loop
  // each, chosen once for the whole call, so no wgmma sits under a branch
  auto run = [&](auto with_lo) {
    for (int c = 0; c < nc; ++c) {
      const uint32_t a_hi = hopper::smem_u32(s_hi + (c & 1) * STile::BYTES);
      const uint32_t a_lo = hopper::smem_u32(s_lo + (c & 1) * STile::BYTES);
      const uint32_t b = hopper::smem_u32(xs + (c % kTcStages) * XTile::BYTES);
      hopper::mbar_wait(&bar[c % kTcStages], (c / kTcStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::Mma<128>::ss_mn(acc, STile::kmajor(a_hi, 64 * wg, kk), XTile::mnmajor(b, kk), 1);
      if constexpr (decltype(with_lo)::value) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::Mma<128>::ss_mn(acc, STile::kmajor(a_lo, 64 * wg, kk), XTile::mnmajor(b, kk), 1);
      }
      hopper::wgmma_commit();
      // this warpgroup's products of c - 1 are done: zero its rows of their
      // stage, the one chunk c + 1 is densified into
      hopper::wgmma_wait<1>();
      if (c > 0) zero_half((c + 1) & 1, with_lo);
      cp_async_wait<kTcStages - 3>();
      __syncthreads();   // all products of c - 1 done; the stage zeroed; c + 1's rows landed
      load(c + kTcStages - 1);
      scatter(c + 1);
      fence_proxy_async();
      __syncthreads();   // chunk c + 1 densified
    }
  };
  // lo_any is one value for the whole call; __shfl_sync lets ptxas see it
  // uniform over the warp
  if (__shfl_sync(0xffffffffu, *lo_any, 0))
    run(std::true_type{});
  else
    run(std::false_type{});
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // this split's block of dW, the accumulator transposed: block row f of
  // S^T is column fo + f % SLOT of head head0 + f / SLOT (a padding row, at
  // or past D, is dropped)
  float* dst = part + static_cast<size_t>(blockIdx.z) * nh * m * D;
  const int lane = tid % 32;
  const int r0 = 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
  const int c0 = m0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int f = r0 + 8 * ((i % 4) / 2);
    const int j = c0 + 8 * (i / 4) + (i % 2);
    const int h = head0 + f / Rows::SLOT, c = fo + f % Rows::SLOT;
    if (h < nh && c < D && j < m) dst[(static_cast<size_t>(h) * m + j) * D + c] = acc[i];
  }
}

// ---- dx on the tensor cores (bf16 codes) -------------------------------------
//
// dx (n x m) = S (n x H.d) . W^T (H.d x m): one GEMM whose reduction is the
// head-feature axis, each head's S_h densified from its codes.
//  * The codes go through pack_dw_codes_kernel as for dW (each row's
//    repeated indices resolved once into idx << 16 | bf16 hi words and lo
//    bits, the flag of a nonzero lo). w, f32 on the compact seam, is split
//    once per call into contiguous (H, m, d) bf16 hi and lo = bf16(w - hi)
//    (hopper::w_heads_bf16): bf16 w alone would lose about 2^-9 of every product,
//    which fails dx's 1e-4; a bf16 w has no lo and skips those products.
//  * A block owns 128 tokens x 128 columns of m, two warpgroups of 64
//    tokens, and walks the heads in order, each in steps of F = 64 features
//    where 64 divides d (d 128: two steps a head, d 256 four), else 32 (d
//    32: one; d 80: three, the third holding features 64-79 and zero S
//    columns 80-95, against w columns that TMA fills with zeros past d:
//    DxSteps), every output with one owner and
//    no split: no atomics, a deterministic result. A = the step's S tile,
//    128 token rows x F features, densified into the swizzled K-major
//    layout (hopper::Tile<F, 128>) by all 256 threads, two a code row, hi
//    and lo in two tiles; B = the step's w_h hi (and lo) tile, 128 rows of
//    m x F features, K-major, by TMA (zero fill past m). Products: S_hi.W_hi
//    + S_hi.W_lo (f32 w) + S_lo.W_hi (where the pack kernel found a nonzero
//    lo: the loop exists twice and the choice is made once per call, as for
//    dW; S_lo.W_lo, below 2^-16 of a product, is left out), F / 16
//    Mma<128>::ss steps each.
//  * The schedule is dW's with heads for chunks: per step s the products of
//    s are issued; each warpgroup waits for its products of s - 1 and zeroes
//    its 64 rows of their S stage; one barrier; the w tiles and packed rows
//    of step s + 2 are issued (TMA; cp.async, each row's 16-byte pieces
//    shared by its threads); step s + 1 is densified into the zeroed stage;
//    fence.proxy.async, one barrier.
//  * A head's packed rows are staged once, with its first step, and serve
//    its d / F steps (d 128: two), so each code row is read once per block.
//    The rows of the head of step s + 2 land while step s + 1's are
//    densified, and those of the head two heads back were densified before
//    the barrier that precedes the load: two stages of rows suffice. Widths
//    8 and 16 keep three (the layout they were tuned in); width 32 takes two
//    (kDxCodeStages), since three stages of 128 x 32 packed rows with the S
//    and w tiles need 238,616 bytes at F = 64, over the 232,448 a block may
//    use (two: 214,040). The w tiles keep three stages: the products of
//    step s read theirs while s + 1's arrive and s + 2's are issued.
// Three other schedules ran slower on an H100 SXM (700 W) at gpt2-small's
// shapes (this kernel 0.0619-0.0626 ms): A = S built in each thread's
// registers from the codes for wgmma's RS form, no S tile (0.1137 ms; 240-255
// registers, the per-code register selects); A = w loaded and split in
// registers, B = S in shared memory (dx^T; 0.1196 ms); and each warpgroup
// densifying its own rows behind a 128-thread barrier, the w ring handed over
// by empty barriers (0.0926 ms).
// Bound on the H100: operations, 2 d flops per (token, column, head) on the
// tensor cores (the lo products double or triple what the body runs).

constexpr int kDxTcTok = 128;      // tokens of a block: two warpgroups of 64
constexpr int kDxTcCols = 128;     // columns of m of a block: the wgmma N
constexpr int kDxTcStages = 3;     // w tiles (and packed rows below kw 32): steps s .. s + 2

// stages of packed rows of the dx body at code width KW (see above)
template <int KW>
constexpr int kDxCodeStages = KW > 16 ? 2 : kDxTcStages;

template <int D, int KW, bool W_LO>
__global__ void __launch_bounds__(kTcThreads, 1)
code_grad_dx_tc_kernel(const __grid_constant__ CUtensorMap hi_map,
                       const __grid_constant__ CUtensorMap lo_map,
                       const uint32_t* __restrict__ words, const uint16_t* __restrict__ lo_bits,
                       const int* __restrict__ lo_any, float* __restrict__ out, int nh, int ntok,
                       int m) {
  constexpr int F = DxSteps<D>::F;               // features of a step
  constexpr int HALVES = DxSteps<D>::STEPS;      // steps of a head
  using T = hopper::Tile<F, kDxTcTok>;           // S and w tiles: 128 rows x F features
  constexpr int P = kTcThreads / kDxTcTok;       // threads a code row
  constexpr int U = KW / P;                      // words of a thread's share
  constexpr int PIECES = KW / 8 + KW / 4;        // 16-byte pieces of a row: lo, words
  constexpr int CSTAGE = kDxTcTok * KW * 6;      // bytes of a step's packed rows
  constexpr int CST = kDxCodeStages<KW>;         // stages of packed rows
  static_assert(KW % 8 == 0 && KW % P == 0 && T::CHUNKS == 1, "one swizzle span a row");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_hi = base;                                  // 2 stages of S, hi
  uint8_t* s_lo = s_hi + 2 * T::BYTES;                   // 2 stages of S, lo
  uint8_t* w_hi = s_lo + 2 * T::BYTES;                   // kDxTcStages w tiles, hi
  uint8_t* w_lo = w_hi + kDxTcStages * T::BYTES;         // kDxTcStages w tiles, lo
  uint8_t* codes = w_lo + kDxTcStages * T::BYTES;        // CST x (128, KW) lo, words
  uint64_t* bar = reinterpret_cast<uint64_t*>(codes + CST * CSTAGE);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t0 = blockIdx.x * kDxTcTok;
  const int m0 = blockIdx.y * kDxTcCols;
  const int steps = nh * HALVES;
  // packed row r = token t0 + r, share sh of its words; a head's rows are
  // staged once, with its first step, and serve its HALVES steps
  const int r = tid % kDxTcTok;
  const int sh = tid / kDxTcTok;
  auto live = [&](int s) { return s < steps && t0 + r < ntok; };
  auto codes_of = [&](int s) { return codes + ((s / HALVES) % CST) * CSTAGE; };

  for (int o = tid * 16; o < 4 * T::BYTES; o += kTcThreads * 16)
    sts_zero16(hopper::smem_u32(s_hi) + o);
  if (tid == 0) {
    for (int i = 0; i < kDxTcStages; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // step s's w tiles (thread 0) and, at a head's first step, its packed
  // rows (a row's threads share their pieces); one commit group per step
  // and thread, empty or not
  auto load = [&](int s) {
    if (tid == 0 && s < steps) {
      const int st = s % kDxTcStages;
      uint64_t* b = &bar[st];
      hopper::mbar_expect_tx(b, (W_LO ? 2 : 1) * T::BYTES);
      hopper::tma_load_3d(w_hi + st * T::BYTES, &hi_map, b, (s % HALVES) * F, m0, s / HALVES);
      if constexpr (W_LO)
        hopper::tma_load_3d(w_lo + st * T::BYTES, &lo_map, b, (s % HALVES) * F, m0, s / HALVES);
    }
    if (live(s) && s % HALVES == 0) {
      const size_t row = (static_cast<size_t>(s / HALVES) * ntok + t0 + r) * KW;
      const uint32_t cs = hopper::smem_u32(codes_of(s));
      for (int q = sh; q < PIECES; q += P) {
        if (q < KW / 8)
          cp_async16(cs + (r * KW + 8 * q) * 2, lo_bits + row + 8 * q);
        else
          cp_async16(cs + kDxTcTok * KW * 2 + (r * KW + 4 * (q - KW / 8)) * 4,
                     words + row + 4 * (q - KW / 8));
      }
    }
    cp_async_commit();
  };
  // the thread's share of step s's packed row into S stage s & 1: the codes
  // whose index falls in the step's F features
  auto scatter = [&](int s) {
    if (!live(s)) return;
    uint32_t w[U], l[(U + 1) / 2];
    load_words<U * 4>(codes_of(s) + kDxTcTok * KW * 2 + (r * KW + sh * U) * 4, w);
    load_words<U * 2>(codes_of(s) + (r * KW + sh * U) * 2, l);
    const uint32_t hi = hopper::smem_u32(s_hi + (s & 1) * T::BYTES);
    const uint32_t lo = hopper::smem_u32(s_lo + (s & 1) * T::BYTES);
    const uint32_t f0 = (s % HALVES) * F;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t f = (w[u] >> 16) - f0;    // no index (0xFFFF) or another step's: >= F
      if (f < static_cast<uint32_t>(F)) {
        const uint32_t off = cell<F>(r, f);
        sts_u16(hi + off, static_cast<unsigned short>(w[u] & 0xffffu));
        const uint32_t lb = (l[u / 2] >> (16 * (u % 2))) & 0xffffu;
        if (lb != 0) sts_u16(lo + off, static_cast<unsigned short>(lb));
      }
    }
  };
  // this warpgroup's 64 rows of S stage st zeroed, hi (and lo)
  auto zero_half = [&](int st, auto with_lo) {
    const uint32_t o = st * T::BYTES + wg * (T::BYTES / 2) + (tid % 128) * 16;
#pragma unroll
    for (int k = 0; k < T::BYTES / 2; k += 128 * 16) {
      sts_zero16(hopper::smem_u32(s_hi) + o + k);
      if constexpr (decltype(with_lo)::value) sts_zero16(hopper::smem_u32(s_lo) + o + k);
    }
  };

  for (int s = 0; s < kDxTcStages - 1; ++s) load(s);
  cp_async_wait<kDxTcStages - 2>();
  __syncthreads();
  scatter(0);
  fence_proxy_async();
  __syncthreads();
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  hopper::fence_regs(acc);
  // the steps, with the S lo products (with_lo true) or without: one loop
  // each, chosen once for the whole call, so no wgmma sits under a branch
  auto run = [&](auto with_lo) {
    for (int s = 0; s < steps; ++s) {
      const int st = s % kDxTcStages;
      const uint32_t a_hi = hopper::smem_u32(s_hi + (s & 1) * T::BYTES);
      const uint32_t a_lo = hopper::smem_u32(s_lo + (s & 1) * T::BYTES);
      const uint32_t b_hi = hopper::smem_u32(w_hi + st * T::BYTES);
      const uint32_t b_lo = hopper::smem_u32(w_lo + st * T::BYTES);
      hopper::mbar_wait(&bar[st], (s / kDxTcStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F / 16; ++kk) {
        hopper::Mma<128>::ss(acc, T::kmajor(a_hi, 64 * wg, kk), T::kmajor(b_hi, 0, kk), 1);
        if constexpr (W_LO)
          hopper::Mma<128>::ss(acc, T::kmajor(a_hi, 64 * wg, kk), T::kmajor(b_lo, 0, kk), 1);
        if constexpr (decltype(with_lo)::value)
          hopper::Mma<128>::ss(acc, T::kmajor(a_lo, 64 * wg, kk), T::kmajor(b_hi, 0, kk), 1);
      }
      hopper::wgmma_commit();
      // this warpgroup's products of s - 1 are done: zero its rows of their
      // S stage, the one step s + 1 is densified into
      hopper::wgmma_wait<1>();
      if (s > 0) zero_half((s + 1) & 1, with_lo);
      cp_async_wait<kDxTcStages - 3>();
      __syncthreads();   // all products of s - 1 done; the stage zeroed; s + 1's rows landed
      load(s + kDxTcStages - 1);
      scatter(s + 1);
      fence_proxy_async();
      __syncthreads();   // step s + 1 densified
    }
  };
  // lo_any is one value for the whole call; __shfl_sync lets ptxas see it
  // uniform over the warp
  if (__shfl_sync(0xffffffffu, *lo_any, 0))
    run(std::true_type{});
  else
    run(std::false_type{});
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // the block's (128, 128) tile of dx: row 64 wg + 16 w + l/4 (+8), columns
  // 8j + 2(l%4) and + 1 (m is even: both or neither in range)
  const int lane = tid % 32;
  const int row0 = t0 + 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
  const int col0 = m0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int t = row0 + 8 * ((i % 4) / 2);
    const int j = col0 + 8 * (i / 4);
    if (t < ntok && j < m)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(t) * m + j) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// The head dims of this source: membership, and a call of f with the dim
// as a compile-time constant (cudaErrorInvalidValue for another d)
template <int... DS>
struct Dims {
  static bool has(int d) { return ((d == DS) || ...); }
  template <class F>
  static int call(int d, F&& f) {
    int e = static_cast<int>(cudaErrorInvalidValue);
    (void)((d == DS ? (e = f(std::integral_constant<int, DS>{}), true) : false) || ...);
    return e;
  }
};
using Bodies = Dims<CODE_GRAD_TC_DIMS>;

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D, int KW>
int launch_dw_tc(const CUtensorMap& map, const uint32_t* words, const uint16_t* lo,
                 const int* lo_any, float* dst, int nh, int ntok, int m, int splits,
                 int split_len, cudaStream_t stream) {
  const size_t smem = 1024 + 4 * STile::BYTES + kTcStages * XTile::BYTES +
                      static_cast<size_t>(kTcStages) * kTcTok * DwRows<D>::HPB * KW * 6 +
                      kTcStages * sizeof(uint64_t);
  auto kernel = code_grad_dw_tc_kernel<D, KW>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((nh + DwRows<D>::HPB - 1) / DwRows<D>::HPB * DwRows<D>::BPH,
                  (m + kTcCols - 1) / kTcCols, splits);
  kernel<<<grid, kTcThreads, smem, stream>>>(map, words, lo, lo_any, dst, nh, ntok, m,
                                             split_len);
  return static_cast<int>(cudaGetLastError());
}

// the pack kernel over (nh, ntok) code rows, after zeroing the lo flag
template <int KW>
int pack_codes(const void* vals, const void* idx, uint32_t* words, uint16_t* lo, int* lo_any,
               int nh, int ntok, int d, cudaStream_t stream) {
  const long long rows = static_cast<long long>(nh) * ntok;
  const long long want = (rows + 255) / 256;
  cudaError_t e = cudaMemsetAsync(lo_any, 0, sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  pack_dw_codes_kernel<KW><<<static_cast<int>(want < 132LL * 16 ? want : 132LL * 16), 256, 0,
                             stream>>>(static_cast<const __nv_bfloat16*>(vals),
                                       static_cast<const int32_t*>(idx), words, lo, lo_any,
                                       rows, d);
  return static_cast<int>(cudaGetLastError());
}

template <int KW>
int launch_dw_tc_kw(const CUtensorMap& map, const void* vals, const void* idx, uint32_t* words,
                    uint16_t* lo, int* lo_any, float* dst, int nh, int ntok, int m, int d,
                    int splits, int split_len, cudaStream_t stream) {
  const int e = pack_codes<KW>(vals, idx, words, lo, lo_any, nh, ntok, d, stream);
  if (e != 0) return e;
  return Bodies::call(d, [&](auto D) {
    if constexpr (tc_shape(decltype(D)::value, KW))
      return launch_dw_tc<decltype(D)::value, KW>(map, words, lo, lo_any, dst, nh, ntok, m,
                                                  splits, split_len, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

template <int D, int KW, bool W_LO>
int launch_dx_tc(const CUtensorMap& hi, const CUtensorMap& lo, const uint32_t* words,
                 const uint16_t* lo_bits, const int* lo_any, float* out, int nh, int ntok, int m,
                 cudaStream_t stream) {
  using T = hopper::Tile<DxSteps<D>::F, kDxTcTok>;
  const size_t smem = 1024 + (4 + 2 * kDxTcStages) * T::BYTES +
                      static_cast<size_t>(kDxCodeStages<KW>) * kDxTcTok * KW * 6 +
                      kDxTcStages * sizeof(uint64_t);
  auto kernel = code_grad_dx_tc_kernel<D, KW, W_LO>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((ntok + kDxTcTok - 1) / kDxTcTok, (m + kDxTcCols - 1) / kDxTcCols);
  kernel<<<grid, kTcThreads, smem, stream>>>(hi, lo, words, lo_bits, lo_any, out, nh, ntok, m);
  return static_cast<int>(cudaGetLastError());
}

template <int KW, bool W_LO>
int launch_dx_tc_d(int d, const CUtensorMap& hi, const CUtensorMap& lo, const uint32_t* words,
                   const uint16_t* lo_bits, const int* lo_any, float* out, int nh, int ntok,
                   int m, cudaStream_t stream) {
  return Bodies::call(d, [&](auto D) {
    if constexpr (tc_shape(decltype(D)::value, KW))
      return launch_dx_tc<decltype(D)::value, KW, W_LO>(hi, lo, words, lo_bits, lo_any, out, nh,
                                                        ntok, m, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

}  // namespace

// The tensor-core body: x (ntok, m), vals (nh, ntok, kw) bf16 and idx
// (nh, ntok, kw) int32, contiguous and 16-byte aligned; (d, kw) a tc_shape
// with d in CODE_GRAD_TC_DIMS, m a multiple of 8; out (nh, m, d) f32; part (splits, nh,
// m, d) f32 scratch, unused when splits == 1; packed: scratch of nh * ntok
// * kw * 6 + 16 bytes, 16-byte aligned (the pack kernel's words, its lo
// bits, then the flag of a nonzero lo).
// Split s takes tokens [s * split_len, (s + 1) * split_len): split_len a
// multiple of 64, every split non-empty. Launches the pack kernel, the
// dense kernel and (splits > 1) the ordered sum; returns the last launch's
// cudaGetLastError().
extern "C" int code_grad_dw_tc_launch(const void* x, const void* vals, const void* idx,
                                      void* out, void* part, void* packed, int nh, int ntok,
                                      int kw, int m, int d, int splits, int split_len,
                                      void* stream) {
  cudaGetLastError();
  if (nh <= 0 || m <= 0) return 0;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (ntok <= 0 || !Bodies::has(d) || !tc_shape(d, kw) || m % 8 != 0 || (m + kTcCols - 1) / kTcCols > 65535 ||
      splits <= 0 || splits > 65535 || split_len <= 0 || split_len % kTcTok != 0 ||
      static_cast<long long>(splits) * split_len < ntok ||
      static_cast<long long>(splits - 1) * split_len >= ntok || misaligned(x) ||
      misaligned(vals) || misaligned(idx) || misaligned(packed) ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map;
  // x (ntok, m): boxes of 64 columns x 64 token rows, zero fill past either edge
  const int e = hopper::map_3d(&map, x, m, ntok, m, 1, static_cast<long long>(ntok) * m,
                               XTile::CHUNK, kTcTok);
  if (e != 0) return e;
  uint32_t* words = static_cast<uint32_t*>(packed);
  uint16_t* lo = reinterpret_cast<uint16_t*>(words + static_cast<size_t>(nh) * ntok * kw);
  int* lo_any = reinterpret_cast<int*>(lo + static_cast<size_t>(nh) * ntok * kw);
  float* dst = static_cast<float*>(splits == 1 ? out : part);
  const int err =
      kw == 8    ? launch_dw_tc_kw<8>(map, vals, idx, words, lo, lo_any, dst, nh, ntok, m, d,
                                      splits, split_len, s)
      : kw == 16 ? launch_dw_tc_kw<16>(map, vals, idx, words, lo, lo_any, dst, nh, ntok, m, d,
                                       splits, split_len, s)
                 : launch_dw_tc_kw<32>(map, vals, idx, words, lo, lo_any, dst, nh, ntok, m, d,
                                       splits, split_len, s);
  if (err != 0 || splits == 1) return err;
  const size_t count = static_cast<size_t>(nh) * m * d;
  sum_splits_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), count, splits);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core dx body: vals (nh, ntok, kw) bf16 and idx (nh, ntok, kw)
// int32, contiguous and 16-byte aligned; (d, kw) a tc_shape with d in
// CODE_GRAD_TC_DIMS, m a multiple of 8; w heads (nh, m, d) in f32|bf16 at element strides
// (w_sh, w_sm, 1); out (ntok, m) f32. packed: scratch as for
// code_grad_dw_tc_launch (nh * ntok * kw * 6 + 16 bytes); wsplit: scratch
// of nh * m * d bf16 (bf16 w) or twice that (f32 w: hi, then lo), 16-byte
// aligned. Launches the pack kernel, the w split and the dense kernel;
// returns the last launch's cudaGetLastError().
extern "C" int code_grad_dx_tc_launch(const void* vals, const void* idx, const void* w,
                                      void* out, void* packed, void* wsplit, int nh, int ntok,
                                      int kw, int m, int d, long long w_sh, long long w_sm,
                                      int w_bf16, void* stream) {
  cudaGetLastError();
  if (ntok <= 0 || m <= 0) return 0;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (nh <= 0 || !Bodies::has(d) || !tc_shape(d, kw) || m % 8 != 0 || (m + kDxTcCols - 1) / kDxTcCols > 65535 ||
      static_cast<long long>(nh) * m * d >= (1LL << 31) || misaligned(vals) ||
      misaligned(idx) || misaligned(packed) || misaligned(wsplit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* words = static_cast<uint32_t*>(packed);
  uint16_t* lo = reinterpret_cast<uint16_t*>(words + static_cast<size_t>(nh) * ntok * kw);
  int* lo_any = reinterpret_cast<int*>(lo + static_cast<size_t>(nh) * ntok * kw);
  int e = kw == 8    ? pack_codes<8>(vals, idx, words, lo, lo_any, nh, ntok, d, s)
          : kw == 16 ? pack_codes<16>(vals, idx, words, lo, lo_any, nh, ntok, d, s)
                     : pack_codes<32>(vals, idx, words, lo, lo_any, nh, ntok, d, s);
  if (e != 0) return e;
  const long long count = static_cast<long long>(nh) * m * d;
  __nv_bfloat16* w_hi = static_cast<__nv_bfloat16*>(wsplit);
  __nv_bfloat16* w_lo = w_bf16 ? nullptr : w_hi + count;
  e = hopper::w_heads_bf16<false>(w, w_bf16, w_hi, w_lo, nh, m, d, w_sh, w_sm, s);
  if (e != 0) return e;
  CUtensorMap hi_map, lo_map;
  e = hopper::make_map(&hi_map, w_hi, d, m, nh, kDxTcCols);
  if (e == 0) e = hopper::make_map(&lo_map, w_bf16 ? w_hi : w_lo, d, m, nh, kDxTcCols);
  if (e != 0) return e;
  float* o = static_cast<float*>(out);
  if (kw == 8)
    return w_bf16 ? launch_dx_tc_d<8, false>(d, hi_map, lo_map, words, lo, lo_any, o, nh, ntok, m, s)
                  : launch_dx_tc_d<8, true>(d, hi_map, lo_map, words, lo, lo_any, o, nh, ntok, m, s);
  if (kw == 16)
    return w_bf16 ? launch_dx_tc_d<16, false>(d, hi_map, lo_map, words, lo, lo_any, o, nh, ntok, m, s)
                  : launch_dx_tc_d<16, true>(d, hi_map, lo_map, words, lo, lo_any, o, nh, ntok, m, s);
  return w_bf16 ? launch_dx_tc_d<32, false>(d, hi_map, lo_map, words, lo, lo_any, o, nh, ntok, m, s)
                : launch_dx_tc_d<32, true>(d, hi_map, lo_map, words, lo, lo_any, o, nh, ntok, m, s);
}
