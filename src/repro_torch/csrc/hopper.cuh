// hopper.cuh — the Hopper (sm_90a) building blocks of the tensor-core
// attention kernels, of code_grad.cu's dx and dW and of proj_rtopk.cu: TMA
// tile loads completing on an mbarrier, wgmma shared-memory descriptors for
// the swizzled tiles TMA writes, the m64nNk16 bf16 wgmma in its SS form (A
// and B in shared memory; for N = 128 also with B MN-major; N = 160 for
// proj_rtopk_wide.cu) and RS form (A in registers), the hi/lo split of an f32 operand into two bf16s, the TMA
// map encoders, and the kernel that writes strided f32|bf16 weight heads as
// contiguous bf16 (hi, and lo = bf16(w - hi) where asked).
//
// Tile layout. A (ROWS, D) bf16 tile of a row-major (bh, n, D) tensor is
// loaded by TMA in column chunks of one swizzle span each: 128-byte rows
// (64 columns) with the 128-byte swizzle for D a multiple of 64 (64, 128,
// 256), 64-byte rows (32 columns) with the 64-byte swizzle for D = 32 and
// 96 (the tile of a head of 80: tile_width). Chunk c holds columns
// [c * CHUNK, (c + 1) * CHUNK) of every row, at c * ROWS * SW bytes. Tiles
// sit on 1024-byte boundaries, since the swizzle is a function of the
// absolute shared address. Such a tile is a wgmma operand two ways:
//  * K-major: D is the reduction axis (Q and K in Q.K^T, dO and V in dO.V^T).
//    One k16 step is 32 bytes of a row: the descriptor starts 32 bytes
//    further in the chunk (the hardware swizzles the sum), SBO = 8 rows.
//  * MN-major: the rows are the reduction axis and D is N (V in P.V, K in
//    dS.K, dO and Q in P^T.dO and dS^T.Q; the transpose bit set). One k16
//    step is 16 rows; SBO = 8 rows, LBO = the distance between chunks.
//
// Register fragments. The f32 accumulator of m64nN gives thread l of warp w
// rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1): d[4j + 2h + e] is row
// 16w + l/4 + 8h, column 8j + 2(l%4) + e. The bf16 A fragment of one k16
// step in the RS form has the same row/column pattern, so accumulator
// entries 8kk .. 8kk + 7, packed in pairs, are the A fragment of columns
// [16kk, 16kk + 16): an accumulator feeds the next product with no shuffle.
//
// The host helper fetches cuTensorMapEncodeTiled at run time
// (cudaGetDriverEntryPointByVersion), so a library that includes this
// header links nothing beyond the CUDA runtime.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces the bytes the coming copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait until the barrier's phase with this parity has completed. A copy
// that never lands (a bad tensor map) traps after 4 s instead of hanging
// the card: the kernel then fails with a CUDA error at the next
// synchronisation.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(addr, parity))
    if (globaltimer_ns() - t0 > 4000000000ull) __trap();
}

// ---- TMA --------------------------------------------------------------------

// (c0 column, c1 row, c2 bh) of a 3-D map -> shared memory; completes on bar.
// Rows past the tensor's n are filled with zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// ---- tiles and descriptors ----------------------------------------------

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// The tile width that holds a head of d columns: d itself, but 80 padded to
// 96, three 64-byte swizzle spans of 32 columns (20 % of the columns idle;
// 128 would leave 60 % idle). The padding columns hold zeros: TMA fills
// what lies past the tensor's d, the densify zeroes every column it owns.
__host__ __device__ constexpr int tile_width(int d) { return d == 80 ? 96 : d; }
// the swizzle span (bytes) of a tile of w columns
__host__ __device__ constexpr int tile_swizzle(int w) { return w % 64 == 0 ? 128 : 64; }

template <int D, int ROWS>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 96 || D == 128 || D == 256,
                "D in {32, 64, 96, 128, 256}");
  static constexpr int SW = tile_swizzle(D);        // swizzle span, bytes
  static constexpr int CHUNK = SW / 2;              // bf16 columns per chunk
  static constexpr int CHUNKS = D / CHUNK;
  static constexpr int BYTES = ROWS * D * 2;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;   // B128 | B64

  // TMA: the whole tile (rows row0.. of head bh) onto bar
  static __device__ __forceinline__ void load(uint8_t* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row0, int bh) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
      tma_load_3d(dst + c * ROWS * SW, map, bar, c * CHUNK, row0, bh);
  }
  // K-major operand: tile rows [r0, r0 + 64 or N), columns [16kk, 16kk + 16)
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int r0, int kk) {
    const int byte = kk * 32;
    return make_desc(base + (byte / SW) * ROWS * SW + r0 * SW + byte % SW, 16, 8 * SW, LAYOUT);
  }
  // MN-major operand: tile rows [16kk, 16kk + 16) as K, the columns from
  // `base`'s chunk on as N (LBO steps from chunk to chunk)
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return make_desc(base + kk * 16 * SW, ROWS * SW, 8 * SW, LAYOUT);
  }
  // byte offset of column c0 (a multiple of CHUNK): where an MN-major
  // operand of the columns [c0, ..) starts
  static __device__ __forceinline__ uint32_t column(int c0) { return (c0 / CHUNK) * ROWS * SW; }
};

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
struct Mma;

template <> struct Mma<32> {
  // D(64x32) += A(64x16, smem, K-major) . B(16x32, smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
  // D(64x32) += A(64x16, registers) . B(16x32, smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

template <> struct Mma<64> {
  // D(64x64) += A(64x16, smem, K-major) . B(16x64, smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
  // D(64x64) += A(64x16, registers) . B(16x64, smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

template <> struct Mma<96> {
  // D(64x96) += A(64x16, registers) . B(16x96, smem, MN-major): P.V, dS.K,
  // P^T.dO and dS^T.Q on the 96-column tile of a head of 80
  static __device__ __forceinline__ void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

template <> struct Mma<128> {
  // D(64x128) += A(64x16, smem, K-major) . B(16x128, smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
  // D(64x128) += A(64x16, smem, K-major) . B(16x128, smem, MN-major): the
  // SS form with B's transpose bit set (code_grad.cu's dW^T = S^T . x)
  static __device__ __forceinline__ void ss_mn(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
  // D(64x128) += A(64x16, registers) . B(16x128, smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

template <> struct Mma<160> {
  // D(64x160) += A(64x16, smem, K-major) . B(16x160, smem, K-major):
  // proj_rtopk_wide.cu's Y = X.W over two heads of 80, w^T as B
  static __device__ __forceinline__ void ss(float (&d)[80], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "%80, %81, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "l"(da), "l"(db), "r"(acc));
  }
};


// ---- the hi/lo split ------------------------------------------------------

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) f32 -> hi = bf16(x, y), lo = bf16(x - hi, y - hi): hi + lo keeps
// about 16 of the 24 bits, where one bf16 keeps 8
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
  hi = bf16x2_bits(h);
}

// A (64 x 64) f32 m64n64 accumulator -> the bf16 A fragments (hi, lo) of
// its four k16 steps: entries [8kk, 8kk + 8) are step kk. Split before the
// wgmma.fence that precedes the products reading them: PTX forbids register
// writes between the fence and a wgmma that reads those registers.
__device__ __forceinline__ void split_frags(const float (&acc)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split2(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
}

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &status);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (e == cudaSuccess && status == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a bf16 tensor of (depth, rows, cols) at row stride row_elems
// and depth stride depth_elems (elements; multiples of 8): boxes of
// (box_cols, box_rows, 1), swizzled in spans of sw bytes (64 or 128), zero
// fill past every edge. Returns a cudaError_t value.
inline int map_3d(CUtensorMap* map, const void* ptr, long long cols, long long rows,
                  long long row_elems, long long depth, long long depth_elems, int box_cols,
                  int box_rows, int sw = 128) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_elems) * 2,
                                 static_cast<cuuint64_t>(depth_elems) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The map of a contiguous (bh, n, d) bf16 tensor for Tile<tile_width(d),
// box_rows>: boxes of (CHUNK columns, box_rows rows, 1 head), swizzled as
// the tile expects; rows past n and columns past d (a head of 80 in its 96
// columns) zero-filled. Returns a cudaError_t value.
inline int make_map(CUtensorMap* map, const void* ptr, int d, int n, int bh, int box_rows) {
  const int sw = tile_swizzle(tile_width(d));
  return map_3d(map, ptr, d, n, d, bh, static_cast<long long>(n) * d, sw / 2, box_rows, sw);
}

// ---- weight heads to bf16 ---------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// w heads (nh, m, d) at strides (w_sh, w_sm, 1) -> hi = bf16(w), contiguous,
// and (lo non-null) lo = bf16(w - hi) in the same layout. ROWS fixes the
// layout: false (nh, m, d), head after head; true (m, nh * d), row j holding
// every head's columns of w's row j.
template <bool ROWS, typename TW>
__global__ void w_heads_bf16_kernel(const TW* __restrict__ w, __nv_bfloat16* __restrict__ hi,
                                    __nv_bfloat16* __restrict__ lo, int nh, int m, int d,
                                    long long w_sh, long long w_sm) {
  const int total = nh * m * d;   // < 2^31 (the callers check)
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    int h, j, c;
    if (ROWS) {
      j = e / (nh * d);
      const int col = e - j * nh * d;
      h = col / d;
      c = col - h * d;
    } else {
      const int hj = e / d;
      c = e - hj * d;
      h = hj / m;
      j = hj - h * m;
    }
    const float v = to_f(w[h * w_sh + j * w_sm + c]);
    const __nv_bfloat16 top = __float2bfloat16_rn(v);
    hi[e] = top;
    if (lo != nullptr) lo[e] = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(top)));
  }
}

// Launches w_heads_bf16_kernel on w, bf16 if w_bf16 else f32. Returns a
// cudaError_t value.
template <bool ROWS>
int w_heads_bf16(const void* w, bool w_bf16, __nv_bfloat16* hi, __nv_bfloat16* lo, int nh, int m,
                 int d, long long w_sh, long long w_sm, cudaStream_t stream) {
  const long long want = (static_cast<long long>(nh) * m * d + 255) / 256;
  const int blocks = static_cast<int>(want < 132LL * 16 ? want : 132LL * 16);
  if (w_bf16)
    w_heads_bf16_kernel<ROWS><<<blocks, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(w), hi, lo, nh, m, d, w_sh, w_sm);
  else
    w_heads_bf16_kernel<ROWS><<<blocks, 256, 0, stream>>>(static_cast<const float*>(w), hi, lo,
                                                          nh, m, d, w_sh, w_sm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper
