// proj_rtopk.cu — fused head projection -> [RoPE] -> top-|k| for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rtopk.py::proj_rtopk (Pallas body
// _proj_rtopk_kernel, helpers _rope_tile and _topk_select). Per row of
// each head: y = x @ w_h with w rounded to x's dtype and the sum in f32,
// rounded to x's dtype (the unfused `x @ w.astype(x.dtype)`); then, with a
// rope spec (theta, rot_dim), RoPE at the row's position on the leading
// rot_dim dims in (2j, 2j+1) pairs (f32 math, each product rounded on its
// own as torch's elementwise ops round it, then rounded to x's dtype); then
// the exact top-|k| of repro_torch's rtopk kernel: NaN read as +0, ties in
// ascending index order, indices ascending, values moved bit-exact. Only
// the (b, H, n, k) codes are written: the dense (n, d) projection never
// leaves the block.
//
// Two bodies, one epilogue: RoPE in shared memory, then the selection, from
// csrc/topk_select.cuh (shared with rtopk.cu) on the f32 tile that holds
// y in x's precision. One warp a row runs the warp-ballot bisection
// (topk::select_row, lane l holding entries e*32 + l); in the tensor-core
// body, for k <= 16, one thread a row keeps the k largest magnitudes in a
// sorted register list instead (topk::select_row_thread, the same choice):
// with 8 warps a block, the bisection's 32 dependent ballot steps a row
// made that body 2.6x slower on an H100.
//
// The tensor-core body (bf16 x, d in {32, 64, 128}, m a multiple of 8;
// proj_rtopk_tc_launch): Y (b.n x H.d) = X (b.n x m) . W (m x H.d) as one
// GEMM on wgmma. A block owns 128 tokens x 128 columns of Y (128 / d
// heads) with two warpgroups of 64 tokens, and walks m in chunks of 64:
// the x chunk (K-major A, 128 x 64) and the w chunk (MN-major B, 64 x 128)
// arrive by TMA into a ring of three stages, zero-filled past n, m and the
// last head, and each chunk is four Mma<128>::ss_mn steps. x is read once
// per 128 columns (6 times at gpt2's 12 heads of 64, from L2 after the
// first) where the CUDA-core body read it once per head. w reaches TMA as
// contiguous (m, H.d) bf16: a pack kernel rounds an f32 head block (or a
// bf16 one whose strides TMA cannot take) once per call; a bf16 block with
// adjacent heads and 16-byte rows goes to TMA in place. bf16 x bf16
// products are exact in f32, so only the order of the f32 sum differs from
// the plain version's. The accumulator, rounded to bf16, then fills a
// (128, 129) f32 tile over the stages for the epilogue.
//
// The CUDA-core body (f32 x, where the tensor cores would be TF32, which
// fails f32's 1e-4; and other shapes; proj_rtopk_launch): one block of 256
// threads per (64-token tile, head, batch row). w is read in place through
// its strides. The product walks m in chunks of 32: the x chunk (64 x 32)
// and the w chunk (32 x D) are staged in shared memory as f32, and each
// thread accumulates a 4-row x D/16-column register tile (rows rg + 16i,
// columns cg + 16j), so a warp reads the w chunk conflict-free and the x
// chunk by broadcast. The rounded (64 x D) tile then goes to shared memory
// (aliasing the chunk buffers) for the epilogue.
//
// The parts both sources share (the CUDA-core body, RoPE, the epilogue)
// are in proj_rtopk.cuh; the head dims 80 and 256 are built apart, in
// proj_rtopk_wide.cu (its own note), so that the two compile in parallel.
//
// Bound on the H100: operations. The projection is 2 m d flops per row and
// head (tensor cores for bf16); the top-k is about d compares a row; the
// bytes are x and w once and k values + k int32 indices per row.

#include "proj_rtopk.cuh"

namespace {

// ---- the tensor-core body (bf16 x) ------------------------------------------

constexpr int kTcCols = 128;     // columns of Y (heads x d) of a block: the wgmma N
constexpr int kYP = kTcCols + 1; // row stride of the f32 y tile
using WTile = hopper::Tile<kTcCols, kTcK>;   // w chunk: 64 rows of m x 128 columns (MN-major)
static_assert(kTcTok * kYP * 4 <= kTcStages * (XTile::BYTES + WTile::BYTES),
              "the y tile fits over the stages");

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
proj_rtopk_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const int32_t* __restrict__ pos,
                     __nv_bfloat16* __restrict__ vals, int32_t* __restrict__ idx, int n, int m,
                     int nh, int k, const float* __restrict__ freqs, int rot_dim) {
  constexpr int HEADS = kTcCols / D;   // heads of a block
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = base;                                // kTcStages x tiles
  uint8_t* ws = xs + kTcStages * XTile::BYTES;       // kTcStages w tiles
  uint64_t* bar = reinterpret_cast<uint64_t*>(ws + kTcStages * WTile::BYTES);
  float* ys = reinterpret_cast<float*>(base);        // (kTcTok, kYP), after the product

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n0 = blockIdx.x * kTcTok;
  const int col0 = blockIdx.y * kTcCols;
  const int b = blockIdx.z;
  const int nc = (m + kTcK - 1) / kTcK;

  if (tid == 0) {
    for (int i = 0; i < kTcStages; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // chunk c's x and w tiles onto its stage's barrier (thread 0)
  auto load = [&](int c) {
    if (tid != 0 || c >= nc) return;
    const int st = c % kTcStages;
    hopper::mbar_expect_tx(&bar[st], XTile::BYTES + WTile::BYTES);
    hopper::tma_load_3d(xs + st * XTile::BYTES, &xmap, &bar[st], c * kTcK, n0, b);
#pragma unroll
    for (int ch = 0; ch < WTile::CHUNKS; ++ch)
      hopper::tma_load_3d(ws + st * WTile::BYTES + ch * kTcK * WTile::SW, &wmap, &bar[st],
                          col0 + ch * WTile::CHUNK, c * kTcK, 0);
  };
  for (int c = 0; c < kTcStages - 1; ++c) load(c);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  hopper::fence_regs(acc);
  for (int c = 0; c < nc; ++c) {
    const int st = c % kTcStages;
    const uint32_t a = hopper::smem_u32(xs + st * XTile::BYTES);
    const uint32_t bw = hopper::smem_u32(ws + st * WTile::BYTES);
    hopper::mbar_wait(&bar[st], (c / kTcStages) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk)
      hopper::Mma<128>::ss_mn(acc, XTile::kmajor(a, 64 * wg, kk), WTile::mnmajor(bw, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();   // this warpgroup's products of c - 1 are done
    __syncthreads();           // both warpgroups': chunk c - 1's stage is free
    load(c + kTcStages - 1);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  __syncthreads();   // every product has read its tiles: the y tile goes over them

  // the accumulator rounded to bf16: row 64 wg + 16 w + l/4 (+8), column
  // 8j + 2(l%4) (+1)
  const int lane = tid % 32;
  const int r0 = 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    ys[(r0 + 8 * ((i % 4) / 2)) * kYP + c0 + 8 * (i / 4) + (i % 2)] =
        round_to(acc[i], __nv_bfloat16());
  __syncthreads();

  tc_epilogue<D, HEADS, kYP>(ys, pos, vals, idx, b, n0, n, nh, col0 / D, k, freqs, rot_dim);
}

template <int D>
int launch_tc(const CUtensorMap& xmap, const CUtensorMap& wmap, const void* pos, void* vals,
              void* idx, int b, int n, int m, int nh, int k, const float* freqs, int rot_dim,
              cudaStream_t stream) {
  const size_t smem = 1024 + kTcStages * (XTile::BYTES + WTile::BYTES) +
                      kTcStages * sizeof(uint64_t);
  auto kernel = proj_rtopk_tc_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + kTcTok - 1) / kTcTok, (nh * D + kTcCols - 1) / kTcCols, b);
  kernel<<<grid, kTcThreads, smem, stream>>>(xmap, wmap, static_cast<const int32_t*>(pos),
                                             static_cast<__nv_bfloat16*>(vals),
                                             static_cast<int32_t*>(idx), n, m, nh, k, freqs,
                                             rot_dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (b, n, m) contiguous, f32|bf16; w heads (nh, m, d) in f32|bf16 at
// element strides (w_sh, w_sm, 1); pos (b, n) int32 contiguous, or null for
// no RoPE (then freqs and rot_dim are unused); freqs (rot_dim / 2) f32, the
// pairs' frequencies (kernels/ref.py::rope_freqs); out vals (b, nh, n, k) in x's
// dtype and idx (b, nh, n, k) int32. d in {32, 64, 128}, 0 < k <= d, even
// rot_dim <= d. Returns the launch's cudaGetLastError().
extern "C" int proj_rtopk_launch(const void* x, const void* w, const void* pos,
                                 void* vals, void* idx, int b, int n, int m, int nh,
                                 int d, long long w_sh, long long w_sm, int k,
                                 const float* freqs, int rot_dim, int x_bf16, int w_bf16,
                                 void* stream) {
  cudaGetLastError();
  if (b <= 0 || n <= 0 || nh <= 0) return 0;
  if (bad_args(b, n, m, nh, d, k, pos, freqs, rot_dim)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32) return by_dtype<32>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, freqs, rot_dim, x_bf16, w_bf16, s);
  if (d == 64) return by_dtype<64>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, freqs, rot_dim, x_bf16, w_bf16, s);
  if (d == 128) return by_dtype<128>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, freqs, rot_dim, x_bf16, w_bf16, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core body: x (b, n, m) bf16 contiguous and 16-byte aligned, m
// a multiple of 8; w heads (nh, m, d) in f32|bf16 at element strides
// (w_sh, w_sm, 1); pos, vals, idx, k, freqs and rot_dim as for
// proj_rtopk_launch (vals bf16), d in {32, 64, 128}. wpack: scratch of
// m * nh * d bf16, 16-byte aligned, where the pack kernel writes w as
// (m, nh * d); null to read a bf16 w in place, which needs w_sh == d,
// w_sm a multiple of 8 and w 16-byte aligned. Launches the pack kernel
// (with wpack) and the dense kernel; returns the last launch's
// cudaGetLastError().
extern "C" int proj_rtopk_tc_launch(const void* x, const void* w, const void* pos, void* vals,
                                    void* idx, void* wpack, int b, int n, int m, int nh, int d,
                                    long long w_sh, long long w_sm, int k, const float* freqs,
                                    int rot_dim, int w_bf16, void* stream) {
  cudaGetLastError();
  if (b <= 0 || n <= 0 || nh <= 0) return 0;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (bad_args(b, n, m, nh, d, k, pos, freqs, rot_dim) || (d != 32 && d != 64 && d != 128) ||
      m % 8 != 0 || static_cast<long long>(nh) * d * m >= (1LL << 31) || misaligned(x) ||
      (wpack != nullptr && misaligned(wpack)) ||
      (wpack == nullptr && (!w_bf16 || w_sh != d || w_sm % 8 != 0 || misaligned(w))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cols = static_cast<long long>(nh) * d;
  const void* wt = w;
  long long w_row = w_sm;
  if (wpack != nullptr) {
    // w as (m, nh * d) bf16, row j holding every head's columns of w's row j
    const int e = hopper::w_heads_bf16<true>(w, w_bf16, static_cast<__nv_bfloat16*>(wpack),
                                             nullptr, nh, m, d, w_sh, w_sm, s);
    if (e != 0) return e;
    wt = wpack;
    w_row = cols;
  }
  CUtensorMap xmap, wmap;
  int e = hopper::map_3d(&xmap, x, m, n, m, b, static_cast<long long>(n) * m, kTcK, kTcTok);
  if (e == 0) e = hopper::map_3d(&wmap, wt, cols, m, w_row, 1, w_row * m, WTile::CHUNK, kTcK);
  if (e != 0) return e;
  if (d == 32) return launch_tc<32>(xmap, wmap, pos, vals, idx, b, n, m, nh, k, freqs, rot_dim, s);
  if (d == 64) return launch_tc<64>(xmap, wmap, pos, vals, idx, b, n, m, nh, k, freqs, rot_dim, s);
  return launch_tc<128>(xmap, wmap, pos, vals, idx, b, n, m, nh, k, freqs, rot_dim, s);
}
