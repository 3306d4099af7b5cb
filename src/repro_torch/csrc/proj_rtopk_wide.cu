// proj_rtopk_wide.cu — the fused head projection -> [RoPE] -> top-|k| at
// head dims 80 (hubert-xlarge) and 256 (paligemma-3b) for Hopper (sm_90a):
// the compact seam's forward codes at these widths.
//
// Replaces the TPU kernel repro/kernels/rtopk.py::proj_rtopk (Pallas body
// _proj_rtopk_kernel) at d 80 and 256, with the same contract as
// proj_rtopk.cu (its note): y = x @ w_h rounded to x's dtype, RoPE, the
// exact top-|k|. A source of its own, so that its build runs beside
// proj_rtopk.cu's.
//
// The CUDA-core body (f32 x; bf16 with m not a multiple of 8;
// proj_rtopk_launch) is proj_rtopk.cuh's at D = 80 (five 16-column thread
// tiles) and 256.
//
// The tensor-core body (bf16 x, m a multiple of 8; proj_rtopk_tc_launch).
// proj_rtopk.cu's block owns 128 columns of Y, a whole number of heads of
// 32, 64 or 128, and reads w MN-major in 64-column swizzle atoms; 128 is
// no whole number of heads of 80, and a head of 256 spans two such blocks
// while the selection needs its whole row. Here a block owns NC columns of
// Y, whole heads: 160 (two heads of 80) or 256 (one head), and w arrives
// K-major: a pack kernel writes w^T as (H.d, m) bf16 rows once per call (a
// 32 x 32 tile transpose through shared memory), and the w chunk is NC rows
// of w^T x 64 of m (hopper::Tile<64, NC>), which wgmma takes as B at any N
// that is a multiple of 8. x arrives as in proj_rtopk.cu (K-major A, 128
// tokens x 64 of m); three stages of both by TMA, zero-filled past n, m and
// the last head. Each chunk is four k16 steps: Mma<160>::ss at d 80, two
// Mma<128>::ss (B rows 0-127 and 128-255) at d 256. At d 256 a warpgroup's
// accumulator is 64 x 256 f32, 128 registers a thread. The accumulator,
// rounded to bf16, fills a (128, NC + 1) f32 tile over the stages (82,432
// or 131,584 bytes, under the stages' 110,592 or 147,456), and the
// epilogue of proj_rtopk.cuh applies RoPE over each head's whole rot_dim
// (256 for paligemma) and selects each (token, head) row over its d
// entries: a block's columns are whole heads, so no row reaches a pad
// column, and rows past the last head or past n are skipped.
//
// Bound on the H100: operations, 2 m d flops per row and head on the
// tensor cores; the bytes are x and w once and k values + k int32 indices
// per row.

#include "proj_rtopk.cuh"

namespace {

// columns of Y a tensor-core block owns at head dim D: whole heads
template <int D>
constexpr int kWideCols = D == 80 ? 160 : D;

// w heads (nh, m, d) at strides (w_sh, w_sm, 1), f32|bf16 -> w^T (nh.d, m)
// bf16, row h.d + c holding column c of head h: 32 x 32 tiles through
// shared memory, reads along d and writes along m both coalesced
template <typename TW>
__global__ void __launch_bounds__(256)
w_heads_t_bf16_kernel(const TW* __restrict__ w, __nv_bfloat16* __restrict__ wt, int nh,
                      int m, int d, long long w_sh, long long w_sm) {
  __shared__ float tile[32][33];
  const int j0 = blockIdx.x * 32, col0 = blockIdx.y * 32;
  const int cols = nh * d;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int j = j0 + i, col = col0 + threadIdx.x;
    float v = 0.0f;
    if (j < m && col < cols) {
      const int h = col / d;
      v = hopper::to_f(w[h * w_sh + j * w_sm + (col - h * d)]);
    }
    tile[i][threadIdx.x] = v;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int col = col0 + i, j = j0 + threadIdx.x;
    if (col < cols && j < m)
      wt[static_cast<size_t>(col) * m + j] = __float2bfloat16_rn(tile[threadIdx.x][i]);
  }
}

int pack_w_t(const void* w, int w_bf16, __nv_bfloat16* wt, int nh, int m, int d, long long w_sh,
             long long w_sm, cudaStream_t stream) {
  const dim3 grid((m + 31) / 32, (nh * d + 31) / 32), block(32, 8);
  if (w_bf16)
    w_heads_t_bf16_kernel<<<grid, block, 0, stream>>>(static_cast<const __nv_bfloat16*>(w), wt,
                                                      nh, m, d, w_sh, w_sm);
  else
    w_heads_t_bf16_kernel<<<grid, block, 0, stream>>>(static_cast<const float*>(w), wt, nh, m,
                                                      d, w_sh, w_sm);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
proj_rtopk_wide_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const int32_t* __restrict__ pos, __nv_bfloat16* __restrict__ vals,
                          int32_t* __restrict__ idx, int n, int m, int nh, int k, const float* __restrict__ freqs,
                          int rot_dim) {
  constexpr int NC = kWideCols<D>;
  constexpr int HEADS = NC / D;
  constexpr int YP = NC + 1;            // row stride of the f32 y tile
  using WTile = hopper::Tile<kTcK, NC>;  // w^T chunk: NC rows (columns of Y) x 64 of m
  static_assert(kTcTok * YP * 4 <= kTcStages * (XTile::BYTES + WTile::BYTES),
                "the y tile fits over the stages");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = base;                                // kTcStages x tiles
  uint8_t* ws = xs + kTcStages * XTile::BYTES;       // kTcStages w^T tiles
  uint64_t* bar = reinterpret_cast<uint64_t*>(ws + kTcStages * WTile::BYTES);
  float* ys = reinterpret_cast<float*>(base);        // (kTcTok, YP), after the product

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n0 = blockIdx.x * kTcTok;
  const int col0 = blockIdx.y * NC;
  const int b = blockIdx.z;
  const int nc = (m + kTcK - 1) / kTcK;

  if (tid == 0) {
    for (int i = 0; i < kTcStages; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // chunk c's x and w^T tiles onto its stage's barrier (thread 0)
  auto load = [&](int c) {
    if (tid != 0 || c >= nc) return;
    const int st = c % kTcStages;
    hopper::mbar_expect_tx(&bar[st], XTile::BYTES + WTile::BYTES);
    hopper::tma_load_3d(xs + st * XTile::BYTES, &xmap, &bar[st], c * kTcK, n0, b);
    hopper::tma_load_3d(ws + st * WTile::BYTES, &wmap, &bar[st], c * kTcK, col0, 0);
  };
  for (int c = 0; c < kTcStages - 1; ++c) load(c);

  // the accumulator: 64 tokens x NC columns a warpgroup (d 256: two halves
  // of 128 columns)
  constexpr int HALF = NC > 128 && NC % 128 == 0 ? 2 : 1;
  float acc[HALF][NC / HALF / 2];
#pragma unroll
  for (int hf = 0; hf < HALF; ++hf) {
#pragma unroll
    for (int i = 0; i < NC / HALF / 2; ++i) acc[hf][i] = 0.0f;
    hopper::fence_regs(acc[hf]);
  }
  for (int c = 0; c < nc; ++c) {
    const int st = c % kTcStages;
    const uint32_t a = hopper::smem_u32(xs + st * XTile::BYTES);
    const uint32_t bw = hopper::smem_u32(ws + st * WTile::BYTES);
    hopper::mbar_wait(&bar[st], (c / kTcStages) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
      const uint64_t da = XTile::kmajor(a, 64 * wg, kk);
      if constexpr (HALF == 2) {
        hopper::Mma<128>::ss(acc[0], da, WTile::kmajor(bw, 0, kk), 1);
        hopper::Mma<128>::ss(acc[1], da, WTile::kmajor(bw, 128, kk), 1);
      } else {
        hopper::Mma<NC>::ss(acc[0], da, WTile::kmajor(bw, 0, kk), 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();   // this warpgroup's products of c - 1 are done
    __syncthreads();           // both warpgroups': chunk c - 1's stage is free
    load(c + kTcStages - 1);
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int hf = 0; hf < HALF; ++hf) hopper::fence_regs(acc[hf]);
  __syncthreads();   // every product has read its tiles: the y tile goes over them

  // the accumulator rounded to bf16: row 64 wg + 16 w + l/4 (+8), column
  // 8j + 2(l%4) (+1) of its half
  const int lane = tid % 32;
  const int r0 = 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int hf = 0; hf < HALF; ++hf)
#pragma unroll
    for (int i = 0; i < NC / HALF / 2; ++i)
      ys[(r0 + 8 * ((i % 4) / 2)) * YP + hf * (NC / HALF) + c0 + 8 * (i / 4) + (i % 2)] =
          round_to(acc[hf][i], __nv_bfloat16());
  __syncthreads();

  tc_epilogue<D, HEADS, YP>(ys, pos, vals, idx, b, n0, n, nh, col0 / D, k, freqs, rot_dim);
}

template <int D>
int launch_wide_tc(const CUtensorMap& xmap, const CUtensorMap& wmap, const void* pos,
                   void* vals, void* idx, int b, int n, int m, int nh, int k, const float* freqs,
                   int rot_dim, cudaStream_t stream) {
  constexpr int NC = kWideCols<D>;
  const size_t smem = 1024 + kTcStages * (XTile::BYTES + hopper::Tile<kTcK, NC>::BYTES) +
                      kTcStages * sizeof(uint64_t);
  auto kernel = proj_rtopk_wide_tc_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + kTcTok - 1) / kTcTok, (nh * D + NC - 1) / NC, b);
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

// The CUDA-core body at d in {80, 256}: arguments as proj_rtopk.cu's
// proj_rtopk_launch. Returns the launch's cudaGetLastError().
extern "C" int proj_rtopk_launch(const void* x, const void* w, const void* pos,
                                 void* vals, void* idx, int b, int n, int m, int nh,
                                 int d, long long w_sh, long long w_sm, int k,
                                 const float* freqs, int rot_dim, int x_bf16, int w_bf16,
                                 void* stream) {
  cudaGetLastError();
  if (b <= 0 || n <= 0 || nh <= 0) return 0;
  if (bad_args(b, n, m, nh, d, k, pos, freqs, rot_dim)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 80) return by_dtype<80>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, freqs, rot_dim, x_bf16, w_bf16, s);
  if (d == 256) return by_dtype<256>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, freqs, rot_dim, x_bf16, w_bf16, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core body at d in {80, 256}: x (b, n, m) bf16 contiguous and
// 16-byte aligned, m a multiple of 8; w heads (nh, m, d) in f32|bf16 at
// element strides (w_sh, w_sm, 1); pos, vals, idx, k, freqs and rot_dim as
// for proj_rtopk_launch (vals bf16). wpack: scratch of nh * d * m bf16,
// 16-byte aligned, where the pack kernel writes w^T as (nh * d, m) (never
// null here). Launches the pack kernel and the dense kernel; returns the
// last launch's cudaGetLastError().
extern "C" int proj_rtopk_tc_launch(const void* x, const void* w, const void* pos, void* vals,
                                    void* idx, void* wpack, int b, int n, int m, int nh, int d,
                                    long long w_sh, long long w_sm, int k, const float* freqs,
                                    int rot_dim, int w_bf16, void* stream) {
  cudaGetLastError();
  if (b <= 0 || n <= 0 || nh <= 0) return 0;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (bad_args(b, n, m, nh, d, k, pos, freqs, rot_dim) || (d != 80 && d != 256) || m % 8 != 0 ||
      static_cast<long long>(nh) * d * m >= (1LL << 31) || misaligned(x) || wpack == nullptr ||
      misaligned(wpack) || (static_cast<long long>(nh) * d + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* wt = static_cast<__nv_bfloat16*>(wpack);
  int e = pack_w_t(w, w_bf16, wt, nh, m, d, w_sh, w_sm, s);
  if (e != 0) return e;
  const long long cols = static_cast<long long>(nh) * d;
  CUtensorMap xmap, wmap;
  e = hopper::map_3d(&xmap, x, m, n, m, b, static_cast<long long>(n) * m, kTcK, kTcTok);
  // w^T (cols, m): boxes of 64 of m x NC rows, zero fill past m and the last head
  if (e == 0)
    e = hopper::map_3d(&wmap, wt, m, cols, m, 1, cols * m, kTcK, d == 80 ? kWideCols<80> : 256);
  if (e != 0) return e;
  if (d == 80) return launch_wide_tc<80>(xmap, wmap, pos, vals, idx, b, n, m, nh, k, freqs, rot_dim, s);
  return launch_wide_tc<256>(xmap, wmap, pos, vals, idx, b, n, m, nh, k, freqs, rot_dim, s);
}
