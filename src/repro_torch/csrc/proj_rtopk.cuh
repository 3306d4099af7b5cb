// proj_rtopk.cuh — what the two proj_rtopk sources share: proj_rtopk.cu
// (head dims 32, 64, 128) and proj_rtopk_wide.cu (80 and 256). The kernels
// replace the TPU kernel repro/kernels/rtopk.py::proj_rtopk; their design
// and bound are in proj_rtopk.cu's note. Here: the rounding to x's dtype,
// RoPE on a pair, the CUDA-core body (any D whose 16-column thread tiles
// divide it: 32, 64, 80, 128, 256), the tensor-core bodies' constants and
// epilogue (RoPE and the selection on the f32 y tile), and the argument
// check.
#pragma once

#include "hopper.cuh"
#include "topk_select.cuh"

namespace {

constexpr int kRows = 64;      // tokens per block
constexpr int kThreads = 256;
constexpr int kChunk = 32;     // m per staged chunk
constexpr int kXP = kChunk + 1;

using hopper::to_f;
// round an f32 to T's precision and back (identity for f32)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// RoPE on the pair (p[0], p[1]) = dims (2 jp, 2 jp + 1) at this position,
// in place, at the pair's frequency freq: the op sequence of
// models.layers.rope (cos and sin of the f32 angle evaluated in double and
// rounded to f32), each product and sum rounded on its own (no FMA), then
// rounded to T. The wrappers pass the frequency table that rope computes
// (kernels/ref.py::rope_freqs, torch's pow on the same device), so the
// angles carry the plain version's bits: the card's powf and torch's pow
// part by an ulp at some exponents (at rot_dim 80 among them).
template <typename T>
__device__ __forceinline__ void rope_pair(float* p, int position, float freq) {
  const float ang = static_cast<float>(position) * freq;
  const float cs = static_cast<float>(cos(static_cast<double>(ang)));
  const float sn = static_cast<float>(sin(static_cast<double>(ang)));
  const float x1 = p[0], x2 = p[1];
  p[0] = round_to(__fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn)), T());
  p[1] = round_to(__fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn)), T());
}

// ---- the CUDA-core body -------------------------------------------------------

template <int D, typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
proj_rtopk_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                  const int32_t* __restrict__ pos, T* __restrict__ vals,
                  int32_t* __restrict__ idx, int n, int m, int nh,
                  long long w_sh, long long w_sm, int k, const float* __restrict__ freqs,
                  int rot_dim) {
  constexpr int TN = D / 16;  // columns per thread
  constexpr int TM = 4;       // rows per thread
  constexpr int YP = D + 1;
  extern __shared__ float smem[];
  float* xs = smem;                 // (kRows, kXP)
  float* ws = xs + kRows * kXP;     // (kChunk, D)
  float* ys = smem;                 // (kRows, YP), after the product

  const int tid = threadIdx.x;
  const int rg = tid >> 4;          // 0..15
  const int cg = tid & 15;          // 0..15
  const int n0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows_left = n - n0;
  const T* xb = x + (static_cast<size_t>(b) * n + n0) * m;
  const TW* wh = w + static_cast<size_t>(h) * w_sh;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int m0 = 0; m0 < m; m0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int t = tid; t < kRows * kChunk; t += kThreads) {
      const int r = t / kChunk, c = t % kChunk;
      xs[r * kXP + c] = (r < rows_left && m0 + c < m)
                            ? to_f(xb[static_cast<size_t>(r) * m + m0 + c]) : 0.0f;
    }
    for (int t = tid; t < kChunk * D; t += kThreads) {
      const int r = t / D, c = t % D;
      ws[t] = m0 + r < m
                  ? round_to(to_f(wh[static_cast<size_t>(m0 + r) * w_sm + c]), T())
                  : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < kChunk; ++kk) {
      float xr[TM], wr[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xr[i] = xs[(rg + 16 * i) * kXP + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) wr[j] = ws[kk * D + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += xr[i] * wr[j];
    }
  }
  __syncthreads();  // the chunk buffers become the y tile
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      ys[(rg + 16 * i) * YP + cg + 16 * j] = round_to(acc[i][j], T());
  __syncthreads();

  if (pos != nullptr) {  // RoPE on the leading rot_dim dims, in place
    const int half = rot_dim / 2;
    for (int t = tid; t < kRows * half; t += kThreads) {
      const int r = t / half, jp = t % half;
      if (r >= rows_left) continue;
      rope_pair<T>(ys + r * YP + 2 * jp, pos[static_cast<size_t>(b) * n + n0 + r], freqs[jp]);
    }
    __syncthreads();
  }

  // top-|k| per row: one warp per row, 8 rows per warp
  const int lane = tid & 31;
  for (int r = tid >> 5; r < kRows && r < rows_left; r += kThreads / 32) {
    const size_t orow = ((static_cast<size_t>(b) * nh + h) * n + n0 + r) * k;
    topk::select_row<(D + 31) / 32>(ys + r * YP, vals + orow, idx + orow, D, k, lane);
  }
}

template <int D, typename T, typename TW>
int launch(const void* x, const void* w, const void* pos, void* vals, void* idx,
           int b, int n, int m, int nh, long long w_sh, long long w_sm, int k,
           const float* freqs, int rot_dim, cudaStream_t stream) {
  const size_t chunk = sizeof(float) * (kRows * kXP + kChunk * D);
  const size_t tile = sizeof(float) * kRows * (D + 1);
  const size_t smem = chunk > tile ? chunk : tile;
  auto kernel = proj_rtopk_kernel<D, T, TW>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n + kRows - 1) / kRows, nh, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w),
      static_cast<const int32_t*>(pos), static_cast<T*>(vals),
      static_cast<int32_t*>(idx), n, m, nh, w_sh, w_sm, k, freqs, rot_dim);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int by_dtype(const void* x, const void* w, const void* pos, void* vals, void* idx,
             int b, int n, int m, int nh, long long w_sh, long long w_sm, int k,
             const float* freqs, int rot_dim, int x_bf16, int w_bf16, cudaStream_t s) {
  if (x_bf16 && w_bf16)
    return launch<D, __nv_bfloat16, __nv_bfloat16>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, freqs, rot_dim, s);
  if (x_bf16)
    return launch<D, __nv_bfloat16, float>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, freqs, rot_dim, s);
  if (w_bf16)
    return launch<D, float, __nv_bfloat16>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, freqs, rot_dim, s);
  return launch<D, float, float>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, freqs, rot_dim, s);
}

// ---- the tensor-core bodies (bf16 x): what both sources' share ------------

constexpr int kTcTok = 128;      // tokens of a block: two warpgroups of 64
constexpr int kTcK = 64;         // m of a chunk: four k16 steps
constexpr int kTcStages = 3;     // x and w tiles: chunks c .. c + 2
constexpr int kTcThreads = 256;
using XTile = hopper::Tile<kTcK, kTcTok>;    // x chunk: 128 token rows x 64 of m (K-major)

// The tensor-core bodies' epilogue on a block's (kTcTok, YP) f32 y tile
// (rows: tokens n0 .., columns: HEADS heads of D, the first being head h0),
// called by all kTcThreads threads: RoPE on each head's leading rot_dim
// dims in place, then each (token, head) row's top-|k|, one thread a row
// for k <= 16 (a warp reads 32 rows' entries column by column: an odd YP
// keeps them on 32 banks), else one warp a row.
template <int D, int HEADS, int YP>
__device__ __forceinline__ void tc_epilogue(float* ys, const int32_t* __restrict__ pos,
                                            __nv_bfloat16* __restrict__ vals,
                                            int32_t* __restrict__ idx, int b, int n0, int n,
                                            int nh, int h0, int k, const float* __restrict__ freqs, int rot_dim) {
  static_assert(YP % 2 == 1, "an odd row stride");
  const int tid = threadIdx.x;
  if (pos != nullptr) {
    const int half = rot_dim / 2;
    for (int t = tid; t < kTcTok * HEADS * half; t += kTcThreads) {
      const int r = t / (HEADS * half), hs = (t / half) % HEADS, jp = t % half;
      if (n0 + r >= n) continue;
      rope_pair<__nv_bfloat16>(ys + r * YP + hs * D + 2 * jp,
                               pos[static_cast<size_t>(b) * n + n0 + r], freqs[jp]);
    }
    __syncthreads();
  }
  if (k <= 16) {
    for (int row = tid; row < kTcTok * HEADS; row += kTcThreads) {
      const int r = row % kTcTok, hs = row / kTcTok;
      const int h = h0 + hs;
      if (h >= nh || n0 + r >= n) continue;
      const size_t orow = ((static_cast<size_t>(b) * nh + h) * n + n0 + r) * k;
      if (k <= 8)
        topk::select_row_thread<D, 8>(ys + r * YP + hs * D, vals + orow, idx + orow, k);
      else
        topk::select_row_thread<D, 16>(ys + r * YP + hs * D, vals + orow, idx + orow, k);
    }
    return;
  }
  const int lane = tid % 32;
  for (int row = tid / 32; row < kTcTok * HEADS; row += kTcThreads / 32) {
    const int r = row % kTcTok, hs = row / kTcTok;
    const int h = h0 + hs;
    if (h >= nh || n0 + r >= n) continue;
    const size_t orow = ((static_cast<size_t>(b) * nh + h) * n + n0 + r) * k;
    topk::select_row<(D + 31) / 32>(ys + r * YP + hs * D, vals + orow, idx + orow, D, k, lane);
  }
}

bool bad_args(int b, int n, int m, int nh, int d, int k, const void* pos, const float* freqs,
              int rot_dim) {
  return m <= 0 || k <= 0 || k > d || nh > 65535 || b > 65535 ||
         (pos != nullptr && (freqs == nullptr || rot_dim <= 0 || rot_dim > d || rot_dim % 2));
}

}  // namespace
