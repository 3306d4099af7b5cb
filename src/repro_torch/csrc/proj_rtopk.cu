// proj_rtopk.cu — fused head projection -> [RoPE] -> top-|k| for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rtopk.py::proj_rtopk (Pallas body
// _proj_rtopk_kernel, helpers _rope_tile and _topk_select). Per row of
// each head: y = x @ w_h with w rounded to x's dtype and the sum in f32,
// rounded to x's dtype (the unfused `x @ w.astype(x.dtype)`); then, with a
// rope spec (theta, rot_dim), RoPE at the row's position on the leading
// rot_dim dims in (2j, 2j+1) pairs (f32 math, rounded to x's dtype); then
// the exact top-|k| of repro_torch's rtopk kernel: NaN read as +0, ties in
// ascending index order, indices ascending, values moved bit-exact. Only
// the (b, H, n, k) codes are written: the dense (n, d) projection never
// leaves the block.
//
// Design: one block of 256 threads per (64-token tile, head, batch row).
// w is read in place through its strides (head stride, row stride; unit
// stride along d), so a per-head view of the packed w_qkv needs no copy.
// The product walks m in chunks of 32: the x chunk (64 x 32) and the w
// chunk (32 x D) are staged in shared memory as f32, and each thread
// accumulates a 4-row x D/16-column register tile (rows rg + 16i, columns
// cg + 16j), so a warp reads the w chunk conflict-free and the x chunk by
// broadcast. The rounded (64 x D) tile then goes to shared memory (aliasing
// the chunk buffers), RoPE rotates it in place, and each of the 8 warps
// selects 8 rows with the warp-ballot bisection of csrc/rtopk.cu (one row
// per warp, lane l holding entries e*32 + l).
//
// Bound on the H100: operations. The projection is 2 m D flops per row and
// head on CUDA cores in f32 here (bf16 inputs could use the tensor cores:
// wgmma, a later change); the top-k is 32 ballot steps per row on
// registers; the bytes are x and w once and k values + k int32 indices per
// row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 64;      // tokens per block
constexpr int kThreads = 256;
constexpr int kChunk = 32;     // m per staged chunk
constexpr int kXP = kChunk + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
// round an f32 to T's precision and back (identity for f32)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
// raw bits of a value that T holds exactly
__device__ __forceinline__ void store_bits(float f, float* p) { *p = f; }
__device__ __forceinline__ void store_bits(float f, __nv_bfloat16* p) {
  *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(__float_as_uint(f) >> 16);
}

template <int D, typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
proj_rtopk_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                  const int32_t* __restrict__ pos, T* __restrict__ vals,
                  int32_t* __restrict__ idx, int n, int m, int nh,
                  long long w_sh, long long w_sm, int k, float theta,
                  int rot_dim) {
  constexpr int TN = D / 16;  // columns per thread
  constexpr int TM = 4;       // rows per thread
  constexpr int E = D / 32;   // entries per lane in the selection
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
      const float freq = powf(theta, -static_cast<float>(2 * jp) / static_cast<float>(rot_dim));
      const float ang = static_cast<float>(pos[static_cast<size_t>(b) * n + n0 + r]) * freq;
      const float cs = cosf(ang), sn = sinf(ang);
      float* p = ys + r * YP + 2 * jp;
      const float x1 = p[0], x2 = p[1];
      p[0] = round_to(x1 * cs - x2 * sn, T());
      p[1] = round_to(x2 * cs + x1 * sn, T());
    }
    __syncthreads();
  }

  // top-|k| per row: one warp per row, 8 rows per warp
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int r = warp; r < kRows && r < rows_left; r += kThreads / 32) {
    float f[E];
    int32_t mag[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      f[e] = ys[r * YP + e * 32 + lane];
      if (isnan(f[e])) f[e] = 0.0f;  // NaN -> +0.0 (the rtopk contract)
      mag[e] = __float_as_int(fabsf(f[e]));
    }
    int lo = 0;
    int hi = 0x7F800001;  // above +inf
    for (int it = 0; it < 32; ++it) {
      const int mid = lo + (hi - lo) / 2;
      int cnt = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) cnt += __popc(__ballot_sync(kFull, mag[e] >= mid));
      if (cnt >= k) lo = mid; else hi = mid;
    }
    const int theta_bits = lo;
    int n_hi = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) n_hi += __popc(__ballot_sync(kFull, mag[e] > theta_bits));
    const int tie_quota = k - n_hi;
    int ties_before = 0, sel_before = 0;
    const size_t orow = ((static_cast<size_t>(b) * nh + h) * n + n0 + r) * k;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool tie = mag[e] == theta_bits;
      const unsigned tie_mask = __ballot_sync(kFull, tie);
      const int tie_rank = ties_before + __popc(tie_mask & lower);
      const bool sel = mag[e] > theta_bits || (tie && tie_rank < tie_quota);
      const unsigned sel_mask = __ballot_sync(kFull, sel);
      if (sel) {
        const size_t o = orow + sel_before + __popc(sel_mask & lower);
        store_bits(f[e], vals + o);
        idx[o] = e * 32 + lane;
      }
      ties_before += __popc(tie_mask);
      sel_before += __popc(sel_mask);
    }
  }
}

template <int D, typename T, typename TW>
int launch(const void* x, const void* w, const void* pos, void* vals, void* idx,
           int b, int n, int m, int nh, long long w_sh, long long w_sm, int k,
           float theta, int rot_dim, cudaStream_t stream) {
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
      static_cast<int32_t*>(idx), n, m, nh, w_sh, w_sm, k, theta, rot_dim);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int by_dtype(const void* x, const void* w, const void* pos, void* vals, void* idx,
             int b, int n, int m, int nh, long long w_sh, long long w_sm, int k,
             float theta, int rot_dim, int x_bf16, int w_bf16, cudaStream_t s) {
  if (x_bf16 && w_bf16)
    return launch<D, __nv_bfloat16, __nv_bfloat16>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, theta, rot_dim, s);
  if (x_bf16)
    return launch<D, __nv_bfloat16, float>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, theta, rot_dim, s);
  if (w_bf16)
    return launch<D, float, __nv_bfloat16>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, theta, rot_dim, s);
  return launch<D, float, float>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, theta, rot_dim, s);
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (b, n, m) contiguous, f32|bf16; w heads (nh, m, d) in f32|bf16 at
// element strides (w_sh, w_sm, 1); pos (b, n) int32 contiguous, or null for
// no RoPE (then theta and rot_dim are unused); out vals (b, nh, n, k) in x's
// dtype and idx (b, nh, n, k) int32. d in {32, 64, 128}, 0 < k <= d, even
// rot_dim <= d. Returns the launch's cudaGetLastError().
extern "C" int proj_rtopk_launch(const void* x, const void* w, const void* pos,
                                 void* vals, void* idx, int b, int n, int m, int nh,
                                 int d, long long w_sh, long long w_sm, int k,
                                 float theta, int rot_dim, int x_bf16, int w_bf16,
                                 void* stream) {
  cudaGetLastError();
  if (b <= 0 || n <= 0 || nh <= 0) return 0;
  if (m <= 0 || k <= 0 || k > d || nh > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pos != nullptr && (rot_dim <= 0 || rot_dim > d || rot_dim % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32) return by_dtype<32>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, theta, rot_dim, x_bf16, w_bf16, s);
  if (d == 64) return by_dtype<64>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, theta, rot_dim, x_bf16, w_bf16, s);
  if (d == 128) return by_dtype<128>(x, w, pos, vals, idx, b, n, m, nh, w_sh, w_sm, k, theta, rot_dim, x_bf16, w_bf16, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
