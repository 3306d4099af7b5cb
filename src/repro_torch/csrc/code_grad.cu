// code_grad.cu — compact code-gradient consumers for Hopper (sm_90a):
// the input-projection backward of the compact training seam.
//
// Replaces the TPU kernels repro/kernels/code_grad.py::code_grad_dx
// (Pallas body _dx_kernel) and ::code_grad_dw (_dw_kernel). Given per-head
// code gradients vals/idx (H, N, kw) — kw = k for emit="compact", 2k for
// the RoPE pair closure — and the per-head weight blocks w_h (m, d):
//   dx[n, j]    = sum_h sum_t vals_h[n, t] * w_h[j, idx_h[n, t]]   (N, m) f32
//   dW_h[j, c]  = sum_n x[n, j] * sum_{t: idx_h[n, t] = c} vals_h[n, t]
// which is scatter(vals_h, idx_h) @ w_h^T and x^T @ scatter(vals_h, idx_h):
// each code entry adds its own term, so duplicate indices sum (as the TPU's
// _densify_block does) and an index outside [0, d) adds nothing. The dense
// (N, d) gradient is never formed in device memory.
//
// Two kinds of body. With bf16 codes, d in {32, 64, 80, 128, 256}, kw in
// {8, 16} (and 32, the RoPE pair closure at k 16, at every d but 32:
// tc_shape) and m a multiple of 8, dx and dW run on the tensor cores
// (code_grad_dx_tc_launch, code_grad_dw_tc_launch, below): the TPU's
// counterpart, each code tile densified in shared memory and fed to a
// d-wide product. f32 codes (on the tensor cores f32 would be TF32, which
// fails f32's 1e-4) and the other bf16 shapes run on CUDA cores: each
// product gathered at the kw stored coordinates, kw multiply-adds per
// output element and head.
//
// Design of the CUDA-core bodies. Every output element has one owner and a
// fixed summation order: no atomics, a deterministic result.
//  * dx: one block of 256 threads per (128-token tile, 64-column tile of
//    m). Per head the block stages w_h's 64 rows of the tile transposed in
//    shared memory, (d, 64 + 1) f32, and the tile's codes; thread (j, rg)
//    owns column j and 32 token rows, and for each code slot t adds
//    vals[r, t] * wT[idx[r, t], j] — the warp reads 32 consecutive columns
//    of one wT row (conflict-free) and the code entry by broadcast. The
//    heads are summed inside the block, in order.
//  * dw: the contraction over all N tokens is the long serial axis, so it
//    is split: one block of 128 threads per (head, 128-column tile of m,
//    token split s). Thread j owns row j of a (128, d + 1) f32 accumulator
//    in shared memory and walks the split's tokens in order, adding
//    x[n, j] * vals[n, t] at column idx[n, t] — only its own row, so no
//    races, and row stride d + 1 keeps the 32 lanes on 32 banks. Each split
//    writes its partial (S, H, m, d) block, and a second kernel sums the S
//    partials in order (S = 1 writes the result directly). Each code entry
//    costs a shared-memory read-modify-write of the accumulator (with the
//    entry's two broadcast reads, four shared-memory operations per two
//    flops): that, not the flops, sets this body's time (0.82 ms at
//    gpt2-small's 12 heads x 8,192 tokens, k 8; PERF.md).
//
// The tensor-core bodies live in code_grad_tc.cuh (their design notes),
// built here at d 32, 64 and 128 and in code_grad_wide.cu at 80 and 256.
//
// Bound on the H100: operations, for each of dx and dW the lesser of 2 kw
// flops per (token, column, head) on CUDA cores and 2 d on the tensor
// cores, against the bytes of x, w and the codes once each and the f32
// outputs.

#define CODE_GRAD_TC_DIMS 32, 64, 128
#include "code_grad_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDxTok = 128;   // dx: tokens per block
constexpr int kDxCol = 64;    // dx: columns of m per block
constexpr int kDxRows = kDxTok / (kThreads / kDxCol);  // 32 rows per thread
constexpr int kDwCol = 128;   // dw: columns of m per block (= threads)
constexpr int kDwTok = 64;    // dw: tokens per staged chunk

using hopper::to_f;

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
code_grad_dx_kernel(const T* __restrict__ vals, const int32_t* __restrict__ idx,
                    const TW* __restrict__ w, float* __restrict__ out, int nh,
                    int ntok, int kw, int m, int d, long long w_sh, long long w_sm) {
  extern __shared__ float smem[];
  constexpr int WP = kDxCol + 1;
  float* wt = smem;                                  // (d, WP) w_h^T tile
  float* vs = wt + d * WP;                           // (kDxTok, kw) values
  int* is = reinterpret_cast<int*>(vs + kDxTok * kw);  // (kDxTok, kw) ids

  const int tid = threadIdx.x;
  const int j = tid % kDxCol;
  const int rg = tid / kDxCol;
  const int n0 = blockIdx.x * kDxTok;
  const int m0 = blockIdx.y * kDxCol;
  const int tok_left = ntok - n0;
  float acc[kDxRows];
#pragma unroll
  for (int i = 0; i < kDxRows; ++i) acc[i] = 0.0f;

  for (int h = 0; h < nh; ++h) {
    __syncthreads();  // the previous head's tiles are consumed
    const TW* wh = w + static_cast<size_t>(h) * w_sh;
    for (int t = tid; t < kDxCol * d; t += kThreads) {
      const int r = t / d, c = t % d;
      wt[c * WP + r] = m0 + r < m ? to_f(wh[static_cast<size_t>(m0 + r) * w_sm + c]) : 0.0f;
    }
    const size_t code0 = (static_cast<size_t>(h) * ntok + n0) * kw;
    for (int t = tid; t < kDxTok * kw; t += kThreads) {
      const bool ok = t / kw < tok_left;
      const int id = ok ? idx[code0 + t] : -1;
      vs[t] = ok ? to_f(vals[code0 + t]) : 0.0f;
      is[t] = (id >= 0 && id < d) ? id : -1;
    }
    __syncthreads();
    for (int t = 0; t < kw; ++t) {
#pragma unroll
      for (int i = 0; i < kDxRows; ++i) {
        const int r = rg * kDxRows + i;
        const int id = is[r * kw + t];
        if (id >= 0) acc[i] += vs[r * kw + t] * wt[id * WP + j];
      }
    }
  }
  if (m0 + j < m) {
#pragma unroll
    for (int i = 0; i < kDxRows; ++i) {
      const int r = rg * kDxRows + i;
      if (r < tok_left) out[static_cast<size_t>(n0 + r) * m + m0 + j] = acc[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kDwCol)
code_grad_dw_kernel(const T* __restrict__ x, const T* __restrict__ vals,
                    const int32_t* __restrict__ idx, float* __restrict__ part,
                    int nh, int ntok, int kw, int m, int d, int split_len) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* acc = smem;                                   // (kDwCol, dp)
  float* vs = acc + kDwCol * dp;                       // (kDwTok, kw)
  int* is = reinterpret_cast<int*>(vs + kDwTok * kw);  // (kDwTok, kw)

  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int m0 = blockIdx.y * kDwCol;
  const int s = blockIdx.z;
  const int t_begin = s * split_len;
  const int t_end = min(ntok, t_begin + split_len);
  const bool col_ok = m0 + j < m;
  for (int t = j; t < kDwCol * dp; t += kDwCol) acc[t] = 0.0f;
  float* arow = acc + j * dp;

  for (int c0 = t_begin; c0 < t_end; c0 += kDwTok) {
    const int chunk = min(kDwTok, t_end - c0);
    __syncthreads();  // the previous chunk is consumed (and acc zeroed)
    const size_t code0 = (static_cast<size_t>(h) * ntok + c0) * kw;
    for (int t = j; t < chunk * kw; t += kDwCol) {
      const int id = idx[code0 + t];
      vs[t] = to_f(vals[code0 + t]);
      is[t] = (id >= 0 && id < d) ? id : -1;
    }
    __syncthreads();
    if (col_ok) {
      const T* xcol = x + static_cast<size_t>(c0) * m + m0 + j;
      for (int r = 0; r < chunk; ++r) {
        const float xv = to_f(xcol[static_cast<size_t>(r) * m]);
        for (int t = 0; t < kw; ++t) {
          const int id = is[r * kw + t];
          if (id >= 0) arow[id] += xv * vs[r * kw + t];
        }
      }
    }
  }
  __syncthreads();
  // this split's (128, d) block of dW_h, written coalesced
  float* dst = part + ((static_cast<size_t>(s) * nh + h) * m + m0) * d;
  const int rows = min(kDwCol, m - m0);
  for (int t = j; t < rows * d; t += kDwCol) dst[t] = acc[(t / d) * dp + t % d];
}

template <typename T, typename TW>
int launch_dx(const void* vals, const void* idx, const void* w, void* out, int nh,
              int ntok, int kw, int m, int d, long long w_sh, long long w_sm,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(d) * (kDxCol + 1) + kDxTok * kw)
                      + sizeof(int) * kDxTok * kw;
  auto kernel = code_grad_dx_kernel<T, TW>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((ntok + kDxTok - 1) / kDxTok, (m + kDxCol - 1) / kDxCol);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(idx),
      static_cast<const TW*>(w), static_cast<float*>(out), nh, ntok, kw, m, d, w_sh, w_sm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw(const void* x, const void* vals, const void* idx, void* out, void* part,
              int nh, int ntok, int kw, int m, int d, int splits, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kDwCol) * (d + 1) + kDwTok * kw)
                      + sizeof(int) * kDwTok * kw;
  auto kernel = code_grad_dw_kernel<T>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int split_len = (ntok + splits - 1) / splits;
  float* dst = static_cast<float*>(splits == 1 ? out : part);
  const dim3 grid(nh, (m + kDwCol - 1) / kDwCol, splits);
  kernel<<<grid, kDwCol, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(vals),
      static_cast<const int32_t*>(idx), dst, nh, ntok, kw, m, d, split_len);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t count = static_cast<size_t>(nh) * m * d;
  sum_splits_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), count, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// vals (nh, ntok, kw) f32|bf16 and idx int32, contiguous; w heads (nh, m, d)
// in f32|bf16 at element strides (w_sh, w_sm, 1); out (ntok, m) f32.
// kw <= 64, d <= 256. Returns the launch's cudaGetLastError().
extern "C" int code_grad_dx_launch(const void* vals, const void* idx, const void* w,
                                   void* out, int nh, int ntok, int kw, int m, int d,
                                   long long w_sh, long long w_sm, int vals_bf16,
                                   int w_bf16, void* stream) {
  cudaGetLastError();
  if (ntok <= 0 || m <= 0) return 0;
  if (nh <= 0 || kw <= 0 || kw > 64 || d <= 0 || d > 256 || m > 65535 * kDxCol)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_bf16 && w_bf16)
    return launch_dx<__nv_bfloat16, __nv_bfloat16>(vals, idx, w, out, nh, ntok, kw, m, d, w_sh, w_sm, s);
  if (vals_bf16)
    return launch_dx<__nv_bfloat16, float>(vals, idx, w, out, nh, ntok, kw, m, d, w_sh, w_sm, s);
  if (w_bf16)
    return launch_dx<float, __nv_bfloat16>(vals, idx, w, out, nh, ntok, kw, m, d, w_sh, w_sm, s);
  return launch_dx<float, float>(vals, idx, w, out, nh, ntok, kw, m, d, w_sh, w_sm, s);
}

// x (ntok, m) and vals (nh, ntok, kw) in one dtype, f32|bf16, idx int32,
// all contiguous; out (nh, m, d) f32; part (splits, nh, m, d) f32 scratch,
// unused when splits == 1. kw <= 64, d <= 256. Returns the last launch's
// cudaGetLastError().
extern "C" int code_grad_dw_launch(const void* x, const void* vals, const void* idx,
                                   void* out, void* part, int nh, int ntok, int kw,
                                   int m, int d, int splits, int is_bf16, void* stream) {
  cudaGetLastError();
  if (nh <= 0 || m <= 0) return 0;
  if (ntok <= 0 || kw <= 0 || kw > 64 || d <= 0 || d > 256 || splits <= 0 ||
      nh > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dw<__nv_bfloat16>(x, vals, idx, out, part, nh, ntok, kw, m, d, splits, s)
                 : launch_dw<float>(x, vals, idx, out, part, nh, ntok, kw, m, d, splits, s);
}
