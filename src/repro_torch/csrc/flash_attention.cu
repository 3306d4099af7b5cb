// flash_attention.cu — dense FlashAttention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_fwd, Pallas body _flash_kernel): the paper's dense baseline,
//   out = softmax(Q . K^T * scale + mask) . V,   LSE = m + log(l),
// with online softmax over key tiles, never forming the (n, n) matrix. Keys
// >= nk and, when causal, keys j > i are masked. q/k/v are (bh, n, d) with
// d == dv; out is in their dtype, the LSE f32.
//
// Design: the dense twin of flash_sfa.cu. One block of 256 threads per
// (bh, 64-query tile), looping over 64-key tiles up to the causal edge; Q,
// K and V tiles are staged in shared memory as f32 (rows padded to d + 1,
// so the 8 rows a warp reads at once fall in different banks). 4 threads
// serve a query row: each scores a quarter of the tile's keys (a d-wide dot
// product), the row's max and sum are combined across the 4 lanes with
// shuffles, P goes through shared memory, and each thread accumulates a
// quarter of the dv output columns. Softmax and accumulation run in f32.
//
// Bound on the H100: operations. Per (query, key) pair it does 2d flops of
// score and 2dv of P.V against O(n (d + dv)) bytes; both products run on
// CUDA cores in f32 here, where a faster kernel would put them on the
// tensor cores (wgmma) — work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;          // query rows per block == keys per tile
constexpr int kThreads = 256;   // 4 threads per query row
constexpr int kP = kB + 1;      // padded stride of the P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <int D, typename T>
__device__ void stage(float* dst, const T* src, size_t row0, int rows_left) {
  for (int t = threadIdx.x; t < kB * D; t += kThreads) {
    const int r = t / D;
    dst[r * (D + 1) + t % D] = r < rows_left ? to_f(src[(row0 + r) * D + t % D]) : 0.0f;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int nq, int nk, float scale,
                           int causal) {
  constexpr int DP = D + 1;
  constexpr int KT = kB / 4;      // keys per thread per tile
  extern __shared__ float smem[];
  float* qs = smem;               // (kB, DP)
  float* ks = qs + kB * DP;       // (kB, DP)
  float* vs = ks + kB * DP;       // (kB, DP)
  float* ps = vs + kB * DP;       // (kB, kP)

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int sub = tid & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int row = q0 + r;
  const size_t qrow0 = static_cast<size_t>(bh) * nq + q0;

  stage<D>(qs, q, qrow0, nq - q0);
  float m = kNegInf;
  float l = 0.0f;
  float acc[D / 4];
#pragma unroll
  for (int a = 0; a < D / 4; ++a) acc[a] = 0.0f;

  const int k_end = causal ? min(nk, q0 + kB) : nk;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();  // the previous tile is consumed (and Q staged)
    const size_t krow0 = static_cast<size_t>(bh) * nk + k0;
    stage<D>(ks, k, krow0, nk - k0);
    stage<D>(vs, v, krow0, nk - k0);
    __syncthreads();

    float s[KT];
    float mt = kNegInf;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int j = sub + 4 * t;
      const int key = k0 + j;
      float dot = 0.0f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) dot += qs[r * DP + c] * ks[j * DP + c];
      const bool ok = key < nk && (!causal || key <= row);
      s[t] = ok ? dot * scale : kNegInf;
      mt = fmaxf(mt, s[t]);
    }
    // the row's 4 threads are 4 neighbouring lanes of one warp
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const float p = s[t] == kNegInf ? 0.0f : expf(s[t] - m_new);
      ps[r * kP + sub + 4 * t] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    __syncwarp();
#pragma unroll
    for (int a = 0; a < D / 4; ++a) acc[a] *= corr;
    for (int j = 0; j < kB; ++j) {
      const float p = ps[r * kP + j];
      const float* vrow = vs + j * DP + sub;
#pragma unroll
      for (int a = 0; a < D / 4; ++a) acc[a] += p * vrow[4 * a];
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (row < nq) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + (qrow0 + r) * D + sub;
#pragma unroll
    for (int a = 0; a < D / 4; ++a) from_f(acc[a] / denom, orow + 4 * a);
    if (lse != nullptr && sub == 0) lse[qrow0 + r] = m + logf(denom);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int bh, int nq, int nk, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * kB * (D + 1) + kB * kP);
  auto kernel = flash_attention_fwd_kernel<D, T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3((nq + kB - 1) / kB, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), nq, nk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (bh, nq, d), k and v (bh, nk, d), out (bh, nq, d): f32|bf16, one dtype,
// d in {32, 64, 128}; lse (bh, nq) f32 or null. All contiguous. Returns the
// launch's cudaGetLastError().
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          void* out, void* lse, int bh, int nq, int nk,
                                          int d, float scale, int causal, int is_bf16,
                                          void* stream) {
  cudaGetLastError();
  if (bh <= 0 || nq <= 0) return 0;
  if (bh > 65535 || nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32) {
    return is_bf16 ? launch<32, __nv_bfloat16>(q, k, v, out, lse, bh, nq, nk, scale, causal, s)
                   : launch<32, float>(q, k, v, out, lse, bh, nq, nk, scale, causal, s);
  }
  if (d == 64) {
    return is_bf16 ? launch<64, __nv_bfloat16>(q, k, v, out, lse, bh, nq, nk, scale, causal, s)
                   : launch<64, float>(q, k, v, out, lse, bh, nq, nk, scale, causal, s);
  }
  if (d == 128) {
    return is_bf16 ? launch<128, __nv_bfloat16>(q, k, v, out, lse, bh, nq, nk, scale, causal, s)
                   : launch<128, float>(q, k, v, out, lse, bh, nq, nk, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
