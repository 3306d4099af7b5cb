// flash_sfa_decode.cu — one decode query against the sparse KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_sfa_decode.py::flash_sfa_decode
// (Pallas body _decode_kernel). For each (batch, head) row it computes
//   out = softmax_j(scale * q . densify(K~_j)) . V_j   over j < length,
// with q the (top-k sparsified) dense query (d floats), K~ the token-major
// cache of top-k codes, V the dense value cache; output in f32.
//
// Design: one block per (batch, head), 16 warps. The query is staged in
// shared memory as d floats. Warp w walks the cache tokens j = w, w+16, ...
// below the row's length; for each token the lanes t < k read one code
// entry each and gather q at its index (s_j = scale * sum_t kv[j,t] *
// q[ki[j,t]], k multiply-adds, no densify), a shuffle reduction sums the
// score, and every lane updates the warp's online softmax (m, l) and its
// own dv/32 accumulator columns from the V row, which the warp reads as
// one coalesced line. The warps' states merge through shared memory at the
// end. The cache is read in place through strides: the SparseKV leaves
// (b, n, hkv, k) with k_idx packed uint8/uint16 (or int32), V (b, n, hkv,
// dv) in bf16 or f32, and head h reads kv head h / (heads / hkv) — no
// unpack, GQA repeat or f32 upcast copy of the cache is ever made.
//
// Bound on the H100: bytes. Each step reads len * (k * (val + idx bytes) +
// dv * val bytes) per kv head and does O(len * (k + dv)) flops. The grid
// is batch * heads blocks (96 for gpt2-small at 8 slots), below the 132
// SMs; splitting the cache across blocks (split-K) is work for a later
// change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Strides {
  long long b, n, h;  // elements; the last axis is contiguous
};

template <int DV, typename T, typename IT>
__global__ void __launch_bounds__(kWarps * 32)
flash_sfa_decode_kernel(const float* __restrict__ q, const T* __restrict__ kv,
                        const IT* __restrict__ ki, const T* __restrict__ v,
                        const int32_t* __restrict__ lengths, float* __restrict__ out,
                        int heads, int group, int kk, int d, int n_max,
                        Strides skv, Strides ski, Strides sv, float scale) {
  constexpr int CPL = DV / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                    // (d)
  float* wm = qs + d;                  // (kWarps)
  float* wl = wm + kWarps;             // (kWarps)
  float* wacc = wl + kWarps;           // (kWarps, DV)

  const int row = blockIdx.x;          // b * heads + h
  const int b = row / heads;
  const int hk = (row % heads) / group;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = min(max(lengths[row], 0), n_max);

  for (int t = threadIdx.x; t < d; t += blockDim.x) qs[t] = q[static_cast<size_t>(row) * d + t];
  __syncthreads();

  const T* kv_row = kv + b * skv.b + hk * skv.h;
  const IT* ki_row = ki + b * ski.b + hk * ski.h;
  const T* v_row = v + b * sv.b + hk * sv.h;

  float m = -CUDART_INF_F;
  float l = 0.0f;
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.0f;

#pragma unroll 4
  for (int j = warp; j < len; j += kWarps) {
    float part = 0.0f;
    for (int t = lane; t < kk; t += 32) {
      const unsigned id = static_cast<unsigned>(ki_row[j * ski.n + t]);
      if (id < static_cast<unsigned>(d)) part += to_f(kv_row[j * skv.n + t]) * qs[id];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
    const float s = part * scale;
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
    const T* vj = v_row + j * sv.n;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = acc[c] * corr + p * to_f(vj[lane + 32 * c]);
    m = m_new;
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) wacc[warp * DV + lane + 32 * c] = acc[c];
  __syncthreads();

  for (int c = threadIdx.x; c < DV; c += blockDim.x) {
    float result = 0.0f;
    if (len > 0) {  // a zero-length row has no keys: its output is 0
      float mx = -CUDART_INF_F;
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w]);
      float lsum = 0.0f;
      float a = 0.0f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(wm[w] - mx);  // 0 for warps that saw no token
        lsum += wl[w] * f;
        a += wacc[w * DV + c] * f;
      }
      result = a / fmaxf(lsum, 1e-30f);
    }
    out[static_cast<size_t>(row) * DV + c] = result;
  }
}

template <int DV, typename T, typename IT>
int launch(const void* q, const void* kv, const void* ki, const void* v,
           const void* lengths, void* out, int batch, int heads, int group,
           int kk, int d, int n_max, Strides skv, Strides ski, Strides sv,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (d + 2 * kWarps + kWarps * DV);
  flash_sfa_decode_kernel<DV, T, IT><<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(kv),
      static_cast<const IT*>(ki), static_cast<const T*>(v),
      static_cast<const int32_t*>(lengths), static_cast<float*>(out), heads,
      group, kk, d, n_max, skv, ski, sv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DV, typename T>
int by_index(int idx_kind, const void* q, const void* kv, const void* ki,
             const void* v, const void* lengths, void* out, int batch,
             int heads, int group, int kk, int d, int n_max, Strides skv,
             Strides ski, Strides sv, float scale, cudaStream_t s) {
  switch (idx_kind) {
    case 0: return launch<DV, T, uint8_t>(q, kv, ki, v, lengths, out, batch, heads, group, kk, d, n_max, skv, ski, sv, scale, s);
    case 1: return launch<DV, T, uint16_t>(q, kv, ki, v, lengths, out, batch, heads, group, kk, d, n_max, skv, ski, sv, scale, s);
    case 2: return launch<DV, T, int32_t>(q, kv, ki, v, lengths, out, batch, heads, group, kk, d, n_max, skv, ski, sv, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (batch*heads, d) f32; cache leaves indexed [b, n, kv_head, :] through
// the given element strides (last axis contiguous): k_vals and v in f32
// (val_kind 0) or bf16 (1), k_idx uint8 (idx_kind 0), uint16 (1) or int32
// (2); lengths (batch*heads,) int32; out (batch*heads, dv) f32.
extern "C" int flash_sfa_decode_launch(
    const void* q, const void* kv, const void* ki, const void* v,
    const void* lengths, void* out, int batch, int heads, int hkv, int kk,
    int d, int dv, int n_max, long long kv_sb, long long kv_sn, long long kv_sh,
    long long ki_sb, long long ki_sn, long long ki_sh, long long v_sb,
    long long v_sn, long long v_sh, float scale, int val_kind, int idx_kind,
    void* stream) {
  cudaGetLastError();
  if (batch <= 0 || heads <= 0) return 0;
  if (hkv <= 0 || heads % hkv != 0 || kk <= 0 || d <= 0 || n_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = heads / hkv;
  const Strides skv{kv_sb, kv_sn, kv_sh}, ski{ki_sb, ki_sn, ki_sh}, sv{v_sb, v_sn, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dv == 32) {
    return val_kind ? by_index<32, __nv_bfloat16>(idx_kind, q, kv, ki, v, lengths, out, batch, heads, group, kk, d, n_max, skv, ski, sv, scale, s)
                    : by_index<32, float>(idx_kind, q, kv, ki, v, lengths, out, batch, heads, group, kk, d, n_max, skv, ski, sv, scale, s);
  }
  if (dv == 64) {
    return val_kind ? by_index<64, __nv_bfloat16>(idx_kind, q, kv, ki, v, lengths, out, batch, heads, group, kk, d, n_max, skv, ski, sv, scale, s)
                    : by_index<64, float>(idx_kind, q, kv, ki, v, lengths, out, batch, heads, group, kk, d, n_max, skv, ski, sv, scale, s);
  }
  if (dv == 128) {
    return val_kind ? by_index<128, __nv_bfloat16>(idx_kind, q, kv, ki, v, lengths, out, batch, heads, group, kk, d, n_max, skv, ski, sv, scale, s)
                    : by_index<128, float>(idx_kind, q, kv, ki, v, lengths, out, batch, heads, group, kk, d, n_max, skv, ski, sv, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
