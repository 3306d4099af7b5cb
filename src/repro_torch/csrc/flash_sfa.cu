// flash_sfa.cu — FlashSFA forward (prefill attention) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_sfa.py::flash_sfa, both
// schedules: block_skip=False (Pallas body _flash_sfa_kernel, helpers
// _tile_update, _finalize_tile, _densify_block) and block_skip=True (body
// _flash_sfa_skip_kernel). It computes
//   out = softmax(densify(Q~) . densify(K~)^T * scale + mask) . V
// from top-k codes (bh, n, k) (values + int32 indices) and V (bh, nk, dv),
// with online softmax over key tiles, never forming the (n, n) matrix;
// optionally it also writes the per-row LSE = m + log(l) that the training
// slice's backward needs. Keys >= nk and, when causal, keys j > i are
// masked. Duplicate indices sum on densify, so padding rows (idx 0, val 0)
// densify to zero; indices outside [0, d) contribute nothing.
//
// Design: one block of 256 threads per (bh, 64-row query tile), looping
// over 64-key tiles up to the causal edge. Each key tile's codes are
// densified into shared memory as a (64 x d) f32 tile (one thread per key
// row adds its k entries in order), and V is staged as f32. Each query row
// is served by 4 threads; a thread scores its row against the tile by
// gathering the row's own k coordinates from the dense K tile,
//   s_ij = scale * sum_t qv[i,t] * Kd[j, qi[i,t]],
// which is k multiply-adds per score instead of d — the paper's
// Theta(n^2 k^2 / d) point, where the TPU kernel ran a dense d-wide matmul
// on its matrix unit. The 4 threads of a row compute the same scores and
// softmax state and split the dv output columns between them (columns
// c*4 + sub, so the V tile is read without bank conflicts). Softmax and
// accumulation run in f32; out is written in v's dtype.
//
// Block skip: given a level map (bh, nq/64, nk/64) int32 built at this
// kernel's own 64 x 64 tile (kernels/flash_sfa.py::_block_maps) and the
// per-tile V row sums vsum (bh, nk/64, dv) f32, each (query tile, key tile)
// step reads its level, uniform across the block: 0 = dead, nothing; 1 =
// the tiles' feature occupancies do not overlap on a fully visible tile, so
// every score is exactly 0 and the online-softmax update has the closed
// form m' = max(m, 0), acc' = acc e^(m - m') + e^(-m') vsum,
// l' = l e^(m - m') + 64 e^(-m') (flash_sfa.py:181-194) — no K codes or V
// tile are read; 2 = the tile update below. The TPU's "fetch" map has no
// counterpart: it only keeps the TPU pipeline from copying a skipped K/V
// block, and a CUDA block reads only the tiles it computes. With a null
// level map every tile is level 2 (block_skip=False).
//
// dv is 32, 64, 80, 128 or 256 (any multiple of 4 fits the body: 4 threads
// a row, DV / 4 columns each); dv 80 and 256 serve hubert-xlarge's and
// paligemma-3b's head dims, which the tensor-core body does not take. Above
// dv 128 (kWideDV) a thread would keep 64 accumulators beside the 64 scores
// of a tile, fully unrolled: there the row's 4 threads score a quarter of
// the keys each, exchange the row's max and sum by warp shuffles and stage
// p in a (64 x 68) shared tile that the P.V loop reads, which cuts the
// score work 4x and the registers, and keeps the body cheap to compile.
// The K and V tiles take 128 KB of shared memory at 256 (the opt-in below).
//
// Bound on the H100: operations. Per (query, key) pair the kernel does 2k
// flops of score and 2dv of P.V, against O(n k + n dv) bytes moved, all on
// CUDA cores in f32. That is the exact path, kept for f32 (the tensor cores
// would compute in TF32, which fails f32's 1e-4) and for bf16 shapes the
// tensor-core body does not take (d != dv, k > 32); bf16 with d = dv in
// {32, 64, 128} and k <= 32 runs flash_sfa_tc.cu instead, 7x faster at the
// serving shape (PERF.md, PR 16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 4 threads per query row
constexpr float kNegInf = -1e30f;
constexpr int kWideDV = 128;  // wider rows score a quarter of the keys a thread
constexpr int kPS = kBK + 4;  // row stride of the wide rows' p tile (no bank conflict)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <int DV, typename T>
__global__ void __launch_bounds__(kThreads)
flash_sfa_fwd_kernel(const T* __restrict__ qv, const int32_t* __restrict__ qi,
                     const T* __restrict__ kv, const int32_t* __restrict__ ki,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, const int32_t* __restrict__ level,
                     const float* __restrict__ vsum, int nq, int nk, int kq, int kk,
                     int d, float scale, int causal) {
  constexpr int DVT = DV / 4;
  extern __shared__ float smem[];
  // the K tile's row stride: d, or d + 1 for wide rows, whose 4 threads
  // read 4 different rows of it at once (at d 256 all in one bank)
  const int dk = DV > kWideDV ? d + 1 : d;
  float* kd = smem;                   // (kBK, dk)  densified key tile
  float* vs = kd + kBK * dk;          // (kBK, DV)  value tile
  float* qvs = vs + kBK * DV;         // (kBQ, kq)  query code values
  int* qis = reinterpret_cast<int*>(qvs + kBQ * kq);  // (kBQ, kq) indices
  float* ps = reinterpret_cast<float*>(qis + kBQ * kq);  // DV > kWideDV: (kBQ, kPS) p

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int sub = tid & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int row = q0 + r;

  for (int t = tid; t < kBQ * kq; t += kThreads) {
    const int qr = q0 + t / kq;
    float val = 0.0f;
    int id = -1;
    if (qr < nq) {
      const size_t o = (static_cast<size_t>(bh) * nq + qr) * kq + t % kq;
      val = to_f(qv[o]);
      id = qi[o];
    }
    qvs[t] = val;
    qis[t] = (id >= 0 && id < d) ? id : -1;
  }

  float m = kNegInf;
  float l = 0.0f;
  float acc[DVT];
#pragma unroll
  for (int c = 0; c < DVT; ++c) acc[c] = 0.0f;

  const int k_end = causal ? min(nk, q0 + kBQ) : nk;
  const int nkb = (nk + kBK - 1) / kBK;
  const int32_t* lvl_row =
      level ? level + (static_cast<size_t>(bh) * gridDim.x + blockIdx.x) * nkb : nullptr;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int lvl = lvl_row ? lvl_row[k0 / kBK] : 2;
    if (lvl == 0) continue;
    if (lvl == 1) {  // zero feature overlap on a fully visible tile
      const float m_new = fmaxf(m, 0.0f);
      const float corr = expf(m - m_new);
      const float e = expf(-m_new);
      const float* vs_row = vsum + (static_cast<size_t>(bh) * nkb + k0 / kBK) * DV + sub;
#pragma unroll
      for (int c = 0; c < DVT; ++c) acc[c] = acc[c] * corr + e * vs_row[c * 4];
      l = l * corr + kBK * e;
      m = m_new;
      continue;
    }
    __syncthreads();  // the previous tile is consumed (and q codes staged)
    for (int t = tid; t < kBK * dk; t += kThreads) kd[t] = 0.0f;
    for (int t = tid; t < kBK * DV; t += kThreads) {
      const int kr = k0 + t / DV;
      vs[t] = kr < nk ? to_f(v[(static_cast<size_t>(bh) * nk + kr) * DV + t % DV]) : 0.0f;
    }
    __syncthreads();
    if (tid < kBK && k0 + tid < nk) {
      const size_t base = (static_cast<size_t>(bh) * nk + k0 + tid) * kk;
      float* dst = kd + tid * dk;
      for (int t = 0; t < kk; ++t) {
        const int id = ki[base + t];
        if (id >= 0 && id < d) dst[id] += to_f(kv[base + t]);
      }
    }
    __syncthreads();

    if constexpr (DV > kWideDV) {
      // wide rows: the row's 4 threads score a quarter of the keys each
      // (keys sub + 4j), share the row's max and sum by shuffles and stage
      // p in shared memory, so the P.V loop reads p there and need not be
      // unrolled over the keys beside DV / 4 accumulators
      constexpr int KQ = kBK / 4;
      float s[KQ];
#pragma unroll
      for (int j = 0; j < KQ; ++j) s[j] = 0.0f;
      for (int t = 0; t < kq; ++t) {
        const int id = qis[r * kq + t];
        if (id < 0) continue;
        const float qval = qvs[r * kq + t];
        const float* col = kd + sub * dk + id;
#pragma unroll
        for (int j = 0; j < KQ; ++j) s[j] += qval * col[j * 4 * dk];
      }
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < KQ; ++j) {
        const int col = k0 + sub + 4 * j;
        const bool ok = col < nk && (!causal || col <= row);
        s[j] = ok ? s[j] * scale : kNegInf;
        mt = fmaxf(mt, s[j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m, mt);
      const float corr = expf(m - m_new);
      float psum = 0.0f;
      float* prow = ps + r * kPS;
#pragma unroll
      for (int j = 0; j < KQ; ++j) {
        const float p = expf(s[j] - m_new);
        psum += p;
        prow[sub + 4 * j] = p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      __syncwarp();  // a row's 4 threads are 4 lanes of one warp
#pragma unroll
      for (int c = 0; c < DVT; ++c) acc[c] *= corr;
#pragma unroll 2
      for (int j = 0; j < kBK; ++j) {
        const float p = prow[j];
        const float* vrow = vs + j * DV + sub;
#pragma unroll
        for (int c = 0; c < DVT; ++c) acc[c] += p * vrow[c * 4];
      }
      l = l * corr + psum;
      m = m_new;
    } else {
      // scores: the row's k code entries, each times one column of the tile
      float s[kBK];
#pragma unroll
      for (int j = 0; j < kBK; ++j) s[j] = 0.0f;
      for (int t = 0; t < kq; ++t) {
        const int id = qis[r * kq + t];
        if (id < 0) continue;
        const float qval = qvs[r * kq + t];
        const float* col = kd + id;
#pragma unroll
        for (int j = 0; j < kBK; ++j) s[j] += qval * col[j * d];
      }
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const int col = k0 + j;
        const bool ok = col < nk && (!causal || col <= row);
        s[j] = ok ? s[j] * scale : kNegInf;
        mt = fmaxf(mt, s[j]);
      }
      const float m_new = fmaxf(m, mt);
      const float corr = expf(m - m_new);
#pragma unroll
      for (int c = 0; c < DVT; ++c) acc[c] *= corr;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float p = expf(s[j] - m_new);
        psum += p;
        const float* vrow = vs + j * DV + sub;
#pragma unroll
        for (int c = 0; c < DVT; ++c) acc[c] += p * vrow[c * 4];
      }
      l = l * corr + psum;
      m = m_new;
    }
  }

  if (row < nq) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + (static_cast<size_t>(bh) * nq + row) * DV + sub;
#pragma unroll
    for (int c = 0; c < DVT; ++c) from_f(acc[c] / denom, orow + c * 4);
    if (lse != nullptr && sub == 0) lse[static_cast<size_t>(bh) * nq + row] = m + logf(denom);
  }
}

template <int DV, typename T>
int launch(const void* qv, const void* qi, const void* kv, const void* ki,
           const void* v, void* out, void* lse, const void* level, const void* vsum,
           int bh, int nq, int nk, int kq, int kk, int d, float scale, int causal,
           cudaStream_t stream) {
  const size_t dk = DV > kWideDV ? d + 1 : d;  // the kernel's K tile stride
  const size_t smem = sizeof(float) * (kBK * dk + kBK * DV + kBQ * kq) + sizeof(int) * kBQ * kq
                      + (DV > kWideDV ? sizeof(float) * kBQ * kPS : 0);
  auto kernel = flash_sfa_fwd_kernel<DV, T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((nq + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qv), static_cast<const int32_t*>(qi),
      static_cast<const T*>(kv), static_cast<const int32_t*>(ki),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      static_cast<const int32_t*>(level), static_cast<const float*>(vsum),
      nq, nk, kq, kk, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q codes (bh, nq, kq), k codes (bh, nk, kk): values f32|bf16 + int32 ids;
// v (bh, nk, dv) and out (bh, nq, dv) in the codes' dtype; lse (bh, nq) f32
// or null; level (bh, ceil(nq/64), ceil(nk/64)) int32 and vsum
// (bh, ceil(nk/64), dv) f32, both null without block skip. All contiguous.
// Returns the launch's cudaGetLastError().
extern "C" int flash_sfa_fwd_launch(const void* qv, const void* qi, const void* kv,
                                    const void* ki, const void* v, void* out,
                                    void* lse, const void* level, const void* vsum,
                                    int bh, int nq, int nk, int kq,
                                    int kk, int d, int dv, float scale,
                                    int causal, int is_bf16, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || nq <= 0) return 0;
  if (bh > 65535 || d <= 0 || d > 256 || kq <= 0 || kk <= 0 || nk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((level == nullptr) != (vsum == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SFA_FWD_CASE(DVV)                                                                    \
  if (dv == DVV)                                                                             \
    return is_bf16 ? launch<DVV, __nv_bfloat16>(qv, qi, kv, ki, v, out, lse, level, vsum, bh, \
                                                nq, nk, kq, kk, d, scale, causal, s)         \
                   : launch<DVV, float>(qv, qi, kv, ki, v, out, lse, level, vsum, bh, nq, nk, \
                                        kq, kk, d, scale, causal, s);
  SFA_FWD_CASE(32)
  SFA_FWD_CASE(64)
  SFA_FWD_CASE(80)
  SFA_FWD_CASE(128)
  SFA_FWD_CASE(256)
#undef SFA_FWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
