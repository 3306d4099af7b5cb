// flash_sfa_bwd.cu — FlashSFA backward (dense, compact and compact2 emits)
// and the f32 dense FlashAttention backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/flash_sfa_bwd.py::flash_sfa_bwd
// (every emit) and, for f32, ::flash_attention_bwd: both run _bwd_impl,
// whose two Pallas kernels _bwd_dq_kernel and _bwd_dkv_kernel recompute
// each tile's probabilities from the saved LSE and accumulate
//   dV_j  = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . V_j - D_i) * scale,   D_i = sum(dO_i * O_i)
//   dQ_i  = sum_j dS_ij K_j,   dK_j = sum_i dS_ij Q_i.
// The template flag SPARSE selects the two forms from one source, as the
// TPU's `sparse` parameter does: SPARSE=true takes top-k codes (values +
// int32 indices, (bh, n, k)); SPARSE=false takes dense
// (bh, n, d) q/k with d == dv and emits plain dQ/dK. D_i comes in from the
// caller (the JAX package computes it in XLA outside the kernel too).
// The SPARSE form writes dQ/dK in one of three emits, a launch parameter:
//  0 dense    (n, d) rows, zero off each row's stored coordinates (the
//             straight-through gradient of paper Eq. 6, _support_mask);
//  1 compact  (n, k): slot t holds the gradient at stored index idx[t]
//             (_gather_support; 0 where idx[t] is outside [0, d); a
//             duplicate index gets the full value in each of its slots);
//  2 compact2 (n, 2k) on the RoPE pair closure (_pair_closure_gather):
//             slot t holds the value if idx[t] is even or >= rot_dim, slot
//             k + t if it is odd and < rot_dim; the other slot holds 0.
// The k-wide accumulators below are exactly the compact values, so the
// compact emits write them straight from registers: no dense tile, k (2k)
// values per row where the dense emit writes d.
//
// Design: two kernels, each output tile owned by one block, so there are no
// atomics and the result is deterministic. A tile is KB rows: 64, or 32 at
// dv 256 (below); R = 256 / KB threads share a row.
//  * dQ: one block of 256 threads per (bh, KB-query tile), looping over the
//    KB-key tiles up to the causal edge. Each key tile is densified into
//    shared memory (duplicate indices sum, indices outside [0, d) add
//    nothing, as in the forward). Phase A: R threads per query row, each
//    scoring its 1/R of the tile's keys (the query's k stored coordinates
//    gathered from the dense K tile: k multiply-adds per score, not d),
//    and writing dS to shared memory. Phase B: each thread accumulates
//    dQ_i[c] = sum_j dS_ij K_j[c] only on its share of the query's k stored
//    coordinates, gathering from the same K tile — k multiply-adds per pair
//    where the TPU ran a d-wide matmul (the backward half of the paper's
//    Theta(n^2 k^2 / d)).
//  * dK/dV: one block per (bh, KB-key tile), looping over the query tiles
//    from the causal diagonal to the end. Each query tile is densified into
//    shared memory; R threads per key row score 1/R of its queries each
//    (the key's own k coordinates gathered from the dense Q tile) and write
//    P and dS; then each thread accumulates its 1/R of dV_j (dv-wide) and
//    of dK_j on the key's k stored coordinates.
// dv is 32, 64, 80, 128 or 256 for SPARSE (80 is hubert-xlarge's head dim:
// the tiles are staged at a stride of dv + 1 and the columns split R ways,
// so any multiple of R fits), 32, 64 or 128 for the dense form. At d = dv
// 256 (paligemma-3b in f32) 64-row tiles do not fit: the dQ kernel stages
// K, V and dO as f32 at a stride of 257 beside dS and the query codes,
// 222,208 B at k 16 and 230,400 at k 32, and the dK/dV kernel 239,360 B at
// k 16, over the 232,448 B a block may have. dv 256 therefore runs on
// 32-row tiles, R = 8: 111,104 B (dQ) and 115,584 B (dK/dV) at k 32, each
// thread holding 32 dV columns where it held 64 at 64 rows. Halving the
// rows changes nothing in the arithmetic (each sum still runs over the
// same keys or queries in the same order) and leaves the instantiations at
// dv <= 128 as they were; staging V and dO in halves of dv instead would
// have split dP = dO.V over two passes with a barrier between them. dv
// 256 is instantiated for f32 only: bf16 at d = dv 256 runs
// flash_sfa_tc_wide.cu (the tensor-core body).
// Ragged n is masked inside the kernels. All sums run in f32; dQ/dK come
// out in the code values' dtype and dV in v's dtype.
//
// Bound on the H100: operations. Per (query, key) pair the two kernels do
// about 2 * (2k + 2dv) + 2k + 2dv flops (scores twice, dO.V twice, dQ, dK,
// dV) on CUDA cores against O(n (k + dv)) bytes. That is the exact path,
// kept for f32 (the tensor cores would compute in TF32, which fails f32's
// 1e-4) and for bf16 shapes the tensor-core body does not take (d != dv);
// bf16 with d = dv in {32, 64, 80, 128, 256} and k <= 32 runs
// flash_sfa_tc.cu / flash_sfa_tc_wide.cu, which densify the code tiles into
// shared memory and run every product on the tensor cores, 12x faster at
// the training shape (PERF.md).
//
// The dense form (SPARSE=false) is built for f32 only: it is the exact f32
// path of the dense FlashAttention backward, where the tensor cores would
// compute in TF32. bf16 dense goes to flash_attention.cu's wgmma kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // a block; kThreads / KB threads per row
constexpr int kMaxK = 32;      // largest code width the kernels take

// rows per tile (query rows == keys) at value width DV: 64, or 32 where
// 64-row f32 tiles of 256 columns do not fit in shared memory
template <int DV>
__host__ __device__ constexpr int tile_rows() { return DV > 128 ? 32 : 64; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// Stage one KB-row tile of one side (queries or keys) into shared memory as
// dense f32 rows of stride dp: the densified codes (SPARSE) or the dense
// rows. Rows >= n are zero. Call between two __syncthreads(); the densify
// needs a second barrier, which this function takes itself.
template <bool SPARSE, int KB, typename T>
__device__ void stage_dense(float* dst, int dp, const T* a, const int32_t* idx,
                            size_t row0, int rows_left, int kw, int d) {
  const int tid = threadIdx.x;
  if (SPARSE) {
    for (int t = tid; t < KB * dp; t += kThreads) dst[t] = 0.0f;
    __syncthreads();
    if (tid < KB && tid < rows_left) {
      const size_t base = (row0 + tid) * kw;
      float* row = dst + tid * dp;
      for (int u = 0; u < kw; ++u) {
        const int id = idx[base + u];
        if (id >= 0 && id < d) row[id] += to_f(a[base + u]);
      }
    }
  } else {
    for (int t = tid; t < KB * d; t += kThreads) {
      const int r = t / d;
      dst[r * dp + t % d] = r < rows_left ? to_f(a[(row0 + r) * d + t % d]) : 0.0f;
    }
  }
}

// Stage a (KB x DV) tile of dv-wide rows (V or dO) at stride DV + 1.
template <int DV, int KB, typename T>
__device__ void stage_rows(float* dst, const T* src, size_t row0, int rows_left) {
  for (int t = threadIdx.x; t < KB * DV; t += kThreads) {
    const int r = t / DV;
    dst[r * (DV + 1) + t % DV] = r < rows_left ? to_f(src[(row0 + r) * DV + t % DV]) : 0.0f;
  }
}

// The columns a thread owns in a dQ/dK row, R threads a row: SPARSE — the
// row's stored coordinates u = sub, sub + R, ... (-1 where none); dense —
// c = sub + R a.
template <bool SPARSE, int DV, int R>
struct Cols {
  static constexpr int N = SPARSE ? kMaxK / R : DV / R;
  int c[N];
  __device__ void load(const int* ids, int kw, int d, int sub) {
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if (SPARSE) {
        const int u = sub + R * a;
        const int id = u < kw ? ids[u] : -1;
        c[a] = (id >= 0 && id < d) ? id : -1;
      } else {
        c[a] = sub + R * a;
      }
    }
  }
};

// Write a block's KB rows of dQ or dK. Compact emits (SPARSE only): each
// thread writes its own slots u = sub + R a of its row from registers.
// Dense: scatter each thread's accumulators into a zeroed (KB x d) shared
// tile (duplicate coordinates write the same value), then store the rows
// < rows_left coalesced. ids are the row's stored indices as given (kw of
// them), for the compact2 parity test.
template <bool SPARSE, int DV, int KB, typename T>
__device__ void emit_rows(float* tile, int dp, const Cols<SPARSE, DV, kThreads / KB>& cols,
                          const float* acc, int r, T* out, size_t row0,
                          int rows_left, int d, const int32_t* ids, int kw,
                          int emit, int rot_dim) {
  constexpr int R = kThreads / KB;
  const int tid = threadIdx.x;
  if (SPARSE && emit != 0) {  // uniform across the block
    if (r >= rows_left) return;
    const int sub = tid % R;
    T* orow = out + (row0 + r) * static_cast<size_t>(emit == 1 ? kw : 2 * kw);
#pragma unroll
    for (int a = 0; a < Cols<SPARSE, DV, R>::N; ++a) {
      const int u = sub + R * a;
      if (u >= kw) continue;
      const float g = cols.c[a] >= 0 ? acc[a] : 0.0f;
      if (emit == 1) {
        from_f(g, orow + u);
      } else {
        const int id = ids[u];
        const bool odd = id >= 0 && id < rot_dim && (id & 1);
        from_f(odd ? 0.0f : g, orow + u);
        from_f(odd ? g : 0.0f, orow + kw + u);
      }
    }
    return;
  }
  __syncthreads();  // the tile's previous contents are consumed
  for (int t = tid; t < KB * dp; t += kThreads) tile[t] = 0.0f;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < Cols<SPARSE, DV, R>::N; ++a)
    if (cols.c[a] >= 0) tile[r * dp + cols.c[a]] = acc[a];
  __syncthreads();
  for (int t = tid; t < KB * d; t += kThreads) {
    const int rr = t / d;
    if (rr < rows_left) from_f(tile[rr * dp + t % d], out + (row0 + rr) * d + t % d);
  }
}

template <bool SPARSE, int DV, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ qa, const int32_t* __restrict__ qi,
              const T* __restrict__ ka, const int32_t* __restrict__ ki,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int nq, int nk, int kq, int kk, int d,
              float scale, int causal, int emit, int rot_dim) {
  constexpr int KB = tile_rows<DV>();
  constexpr int R = kThreads / KB;   // threads a query row
  constexpr int KP = KB + 1;         // padded row stride of the (KB x KB) dS tile
  constexpr int DVP = DV + 1;
  const int dp = d + 1;
  extern __shared__ float smem[];
  float* kd = smem;                  // (KB, dp)  K tile, dense f32
  float* vs = kd + KB * dp;          // (KB, DVP) V tile
  float* dos = vs + KB * DVP;        // (KB, DVP) dO of this query tile
  float* dss = dos + KB * DVP;       // (KB, KP)  dS[i][j] of the tile pair
  float* qs = dss + KB * KP;         // SPARSE: (KB, kq) values; dense: (KB, dp)
  int* qis = reinterpret_cast<int*>(qs + KB * kq);  // SPARSE: (KB, kq) ids

  const int tid = threadIdx.x;
  const int r = tid / R;
  const int sub = tid % R;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * KB;
  const int row = q0 + r;
  const bool row_ok = row < nq;
  const size_t qrow0 = static_cast<size_t>(bh) * nq + q0;

  if (SPARSE) {
    for (int t = tid; t < KB * kq; t += kThreads) {
      const bool ok = t / kq < nq - q0;
      const int id = ok ? qi[qrow0 * kq + t] : -1;
      qs[t] = ok ? to_f(qa[qrow0 * kq + t]) : 0.0f;
      qis[t] = (id >= 0 && id < d) ? id : -1;
    }
  } else {
    stage_dense<false, KB>(qs, dp, qa, qi, qrow0, nq - q0, 0, d);
  }
  stage_rows<DV, KB>(dos, dout, qrow0, nq - q0);
  const float lse_r = row_ok ? lse[qrow0 + r] : 0.0f;
  const float delta_r = row_ok ? delta[qrow0 + r] : 0.0f;
  __syncthreads();
  Cols<SPARSE, DV, R> cols;
  cols.load(qis + r * kq, kq, d, sub);
  float acc[Cols<SPARSE, DV, R>::N];
#pragma unroll
  for (int a = 0; a < Cols<SPARSE, DV, R>::N; ++a) acc[a] = 0.0f;

  const int k_end = causal ? min(nk, q0 + KB) : nk;
  for (int k0 = 0; k0 < k_end; k0 += KB) {
    __syncthreads();  // the previous K/V tile is consumed
    const size_t krow0 = static_cast<size_t>(bh) * nk + k0;
    stage_dense<SPARSE, KB>(kd, dp, ka, ki, krow0, nk - k0, kk, d);
    stage_rows<DV, KB>(vs, v, krow0, nk - k0);
    __syncthreads();

    // phase A: dS for this thread's 1/R of the keys
    for (int t = 0; t < KB / R; ++t) {
      const int j = sub + R * t;
      const int key = k0 + j;
      const float* krow = kd + j * dp;
      float ds = 0.0f;
      if (row_ok && key < nk && (!causal || key <= row)) {
        float s = 0.0f;
        if (SPARSE) {
          for (int u = 0; u < kq; ++u) {
            const int id = qis[r * kq + u];
            if (id >= 0) s += qs[r * kq + u] * krow[id];
          }
        } else {
          for (int c = 0; c < d; ++c) s += qs[r * dp + c] * krow[c];
        }
        const float p = expf(s * scale - lse_r);
        float dpv = 0.0f;
#pragma unroll 16
        for (int c = 0; c < DV; ++c) dpv += dos[r * DVP + c] * vs[j * DVP + c];
        ds = p * (dpv - delta_r) * scale;
      }
      dss[r * KP + j] = ds;
    }
    __syncwarp();  // a row's R threads are R lanes of one warp

    // phase B: dQ on this thread's columns, gathered from the K tile
    for (int j = 0; j < KB; ++j) {
      const float ds = dss[r * KP + j];
      const float* krow = kd + j * dp;
#pragma unroll
      for (int a = 0; a < Cols<SPARSE, DV, R>::N; ++a)
        if (cols.c[a] >= 0) acc[a] += ds * krow[cols.c[a]];
    }
  }
  emit_rows<SPARSE, DV, KB>(kd, dp, cols, acc, r, dq, qrow0, nq - q0, d,
                            SPARSE ? qi + (qrow0 + r) * kq : nullptr, kq, emit, rot_dim);
}

template <bool SPARSE, int DV, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const T* __restrict__ qa, const int32_t* __restrict__ qi,
               const T* __restrict__ ka, const int32_t* __restrict__ ki,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dvout, int nq, int nk,
               int kq, int kk, int d, float scale, int causal, int emit,
               int rot_dim) {
  constexpr int KB = tile_rows<DV>();
  constexpr int R = kThreads / KB;   // threads a key row
  constexpr int KP = KB + 1;
  constexpr int DVP = DV + 1;
  const int dp = d + 1;
  extern __shared__ float smem[];
  float* qd = smem;                  // (KB, dp)  Q tile, dense f32
  float* dos = qd + KB * dp;         // (KB, DVP) dO tile
  float* lses = dos + KB * DVP;      // (KB)
  float* deltas = lses + KB;         // (KB)
  float* vs = deltas + KB;           // (KB, DVP) this block's V rows
  float* ps = vs + KB * DVP;         // (KB, KP)  P[j][i]
  float* dss = ps + KB * KP;         // (KB, KP)  dS[j][i]
  float* ks = dss + KB * KP;         // SPARSE: (KB, kk) values; dense: (KB, dp)
  int* kis = reinterpret_cast<int*>(ks + KB * kk);  // SPARSE: (KB, kk) ids

  const int tid = threadIdx.x;
  const int j = tid / R;             // this thread's key row in the tile
  const int sub = tid % R;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * KB;
  const int key = k0 + j;
  const size_t krow0 = static_cast<size_t>(bh) * nk + k0;

  if (SPARSE) {
    for (int t = tid; t < KB * kk; t += kThreads) {
      const bool ok = t / kk < nk - k0;
      const int id = ok ? ki[krow0 * kk + t] : -1;
      ks[t] = ok ? to_f(ka[krow0 * kk + t]) : 0.0f;
      kis[t] = (id >= 0 && id < d) ? id : -1;
    }
  } else {
    stage_dense<false, KB>(ks, dp, ka, ki, krow0, nk - k0, 0, d);
  }
  stage_rows<DV, KB>(vs, v, krow0, nk - k0);
  __syncthreads();
  Cols<SPARSE, DV, R> cols;
  cols.load(kis + j * kk, kk, d, sub);
  float dkacc[Cols<SPARSE, DV, R>::N];
  float dvacc[DV / R];
#pragma unroll
  for (int a = 0; a < Cols<SPARSE, DV, R>::N; ++a) dkacc[a] = 0.0f;
#pragma unroll
  for (int a = 0; a < DV / R; ++a) dvacc[a] = 0.0f;

  // KB rows per query tile as per key tile: the tile holding key k0 is the
  // first one with a query at or past the causal diagonal
  for (int q0 = causal ? k0 : 0; q0 < nq; q0 += KB) {
    __syncthreads();  // the previous query tile is consumed
    const size_t qrow0 = static_cast<size_t>(bh) * nq + q0;
    stage_dense<SPARSE, KB>(qd, dp, qa, qi, qrow0, nq - q0, kq, d);
    stage_rows<DV, KB>(dos, dout, qrow0, nq - q0);
    if (tid < KB) {
      const bool ok = tid < nq - q0;
      lses[tid] = ok ? lse[qrow0 + tid] : 0.0f;
      deltas[tid] = ok ? delta[qrow0 + tid] : 0.0f;
    }
    __syncthreads();

    // phase A: P and dS for this thread's 1/R of the queries
    for (int t = 0; t < KB / R; ++t) {
      const int i = sub + R * t;
      const int qrow = q0 + i;
      const float* qrowp = qd + i * dp;
      float p = 0.0f, ds = 0.0f;
      if (key < nk && qrow < nq && (!causal || key <= qrow)) {
        float s = 0.0f;
        if (SPARSE) {
          for (int u = 0; u < kk; ++u) {
            const int id = kis[j * kk + u];
            if (id >= 0) s += ks[j * kk + u] * qrowp[id];
          }
        } else {
          for (int c = 0; c < d; ++c) s += ks[j * dp + c] * qrowp[c];
        }
        p = expf(s * scale - lses[i]);
        float dpv = 0.0f;
#pragma unroll 16
        for (int c = 0; c < DV; ++c) dpv += dos[i * DVP + c] * vs[j * DVP + c];
        ds = p * (dpv - deltas[i]) * scale;
      }
      ps[j * KP + i] = p;
      dss[j * KP + i] = ds;
    }
    __syncwarp();

    // phase B: dV on columns sub + R a, dK on this thread's columns
    for (int i = 0; i < KB; ++i) {
      const float p = ps[j * KP + i];
      const float ds = dss[j * KP + i];
      const float* dorow = dos + i * DVP;
      const float* qrowp = qd + i * dp;
#pragma unroll
      for (int a = 0; a < DV / R; ++a) dvacc[a] += p * dorow[sub + R * a];
#pragma unroll
      for (int a = 0; a < Cols<SPARSE, DV, R>::N; ++a)
        if (cols.c[a] >= 0) dkacc[a] += ds * qrowp[cols.c[a]];
    }
  }
  if (key < nk) {
    T* dvrow = dvout + (krow0 + j) * DV;
#pragma unroll
    for (int a = 0; a < DV / R; ++a) from_f(dvacc[a], dvrow + sub + R * a);
  }
  emit_rows<SPARSE, DV, KB>(qd, dp, cols, dkacc, j, dk, krow0, nk - k0, d,
                            SPARSE ? ki + (krow0 + j) * kk : nullptr, kk, emit, rot_dim);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool SPARSE, int DV, typename T>
int launch(const void* qa, const void* qi, const void* ka, const void* ki,
           const void* v, const void* dout, const void* lse, const void* delta,
           void* dq, void* dk, void* dv, int bh, int nq, int nk, int kq, int kk,
           int d, float scale, int causal, int emit, int rot_dim,
           cudaStream_t stream) {
  constexpr int KB = tile_rows<DV>(), KP = KB + 1;
  const size_t dp = d + 1, dvp = DV + 1;
  const size_t q_side = SPARSE ? 2 * KB * kq : KB * dp;
  const size_t k_side = SPARSE ? 2 * KB * kk : KB * dp;
  const size_t smem_dq = sizeof(float) * (KB * dp + 2 * KB * dvp + KB * KP + q_side);
  const size_t smem_dkv = sizeof(float) * (KB * dp + 2 * KB * dvp + 2 * KB + 2 * KB * KP + k_side);
  auto kdq = bwd_dq_kernel<SPARSE, DV, T>;
  auto kdkv = bwd_dkv_kernel<SPARSE, DV, T>;
  cudaError_t e = prepare(kdq, smem_dq);
  if (e == cudaSuccess) e = prepare(kdkv, smem_dkv);
  if (e != cudaSuccess) return static_cast<int>(e);
  const T* qa_ = static_cast<const T*>(qa);
  const T* ka_ = static_cast<const T*>(ka);
  const int32_t* qi_ = static_cast<const int32_t*>(qi);
  const int32_t* ki_ = static_cast<const int32_t*>(ki);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);
  kdq<<<dim3((nq + KB - 1) / KB, bh), kThreads, smem_dq, stream>>>(
      qa_, qi_, ka_, ki_, v_, do_, lse_, delta_, static_cast<T*>(dq), nq, nk,
      kq, kk, d, scale, causal, emit, rot_dim);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kdkv<<<dim3((nk + KB - 1) / KB, bh), kThreads, smem_dkv, stream>>>(
      qa_, qi_, ka_, ki_, v_, do_, lse_, delta_, static_cast<T*>(dk),
      static_cast<T*>(dv), nq, nk, kq, kk, d, scale, causal, emit, rot_dim);
  return static_cast<int>(cudaGetLastError());
}

template <bool SPARSE>
int dispatch(const void* qa, const void* qi, const void* ka, const void* ki,
             const void* v, const void* dout, const void* lse, const void* delta,
             void* dq, void* dk, void* dv, int bh, int nq, int nk, int kq, int kk,
             int d, int dvdim, float scale, int causal, int is_bf16, int emit,
             int rot_dim, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || nq <= 0 || nk <= 0) return 0;
  if (bh > 65535 || d <= 0 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (SPARSE && (kq <= 0 || kk <= 0 || kq > kMaxK || kk > kMaxK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!SPARSE && (d != dvdim || emit != 0 || is_bf16))  // dense: f32 only
    return static_cast<int>(cudaErrorInvalidValue);
  if (emit < 0 || emit > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the dense form is not instantiated for bf16
  using B16 = typename std::conditional<SPARSE, __nv_bfloat16, float>::type;
#define SFA_BWD_F32(DVV)                                                            \
  launch<SPARSE, DVV, float>(qa, qi, ka, ki, v, dout, lse, delta, dq, dk, dv, bh, nq, \
                             nk, kq, kk, d, scale, causal, emit, rot_dim, s)
#define SFA_BWD_CASE(DVV)                                                          \
  if (dvdim == DVV)                                                                \
    return is_bf16 ? launch<SPARSE, DVV, B16>(qa, qi, ka, ki, v, dout, lse, delta, dq, \
                                              dk, dv, bh, nq, nk, kq, kk, d, scale,  \
                                              causal, emit, rot_dim, s)              \
                   : SFA_BWD_F32(DVV);
  SFA_BWD_CASE(32)
  SFA_BWD_CASE(64)
  if constexpr (SPARSE) {  // dv 80 (hubert-xlarge) and 256 for FlashSFA only
    SFA_BWD_CASE(80)
    // f32 only: bf16 at dv 256 runs the tensor-core body (flash_sfa_tc_wide.cu)
    if (dvdim == 256 && !is_bf16) return SFA_BWD_F32(256);
  }
  SFA_BWD_CASE(128)
#undef SFA_BWD_CASE
#undef SFA_BWD_F32
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Codes (bh, nq, kq) / (bh, nk, kk): values f32|bf16 + int32 ids; v (bh, nk,
// dv), dout (bh, nq, dv) in the values' dtype; lse, delta (bh, nq) f32. Out:
// dq, dk in the same dtype — (bh, n, d) for emit 0, (bh, n, k) for emit 1,
// (bh, n, 2k) for emit 2 (pairs below rot_dim) — and dv (bh, nk, dv). All
// contiguous; kq, kk <= 32. Returns the last launch's cudaGetLastError().
extern "C" int flash_sfa_bwd_launch(const void* qv, const void* qi, const void* kv,
                                    const void* ki, const void* v, const void* dout,
                                    const void* lse, const void* delta, void* dq,
                                    void* dk, void* dv, int bh, int nq, int nk,
                                    int kq, int kk, int d, int dvdim, float scale,
                                    int causal, int is_bf16, int emit, int rot_dim,
                                    void* stream) {
  return dispatch<true>(qv, qi, kv, ki, v, dout, lse, delta, dq, dk, dv, bh, nq, nk,
                        kq, kk, d, dvdim, scale, causal, is_bf16, emit, rot_dim, stream);
}

// Dense q (bh, nq, d), k (bh, nk, d), v (bh, nk, d), dout (bh, nq, d) with
// d == dv, in f32 (bf16: flash_attention.cu, same signature); lse, delta
// (bh, nq) f32. Out: dq, dk, dv alike.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, void* dk,
                                          void* dv, int bh, int nq, int nk, int d,
                                          float scale, int causal, void* stream) {
  return dispatch<false>(q, nullptr, k, nullptr, v, dout, lse, delta, dq, dk, dv, bh,
                         nq, nk, 0, 0, d, d, scale, causal, 0, 0, 0, stream);
}
