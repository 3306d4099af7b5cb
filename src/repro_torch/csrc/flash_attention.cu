// flash_attention.cu — dense FlashAttention forward and backward for Hopper
// (sm_90a).
//
// Replaces the TPU kernels repro/kernels/flash_attention.py::flash_attention
// (_flash_fwd, Pallas body _flash_kernel) and, for bf16,
// repro/kernels/flash_sfa_bwd.py::flash_attention_bwd (_bwd_impl with
// sparse=False: _bwd_dq_kernel and _bwd_dkv_kernel): the paper's dense
// baseline,
//   out = softmax(Q . K^T * scale + mask) . V,   LSE = m + log(l),
//   dS = P (dO . V^T - D) * scale,  dQ = dS . K,  dK = dS^T . Q,  dV = P^T . dO,
// with online softmax over key tiles, never forming the (n, n) matrix. Keys
// >= nk and, when causal, keys j > i are masked (top-left aligned). q/k/v
// are (bh, n, d) with d == dv in {32, 64, 128}; out is in their dtype, the
// LSE f32. D_i = sum(dO_i * O_i) comes in from the caller.
//
// Bound on the H100: near the ridge. Per (query, key) pair the forward does
// 4d flops (Q.K^T, P.V) and the backward 10d (Q.K^T and dO.V^T again, dV,
// dQ, dK), against 8d and 16d bytes per row: at n = 1024, causal, ~256 and
// ~320 flops per byte, either side of the card's ~295 for bf16 (the forward
// is bound by its bytes, the backward by its operations). Either way the
// products have to run on the tensor cores while the next tiles stream in,
// which is what the bf16 design below does.
//
// bf16: the tensor-core bodies of attention_tc.cuh, instantiated here with
// SPARSE = false (flash_sfa_tc.cu instantiates the same schedule on
// densified top-k codes). Every product runs as wgmma m64nNk16 (bf16 in,
// f32 accumulate) on tiles that TMA copies into 128- (64-, d = 32)
// byte-swizzled shared memory one stage ahead of their use (hopper.cuh).
//  * forward: one block of two warpgroups per (bh, 128-query tile), 64 rows
//    each; K/V 64-key tiles in a 2-stage ring. S = Q.K^T in the SS form;
//    online softmax in registers (a row's statistics live in 4 lanes of a
//    quad); P.V in the RS form, P fed from S's accumulator registers.
//  * backward: two kernels, each output tile with one owner (no atomics, a
//    deterministic result). dK/dV: one warpgroup per (bh, 64-key tile),
//    walking query tiles from the diagonal; S^T = K.Q^T and dP^T = V.dO^T
//    (SS), P^T and dS^T in registers, dV += P^T.dO and dK += dS^T.Q (RS).
//    dQ: one warpgroup per (bh, 64-query tile) over the key tiles up to the
//    causal edge; S = Q.K^T, dP = dO.V^T, dQ += dS.K.
// P and dS are f32 values, not inputs: rounded once to bf16 they would add
// ~2^-9 |p| per term, which fails the 1e-4 absolute check on outputs near
// zero. Each is split into hi = bf16(x) and lo = bf16(x - hi), and two
// wgmmas accumulate hi and lo into the same f32 registers: ~16 bits of P
// and dS, at 6d instead of 4d flops per pair forward (16d instead of 10d
// backward), all on the tensor cores. Q, K, V and dO are bf16 already and
// exact as operands. Causal tiles are launched longest first.
//
// f32: the CUDA-core forward below (and flash_sfa_bwd.cu's SPARSE=false
// backward), kept as the exact path: f32 on the tensor cores would be TF32
// (~3 decimal digits), which fails f32's 1e-4 check. One block of 256
// threads per (bh, 64-query tile); Q, K and V tiles staged as f32 (rows
// padded to d + 1); 4 threads per query row each score a quarter of the
// tile's keys, P goes through shared memory, and each thread accumulates a
// quarter of the output columns.

#include "attention_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: the CUDA-core forward
// ---------------------------------------------------------------------------

constexpr int kB = 64;          // query rows per block == keys per tile
constexpr int kThreads = 256;   // 4 threads per query row
constexpr int kP = kB + 1;      // padded stride of the P tile
constexpr float kNegInf = -1e30f;

template <int D>
__device__ void stage(float* dst, const float* src, size_t row0, int rows_left) {
  for (int t = threadIdx.x; t < kB * D; t += kThreads) {
    const int r = t / D;
    dst[r * (D + 1) + t % D] = r < rows_left ? src[(row0 + r) * D + t % D] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
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
    float* orow = out + (qrow0 + r) * D + sub;
#pragma unroll
    for (int a = 0; a < D / 4; ++a) orow[4 * a] = acc[a] / denom;
    if (lse != nullptr && sub == 0) lse[qrow0 + r] = m + logf(denom);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
               int nq, int nk, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * kB * (D + 1) + kB * kP);
  auto kernel = flash_attention_fwd_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3((nq + kB - 1) / kB, bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), nq, nk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
                  int nq, int nk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int e = hopper::make_map(&qm, q, D, nq, bh, 2 * kTile);
  if (e == 0) e = hopper::make_map(&km, k, D, nk, bh, kTile);
  if (e == 0) e = hopper::make_map(&vm, v, D, nk, bh, kTile);
  if (e != 0) return e;
  const size_t smem = 1024 + Tile<D, 2 * kTile>::BYTES + 4 * Tile<D, kTile>::BYTES;
  auto kernel = flash_attention_tc_fwd_kernel<D, false>;
  cudaError_t ce = allow_smem(kernel, smem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  kernel<<<dim3(bh, (nq + 2 * kTile - 1) / (2 * kTile)), 2 * kWG, smem, stream>>>(
      qm, km, vm, Codes{}, Codes{}, nullptr, nullptr, static_cast<bf16*>(out),
      static_cast<float*>(lse), nq, nk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc_bwd(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, void* dk, void* dv, int bh,
                  int nq, int nk, float scale, int causal, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dm;
  int e = hopper::make_map(&qm, q, D, nq, bh, kTile);
  if (e == 0) e = hopper::make_map(&km, k, D, nk, bh, kTile);
  if (e == 0) e = hopper::make_map(&vm, v, D, nk, bh, kTile);
  if (e == 0) e = hopper::make_map(&dm, dout, D, nq, bh, kTile);
  if (e != 0) return e;
  const size_t smem = 1024 + 6 * Tile<D, kTile>::BYTES;
  auto kdq = attention_bwd_dq_tc_kernel<D, false>;
  auto kdkv = attention_bwd_dkv_tc_kernel<D, false>;
  cudaError_t ce = allow_smem(kdq, smem);
  if (ce == cudaSuccess) ce = allow_smem(kdkv, smem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);
  kdq<<<dim3(bh, (nq + kTile - 1) / kTile), kWG, smem, stream>>>(
      qm, km, vm, dm, Codes{}, Codes{}, lse_, delta_, static_cast<bf16*>(dq), nq, nk, scale,
      causal, 0, 0);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return static_cast<int>(ce);
  kdkv<<<dim3(bh, (nk + kTile - 1) / kTile), kWG, smem, stream>>>(
      qm, km, vm, dm, Codes{}, Codes{}, lse_, delta_, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), nq, nk, scale, causal, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

// The layout probe: S = A . B^T by one SS chain and O = bf16(S) . C by one
// RS chain fed from S's accumulator (hi part only), for (64, D) tiles loaded
// by TMA exactly as the attention kernels load theirs.
template <int D>
__global__ void __launch_bounds__(kWG, 1)
wgmma_probe_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __grid_constant__ CUtensorMap cmap, float* __restrict__ s_out,
                   float* __restrict__ o_out) {
  using T = Tile<D, kTile>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  uint8_t* as = align1024(smem_raw);
  uint8_t* bs = as + T::BYTES;
  uint8_t* cs = bs + T::BYTES;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(&bar, 3 * T::BYTES);
    T::load(as, &amap, &bar, 0, 0);
    T::load(bs, &bmap, &bar, 0, 0);
    T::load(cs, &cmap, &bar, 0, 0);
  }
  hopper::mbar_wait(&bar, 0);
  float s[32];
  hopper::wgmma_fence();
  mma_abt<D, kTile>(s, hopper::smem_u32(as), 0, hopper::smem_u32(bs));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  for (int i = 0; i < 32; ++i) s_out[acc_row(i) * kTile + acc_col(i)] = s[i];
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  const Split x(s);
  hopper::fence_regs(o);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Mma<D>::rs(o, x.hi[kk], T::mnmajor(hopper::smem_u32(cs), kk), 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);
  for (int i = 0; i < D / 2; ++i) o_out[acc_row(i) * D + acc_col(i)] = o[i];
}

template <int D>
int launch_probe(const void* a, const void* b, const void* c, void* s_out, void* o_out,
                 cudaStream_t stream) {
  CUtensorMap am, bm, cm;
  int e = hopper::make_map(&am, a, D, kTile, 1, kTile);
  if (e == 0) e = hopper::make_map(&bm, b, D, kTile, 1, kTile);
  if (e == 0) e = hopper::make_map(&cm, c, D, kTile, 1, kTile);
  if (e != 0) return e;
  const size_t smem = 1024 + 3 * Tile<D, kTile>::BYTES;
  auto kernel = wgmma_probe_kernel<D>;
  cudaError_t ce = allow_smem(kernel, smem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  kernel<<<1, kWG, smem, stream>>>(am, bm, cm, static_cast<float*>(s_out),
                                   static_cast<float*>(o_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// f32: q (bh, nq, d), k and v (bh, nk, d), out (bh, nq, d), d in {32, 64,
// 128}; lse (bh, nq) f32 or null. All contiguous. Returns the launch's
// cudaGetLastError().
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          void* out, void* lse, int bh, int nq, int nk,
                                          int d, float scale, int causal, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || nq <= 0) return 0;
  if (bh > 65535 || nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SFA_CALL(D) launch_f32<D>(q, k, v, out, lse, bh, nq, nk, scale, causal, s)
  switch (d) {
    case 32: return SFA_CALL(32);
    case 64: return SFA_CALL(64);
    case 128: return SFA_CALL(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SFA_CALL
}

// bf16, the tensor-core forward: as flash_attention_fwd_launch, with every
// pointer 16-byte aligned.
extern "C" int flash_attention_tc_fwd_launch(const void* q, const void* k, const void* v,
                                             void* out, void* lse, int bh, int nq, int nk,
                                             int d, float scale, int causal, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || nq <= 0) return 0;
  if (nk <= 0 || (nq + 2 * kTile - 1) / (2 * kTile) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SFA_CALL(D) launch_tc_fwd<D>(q, k, v, out, lse, bh, nq, nk, scale, causal, s)
  switch (d) {
    case 32: return SFA_CALL(32);
    case 64: return SFA_CALL(64);
    case 128: return SFA_CALL(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SFA_CALL
}

// bf16, the tensor-core backward: q (bh, nq, d), k, v (bh, nk, d), dout
// (bh, nq, d); lse, delta (bh, nq) f32. Out: dq (bh, nq, d), dk, dv (bh, nk,
// d), bf16. All contiguous and 16-byte aligned; d in {32, 64, 128}. Returns
// the last launch's cudaGetLastError().
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, void* dk, void* dv,
                                          int bh, int nq, int nk, int d, float scale,
                                          int causal, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || nq <= 0 || nk <= 0) return 0;
  if ((nq + kTile - 1) / kTile > 65535 || (nk + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SFA_CALL(D) \
  launch_tc_bwd<D>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq, nk, scale, causal, s)
  switch (d) {
    case 32: return SFA_CALL(32);
    case 64: return SFA_CALL(64);
    case 128: return SFA_CALL(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SFA_CALL
}

// The layout probe: a, b, c (64, d) bf16 -> s_out (64, 64) = a . b^T and
// o_out (64, d) = bf16(s) . c, f32.
extern "C" int wgmma_probe_launch(const void* a, const void* b, const void* c, void* s_out,
                                  void* o_out, int d, void* stream) {
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SFA_CALL(D) launch_probe<D>(a, b, c, s_out, o_out, s)
  switch (d) {
    case 32: return SFA_CALL(32);
    case 64: return SFA_CALL(64);
    case 128: return SFA_CALL(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SFA_CALL
}
