// flash_sfa_tc.cuh — the FlashSFA forward (both schedules) and backward (all
// three emits) for bf16 on Hopper's tensor cores (sm_90a): the launchers and
// C entry points, instantiated by two sources at the head widths each lists
// in SFA_TC_DIMS (defined before the include) so that the two compile in
// parallel: flash_sfa_tc.cu at d = dv in {32, 64, 128}, flash_sfa_tc_wide.cu
// at 80 and 256.
//
// Replaces, for bf16 with d = dv in {32, 64, 80, 128, 256} and k <= 32 (both
// forward schedules), the TPU kernels
// repro/kernels/flash_sfa.py::flash_sfa (block_skip=False: Pallas body
// _flash_sfa_kernel; block_skip=True: _flash_sfa_skip_kernel, both on
// _densify_block) and repro/kernels/flash_sfa_bwd.py::flash_sfa_bwd
// (_bwd_impl with sparse=True: _bwd_dq_kernel, _bwd_dkv_kernel, _unpack and
// the emits _support_mask / _gather_support / _pair_closure_gather). f32 and
// the other bf16 shapes stay on the exact CUDA-core bodies of flash_sfa.cu
// and flash_sfa_bwd.cu (f32 on the tensor cores would be TF32, which fails
// f32's 1e-4 check).
//
// The TPU kernels densify each code tile in VMEM (iota-compare) and run one
// dense matrix-unit product. Here the counterpart: the bodies of
// attention_tc.cuh with SPARSE = true densify each (64 or 128, k) code tile
// into the swizzled shared-memory tile that wgmma reads (a few lanes a row),
// then run the dense attention's schedule unchanged (S and dP in the SS form, P.V, dV, dK and dQ
// in the RS form with P and dS split hi + lo). A pack kernel first turns each
// code into one 32-bit word (idx << 16 | bf16 bits, 0 where idx is outside
// [0, d)), so the next tile's codes are 4-byte words that cp.async stages
// one tile ahead, beside the TMA loads of V and dO. A head of 80 runs in
// tiles of 96 columns, one of 256 with two warpgroups a block, each owning
// a 128-column half of every output (attention_tc.cuh, Width).
//
// Bound on the H100: operations. Densified, the products are the dense
// attention's (4d flops per (query, key) pair forward, 10d backward, on the
// tensor cores; 6d and 16d with the hi/lo split; at d 256 the second
// warpgroup's copy of S and dP adds 2d forward and 4d backward, at d 80 the
// padding 16 columns to each product of N), where the paper's
// Theta(n^2 k^2 / d) would count k-wide gathers; at d 64 and k 8 the
// tensor cores' 15x rate over CUDA cores beats the gather's 8x saving. The
// densify adds a row's zeroing and k stores per tile row; the block-skip
// level map and V row sums stay the wrapper's torch pre-pass.
// D_i = sum(dO_i * O_i) comes in from the caller, as in the JAX package.
#pragma once

#include <type_traits>

#include "attention_tc.cuh"

#ifndef SFA_TC_DIMS
#error "define SFA_TC_DIMS (the head widths this source instantiates) before the include"
#endif

namespace {

constexpr int kMaxK = 32;       // largest code width the bodies take

// The head widths of this source: membership, and a call of f with the
// width as a compile-time constant (cudaErrorInvalidValue for another d)
template <int... DS>
struct Dims {
  static bool has(int d) { return ((d == DS) || ...); }
  template <class F>
  static int call(int d, F&& f) {
    int e = static_cast<int>(cudaErrorInvalidValue);
    (void)((d == DS ? (e = f(std::integral_constant<int, DS>{}), true) : false) || ...);
    return e;
  }
};
using Bodies = Dims<SFA_TC_DIMS>;

// codes -> packed words, the Q side then the K side in one launch
__global__ void pack_codes_kernel(const bf16* __restrict__ qv, const int32_t* __restrict__ qi,
                                  const bf16* __restrict__ kv, const int32_t* __restrict__ ki,
                                  uint32_t* __restrict__ packed, long long nqw, long long nkw,
                                  int d) {
  const long long total = nqw + nkw;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const bool q = i < nqw;
    const long long j = q ? i : i - nqw;
    const int id = q ? qi[j] : ki[j];
    const uint32_t bits = __bfloat16_as_ushort(q ? qv[j] : kv[j]);
    packed[i] = (id >= 0 && id < d) ? (static_cast<uint32_t>(id) << 16) | bits : 0u;
  }
}

int pack(const void* qv, const void* qi, const void* kv, const void* ki, uint32_t* packed,
         long long nqw, long long nkw, int d, cudaStream_t stream) {
  const long long want = (nqw + nkw + 255) / 256;
  const long long blocks = want < 132LL * 16 ? want : 132LL * 16;
  pack_codes_kernel<<<static_cast<int>(blocks), 256, 0, stream>>>(
      static_cast<const bf16*>(qv), static_cast<const int32_t*>(qi),
      static_cast<const bf16*>(kv), static_cast<const int32_t*>(ki), packed, nqw, nkw, d);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd(const void* v, Codes qc, Codes kc, void* out, void* lse, const void* level,
               const void* vsum, int bh, int nq, int nk, float scale, int causal,
               cudaStream_t stream) {
  using Wd = Width<D>;
  constexpr int QROWS = 2 * kTile / Wd::SPLIT;   // a block's query rows
  CUtensorMap vm;
  const int e = hopper::make_map(&vm, v, D, nk, bh, kTile);
  if (e != 0) return e;
  const size_t smem = 1024 + Tile<Wd::W, QROWS>::BYTES + 4 * Tile<Wd::W, kTile>::BYTES +
                      sizeof(uint32_t) * kTile * (kc.k + 1) + 2 * ((nk + kTile - 1) / kTile);
  auto kernel = flash_attention_tc_fwd_kernel<D, true>;
  cudaError_t ce = allow_smem(kernel, smem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  // the Q and K maps are not read on this path
  kernel<<<dim3(bh, (nq + QROWS - 1) / QROWS), 2 * kWG, smem, stream>>>(
      vm, vm, vm, qc, kc, static_cast<const int32_t*>(level), static_cast<const float*>(vsum),
      static_cast<bf16*>(out), static_cast<float*>(lse), nq, nk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const void* v, const void* dout, Codes qc, Codes kc, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int bh, int nq, int nk,
               float scale, int causal, int emit, int rot_dim, cudaStream_t stream) {
  using Wd = Width<D>;
  CUtensorMap vm, dm;
  int e = hopper::make_map(&vm, v, D, nk, bh, kTile);
  if (e == 0) e = hopper::make_map(&dm, dout, D, nq, bh, kTile);
  if (e != 0) return e;
  const size_t tiles = 1024 + 6 * Tile<Wd::W, kTile>::BYTES;
  auto kdq = attention_bwd_dq_tc_kernel<D, true>;
  auto kdkv = attention_bwd_dkv_tc_kernel<D, true>;
  const size_t smem_dq = tiles + sizeof(uint32_t) * kTile * (kc.k + 1);
  const size_t smem_dkv = tiles + sizeof(uint32_t) * kTile * (qc.k + 1);
  cudaError_t ce = allow_smem(kdq, smem_dq);
  if (ce == cudaSuccess) ce = allow_smem(kdkv, smem_dkv);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);
  // the Q and K maps are not read on this path
  kdq<<<dim3(bh, (nq + kTile - 1) / kTile), Wd::THREADS, smem_dq, stream>>>(
      vm, vm, vm, dm, qc, kc, lse_, delta_, static_cast<bf16*>(dq), nq, nk, scale, causal,
      emit, rot_dim);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return static_cast<int>(ce);
  kdkv<<<dim3(bh, (nk + kTile - 1) / kTile), Wd::THREADS, smem_dkv, stream>>>(
      vm, vm, vm, dm, qc, kc, lse_, delta_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), nq,
      nk, scale, causal, emit, rot_dim);
  return static_cast<int>(cudaGetLastError());
}

// The densify probe: A, B and C (64, D) densified from packed codes into
// W-column tiles, then S = A . B^T by one SS chain and O = bf16(S) . C by
// one RS chain per N columns of C (hi part only), as wgmma_probe_kernel
// does on TMA-loaded tiles.
template <int D>
__global__ void __launch_bounds__(kWG, 1)
densify_probe_kernel(const uint32_t* __restrict__ packed, int k, float* __restrict__ s_out,
                     float* __restrict__ o_out) {
  constexpr int W = Width<D>::W, N = Width<D>::N;
  constexpr int LANES = W > 128 ? 4 : 2;        // a lane owns at most 64 columns
  using T = Tile<W, kTile>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* as = align1024(smem_raw);
  uint8_t* bs = as + T::BYTES;
  uint8_t* cs = bs + T::BYTES;
  const int r = threadIdx.x >> 1;               // two threads a row, LANES / 2 parts each
  for (int part = threadIdx.x & 1; part < LANES; part += 2) {
    densify_part<W, kTile, LANES>(as, r, part, packed + r * k, k, true);
    densify_part<W, kTile, LANES>(bs, r, part, packed + (kTile + r) * k, k, true);
    densify_part<W, kTile, LANES>(cs, r, part, packed + (2 * kTile + r) * k, k, true);
  }
  fence_proxy_async();
  __syncthreads();
  float s[32];
  hopper::wgmma_fence();
  mma_abt<D, kTile>(s, hopper::smem_u32(as), 0, hopper::smem_u32(bs));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  for (int i = 0; i < 32; ++i) s_out[acc_row(i) * kTile + acc_col(i)] = s[i];
  const Split x(s);
  for (int c0 = 0; c0 < W; c0 += N) {
    float o[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) o[i] = 0.0f;
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<N>::rs(o, x.hi[kk], T::mnmajor(hopper::smem_u32(cs) + T::column(c0), kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    for (int i = 0; i < Width<D>::COLS / 2; ++i) o_out[acc_row(i) * D + c0 + acc_col(i)] = o[i];
  }
}

template <int D>
int launch_probe(const uint32_t* packed, int k, void* s_out, void* o_out, cudaStream_t stream) {
  const size_t smem = 1024 + 3 * Tile<Width<D>::W, kTile>::BYTES;
  auto kernel = densify_probe_kernel<D>;
  cudaError_t ce = allow_smem(kernel, smem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  kernel<<<1, kWG, smem, stream>>>(packed, k, static_cast<float*>(s_out),
                                   static_cast<float*>(o_out));
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int bh, int nq, int nk, int kq, int kk, int d) {
  return !Bodies::has(d) || kq <= 0 || kk <= 0 || kq > kMaxK || kk > kMaxK ||
         (nq + kTile - 1) / kTile > 65535 || (nk + kTile - 1) / kTile > 65535 || bh <= 0;
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bf16 codes (bh, nq, kq) / (bh, nk, kk) values + int32 ids, kq, kk <= 32;
// v (bh, nk, d) and out (bh, nq, d) bf16 with d in SFA_TC_DIMS; lse (bh, nq)
// f32 or null; level (bh, ceil(nq/64), ceil(nk/64)) int32 and vsum (bh,
// ceil(nk/64), d) f32, both null without block skip; packed: scratch of bh * (nq * kq + nk * kk) words. All
// contiguous, v 16-byte aligned. Returns the last launch's
// cudaGetLastError().
extern "C" int flash_sfa_tc_fwd_launch(const void* qv, const void* qi, const void* kv,
                                       const void* ki, const void* v, void* out, void* lse,
                                       const void* level, const void* vsum, void* packed,
                                       int bh, int nq, int nk, int kq, int kk, int d,
                                       float scale, int causal, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || nq <= 0) return 0;
  if (nk <= 0 || bad_shape(bh, nq, nk, kq, kk, d) || (level == nullptr) != (vsum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* qp = static_cast<uint32_t*>(packed);
  const long long nqw = static_cast<long long>(bh) * nq * kq;
  uint32_t* kp = qp + nqw;
  int e = pack(qv, qi, kv, ki, qp, nqw, static_cast<long long>(bh) * nk * kk, d, s);
  if (e != 0) return e;
  const Codes qc{qp, static_cast<const int32_t*>(qi), kq};
  const Codes kc{kp, static_cast<const int32_t*>(ki), kk};
  return Bodies::call(d, [&](auto D) {
    return launch_fwd<decltype(D)::value>(v, qc, kc, out, lse, level, vsum, bh, nq, nk, scale,
                                          causal, s);
  });
}

// bf16 codes as above; v (bh, nk, d), dout (bh, nq, d); lse, delta (bh, nq)
// f32. Out: dq, dk — (bh, n, d) for emit 0, (bh, n, k) for emit 1, (bh, n,
// 2k) for emit 2 (pairs below rot_dim) — and dv (bh, nk, d), bf16. packed:
// scratch as for the forward. All contiguous, v and dout 16-byte aligned.
// Returns the last launch's cudaGetLastError().
extern "C" int flash_sfa_tc_bwd_launch(const void* qv, const void* qi, const void* kv,
                                       const void* ki, const void* v, const void* dout,
                                       const void* lse, const void* delta, void* dq, void* dk,
                                       void* dv, void* packed, int bh, int nq, int nk, int kq,
                                       int kk, int d, float scale, int causal, int emit,
                                       int rot_dim, void* stream) {
  cudaGetLastError();
  if (bh <= 0 || nq <= 0 || nk <= 0) return 0;
  if (bad_shape(bh, nq, nk, kq, kk, d) || emit < 0 || emit > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* qp = static_cast<uint32_t*>(packed);
  const long long nqw = static_cast<long long>(bh) * nq * kq;
  uint32_t* kp = qp + nqw;
  int e = pack(qv, qi, kv, ki, qp, nqw, static_cast<long long>(bh) * nk * kk, d, s);
  if (e != 0) return e;
  const Codes qc{qp, static_cast<const int32_t*>(qi), kq};
  const Codes kc{kp, static_cast<const int32_t*>(ki), kk};
  return Bodies::call(d, [&](auto D) {
    return launch_bwd<decltype(D)::value>(v, dout, qc, kc, lse, delta, dq, dk, dv, bh, nq, nk,
                                          scale, causal, emit, rot_dim, s);
  });
}

// The densify probe: codes (3, 64, k) bf16 values + int32 ids (A, B, C) ->
// s_out (64, 64) = A . B^T and o_out (64, d) = bf16(s) . C, f32, with A, B
// and C densified in shared memory. packed: scratch of 3 * 64 * k words.
extern "C" int densify_probe_launch(const void* vals, const void* idx, void* packed, int k,
                                    void* s_out, void* o_out, int d, void* stream) {
  cudaGetLastError();
  if (!Bodies::has(d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* p = static_cast<uint32_t*>(packed);
  const int e = pack(vals, idx, vals, idx, p, 3LL * kTile * k, 0, d, s);
  if (e != 0) return e;
  return Bodies::call(d, [&](auto D) {
    return launch_probe<decltype(D)::value>(p, k, s_out, o_out, s);
  });
}
