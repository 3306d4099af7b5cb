// decode_split.cuh — what the two decode sources split over the keys share:
// the runs of kSplit positions, the walk of a row (its length, its block
// table), the cp.async copies that stage a run's V rows, and the merge
// kernel that folds a row's run partials in run order.
//
// A row's tokens fall into runs of kSplit = 128 positions, run s holding
// [128 s, 128 s + 128), by position alone. Each run's block writes its
// partial (m, l, acc[DV]) to an f32 workspace (rows, splits, DV + 2); the
// merge kernel then gives out = sum_s acc_s e^(m_s - M) /
// max(sum_s l_s e^(m_s - M), 1e-30) with M = max_s m_s, the runs in
// increasing index; a zero-length row (no run) gives 0, a run with m = -inf
// weighs 0. Used by flash_sfa_decode.cu (rows 10-12) and
// flash_sfa_decode_fm.cu (rows 13-14).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 128;          // tokens of a run = threads of a split block
constexpr int kWarps = kSplit / 32;  // each warp accumulates 32 tokens of the run
constexpr int kMergeChunk = 32;      // runs the merge kernel stages at a time
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Walk {
  const int32_t* bt;  // PAGED: block table (slots, max_pages)
  int max_pages, page;
  int slot_fixed;     // >= 0: every row reads this slot; else row / heads
  int len_per_slot;   // lengths indexed by slot (1) or by query row (0)
  int n_cap;          // the walk stops at min(length, n_cap)
};

__device__ __forceinline__ int row_length(const int32_t* lengths, int row, int heads,
                                          const Walk& walk) {
  return min(max(lengths[walk.len_per_slot ? row / heads : row], 0), walk.n_cap);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <int DV>
__global__ void __launch_bounds__(DV)
decode_merge_kernel(const float* __restrict__ ws, const int32_t* __restrict__ lengths,
                    float* __restrict__ out, int heads, int splits, Walk walk) {
  __shared__ float chunk[kMergeChunk * (DV + 2)];
  __shared__ float red[DV / 32];
  const int row = blockIdx.x;
  const int c = threadIdx.x;
  const int runs = (row_length(lengths, row, heads, walk) + kSplit - 1) / kSplit;
  const float* src = ws + static_cast<size_t>(row) * splits * (DV + 2);
  // the largest run max (order-free)
  float mx = -CUDART_INF_F;
  for (int s = c; s < runs; s += DV) mx = fmaxf(mx, src[s * (DV + 2)]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  if ((c & 31) == 0) red[c >> 5] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < DV / 32; ++w) mx = fmaxf(mx, red[w]);
  // the runs in order, kMergeChunk at a time staged in shared memory
  float lsum = 0.0f;
  float a = 0.0f;
  for (int base = 0; base < runs; base += kMergeChunk) {
    const int cnt = min(kMergeChunk, runs - base);
    for (int i = c; i < cnt * (DV + 2); i += DV) chunk[i] = src[base * (DV + 2) + i];
    __syncthreads();
    for (int s = 0; s < cnt; ++s) {
      const float* part = chunk + s * (DV + 2);
      const float f = part[0] == -CUDART_INF_F ? 0.0f : expf(__fsub_rn(part[0], mx));
      lsum = __fmaf_rn(part[1], f, lsum);
      a = __fmaf_rn(part[2 + c], f, a);
    }
    __syncthreads();
  }
  // a zero-length row has no run: its output is 0
  out[static_cast<size_t>(row) * DV + c] = runs > 0 ? __fdiv_rn(a, fmaxf(lsum, 1e-30f)) : 0.0f;
}

}  // namespace
