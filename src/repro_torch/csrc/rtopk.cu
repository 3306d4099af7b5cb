// rtopk.cu — row-wise exact top-|k| selection for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rtopk.py::rtopk (Pallas body
// _rtopk_kernel -> _topk_select). Contract, as there: for each row of x
// (rows, d), the k entries of largest |x| with NaN canonicalized to +0,
// ties kept in ascending index order, indices ascending (int32), values
// moved bit-exact in x's dtype (f32 or bf16).
//
// Design: one warp per row, the row strided across the 32 lanes so that
// element j = e*32 + lane; (e, lane) order is index order. Each lane keeps
// its E = ceil(d/32) magnitudes as int32 bit patterns (order-isomorphic to
// |x| for non-negative floats) in registers. The threshold is found by an
// exact 32-step integer bisection; each step counts the row's entries
// >= mid with one __ballot_sync/__popc per register slot, so the warp-wide
// count needs no shuffles. Selection keeps everything strictly above the
// threshold and then the first ties in index order, and a lane's output
// slot is the number of selected entries before it (a warp prefix count
// from the ballot masks).
//
// Bound on the H100: bytes. The row is read once (d values) and k values +
// k int32 indices are written; the bisection is 32*E ballots per row on
// data held in registers. Rows are independent warps, so the grid has
// rows/8 blocks of 8 warps — thousands of warps at the serving shapes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

template <int E, bool kBf16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rtopk_kernel(const void* __restrict__ x, void* __restrict__ vals,
             int32_t* __restrict__ idx, int rows, int d, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp: the whole warp leaves
  uint32_t raw[E];
  int32_t mag[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = e * 32 + lane;
    raw[e] = 0u;
    mag[e] = -1;  // below every bisection midpoint: never counted
    if (j < d) {
      const size_t off = static_cast<size_t>(row) * d + j;
      uint32_t u;
      float f;
      if (kBf16) {
        u = static_cast<const uint16_t*>(x)[off];
        f = __uint_as_float(u << 16);
      } else {
        u = static_cast<const uint32_t*>(x)[off];
        f = __uint_as_float(u);
      }
      if (isnan(f)) {  // NaN -> +0.0 (the rtopk contract)
        u = 0u;
        f = 0.0f;
      }
      raw[e] = u;
      mag[e] = __float_as_int(fabsf(f));
    }
  }
  // exact bisection: invariant count(mag >= lo) >= k > count(mag >= hi)
  int lo = 0;
  int hi = 0x7F800001;  // above +inf
  for (int it = 0; it < 32; ++it) {
    const int mid = lo + (hi - lo) / 2;
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) cnt += __popc(__ballot_sync(kFull, mag[e] >= mid));
    if (cnt >= k) lo = mid; else hi = mid;
  }
  const int theta = lo;
  int n_hi = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) n_hi += __popc(__ballot_sync(kFull, mag[e] > theta));
  const int tie_quota = k - n_hi;
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one
  int ties_before = 0;
  int sel_before = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool tie = mag[e] == theta;
    const unsigned tie_mask = __ballot_sync(kFull, tie);
    const int tie_rank = ties_before + __popc(tie_mask & lower);
    const bool sel = mag[e] > theta || (tie && tie_rank < tie_quota);
    const unsigned sel_mask = __ballot_sync(kFull, sel);
    if (sel) {
      const size_t o = static_cast<size_t>(row) * k + sel_before + __popc(sel_mask & lower);
      if (kBf16) static_cast<uint16_t*>(vals)[o] = static_cast<uint16_t>(raw[e]);
      else static_cast<uint32_t*>(vals)[o] = raw[e];
      idx[o] = e * 32 + lane;
    }
    ties_before += __popc(tie_mask);
    sel_before += __popc(sel_mask);
  }
}

template <int E>
void launch(const void* x, void* vals, int32_t* idx, int rows, int d, int k,
            int is_bf16, cudaStream_t stream) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  if (is_bf16) rtopk_kernel<E, true><<<grid, block, 0, stream>>>(x, vals, idx, rows, d, k);
  else rtopk_kernel<E, false><<<grid, block, 0, stream>>>(x, vals, idx, rows, d, k);
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (rows, d) contiguous f32 or bf16; vals (rows, k) same dtype; idx (rows, k)
// int32. Returns the launch's cudaGetLastError().
extern "C" int rtopk_launch(const void* x, void* vals, void* idx, int rows,
                            int d, int k, int is_bf16, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is ours
  if (rows <= 0) return 0;
  if (k <= 0 || k > d || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* ip = static_cast<int32_t*>(idx);
  if (d <= 32) launch<1>(x, vals, ip, rows, d, k, is_bf16, s);
  else if (d <= 64) launch<2>(x, vals, ip, rows, d, k, is_bf16, s);
  else if (d <= 128) launch<4>(x, vals, ip, rows, d, k, is_bf16, s);
  else launch<8>(x, vals, ip, rows, d, k, is_bf16, s);
  return static_cast<int>(cudaGetLastError());
}
