// topk_select.cuh — the exact row top-|k| selection of rtopk.cu and
// proj_rtopk.cu, in one copy.
//
// Contract (repro/kernels/rtopk.py::_topk_select): the k entries of largest
// |x| with NaN read as +0, ties kept in ascending index order, indices
// written ascending, values moved bit-exact (-0, subnormals and +-inf kept).
//
// A row entry is one of three types: float (a value, proj_rtopk's rounded
// y tile), uint32_t (the bits of an f32) or uint16_t (the bits of a bf16).
// key_of maps each to an int32 that orders as |x| does (NaN -> 0): the
// magnitude's bit pattern, which IEEE-754 orders like the magnitude for
// non-negative values. put writes the entry's bits into an output slot of
// float, __nv_bfloat16 or the entry's own raw type, NaN as +0.
//
// Two selections, the same choice:
//  * select_row: one warp a row, lane l holding entries e * 32 + l; the
//    k-th largest key by an exact bisection over the key range (32 steps
//    for f32 keys, 16 for bf16's 15-bit keys), each step a __ballot_sync /
//    __popc per register slot; then the entries above it and the first
//    ties, a lane's output slot counted from the ballot masks.
//  * select_row_thread (and its parts top_keys, kth, emit): one thread a
//    row for k <= KL, the KL largest keys kept in a descending register
//    list (each group of 8 keys sorted by a network and merged in by a
//    bitonic merge), top[k - 1] the threshold, then one
//    pass in index order writing the entries above it and the first
//    (k - n_hi) at it. No ballot chain: on an H100 the 32 dependent ballot
//    steps a row made proj_rtopk's selection 2.6x slower than this. For
//    bf16 keys the list can hold packed keys instead (top_packed): key and
//    index in one int32, unique, so its first k are the selection and the
//    second pass goes (ascending_indices sorts their indices).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topk {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t key_of(float f) {
  return isnan(f) ? 0 : __float_as_int(fabsf(f));
}
__device__ __forceinline__ int32_t key_of(uint32_t u) {
  const uint32_t m = u & 0x7fffffffu;
  return m > 0x7f800000u ? 0 : static_cast<int32_t>(m);
}
__device__ __forceinline__ int32_t key_of(uint16_t u) {
  const int32_t m = u & 0x7fff;
  return m > 0x7f80 ? 0 : m;
}

// the bisection's range: every key of T is below kHi, which 2^kSteps exceeds
template <typename T>
struct KeyRange {
  static constexpr int32_t kHi = 0x7F800001;  // above +inf's f32 key
  static constexpr int kSteps = 32;
};
template <>
struct KeyRange<uint16_t> {
  static constexpr int32_t kHi = 0x7F81;      // above +inf's bf16 key
  static constexpr int kSteps = 16;
};

__device__ __forceinline__ void put(float f, float* p) { *p = isnan(f) ? 0.0f : f; }
__device__ __forceinline__ void put(float f, __nv_bfloat16* p) {
  *reinterpret_cast<uint16_t*>(p) =
      isnan(f) ? uint16_t(0) : static_cast<uint16_t>(__float_as_uint(f) >> 16);
}
__device__ __forceinline__ void put(uint32_t u, uint32_t* p) {
  *p = (u & 0x7fffffffu) > 0x7f800000u ? 0u : u;
}
__device__ __forceinline__ void put(uint16_t u, uint16_t* p) {
  *p = (u & 0x7fff) > 0x7f80 ? uint16_t(0) : u;
}

// the top-|k| of row[0 .. d), d <= E * 32, by one warp, into k values and k
// ascending indices at vals / idx (every lane calls it for the same row)
template <int E, typename T, typename V>
__device__ __forceinline__ void select_row(const T* row, V* vals, int32_t* idx, int d, int k,
                                           int lane) {
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one
  T x[E];
  int32_t key[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = e * 32 + lane;
    x[e] = j < d ? row[j] : T();
    key[e] = j < d ? key_of(x[e]) : -1;  // below every midpoint: never counted
  }
  // invariant count(key >= lo) >= k > count(key >= hi)
  int32_t lo = 0, hi = KeyRange<T>::kHi;
  for (int it = 0; it < KeyRange<T>::kSteps; ++it) {
    const int32_t mid = lo + (hi - lo) / 2;
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) cnt += __popc(__ballot_sync(kFull, key[e] >= mid));
    if (cnt >= k) lo = mid; else hi = mid;
  }
  const int32_t theta = lo;
  int n_hi = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) n_hi += __popc(__ballot_sync(kFull, key[e] > theta));
  const int tie_quota = k - n_hi;
  int ties_before = 0, sel_before = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool tie = key[e] == theta;
    const unsigned tie_mask = __ballot_sync(kFull, tie);
    const int tie_rank = ties_before + __popc(tie_mask & lower);
    const bool sel = key[e] > theta || (tie && tie_rank < tie_quota);
    const unsigned sel_mask = __ballot_sync(kFull, sel);
    if (sel) {
      const int o = sel_before + __popc(sel_mask & lower);
      put(x[e], vals + o);
      idx[o] = e * 32 + lane;
    }
    ties_before += __popc(tie_mask);
    sel_before += __popc(sel_mask);
  }
}

// (a, b) -> (max, min)
__device__ __forceinline__ void order(int32_t& a, int32_t& b) {
  const int32_t hi = max(a, b);
  b = min(a, b);
  a = hi;
}

// 8 keys sorted descending: Batcher's odd-even merge network, 19 pairs
__device__ __forceinline__ void sort8(int32_t (&b)[8]) {
  order(b[0], b[1]); order(b[2], b[3]); order(b[4], b[5]); order(b[6], b[7]);
  order(b[0], b[2]); order(b[1], b[3]); order(b[4], b[6]); order(b[5], b[7]);
  order(b[1], b[2]); order(b[5], b[6]);
  order(b[0], b[4]); order(b[1], b[5]); order(b[2], b[6]); order(b[3], b[7]);
  order(b[2], b[4]); order(b[3], b[5]);
  order(b[1], b[2]); order(b[3], b[4]); order(b[5], b[6]);
}

// a descending bitonic sequence's bitonic merge: descending
template <int KL>
__device__ __forceinline__ void bitonic_merge(int32_t (&top)[KL]) {
#pragma unroll
  for (int s = KL / 2; s > 0; s /= 2)
#pragma unroll
    for (int i = 0; i < KL; ++i)
      if ((i & s) == 0) order(top[i], top[i + s]);
}

// top := the KL largest of top and b, both descending (b of G <= KL):
// slot KL - 1 - i keeps the larger of itself and b[i], which leaves the KL
// largest as a bitonic sequence, and a bitonic merge sorts them
template <int KL, int G>
__device__ __forceinline__ void merge(int32_t (&top)[KL], const int32_t (&b)[G]) {
#pragma unroll
  for (int i = 0; i < G; ++i) top[KL - 1 - i] = max(top[KL - 1 - i], b[i]);
  bitonic_merge(top);
}

// the KL largest of key(0) .. key(N - 1) as a descending list (-1 past N),
// N a multiple of 8: each group of 8 sorted, then merged into the list
// (about 9 operations a key for KL = 8 where inserting one at a time takes
// 15)
template <int N, int KL, typename Key>
__device__ __forceinline__ void top_list(Key key, int32_t (&top)[KL]) {
  static_assert(N % 8 == 0 && KL >= 8, "groups of 8");
#pragma unroll
  for (int j = 0; j < KL; ++j) top[j] = -1;
#pragma unroll 2
  for (int g = 0; g < N; g += 8) {
    int32_t b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) b[i] = key(g + i);
    sort8(b);
    merge(top, b);
  }
}

// The thread routines read a row through row[e], e < N: a pointer to its
// entries, or an accessor that loads them (rtopk.cu reads 16 bytes at a
// time from shared memory).

// the KL largest keys of row[0 .. N) as a descending list (-1 past N)
template <int N, int KL, typename Row>
__device__ __forceinline__ void top_keys(Row row, int32_t (&top)[KL]) {
  top_list<N>([&](int e) { return key_of(row[e]); }, top);
}

// top[k - 1] of a descending list, 0 < k <= KL: the least of the first k
// (a min chain, not an index, so the list stays in registers)
template <int KL>
__device__ __forceinline__ int32_t kth(const int32_t (&top)[KL], int k) {
  int32_t theta = top[0];
#pragma unroll
  for (int j = 1; j < KL; ++j) theta = j < k ? min(theta, top[j]) : theta;
  return theta;
}

// the entries of row[0 .. N) with keys above theta and the first `quota`
// at it, in index order, into vals / idx from slot o on; row[e] is entry
// j0 + e of its row
template <int N, typename Row, typename V>
__device__ __forceinline__ void emit(Row row, int j0, int32_t theta, int quota, V* vals,
                                     int32_t* idx, int o) {
  int ties = 0;
#pragma unroll 8
  for (int e = 0; e < N; ++e) {
    const auto x = row[e];
    const int32_t v = key_of(x);
    const bool tie = v == theta;
    if (v > theta || (tie && ties < quota)) {
      put(x, vals + o);
      idx[o] = j0 + e;
      ++o;
    }
    ties += tie;
  }
}

// The packed form, for bf16's 15-bit keys and rows of at most 256 entries:
// key << 8 | (255 - j) orders entries as the contract does (the larger
// magnitude first, then the lower index), and no two are equal, so the k
// largest packed keys are the selection itself: no threshold, no tie pass.
__device__ __forceinline__ int32_t packed(int32_t key, int j) { return key << 8 | (255 - j); }

// the KL largest packed keys of row[0 .. N), row[e] being entry j0 + e
template <int N, int KL, typename Row>
__device__ __forceinline__ void top_packed(Row row, int j0, int32_t (&top)[KL]) {
  top_list<N>([&](int e) { return packed(key_of(row[e]), j0 + e); }, top);
}

// the indices of the first k entries of a descending packed list, in
// ascending order (a bitonic network; slots from k on hold INT32_MAX)
template <int KL>
__device__ __forceinline__ void ascending_indices(const int32_t (&top)[KL], int k,
                                                  int32_t (&ix)[KL]) {
#pragma unroll
  for (int j = 0; j < KL; ++j) ix[j] = j < k ? 255 - (top[j] & 255) : INT32_MAX;
#pragma unroll
  for (int size = 2; size <= KL; size *= 2)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2)
#pragma unroll
      for (int i = 0; i < KL; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const int32_t lo = min(ix[i], ix[j]), hi = max(ix[i], ix[j]);
          const bool up = (i & size) == 0;
          ix[i] = up ? lo : hi;
          ix[j] = up ? hi : lo;
        }
      }
}

// the top-|k| of row[0 .. D) by one thread, k <= KL
template <int D, int KL, typename Row, typename V>
__device__ __forceinline__ void select_row_thread(Row row, V* vals, int32_t* idx, int k) {
  int32_t top[KL];
  top_keys<D>(row, top);
  const int32_t theta = kth(top, k);
  int n_hi = 0;
#pragma unroll
  for (int j = 0; j < KL; ++j) n_hi += top[j] > theta;  // the list is descending
  emit<D>(row, 0, theta, k - n_hi, vals, idx, 0);
}

}  // namespace topk
