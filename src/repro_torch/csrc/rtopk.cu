// rtopk.cu — row-wise exact top-|k| selection for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rtopk.py::rtopk (Pallas body
// _rtopk_kernel -> _topk_select). Contract, as there: for each row of x
// (rows, d), the k entries of largest |x| with NaN read as +0, ties kept in
// ascending index order, indices ascending (int32), values moved bit-exact
// in x's dtype (f32 or bf16: -0, subnormals and +-inf kept). The selection
// itself lives in csrc/topk_select.cuh, shared with proj_rtopk.cu; this
// file moves the raw bits (uint32 for f32, uint16 for bf16), never a float.
//
// Bound on the H100: bytes. The row is read once (d values) and k values +
// k int32 indices are written. The TPU's form, a 32-step bisection of one
// warp a row, was issue-bound here: each step is E ballots and popcounts
// on one row's d values, ~350 warp instructions a row. The one-thread body
// spends about 14 integer operations an entry on bf16 (the key, its
// packing, a share of the sort and merge networks): at the training shape
// it is bound by instruction issue, at twice its byte bound on an H100.
//
// Two bodies, picked by the caller (kernels/rtopk.py::one_thread_body):
//  * the one-thread body, for d in {32, 64, 128} and k <= 16 (every path
//    of the port's models): each warp takes 32 / L consecutive rows, one
//    contiguous span of x, stages it in shared memory by 16-byte cp.async
//    at a pitch of an odd number of 16-byte chunks, and goes on as soon as
//    its own rows are in (no block barrier: warps overlap their loads with
//    others' selection). A lane reads its entries 16 bytes at a time; the
//    odd pitch keeps each quarter-warp's 16-byte reads on distinct banks.
//    L lanes a row (adjacent threads) each keep the KL largest keys of
//    their d / L entries in a descending register list (KL = 8 for k <= 8,
//    16 for k <= 16), a group of 8 at a time (topk::top_list); L > 1
//    merges the lists by shuffles. For bf16 the keys are packed with their
//    index (topk::packed), so no two are equal and the row's first k are
//    its codes: their indices sorted, each lane writes its share. For f32
//    (31-bit keys, no room for an index) top[k - 1] is the threshold, and
//    an exclusive scan over the lanes gives each its first output slot and
//    its share of the ties, so every lane writes its entries above the
//    threshold and its ties in index order. The codes go to shared memory
//    and leave as the warp's two contiguous spans of vals and idx,
//    coalesced. L follows the dtype and the row count (kManyRows): at the
//    training shape 1 lane a row on bf16, 2 on f32; below it 4 on bf16, 8
//    on f32, where a single row's chain of work is the time.
//  * the warp body, for the rest (k > 16, other d <= 256): one warp a row
//    reading x in place, topk::select_row's bisection (16 steps on bf16's
//    15-bit keys, 32 on f32's), rows / 8 blocks of 8 warps.

#include "topk_select.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;   // the warp body
constexpr int kThreads = 128;       // the one-thread body

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// a row staged in shared memory on a 16-byte boundary: row[e] reads entry
// e of type T out of the 16-byte chunk that holds it (one LDS.128 for
// 16 / sizeof(T) entries once the caller's loop is unrolled)
template <typename T>
struct Staged {
  const uint4* p;
  __device__ __forceinline__ T operator[](int e) const {
    constexpr int kPer = 16 / sizeof(T);
    const uint4 c = p[e / kPer];
    const int w = e % kPer * sizeof(T) / 4;
    const uint32_t word = w == 0 ? c.x : w == 1 ? c.y : w == 2 ? c.z : c.w;
    return static_cast<T>(sizeof(T) == 4 ? word : word >> (16 * (e % 2)));
  }
};

template <int D, int KL, int L, int THREADS, typename T>
__global__ void __launch_bounds__(THREADS)
rtopk_thread_kernel(const T* __restrict__ x, T* __restrict__ vals, int32_t* __restrict__ idx,
                    int rows, int k) {
  constexpr int RW = 32 / L;              // rows of a warp
  constexpr int N = D / L;                // entries of a lane
  constexpr int C = D * sizeof(T) / 16;   // 16-byte chunks of a row
  constexpr int P = C + 1;                // row pitch in chunks: odd
  const int sk = k | 1;                   // codes pitch: odd
  extern __shared__ uint4 smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this warp's rows (RW, P) and codes (RW, sk) of each type
  uint4* rw = smem + warp * RW * P;
  int32_t* si = reinterpret_cast<int32_t*>(smem + THREADS / 32 * RW * P) + warp * RW * sk;
  T* sv = reinterpret_cast<T*>(reinterpret_cast<int32_t*>(smem + THREADS / 32 * RW * P) +
                               THREADS / 32 * RW * sk) + warp * RW * sk;

  // each warp stages its own rows, one contiguous span of x, and goes on as
  // soon as they are in: warps overlap their loads with others' selection
  const long long row0 = (static_cast<long long>(blockIdx.x) * (THREADS / 32) + warp) * RW;
  if (row0 >= rows) return;   // uniform per warp
  const int nrows = static_cast<int>(min(static_cast<long long>(RW), rows - row0));
  const uint4* src = reinterpret_cast<const uint4*>(x + row0 * D);
  for (int i = lane; i < nrows * C; i += 32) cp_async16(rw + i / C * P + i % C, src + i);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  // rows past nrows hold stale words: their lanes select on them (the
  // shuffles need every lane) and write nothing
  const int r = lane / L, l = lane % L;
  const Staged<T> row{rw + r * P + l * (N * sizeof(T) / 16)};
  constexpr bool kPacked = sizeof(T) == 2;   // bf16: packed keys, one pass
  int32_t mine[KL], top[KL];
  if constexpr (kPacked) topk::top_packed<N>(row, l * N, mine);
  else topk::top_keys<N>(row, mine);
#pragma unroll
  for (int j = 0; j < KL; ++j) top[j] = mine[j];
#pragma unroll
  for (int s = 1; s < L; s <<= 1) {   // butterfly: every lane ends with the row's list
    int32_t other[KL];
#pragma unroll
    for (int j = 0; j < KL; ++j) other[j] = __shfl_xor_sync(topk::kFull, top[j], s);
    topk::merge(top, other);
  }
  if constexpr (kPacked) {
    // the row's first k packed keys are its codes: lane l writes slots l,
    // l + L, ... of them, each value read from the staged row
    int32_t ix[KL];
    topk::ascending_indices(top, k, ix);
    const T* whole = reinterpret_cast<const T*>(rw + r * P);
#pragma unroll
    for (int j = 0; j < KL; ++j)
      if (j % L == l && j < k && r < nrows) {
        topk::put(whole[ix[j]], sv + r * sk + j);
        si[r * sk + j] = ix[j];
      }
  } else {
    const int32_t theta = topk::kth(top, k);
    // this lane's entries above theta are all in its own list (fewer than
    // k); its ties there number min(its ties, KL - above) >= the row's
    // quota, and that is all the scan needs
    int n_hi = 0, hi = 0, ties = 0;
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      n_hi += top[j] > theta;
      hi += mine[j] > theta;
      ties += mine[j] == theta;
    }
    int hi_inc = hi, ties_inc = ties;
#pragma unroll
    for (int s = 1; s < L; s <<= 1) {
      const int a = __shfl_up_sync(topk::kFull, hi_inc, s, L);
      const int b = __shfl_up_sync(topk::kFull, ties_inc, s, L);
      if (l >= s) {
        hi_inc += a;
        ties_inc += b;
      }
    }
    const int quota = k - n_hi;
    const int ties_before = ties_inc - ties;
    if (r < nrows)
      topk::emit<N>(row, l * N, theta, max(quota - ties_before, 0), sv + r * sk, si + r * sk,
                    hi_inc - hi + min(ties_before, quota));
  }
  __syncwarp();

  // the warp's codes are one contiguous span of vals and one of idx
  T* gv = vals + row0 * k;
  int32_t* gi = idx + row0 * k;
  const int step_r = 32 / k, step_o = 32 % k;
  int rr = lane / k, o = lane % k;
  for (int e = lane; e < nrows * k; e += 32) {
    gv[e] = sv[rr * sk + o];
    gi[e] = si[rr * sk + o];
    o += step_o;
    rr += step_r;
    if (o >= k) {
      o -= k;
      ++rr;
    }
  }
}

template <int D, int KL, int L, int THREADS, typename T>
int launch_thread(const void* x, void* vals, int32_t* idx, int rows, int k, cudaStream_t s) {
  constexpr int R = THREADS / L;   // rows of a block
  const size_t smem = 16 * R * (D * sizeof(T) / 16 + 1) +
                      static_cast<size_t>(R) * (k | 1) * (sizeof(int32_t) + sizeof(T));
  auto kernel = rtopk_thread_kernel<D, KL, L, THREADS, T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<(rows + R - 1) / R, THREADS, smem, s>>>(static_cast<const T*>(x),
                                                   static_cast<T*>(vals), idx, rows, k);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int L, int THREADS, typename T>
int by_k(const void* x, void* vals, int32_t* idx, int rows, int k, cudaStream_t s) {
  if (k <= 8) return launch_thread<D, 8, L, THREADS, T>(x, vals, idx, rows, k, s);
  return launch_thread<D, 16, L, THREADS, T>(x, vals, idx, rows, k, s);
}

// lanes a row of the one-thread body (tools/rtopk_sweep.py at d 64, its
// table in PERF.md §6): a call of kManyRows rows or more takes 1 lane a row
// on bf16 and 2 on f32, a smaller one 4 on bf16 and 8 on f32 (4 at d 32, a
// lane's entries being groups of 8), where one row's chain of work is the time
constexpr int kManyRows = 32768;

template <int D, typename T>
int by_rows(const void* x, void* vals, int32_t* idx, int rows, int k, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kFew = kBf16 ? 4 : (D / 8 < 8 ? D / 8 : 8);
  if (rows >= kManyRows) return by_k<D, kBf16 ? 1 : 2, kThreads, T>(x, vals, idx, rows, k, s);
  return by_k<D, kFew, kThreads, T>(x, vals, idx, rows, k, s);
}

template <typename T>
int by_d(const void* x, void* vals, int32_t* idx, int rows, int d, int k, cudaStream_t s) {
  if (d == 32) return by_rows<32, T>(x, vals, idx, rows, k, s);
  if (d == 64) return by_rows<64, T>(x, vals, idx, rows, k, s);
  return by_rows<128, T>(x, vals, idx, rows, k, s);
}

template <int E, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rtopk_warp_kernel(const T* __restrict__ x, T* __restrict__ vals, int32_t* __restrict__ idx,
                  int rows, int d, int k) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp: the whole warp leaves
  const size_t r = row;
  topk::select_row<E>(x + r * d, vals + r * k, idx + r * k, d, k, threadIdx.x & 31);
}

template <int E, typename T>
int launch_warp(const void* x, void* vals, int32_t* idx, int rows, int d, int k,
                cudaStream_t s) {
  rtopk_warp_kernel<E, T><<<(rows + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarpsPerBlock * 32,
                            0, s>>>(static_cast<const T*>(x), static_cast<T*>(vals), idx, rows,
                                    d, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int warp_by_d(const void* x, void* vals, int32_t* idx, int rows, int d, int k, cudaStream_t s) {
  if (d <= 32) return launch_warp<1, T>(x, vals, idx, rows, d, k, s);
  if (d <= 64) return launch_warp<2, T>(x, vals, idx, rows, d, k, s);
  if (d <= 128) return launch_warp<4, T>(x, vals, idx, rows, d, k, s);
  return launch_warp<8, T>(x, vals, idx, rows, d, k, s);
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (rows, d) contiguous f32 or bf16; vals (rows, k) same dtype; idx (rows, k)
// int32. one_thread: the one-thread body (d in {32, 64, 128}, k <= 16, x
// 16-byte aligned), else the warp body (d <= 256). Returns the launch's
// cudaGetLastError().
extern "C" int rtopk_launch(const void* x, void* vals, void* idx, int rows, int d, int k,
                            int is_bf16, int one_thread, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is ours
  if (rows <= 0) return 0;
  if (k <= 0 || k > d || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* ip = static_cast<int32_t*>(idx);
  if (one_thread) {
    if ((d != 32 && d != 64 && d != 128) || k > 16 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return is_bf16 ? by_d<uint16_t>(x, vals, ip, rows, d, k, s)
                   : by_d<uint32_t>(x, vals, ip, rows, d, k, s);
  }
  return is_bf16 ? warp_by_d<uint16_t>(x, vals, ip, rows, d, k, s)
                 : warp_by_d<uint32_t>(x, vals, ip, rows, d, k, s);
}
