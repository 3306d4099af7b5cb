// flash_sfa_decode.cu — one decode query against the sparse KV cache, for
// Hopper (sm_90a): the contiguous, paged and multi-query (speculative
// verify) forms of the token-major decode, one kernel body.
//
// Replaces three TPU kernels of repro/kernels/flash_sfa_decode.py:
//   flash_sfa_decode        (Pallas body _decode_kernel)        row 10
//   flash_sfa_decode_paged  (Pallas body _decode_paged_kernel)  row 11
//   flash_sfa_decode_multi  (Pallas body _decode_multi_kernel)  row 12
// For each query row it computes
//   out = softmax_j(scale * q . densify(K~_j)) . V_j   over j < length,
// with q the (top-k sparsified) dense query (d floats), K~ the token-major
// cache of top-k codes, V the dense value cache; output in f32.
//
// Design: one block per query row, 16 warps. The query is staged in shared
// memory as d floats. Warp w walks the cache tokens j = w, w+16, ... below
// the row's length; for each token the lanes t < k read one code entry
// each and gather q at its index (s_j = scale * sum_t kv[j,t] * q[ki[j,t]],
// k multiply-adds, no densify), a shuffle reduction sums the score, and
// every lane updates the warp's online softmax (m, l) and its own dv/32
// accumulator columns from the V row, which the warp reads as one
// coalesced line. The warps' states merge through shared memory at the
// end. Every multiply-add is an explicit __fmaf_rn / __fmul_rn, so the
// three forms give the same bits on the same content whatever the compiler
// contracts.
//
// Only the addressing of token j differs (template parameter PAGED):
//   contiguous: leaf[b, j, kv_head, :] through strides (SparseKV leaves
//               (b, n, hkv, F), or one slot's (H, n, F) leaves for multi);
//   paged:      pool[kv_head, bt[slot, j / page], j % page, :] of the
//               (hkv, P, page, F) pools, the walk capped at max_pages*page
//               tokens (dead slots sit at a past-the-table sentinel length).
// Which slot and which length a row reads is a runtime choice: row 10
// reads batch row / heads at lengths[row]; row 11 slot row / heads at
// lengths[slot]; row 12 one fixed slot at lengths[row] (query c of the
// verify pass at its own causal length). k_idx is read packed (uint8 /
// uint16, or int32), V in bf16 or f32, and head h reads kv head
// h / (heads / hkv): no unpack, GQA repeat or f32 upcast copy of the cache
// is ever made.
//
// Bound on the H100: bytes. Each step reads len * (k * (val + idx bytes) +
// dv * val bytes) per kv head and does O(len * (k + dv)) flops. The grid
// is one block per query row (96 for gpt2-small at 8 slots, below the 132
// SMs), and the verify pass reads the slot's cache once per query row
// rather than once; splitting the cache across blocks (split-K) and
// sharing tiles across the verify queries are work for a later change.

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
  long long b, n, h;  // elements; the last axis is contiguous. Paged: b is
                      // the pool page stride, n the in-page token stride
};

struct Walk {
  const int32_t* bt;  // PAGED: block table (slots, max_pages)
  int max_pages, page;
  int slot_fixed;     // >= 0: every row reads this slot; else row / heads
  int len_per_slot;   // lengths indexed by slot (1) or by query row (0)
  int n_cap;          // the walk stops at min(length, n_cap)
};

template <int DV, typename T, typename IT, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32)
flash_sfa_decode_kernel(const float* __restrict__ q, const T* __restrict__ kv,
                        const IT* __restrict__ ki, const T* __restrict__ v,
                        const int32_t* __restrict__ lengths, float* __restrict__ out,
                        int heads, int group, int kk, int d, Strides skv,
                        Strides ski, Strides sv, float scale, Walk walk) {
  constexpr int CPL = DV / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                    // (d)
  float* wm = qs + d;                  // (kWarps)
  float* wl = wm + kWarps;             // (kWarps)
  float* wacc = wl + kWarps;           // (kWarps, DV)

  const int row = blockIdx.x;          // slot (or query) * heads + h
  const int slot = walk.slot_fixed >= 0 ? walk.slot_fixed : row / heads;
  const int hk = (row % heads) / group;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = min(max(lengths[walk.len_per_slot ? row / heads : row], 0), walk.n_cap);

  for (int t = threadIdx.x; t < d; t += blockDim.x) qs[t] = q[static_cast<size_t>(row) * d + t];
  __syncthreads();

  const T* kv_head = kv + hk * skv.h;
  const IT* ki_head = ki + hk * ski.h;
  const T* v_head = v + hk * sv.h;
  const int32_t* bt_row = PAGED ? walk.bt + static_cast<long long>(slot) * walk.max_pages : nullptr;

  float m = -CUDART_INF_F;
  float l = 0.0f;
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.0f;

#pragma unroll 4
  for (int j = warp; j < len; j += kWarps) {
    long long blk;   // batch row, or pool page
    int jj;          // token within it
    if (PAGED) {
      const int pj = j / walk.page;
      blk = bt_row[pj];
      jj = j - pj * walk.page;
    } else {
      blk = slot;
      jj = j;
    }
    const T* kvj = kv_head + blk * skv.b + jj * skv.n;
    const IT* kij = ki_head + blk * ski.b + jj * ski.n;
    float part = 0.0f;
    for (int t = lane; t < kk; t += 32) {
      const unsigned id = static_cast<unsigned>(kij[t]);
      if (id < static_cast<unsigned>(d)) part = __fmaf_rn(to_f(kvj[t]), qs[id], part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part = __fadd_rn(part, __shfl_xor_sync(kFull, part, off));
    const float s = __fmul_rn(part, scale);
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = __fmaf_rn(l, corr, p);
    const T* vj = v_head + blk * sv.b + jj * sv.n;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      acc[c] = __fmaf_rn(p, to_f(vj[lane + 32 * c]), __fmul_rn(acc[c], corr));
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
        lsum = __fmaf_rn(wl[w], f, lsum);
        a = __fmaf_rn(wacc[w * DV + c], f, a);
      }
      result = __fdiv_rn(a, fmaxf(lsum, 1e-30f));
    }
    out[static_cast<size_t>(row) * DV + c] = result;
  }
}

struct Args {
  const void *q, *kv, *ki, *v, *lengths;
  void* out;
  int rows, heads, group, kk, d;
  Strides skv, ski, sv;
  float scale;
  Walk walk;
  cudaStream_t stream;
};

template <int DV, typename T, typename IT, bool PAGED>
void run(const Args& a) {
  const size_t smem = sizeof(float) * (a.d + 2 * kWarps + kWarps * DV);
  flash_sfa_decode_kernel<DV, T, IT, PAGED><<<a.rows, kWarps * 32, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.kv),
      static_cast<const IT*>(a.ki), static_cast<const T*>(a.v),
      static_cast<const int32_t*>(a.lengths), static_cast<float*>(a.out), a.heads,
      a.group, a.kk, a.d, a.skv, a.ski, a.sv, a.scale, a.walk);
}

template <int DV, typename T, typename IT>
int launch(const Args& a) {
  if (a.walk.bt != nullptr) run<DV, T, IT, true>(a);
  else run<DV, T, IT, false>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DV, typename T>
int by_index(int idx_kind, const Args& a) {
  switch (idx_kind) {
    case 0: return launch<DV, T, uint8_t>(a);
    case 1: return launch<DV, T, uint16_t>(a);
    case 2: return launch<DV, T, int32_t>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DV>
int by_value(int val_kind, int idx_kind, const Args& a) {
  return val_kind ? by_index<DV, __nv_bfloat16>(idx_kind, a) : by_index<DV, float>(idx_kind, a);
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (rows, d) f32; lengths int32; out (rows, dv) f32. Cache leaves in f32
// (val_kind 0) or bf16 (1), k_idx uint8 (idx_kind 0), uint16 (1) or int32
// (2), indexed through the given element strides (last axis contiguous):
// contiguous (bt null) [b, j, kv_head, :]; paged (bt = the block table
// (slots, max_pages) int32) [kv_head, bt[slot, j / page], j % page, :].
// Row r reads slot slot_fixed (>= 0) or r / heads, at lengths[r / heads]
// (len_per_slot 1) or lengths[r], and kv head (r % heads) / (heads / hkv);
// the walk stops at n_cap tokens.
extern "C" int flash_sfa_decode_launch(
    const void* q, const void* kv, const void* ki, const void* v,
    const void* lengths, void* out, int rows, int heads, int hkv, int kk,
    int d, int dv, int n_cap, long long kv_sb, long long kv_sn, long long kv_sh,
    long long ki_sb, long long ki_sn, long long ki_sh, long long v_sb,
    long long v_sn, long long v_sh, float scale, int val_kind, int idx_kind,
    const void* bt, int max_pages, int page, int slot_fixed, int len_per_slot,
    void* stream) {
  cudaGetLastError();
  if (rows <= 0) return 0;
  if (heads <= 0 || hkv <= 0 || heads % hkv != 0 || rows % heads != 0 || kk <= 0 ||
      d <= 0 || n_cap <= 0 || (bt != nullptr && (max_pages <= 0 || page <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, kv, ki, v, lengths, out, rows, heads, heads / hkv, kk, d,
         Strides{kv_sb, kv_sn, kv_sh}, Strides{ki_sb, ki_sn, ki_sh}, Strides{v_sb, v_sn, v_sh},
         scale, Walk{static_cast<const int32_t*>(bt), max_pages, page, slot_fixed, len_per_slot, n_cap},
         static_cast<cudaStream_t>(stream)};
  if (dv == 32) return by_value<32>(val_kind, idx_kind, a);
  if (dv == 64) return by_value<64>(val_kind, idx_kind, a);
  if (dv == 128) return by_value<128>(val_kind, idx_kind, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
