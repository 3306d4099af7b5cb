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
// Design: split over the keys (flash-decoding), two kernels in one launch
// call. A row's tokens fall into runs of kSplit = 128 positions, run s
// holding [128 s, 128 s + 128), by position alone: n_cap, the layout, the
// page size and the other rows move no boundary, so a row at a given length
// is split the same way in every form. The grid is (rows, ceil(n_cap /
// 128)) blocks of 128 threads; a block whose run starts at or past its
// row's length returns at once.
//
//   split kernel — every load of the run is issued before the first wait:
//     the run's V rows go by cp.async (16-byte chunks, coalesced) into
//     shared memory, where they land while the run is scored; thread i
//     loads token i's k codes (k = 8: one vector of values, one of indices,
//     where base and strides allow; scalar loads otherwise, as the
//     speculative draft's k' = 2 rows need) and the block
//     stages the f32 query. Thread i then gathers the query at the stored
//     indices, s = scale * sum_t kv[t] * q[ki[t]] in t order (an index
//     >= d lands nowhere). The run's max m comes from a warp shuffle and a
//     block reduction, p_j = exp(s_j - m). Warp w adds p_j * V_j over its
//     32 tokens of the run from shared memory, each lane owning dv/32
//     adjacent columns; the warps' (l, acc) add in warp order and the run's
//     partial (m, l, acc[dv]) goes to an f32 workspace. A paged run looks
//     each of its pages up once, into shared memory.
//   merge kernel (decode_split.cuh, shared with the feature-major decode) —
//     one block per row folds the row's partials in increasing run index:
//     M = max m_s, out = sum_s acc_s e^(m_s - M) / max(sum_s l_s
//     e^(m_s - M), 1e-30); a zero-length row (no run) gives 0, a run with
//     m = -inf weighs 0.
//
// No atomics: every sum runs in an order fixed by token position, and
// every multiply-add is an explicit __fmaf_rn / __fmul_rn / __fadd_rn, so
// the three forms give the same bits on the same content at the same length
// whatever the compiler contracts or which load path a stride allows.
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
// dv * val bytes) per kv head and does O(len * (k + dv)) flops. The split
// gives gpt2-small's 96 rows up to 16 blocks each, all resident at once,
// and each block has its whole run's loads in flight at once, so the card
// waits on a few round trips per block rather than one per token. The
// verify pass still reads the slot's cache once per query row (from L2
// after the first); sharing a tile across the C verify queries is work for
// a later change.

#include "decode_split.cuh"

namespace {

constexpr int kChunk = 8;            // k whose codes load as one vector each

struct Strides {
  long long b, n, h;  // elements; the last axis is contiguous. Paged: b is
                      // the pool page stride, n the in-page token stride
};

// BYTES (8 or a multiple of 16) bytes from p, aligned to min(16, BYTES),
// into 32-bit words w (registers; Elem reads the elements out of them)
template <int BYTES>
__device__ __forceinline__ void load_words(const void* __restrict__ p, unsigned* w) {
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = r.x;
      w[4 * i + 1] = r.y;
      w[4 * i + 2] = r.z;
      w[4 * i + 3] = r.w;
    }
  } else {
    static_assert(BYTES == 8, "a code vector is 8 or a multiple of 16 bytes");
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = r.x;
    w[1] = r.y;
  }
}

// element i of E values packed little-endian into words: a value as f32
// (exactly what to_f gives), an index as unsigned (a negative int32 wraps
// past d and lands nowhere, as static_cast<unsigned> of the scalar does)
template <typename E> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float f(const unsigned* w, int i) { return __uint_as_float(w[i]); }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float f(const unsigned* w, int i) {
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
  }
};
template <> struct Elem<uint8_t> {
  static __device__ __forceinline__ unsigned u(const unsigned* w, int i) {
    return (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
  }
};
template <> struct Elem<uint16_t> {
  static __device__ __forceinline__ unsigned u(const unsigned* w, int i) {
    return (w[i >> 1] >> (16 * (i & 1))) & 0xffffu;
  }
};
template <> struct Elem<int32_t> {
  static __device__ __forceinline__ unsigned u(const unsigned* w, int i) { return w[i]; }
};

template <int N, typename E>
__host__ __device__ constexpr int words() { return N * static_cast<int>(sizeof(E)) / 4; }

template <int DV, typename T, typename IT, bool PAGED>
__global__ void __launch_bounds__(kSplit)
decode_split_kernel(const float* __restrict__ q, const T* __restrict__ kv,
                    const IT* __restrict__ ki, const T* __restrict__ v,
                    const int32_t* __restrict__ lengths, float* __restrict__ ws,
                    int heads, int group, int kk, int d, Strides skv, Strides ski,
                    Strides sv, float scale, Walk walk, int vec_codes, int vec_v) {
  // vec_codes: k = kChunk and the code rows sit on the vector grid;
  // vec_v: the V rows sit on the 16-byte grid
  constexpr int CPL = DV / 32;                                // adjacent columns per lane
  constexpr int CPR = DV * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks of a V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vs = reinterpret_cast<T*>(smem_raw);                     // (kSplit, DV) the run's V
  float* qs = reinterpret_cast<float*>(vs + kSplit * DV);     // (d)
  float* ps = qs + d;                  // (kSplit) p of the run's tokens
  float* wred = ps + kSplit;           // (kWarps) the warps' max, then their l
  float* wacc = wred + kWarps;         // (kWarps, DV)
  int* pg = reinterpret_cast<int*>(wacc + kWarps * DV);  // (kSplit) pages of the run

  const int row = blockIdx.x;          // slot (or query) * heads + h
  const int len = row_length(lengths, row, heads, walk);
  const int j0 = blockIdx.y * kSplit;
  if (j0 >= len) return;
  const int nrun = min(kSplit, len - j0);
  const int slot = walk.slot_fixed >= 0 ? walk.slot_fixed : row / heads;
  const int hk = (row % heads) / group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int p0 = PAGED ? j0 / walk.page : 0;
  if (PAGED) {  // each page of the run looked up once
    const int32_t* bt_row = walk.bt + static_cast<long long>(slot) * walk.max_pages;
    const int np = (j0 + nrun - 1) / walk.page - p0 + 1;
    for (int t = tid; t < np; t += kSplit) pg[t] = bt_row[p0 + t];
    __syncthreads();
  }

  // token j of the row: (batch row or pool page, token within it)
  auto locate = [&](int j, long long& blk, long long& jj) {
    if (PAGED) {
      const int pj = j / walk.page;
      blk = pg[pj - p0];
      jj = j - pj * walk.page;
    } else {
      blk = slot;
      jj = j;
    }
  };
  const T* v_head = v + hk * sv.h;

  // every load of the run is issued before the first wait: the V rows by
  // cp.async into shared memory, the codes of thread tid's token (k = 8: a
  // vector of values and one of indices) into registers, then the query
  if (vec_v) {
    for (int c = tid; c < nrun * CPR; c += kSplit) {
      long long blk, jj;
      locate(j0 + c / CPR, blk, jj);
      cp_async16(vs + (c / CPR) * DV + (c % CPR) * (16 / sizeof(T)),
                 v_head + blk * sv.b + jj * sv.n + (c % CPR) * (16 / sizeof(T)));
    }
  }
  cp_async_commit();
  const T* kvj = nullptr;
  const IT* kij = nullptr;
  if (tid < nrun) {
    long long blk, jj;
    locate(j0 + tid, blk, jj);
    kvj = kv + hk * skv.h + blk * skv.b + jj * skv.n;
    kij = ki + hk * ski.h + blk * ski.b + jj * ski.n;
  }
  const bool pre = vec_codes && tid < nrun;
  unsigned cv[words<kChunk, T>()], ci[words<kChunk, IT>()];
  if (pre) {
    load_words<kChunk * static_cast<int>(sizeof(T))>(kvj, cv);
    load_words<kChunk * static_cast<int>(sizeof(IT))>(kij, ci);
  }
  for (int t = tid; t < d; t += kSplit) qs[t] = q[static_cast<size_t>(row) * d + t];
  if (!vec_v) {  // V rows off the 16-byte grid: plain loads
    for (int e = tid; e < nrun * DV; e += kSplit) {
      long long blk, jj;
      locate(j0 + e / DV, blk, jj);
      vs[e] = v_head[blk * sv.b + jj * sv.n + e % DV];
    }
  }
  __syncthreads();

  // score: thread tid owns token j0 + tid; s = scale * sum_t kv[t] q[ki[t]]
  float s = -CUDART_INF_F;
  if (tid < nrun) {
    float part = 0.0f;
    if (pre) {
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const unsigned id = Elem<IT>::u(ci, u);
        if (id < static_cast<unsigned>(d)) part = __fmaf_rn(Elem<T>::f(cv, u), qs[id], part);
      }
    } else {  // another k, or codes off the vector grid: scalar loads
      for (int t = 0; t < kk; ++t) {
        const unsigned id = static_cast<unsigned>(kij[t]);
        if (id < static_cast<unsigned>(d)) part = __fmaf_rn(to_f(kvj[t]), qs[id], part);
      }
    }
    s = __fmul_rn(part, scale);
  }

  // the run's max, then p and the warps' sums of p
  float m = s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) wred[warp] = m;
  __syncthreads();
  m = wred[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wred[w]);
  const float p = tid < nrun ? expf(__fsub_rn(s, m)) : 0.0f;
  ps[tid] = p;
  float l = p;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l = __fadd_rn(l, __shfl_xor_sync(kFull, l, off));
  cp_async_wait<0>();
  __syncthreads();  // the maxima are read, ps is complete, the V rows have landed
  if (lane == 0) wred[warp] = l;

  // P.V: warp w adds its 32 tokens in order, lane owning columns lane*CPL..
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.0f;
  const int jw = warp * 32;
  const int nw = min(32, nrun - jw);
  for (int t = 0; t < nw; ++t) {
    const float pj = ps[jw + t];
    const T* vr = vs + (jw + t) * DV + lane * CPL;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = __fmaf_rn(pj, to_f(vr[c]), acc[c]);
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) wacc[warp * DV + lane * CPL + c] = acc[c];
  __syncthreads();

  float* part = ws + (static_cast<size_t>(row) * gridDim.y + blockIdx.y) * (DV + 2);
  for (int c = tid; c < DV; c += kSplit) {
    float a = wacc[c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a = __fadd_rn(a, wacc[w * DV + c]);
    part[2 + c] = a;
  }
  if (tid == 0) {
    float lsum = wred[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) lsum = __fadd_rn(lsum, wred[w]);
    part[0] = m;
    part[1] = lsum;
  }
}

struct Args {
  const void *q, *kv, *ki, *v, *lengths;
  void *out, *ws;
  int rows, heads, group, kk, d, splits;
  Strides skv, ski, sv;
  float scale;
  Walk walk;
  cudaStream_t stream;
};

// Is every address base + i*strides aligned to `bytes`?
bool aligned(const void* base, const Strides& s, int elem, int bytes) {
  return reinterpret_cast<uintptr_t>(base) % bytes == 0 && (s.b * elem) % bytes == 0 &&
         (s.n * elem) % bytes == 0 && (s.h * elem) % bytes == 0;
}

template <int DV, typename T, typename IT, bool PAGED>
int run(const Args& a) {
  const int code_bytes_v = static_cast<int>(sizeof(T)) * kChunk;
  const int code_bytes_i = static_cast<int>(sizeof(IT)) * kChunk;
  const int vec_codes = a.kk == kChunk &&
                        aligned(a.kv, a.skv, sizeof(T), code_bytes_v < 16 ? code_bytes_v : 16) &&
                        aligned(a.ki, a.ski, sizeof(IT), code_bytes_i < 16 ? code_bytes_i : 16);
  const int vec_v = aligned(a.v, a.sv, sizeof(T), 16);
  const size_t smem = sizeof(T) * kSplit * DV +
                      sizeof(float) * (a.d + kSplit + kWarps + kWarps * DV) + sizeof(int) * kSplit;
  auto kernel = decode_split_kernel<DV, T, IT, PAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.rows, a.splits), kSplit, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.kv),
      static_cast<const IT*>(a.ki), static_cast<const T*>(a.v),
      static_cast<const int32_t*>(a.lengths), static_cast<float*>(a.ws), a.heads, a.group,
      a.kk, a.d, a.skv, a.ski, a.sv, a.scale, a.walk, vec_codes, vec_v);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<DV><<<a.rows, DV, 0, a.stream>>>(
      static_cast<const float*>(a.ws), static_cast<const int32_t*>(a.lengths),
      static_cast<float*>(a.out), a.heads, a.splits, a.walk);
  return static_cast<int>(cudaGetLastError());
}

template <int DV, typename T, typename IT>
int launch(const Args& a) {
  return a.walk.bt != nullptr ? run<DV, T, IT, true>(a) : run<DV, T, IT, false>(a);
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

// q (rows, d) f32; lengths int32; out (rows, dv) f32; ws an f32 workspace
// of rows * ceil(n_cap / split) * (dv + 2) floats; split must be the
// kernel's run length (128). Cache leaves in f32 (val_kind 0) or bf16 (1),
// k_idx uint8 (idx_kind 0), uint16 (1) or int32 (2), indexed through the
// given element strides (last axis contiguous): contiguous (bt null)
// [b, j, kv_head, :]; paged (bt = the block table (slots, max_pages)
// int32) [kv_head, bt[slot, j / page], j % page, :]. Row r reads slot
// slot_fixed (>= 0) or r / heads, at lengths[r / heads] (len_per_slot 1) or
// lengths[r], and kv head (r % heads) / (heads / hkv); the walk stops at
// n_cap tokens. Launches the split kernel, then the merge kernel, on stream.
extern "C" int flash_sfa_decode_launch(
    const void* q, const void* kv, const void* ki, const void* v,
    const void* lengths, void* out, void* ws, int rows, int heads, int hkv, int kk,
    int d, int dv, int n_cap, int split, long long kv_sb, long long kv_sn, long long kv_sh,
    long long ki_sb, long long ki_sn, long long ki_sh, long long v_sb,
    long long v_sn, long long v_sh, float scale, int val_kind, int idx_kind,
    const void* bt, int max_pages, int page, int slot_fixed, int len_per_slot,
    void* stream) {
  cudaGetLastError();
  if (rows <= 0) return 0;
  const long long splits = (static_cast<long long>(n_cap) + kSplit - 1) / kSplit;
  if (split != kSplit || heads <= 0 || hkv <= 0 || heads % hkv != 0 || rows % heads != 0 ||
      kk <= 0 || d <= 0 || n_cap <= 0 || splits > 65535 ||
      (bt != nullptr && (max_pages <= 0 || page <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, kv, ki, v, lengths, out, ws, rows, heads, heads / hkv, kk, d,
         static_cast<int>(splits),
         Strides{kv_sb, kv_sn, kv_sh}, Strides{ki_sb, ki_sn, ki_sh}, Strides{v_sb, v_sn, v_sh},
         scale, Walk{static_cast<const int32_t*>(bt), max_pages, page, slot_fixed, len_per_slot, n_cap},
         static_cast<cudaStream_t>(stream)};
  if (dv == 32) return by_value<32>(val_kind, idx_kind, a);
  if (dv == 64) return by_value<64>(val_kind, idx_kind, a);
  if (dv == 128) return by_value<128>(val_kind, idx_kind, a);
  if (dv == 256) return by_value<256>(val_kind, idx_kind, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
