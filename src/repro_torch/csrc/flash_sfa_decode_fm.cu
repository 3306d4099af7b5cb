// flash_sfa_decode_fm.cu — feature-major decode for Hopper (sm_90a): a
// sparse query reads its k feature rows of a dense (d, n) K image.
//
// Replaces two TPU kernels of repro/kernels/flash_sfa_decode.py:
//   flash_sfa_decode_fm        (Pallas body _decode_fm_kernel)        row 13
//   flash_sfa_decode_fm_paged  (Pallas body _decode_fm_paged_kernel)  row 14
// For each query row, with the query's top-k code (qv[t], qi[t]):
//   s_j = scale * sum_t qv[t] * K_feat[qi[t], j],
//   out = softmax_j(s_j) . V_j   over j < length, in f32.
//
// Design: split over the keys (flash-decoding), as the token-major decode
// (flash_sfa_decode.cu), two kernels in one launch call. A row's tokens
// fall into runs of kSplit = 128 positions by position alone (n_cap, the
// layout, the page size and the other rows move no boundary). The grid is
// (rows, ceil(n_cap / 128)) blocks of 128 threads; a block whose run starts
// at or past its row's length returns at once.
//
//   split kernel — every load of the run is issued before the first wait:
//     a paged run looks its pages up once, into shared memory; the run's V
//     rows go by cp.async (16-byte chunks, coalesced) into shared memory,
//     where they land while the run is scored; thread i loads the query's
//     kq (value, index) pairs, eight at a time, and for each the image
//     value of token i in that feature row (the row's 128 tokens one
//     coalesced read: the O(n * k) image traffic this layout exists for; an
//     index >= d adds nothing), s = scale * sum_t qv[t] * K_feat[qi[t], j]
//     in t order. The run's max m comes from a warp shuffle and a block
//     reduction, p_j = exp(s_j - m); warp w adds p_j * V_j over its 32
//     tokens from shared memory, lane owning dv/32 adjacent columns; the
//     warps' (l, acc) add in warp order and the run's partial
//     (m, l, acc[dv]) goes to an f32 workspace.
//   merge kernel (decode_split.cuh, the token-major decode's) — one block
//     per row folds the row's partials in run order; a zero-length row
//     gives 0.
// Every multiply-add is an explicit __fmaf_rn / __fmul_rn / __fadd_rn and
// every sum runs in an order fixed by token position, so the two forms give
// the same bits on the same content at the same length whatever the
// strides or which load path they allow.
//
// Only the addressing of token j differs (template parameter PAGED):
//   contiguous: image row r = row / group of k_feat (R, d, n) and V
//               (R, n, dv), token j at column j, at lengths[row];
//   paged:      kv head (row % heads) / group of the pools k_feat (hkv, P,
//               d, page) and V (hkv, P, page, dv), token j at column
//               j % page of pool page bt[slot, j / page], slot = row /
//               heads, at lengths[slot]; the walk is capped at max_pages *
//               page tokens (dead slots sit at a past-the-table sentinel
//               length).
// The image and V are read in place, in bf16 or f32; GQA shares one image
// per group.
//
// Bound on the H100: bytes. Each step reads len * (k * val bytes + dv *
// val bytes) per query row (the image rows a query addresses and the V
// rows) and does O(len * (k + dv)) flops. One block a row would leave most
// of the 132 SMs idle at gpt2-small's 96 rows (8 slots) and walk a row's
// tokens in turn; the split gives each row up to 16 blocks, each with its
// whole run's loads in flight at once.

#include "decode_split.cuh"

namespace {

constexpr int kQChunk = 8;   // query pairs whose image values load together

struct Layout {
  long long kf_r, kf_p, kf_f;  // image: row (or kv head), pool page, feature
  long long v_r, v_p, v_n;     // V: row (or kv head), pool page, token
};

template <int DV, typename T, bool PAGED>
__global__ void __launch_bounds__(kSplit)
decode_fm_split_kernel(const float* __restrict__ qv, const int32_t* __restrict__ qi,
                       const T* __restrict__ kf, const T* __restrict__ v,
                       const int32_t* __restrict__ lengths, float* __restrict__ ws,
                       int heads, int group, int kq, int d, float scale, Layout lay,
                       Walk walk, int vec_v) {
  // vec_v: the V rows sit on the 16-byte grid
  constexpr int CPL = DV / 32;                                // adjacent columns per lane
  constexpr int CPR = DV * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks of a V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vs = reinterpret_cast<T*>(smem_raw);                     // (kSplit, DV) the run's V
  float* ps = reinterpret_cast<float*>(vs + kSplit * DV);     // (kSplit) p of the run's tokens
  float* wred = ps + kSplit;           // (kWarps) the warps' max, then their l
  float* wacc = wred + kWarps;         // (kWarps, DV)
  int* pg = reinterpret_cast<int*>(wacc + kWarps * DV);  // (kSplit) pages of the run

  const int row = blockIdx.x;
  const int len = row_length(lengths, row, heads, walk);
  const int j0 = blockIdx.y * kSplit;
  if (j0 >= len) return;
  const int nrun = min(kSplit, len - j0);
  const int hk = PAGED ? (row % heads) / group : row / group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int p0 = PAGED ? j0 / walk.page : 0;
  if (PAGED) {  // each page of the run looked up once
    const int32_t* bt_row = walk.bt + static_cast<long long>(row / heads) * walk.max_pages;
    const int np = (j0 + nrun - 1) / walk.page - p0 + 1;
    for (int t = tid; t < np; t += kSplit) pg[t] = bt_row[p0 + t];
    __syncthreads();
  }

  // token j of the row: (pool page, token within it); contiguous: (0, j)
  auto locate = [&](int j, long long& blk, long long& jj) {
    if (PAGED) {
      const int pj = j / walk.page;
      blk = pg[pj - p0];
      jj = j - pj * walk.page;
    } else {
      blk = 0;
      jj = j;
    }
  };
  const T* kf_head = kf + hk * lay.kf_r;
  const T* v_head = v + hk * lay.v_r;

  // the V rows by cp.async into shared memory, landing while the run is scored
  if (vec_v) {
    for (int c = tid; c < nrun * CPR; c += kSplit) {
      long long blk, jj;
      locate(j0 + c / CPR, blk, jj);
      cp_async16(vs + (c / CPR) * DV + (c % CPR) * (16 / sizeof(T)),
                 v_head + blk * lay.v_p + jj * lay.v_n + (c % CPR) * (16 / sizeof(T)));
    }
  }
  cp_async_commit();

  // score: thread tid owns token j0 + tid; s = scale * sum_t qv[t] kf[qi[t], j]
  float s = -CUDART_INF_F;
  if (tid < nrun) {
    long long blk, jj;
    locate(j0 + tid, blk, jj);
    const T* col = kf_head + blk * lay.kf_p + jj;
    const float* qvr = qv + static_cast<size_t>(row) * kq;
    const int32_t* qir = qi + static_cast<size_t>(row) * kq;
    float part = 0.0f;
    for (int t0 = 0; t0 < kq; t0 += kQChunk) {
      unsigned f[kQChunk];
      float w[kQChunk], x[kQChunk];
#pragma unroll
      for (int e = 0; e < kQChunk; ++e) {
        const bool ok = t0 + e < kq;
        f[e] = ok ? static_cast<unsigned>(qir[t0 + e]) : 0xffffffffu;
        w[e] = ok ? qvr[t0 + e] : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kQChunk; ++e)
        x[e] = f[e] < static_cast<unsigned>(d) ? to_f(col[f[e] * lay.kf_f]) : 0.0f;
#pragma unroll
      for (int e = 0; e < kQChunk; ++e)
        if (f[e] < static_cast<unsigned>(d)) part = __fmaf_rn(w[e], x[e], part);
    }
    s = __fmul_rn(part, scale);
  }
  if (!vec_v) {  // V rows off the 16-byte grid: plain loads
    for (int e = tid; e < nrun * DV; e += kSplit) {
      long long blk, jj;
      locate(j0 + e / DV, blk, jj);
      vs[e] = v_head[blk * lay.v_p + jj * lay.v_n + e % DV];
    }
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

  float* out = ws + (static_cast<size_t>(row) * gridDim.y + blockIdx.y) * (DV + 2);
  for (int c = tid; c < DV; c += kSplit) {
    float a = wacc[c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a = __fadd_rn(a, wacc[w * DV + c]);
    out[2 + c] = a;
  }
  if (tid == 0) {
    float lsum = wred[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) lsum = __fadd_rn(lsum, wred[w]);
    out[0] = m;
    out[1] = lsum;
  }
}

struct Args {
  const void *qv, *qi, *kf, *v, *lengths;
  void *out, *ws;
  int rows, heads, group, kq, d, splits;
  float scale;
  Layout lay;
  Walk walk;
  cudaStream_t stream;
};

template <int DV, typename T, bool PAGED>
int run(const Args& a) {
  const int es = static_cast<int>(sizeof(T));
  const int vec_v = reinterpret_cast<uintptr_t>(a.v) % 16 == 0 && (a.lay.v_r * es) % 16 == 0 &&
                    (a.lay.v_p * es) % 16 == 0 && (a.lay.v_n * es) % 16 == 0;
  const size_t smem = sizeof(T) * kSplit * DV +
                      sizeof(float) * (kSplit + kWarps + kWarps * DV) + sizeof(int) * kSplit;
  auto kernel = decode_fm_split_kernel<DV, T, PAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.rows, a.splits), kSplit, smem, a.stream>>>(
      static_cast<const float*>(a.qv), static_cast<const int32_t*>(a.qi),
      static_cast<const T*>(a.kf), static_cast<const T*>(a.v),
      static_cast<const int32_t*>(a.lengths), static_cast<float*>(a.ws), a.heads, a.group,
      a.kq, a.d, a.scale, a.lay, a.walk, vec_v);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<DV><<<a.rows, DV, 0, a.stream>>>(
      static_cast<const float*>(a.ws), static_cast<const int32_t*>(a.lengths),
      static_cast<float*>(a.out), a.heads, a.splits, a.walk);
  return static_cast<int>(cudaGetLastError());
}

template <int DV, typename T>
int launch(const Args& a) {
  return a.walk.bt != nullptr ? run<DV, T, true>(a) : run<DV, T, false>(a);
}

template <int DV>
int by_value(int val_kind, const Args& a) {
  return val_kind ? launch<DV, __nv_bfloat16>(a) : launch<DV, float>(a);
}

}  // namespace

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q_vals (rows, kq) f32, q_idx (rows, kq) int32, lengths int32, out (rows,
// dv) f32; ws an f32 workspace of rows * ceil(n_cap / split) * (dv + 2)
// floats; split must be the kernel's run length (128). The image and V in
// f32 (val_kind 0) or bf16 (1), indexed through the given element strides
// (the token / in-page column axis of the image and the last axis of V
// contiguous): contiguous (bt null) image [r, f, j], V [r, j, :] with r =
// row / group, at lengths[row]; paged (bt = the block table (slots,
// max_pages) int32) image [hk, bt[slot, j / page], f, j % page], V [hk,
// bt[...], j % page, :] with slot = row / heads and hk = (row % heads) /
// group, at lengths[slot]. The walk stops at n_cap tokens. Launches the
// split kernel, then the merge kernel, on stream.
extern "C" int flash_sfa_decode_fm_launch(
    const void* qv, const void* qi, const void* kf, const void* v,
    const void* lengths, void* out, void* ws, int rows, int heads, int group, int kq,
    int d, int dv, int n_cap, int split, long long kf_r, long long kf_p, long long kf_f,
    long long v_r, long long v_p, long long v_n, float scale, int val_kind,
    const void* bt, int max_pages, int page, void* stream) {
  cudaGetLastError();
  if (rows <= 0) return 0;
  const long long splits = (static_cast<long long>(n_cap) + kSplit - 1) / kSplit;
  if (split != kSplit || heads <= 0 || group <= 0 || rows % heads != 0 || kq <= 0 ||
      d <= 0 || n_cap <= 0 || splits > 65535 ||
      (bt != nullptr && (max_pages <= 0 || page <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{qv, qi, kf, v, lengths, out, ws, rows, heads, group, kq, d,
         static_cast<int>(splits), scale, Layout{kf_r, kf_p, kf_f, v_r, v_p, v_n},
         Walk{static_cast<const int32_t*>(bt), max_pages, page, -1, bt != nullptr ? 1 : 0,
              n_cap},
         static_cast<cudaStream_t>(stream)};
  if (dv == 32) return by_value<32>(val_kind, a);
  if (dv == 64) return by_value<64>(val_kind, a);
  if (dv == 128) return by_value<128>(val_kind, a);
  if (dv == 256) return by_value<256>(val_kind, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
