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
// Design: one block per query row, 512 threads (16 warps). The query's kq
// (value, index) pairs are staged in shared memory. The row's tokens go in
// tiles of 512: thread x scores token tile + x, summing its kq products in
// t order, so each feature row of the tile is one coalesced read of the
// image — the O(n * k) image traffic this layout exists for; the scores go
// to shared memory. Then warp w takes the tile's tokens w, w + 16, ...: the
// online softmax (m, l) per warp and each lane's dv/32 f32 accumulator
// columns from the V row, one coalesced line, as in flash_sfa_decode.cu.
// The warps' states merge through shared memory at the end. Every
// multiply-add is an explicit __fmaf_rn / __fmul_rn.
//
// Only the addressing of token j differs (template parameter PAGED):
//   contiguous: image row r = row / group of k_feat (R, d, n) and V
//               (R, n, dv), token j at column j;
//   paged:      kv head (row % heads) / group of the pools k_feat (hkv, P,
//               d, page) and V (hkv, P, page, dv), token j at column
//               j % page of pool page bt[slot, j / page]; the walk is capped
//               at max_pages * page tokens (dead slots sit at a
//               past-the-table sentinel length).
// The tiles and the walk are the same in both, so the paged kernel gives
// the contiguous one's bits on the gathered image. The image and V are
// read in place, in bf16 or f32; GQA shares one image per group.
//
// Bound on the H100: bytes. Each step reads len * (k * val bytes + dv *
// val bytes) per query row (the image rows a query addresses and the V
// rows) and does O(len * (k + dv)) flops. The grid is one block per query
// row (96 for gpt2-small at 8 slots, below the 132 SMs), and the softmax
// walks each token serially within a warp; split-K and a tile-wide softmax
// are work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kTile = kWarps * 32;  // tokens scored per tile, one a thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Layout {
  long long kf_r, kf_p, kf_f;  // image: row (or kv head), pool page, feature
  long long v_r, v_p, v_n;     // V: row (or kv head), pool page, token
  const int32_t* bt;           // PAGED: block table (slots, max_pages)
  int max_pages, page;
  int n_cap;                   // the walk stops at min(length, n_cap)
};

template <int DV, typename T, bool PAGED>
__global__ void __launch_bounds__(kTile)
flash_sfa_decode_fm_kernel(const float* __restrict__ qv, const int32_t* __restrict__ qi,
                           const T* __restrict__ kf, const T* __restrict__ v,
                           const int32_t* __restrict__ lengths, float* __restrict__ out,
                           int heads, int group, int kq, int d, float scale, Layout lay) {
  constexpr int CPL = DV / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* qvs = smem;                                     // (kq)
  int* qis = reinterpret_cast<int*>(qvs + kq);           // (kq)
  float* st = reinterpret_cast<float*>(qis + kq);        // (kTile) scores
  float* wm = st + kTile;                                // (kWarps)
  float* wl = wm + kWarps;                               // (kWarps)
  float* wacc = wl + kWarps;                             // (kWarps, DV)

  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int len, head;
  const int32_t* bt_row = nullptr;
  if (PAGED) {
    const int slot = row / heads;
    len = lengths[slot];
    head = (row % heads) / group;
    bt_row = lay.bt + static_cast<long long>(slot) * lay.max_pages;
  } else {
    len = lengths[row];
    head = row / group;
  }
  len = min(max(len, 0), lay.n_cap);

  for (int t = threadIdx.x; t < kq; t += blockDim.x) {
    qvs[t] = qv[static_cast<size_t>(row) * kq + t];
    qis[t] = qi[static_cast<size_t>(row) * kq + t];
  }
  __syncthreads();

  const T* kf_head = kf + head * lay.kf_r;
  const T* v_head = v + head * lay.v_r;

  float m = -CUDART_INF_F;
  float l = 0.0f;
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.0f;

  for (int base = 0; base < len; base += kTile) {
    const int j = base + threadIdx.x;
    if (j < len) {
      long long blk = 0;
      int jj = j;
      if (PAGED) {
        const int pj = j / lay.page;
        blk = bt_row[pj];
        jj = j - pj * lay.page;
      }
      const T* col = kf_head + blk * lay.kf_p + jj;
      float sc = 0.0f;
      for (int t = 0; t < kq; ++t) {
        const unsigned f = static_cast<unsigned>(qis[t]);
        if (f < static_cast<unsigned>(d)) sc = __fmaf_rn(qvs[t], to_f(col[f * lay.kf_f]), sc);
      }
      st[threadIdx.x] = __fmul_rn(sc, scale);
    }
    __syncthreads();
    const int cnt = min(kTile, len - base);
    for (int jt = warp; jt < cnt; jt += kWarps) {
      const int j2 = base + jt;
      long long blk = 0;
      int jj = j2;
      if (PAGED) {
        const int pj = j2 / lay.page;
        blk = bt_row[pj];
        jj = j2 - pj * lay.page;
      }
      const float s = st[jt];
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = __fmaf_rn(l, corr, p);
      const T* vj = v_head + blk * lay.v_p + jj * lay.v_n;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        acc[c] = __fmaf_rn(p, to_f(vj[lane + 32 * c]), __fmul_rn(acc[c], corr));
      m = m_new;
    }
    __syncthreads();
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
  const void *qv, *qi, *kf, *v, *lengths;
  void* out;
  int rows, heads, group, kq, d;
  float scale;
  Layout lay;
  cudaStream_t stream;
};

template <int DV, typename T, bool PAGED>
void run(const Args& a) {
  const size_t smem = sizeof(float) * (2 * a.kq + kTile + 2 * kWarps + kWarps * DV);
  flash_sfa_decode_fm_kernel<DV, T, PAGED><<<a.rows, kTile, smem, a.stream>>>(
      static_cast<const float*>(a.qv), static_cast<const int32_t*>(a.qi),
      static_cast<const T*>(a.kf), static_cast<const T*>(a.v),
      static_cast<const int32_t*>(a.lengths), static_cast<float*>(a.out), a.heads,
      a.group, a.kq, a.d, a.scale, a.lay);
}

template <int DV, typename T>
int launch(const Args& a) {
  if (a.lay.bt != nullptr) run<DV, T, true>(a);
  else run<DV, T, false>(a);
  return static_cast<int>(cudaGetLastError());
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
// dv) f32. The image and V in f32 (val_kind 0) or bf16 (1), indexed through
// the given element strides (the token / in-page column axis of the image
// and the last axis of V contiguous): contiguous (bt null) image [r, f, j],
// V [r, j, :] with r = row / group, at lengths[row]; paged (bt = the block
// table (slots, max_pages) int32) image [hk, bt[slot, j / page], f,
// j % page], V [hk, bt[...], j % page, :] with slot = row / heads and hk =
// (row % heads) / group, at lengths[slot]. The walk stops at n_cap tokens.
extern "C" int flash_sfa_decode_fm_launch(
    const void* qv, const void* qi, const void* kf, const void* v,
    const void* lengths, void* out, int rows, int heads, int group, int kq,
    int d, int dv, int n_cap, long long kf_r, long long kf_p, long long kf_f,
    long long v_r, long long v_p, long long v_n, float scale, int val_kind,
    const void* bt, int max_pages, int page, void* stream) {
  cudaGetLastError();
  if (rows <= 0) return 0;
  if (heads <= 0 || group <= 0 || rows % heads != 0 || kq <= 0 || d <= 0 ||
      n_cap <= 0 || (bt != nullptr && (max_pages <= 0 || page <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{qv, qi, kf, v, lengths, out, rows, heads, group, kq, d, scale,
         Layout{kf_r, kf_p, kf_f, v_r, v_p, v_n, static_cast<const int32_t*>(bt),
                max_pages, page, n_cap},
         static_cast<cudaStream_t>(stream)};
  if (dv == 32) return by_value<32>(val_kind, a);
  if (dv == 64) return by_value<64>(val_kind, a);
  if (dv == 128) return by_value<128>(val_kind, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
