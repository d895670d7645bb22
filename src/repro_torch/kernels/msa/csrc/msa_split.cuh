// The work item and the merge shared by the split layout's kernels for
// Hopper (msa_prefill.cu, msa_decode.cu).
//
// A work item is one piece of the page range of some rows of one sequence
// against one kv head.  Its M rows are the rows times the G = H / KH q
// heads of the group, stacked (M-row m is row m / G, head head0 + m % G),
// at most 64 of them (G <= 64), so each K/V page of the piece is read once
// per GQA group.  It runs as the fused kernel's work item does (msa_tile.cuh):
// the q rows copied into shared memory once, the piece's keys streamed
// through the cp.async ring in stages of 32 key slots (whole pages, or
// 32-key pieces of a longer page) read through the sequence's block-table
// row, the products on the tensor cores in bf16 (full-float32 FMAs in
// f32), four warps on 16 M rows each, or, with at most 16 live M rows
// (a decode row: G of them), on 8 keys of each stage each, their states
// merged in warp order at the end.
//
// A range of n pages is cut into min(max_pieces, ceil(n / piece_pages))
// pieces of consecutive pages, evenly; max_pieces follows from the shapes
// alone (the wrapper's n_pieces), so the grid does not depend on the
// step's values, and blocks of pieces past a range's count exit at once.
// An uncut range writes its rows' output; the pieces of a cut range write
// f32 partials (o, m, l), which a second kernel of the same call merges
// in piece order (merge_pair), so a launch gives the same bits every time.
// A masked key's p is 0 (masked scores hold the finite NEG_INF), so a row
// that sees nothing in a piece keeps m = NEG_INF and l = 0, and the merge
// weighs that piece by 0.
#pragma once

#include <limits.h>

#include "msa_tile.cuh"

namespace {

// Blocks an SM holds by shared memory (at most 3); the kernels cap their
// registers to match (__launch_bounds__), so that the bf16 instantiations
// up to D 128 run three blocks an SM and not two.
template <typename T, int kDP>
constexpr int kBlocksPerSm =
    kMaxSmem / Tile<T, kDP>::kSmem < 3 ? (int)(kMaxSmem / Tile<T, kDP>::kSmem)
                                       : 3;

// Pieces of a range of n_pages pages (0 for an empty range).
__device__ __forceinline__ int piece_count(int n_pages, int piece_pages,
                                           int max_pieces) {
  return n_pages <= 0
             ? 0
             : min(max_pieces, (n_pages + piece_pages - 1) / piece_pages);
}

// One work item: the rows x G <= 64 M rows against pages j0 .. j1 (j0 <=
// j1) of block-table row bt.  q and out point at row 0, head 0 of
// the item's rows (rows n_heads * D elements apart); part_o / part_ml at
// the same row of the piece's partial plane, or nullptr when the range
// was not cut.  qpos holds each row's logical position (nullptr: every row
// is at qp_all).
template <typename T, int kDP>
__device__ __forceinline__ void paged_item(
    unsigned char* smem, const T* __restrict__ q,
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ bt, const int* __restrict__ qpos, int qp_all,
    int rows, int G, int head0, int n_heads, int n_kv_heads, int kvh,
    int D, int page, int j0, int j1, int ctx, int window, float softcap,
    float scale, bool wide, T* __restrict__ out, float* __restrict__ part_o,
    float* __restrict__ part_ml) {
  using L = Tile<T, kDP>;
  T* qs = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t key_stride = (size_t)n_kv_heads * D;
  const size_t row_stride = (size_t)n_heads * D;
  const int M = rows * G;
  // stages of 32 key slots: ipp whole pages each, or a 32-key piece of a
  // page longer than 32 keys (cpp pieces a page)
  const int ipp = max(1, kKeys / page);
  const int cpp = (page + kKeys - 1) / kKeys;
  const int n_pages = j1 - j0 + 1;
  const int n_stages =
      page <= kKeys ? (n_pages + ipp - 1) / ipp : n_pages * cpp;

  {  // the q rows: M-row m is row m / G, head m % G
    const int m = tid >> 1;
    const T* src =
        m < M ? q + (size_t)(m / G) * row_stride + (size_t)(head0 + m % G) * D
              : q;
    copy_row<T, kDP>(qs + m * L::kStride, src, m < M, D, wide, tid & 1, 2);
  }
  // where this thread's key slot of stage st comes from: the slot's
  // element offset in a pool, its kv position (INT_MAX: no key), and
  // whether it is a key of the piece
  struct Loc {
    size_t src;
    int kv;
    bool ok;
  };
  const int slot = tid >> 2;
  auto locate = [&](int st) {
    Loc c{0, INT_MAX, false};
    int j, off;
    if (page <= kKeys) {
      j = j0 + st * ipp + slot / page;
      off = slot % page;
      c.ok = slot < ipp * page && j <= j1;
    } else {
      j = j0 + st / cpp;
      off = (st % cpp) * kKeys + slot;
      c.ok = st < n_stages && off < page;
    }
    if (c.ok) {
      MSA_CHECK(j >= 0 && j < g_ext.items);
      MSA_CHECK(bt[j] >= 0 && bt[j] < g_ext.pages);
      c.src = ((size_t)bt[j] * page + off) * key_stride + (size_t)kvh * D;
      c.kv = j * page + off;
    }
    return c;
  };
  auto issue = [&](int st, const Loc& c) {
    unsigned char* base =
        smem + L::kQBytes + (size_t)(st % L::kStages) * L::kStageBytes;
    T* ks = reinterpret_cast<T*>(base);
    T* vs = ks + kKeys * L::kStride;
    if ((tid & 3) == 0)
      reinterpret_cast<int*>(vs + kKeys * L::kStride)[slot] = c.kv;
    copy_row<T, kDP>(ks + slot * L::kStride, k_pages + c.src, c.ok, D, wide,
                     tid & 3, 4);
    copy_row<T, kDP>(vs + slot * L::kStride, v_pages + c.src, c.ok, D, wide,
                     tid & 3, 4);
  };
#pragma unroll
  for (int st = 0; st < L::kStages - 1; ++st) {
    if (st < n_stages) issue(st, locate(st));
    cp_async_commit();
  }
  // the block-table entry of the next stage to issue is read a stage
  // ahead, so its latency hides behind the math
  Loc ahead = locate(L::kStages - 1);

  const bool split = M <= 16;
  const int mw = split ? 0 : warp * 16;
  const bool active = mw < M;
  int qp[2];  // this thread's two M rows (lane / 4 and lane / 4 + 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mw + (lane >> 2) + 8 * h;
    qp[h] = m < M ? (qpos ? qpos[m / G] : qp_all) : -1;  // -1: no key
  }
  float o[kDP / 8][4];
#pragma unroll
  for (int nd = 0; nd < kDP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();
    if (st + L::kStages - 1 < n_stages) issue(st + L::kStages - 1, ahead);
    cp_async_commit();
    ahead = locate(st + L::kStages);
    if (!active) continue;
    const unsigned char* base =
        smem + L::kQBytes + (size_t)(st % L::kStages) * L::kStageBytes;
    const T* ks = reinterpret_cast<const T*>(base);
    const T* vs = ks + kKeys * L::kStride;
    const int* kv = reinterpret_cast<const int*>(vs + kKeys * L::kStride);
    if (split) {
      const int k0 = warp * 8;
      stage_update<T, kDP, 1>(o, m_run, l_run, qs, ks + k0 * L::kStride,
                              vs + k0 * L::kStride, kv + k0, qp, ctx, window,
                              softcap, scale, D, lane);
    } else {
      stage_update<T, kDP, 4>(o, m_run, l_run, qs + warp * 16 * L::kStride,
                              ks, vs, kv, qp, ctx, window, softcap, scale, D,
                              lane);
    }
  }
  cp_async_wait<0>();

  if (!active) return;
  float l_row[2] = {quad_sum(l_run[0]), quad_sum(l_run[1])};
  if (split) {  // merge the warps' states, in warp order, into warp 0
    float* xo = reinterpret_cast<float*>(smem + L::kQBytes);  // (4,16,kDP)
    float* xm = xo + kWarpsF * 16 * kDP;                        // (4, 16)
    float* xl = xm + kWarpsF * 16;                              // (4, 16)
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (lane >> 2) + 8 * h;
#pragma unroll
      for (int nd = 0; nd < kDP / 8; ++nd)
        *reinterpret_cast<float2*>(xo + (warp * 16 + r) * kDP + nd * 8 +
                                   2 * (lane & 3)) =
            make_float2(o[nd][2 * h], o[nd][2 * h + 1]);
      if ((lane & 3) == 0) {
        xm[warp * 16 + r] = m_run[h];
        xl[warp * 16 + r] = l_row[h];
      }
    }
    __syncthreads();
    if (warp != 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (lane >> 2) + 8 * h;
      float mm = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarpsF; ++w) mm = fmaxf(mm, xm[w * 16 + r]);
      float wt[kWarpsF], ll = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsF; ++w) {
        wt[w] = expf(xm[w * 16 + r] - mm);
        ll = fmaf(xl[w * 16 + r], wt[w], ll);
      }
#pragma unroll
      for (int nd = 0; nd < kDP / 8; ++nd) {
        float x = 0.f, y = 0.f;
#pragma unroll
        for (int w = 0; w < kWarpsF; ++w) {
          const float2 v = *reinterpret_cast<const float2*>(
              xo + (w * 16 + r) * kDP + nd * 8 + 2 * (lane & 3));
          x = fmaf(v.x, wt[w], x);
          y = fmaf(v.y, wt[w], y);
        }
        o[nd][2 * h] = x;
        o[nd][2 * h + 1] = y;
      }
      m_run[h] = mm;
      l_row[h] = ll;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mw + (lane >> 2) + 8 * h;
    if (m >= M) continue;
    const size_t at = (size_t)(m / G) * n_heads + head0 + m % G;
    if (part_o == nullptr) {
      const float inv = 1.f / fmaxf(l_row[h], 1e-30f);
      T* dst = out + at * D;
#pragma unroll
      for (int nd = 0; nd < kDP / 8; ++nd) {
        const int d = nd * 8 + 2 * (lane & 3);
        if (d < D) {
          dst[d] = from_f32<T>(o[nd][2 * h] * inv);
          dst[d + 1] = from_f32<T>(o[nd][2 * h + 1] * inv);
        }
      }
    } else {
      float* dst = part_o + at * D;
#pragma unroll
      for (int nd = 0; nd < kDP / 8; ++nd) {
        const int d = nd * 8 + 2 * (lane & 3);
        if (d < D)
          *reinterpret_cast<float2*>(dst + d) =
              make_float2(o[nd][2 * h], o[nd][2 * h + 1]);
      }
      if ((lane & 3) == 0)
        *reinterpret_cast<float2*>(part_ml + at * 2) =
            make_float2(m_run[h], l_row[h]);
    }
  }
}

// Exact zeros for the rows x G M rows (out at row 0, head 0 of the rows,
// as in paged_item).
template <typename T>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, int rows,
                                          int G, int head0, int n_heads,
                                          int D) {
  for (int i = threadIdx.x; i < rows * G * D; i += kThreadsF) {
    const int m = i / D;
    out[((size_t)(m / G) * n_heads + head0 + m % G) * D + i % D] =
        from_f32<T>(0.f);
  }
}

// One output pair (dims d, d + 1) of (row, head) at = row * H + head of a
// cut range: out = sum_k o_k e^(m_k - m) / max(sum_k l_k e^(m_k - m),
// 1e-30), m = max_k m_k, over pieces k = 0 .. n - 1 in order; plane =
// rows x H of a partial plane.
template <typename T>
__device__ __forceinline__ void merge_pair(T* __restrict__ out,
                                           const float* __restrict__ part_o,
                                           const float* __restrict__ part_ml,
                                           size_t plane, size_t at, int d,
                                           int D, int n) {
  MSA_CHECK(n >= 0 && n <= g_ext.run_units);
  float m = kNegInf;
  for (int k = 0; k < n; ++k) m = fmaxf(m, part_ml[(k * plane + at) * 2]);
  float l = 0.f, x = 0.f, y = 0.f;
  for (int k = 0; k < n; ++k) {
    const float2 ml =
        *reinterpret_cast<const float2*>(part_ml + (k * plane + at) * 2);
    const float2 v =
        *reinterpret_cast<const float2*>(part_o + (k * plane + at) * D + d);
    const float w = expf(ml.x - m);
    l = fmaf(ml.y, w, l);
    x = fmaf(v.x, w, x);
    y = fmaf(v.y, w, y);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  out[at * D + d] = from_f32<T>(x * inv);
  out[at * D + d + 1] = from_f32<T>(y * inv);
}

}  // namespace
