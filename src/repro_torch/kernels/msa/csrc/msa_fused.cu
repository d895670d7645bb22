// Fused varlen mixed-batch Multi-Segment Attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.msa.msa_fused._msa_fused_kernel
// (src/repro/kernels/msa/msa_fused.py:146, launched by msa_fused_pallas).
// It computes the same function: for every row of the flattened (T, H, D)
// token stream, softmax(q.k / sqrt(D) [softcapped]) . v over the paged
// K/V context of the row's own sequence, with the mask
//   row inside the item's sequence run, kv_pos <= q_pos, kv_pos < ctx,
//   q_pos - kv_pos < window (window > 0),
// GQA head h reading kv head h / (H / KH), f32 online softmax, output
// acc / max(l, 1e-30) in the input type, and exact zeros on rows no item
// covers (padding, all-padding tiles).
//
// Work decomposition.  The Pallas grid (H, W) ran the work-list axis W in
// order and carried acc/m/l in VMEM from one grid step to the next.  Here
// the host cuts the work-list into work units (msa_fused.build_units): a
// unit is a (sequence, q tile) run of the work-list, or a piece of at most
// a fixed number of its pages when the run is long, or a span of rows no
// item covers.  A work item of the kernel is one (unit, kv head, 64-row
// slice): its M rows are the unit's rows times the G = H / KH q heads of
// the group, stacked (M-row m is row m / G, head m % G), so every K/V page
// is read once per GQA group and feeds a 64 x 32 x D product.  A run that
// was not cut writes the output directly; the units of a cut run write
// f32 partials (o, m, l) to scratch, and a second kernel of the same call
// (msa_fused_merge_kernel) merges each run's partials in unit order, so
// the result is the same bits on every launch.  Blocks are persistent:
// the grid fills the card once and each block walks the work items
// blockIdx.x, blockIdx.x + gridDim.x, ... below the unit count, which the
// kernel reads from device memory (the host's unit fields are padded to a
// bucket, so the launch shape does not depend on the step).
//
// Inside a block: four warps.  A work item with more than 16 live M rows
// gives warp w M rows 16w .. 16w + 15 against all of a stage's keys; one
// with at most 16 (a decode unit: its G rows) gives every warp those rows
// against its own 8 of each stage's 32 keys, and the four warps' (o, m, l)
// are merged in warp order in shared memory at the end.  The
// q tile is copied into shared memory once; the unit's keys stream
// through a ring of 2-3 stages of 32 key slots (whole pages, or 32-key
// pieces of a longer page), K and V rows copied with cp.async (16 bytes a
// thread where rows are 16-byte aligned, else 4) and zero-filled past D
// and past the unit's last key, so the next stages load while the current
// one is in the products.  bf16: S = Q K^T and O += P V on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate, operands through
// ldmatrix); P is carried as a hi + lo pair of bf16 values through two
// products, so rounding P costs nothing measurable against the output's
// own bf16 rounding.  f32: the same tiles and the same register layout,
// with full-float32 FMAs on the CUDA cores (never TF32).  A masked key's
// p is set to 0 explicitly (masked scores hold the finite NEG_INF), so a
// row whose first stages are all masked keeps m = NEG_INF and l = 0.
//
// What bounds it on the H100: bytes.  A step reads every needed K/V page
// (16 x 128 bf16 = 4 KB of K and 4 KB of V per page per kv head at
// Llama-3.1-8B) and does ~45 flops per byte on a mixed step, far below the
// ~295 flop/byte at which the tensor cores would be the limit.  What this
// design does about it: only pages the work-list names are read, once per
// GQA group; long contexts are spread over several blocks, so the card is
// full on a decode-only step; copies run ahead of the math.  What it does
// not do yet: TMA, wgmma, or warp specialisation; a decode unit still
// fills only G of the 16 rows of its products.
//
// The (o, lse) mode (kLse, msa_fused.msa_fused_partial_cuda) is the per-
// shard term of sharded serving, the plain version's msa_fused_partial_ref
// (the JAX package computes it in XLA only, ops.msa_fused_partial): the
// same work items over one shard's local pages and work-list, but the
// output is float32 o = acc / max(l, 1e-30), not rounded to the input
// type, beside lse = m + log(l) where l > 0 and NEG_INF where no visible
// key was seen (a row whose local keys are all masked, or that no local
// item covers), so that the shards' partials merge exactly.  The merge
// kernel writes lse for the runs it merges.  The mode is a template
// argument: the other mode's code is as it was.

#include "msa_tile.cuh"

#include <limits.h>
#include <type_traits>

namespace {

// The work units (see msa_fused.build_units); counts = {units, merges}.
struct Units {
  const int *item0, *items, *row0, *rows, *seq, *part;
  const int *mg_row0, *mg_rows, *mg_units, *counts;
};

template <typename T, int kDP, bool kLse>
__global__ void __launch_bounds__(kThreadsF) msa_fused_kernel(
    const T* __restrict__ q,            // (T, H, D)
    const T* __restrict__ k_pages,      // (P, page, KH, D)
    const T* __restrict__ v_pages,      // (P, page, KH, D)
    std::conditional_t<kLse, float, T>* __restrict__ out,  // (T, H, D)
    float* __restrict__ lse,            // (T, H), kLse only
    float* __restrict__ part_o,         // (RUN_UNITS, T, H, D)
    float* __restrict__ part_ml,        // (RUN_UNITS, T, H, 2)
    const int* __restrict__ ctx_lens,   // (N,)
    const int* __restrict__ q_pos,      // (T,)
    const int* __restrict__ wl_slot,    // (W,)
    const int* __restrict__ wl_kvbase,  // (W,)
    Units u, int n_rows, int n_heads, int n_kv_heads, int D, int page,
    int q_tile, int slices, int window, float softcap, float scale,
    bool wide) {
  using L = Tile<T, kDP>;
  using TO = std::conditional_t<kLse, float, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = n_heads / n_kv_heads;
  const size_t key_stride = (size_t)n_kv_heads * D;
  const int per_unit = n_kv_heads * slices;
  const int n_work = u.counts[0] * per_unit;
  MSA_CHECK(u.counts[0] >= 0 && u.counts[0] <= g_ext.units);
  // stages of 32 key slots: ipp whole pages each, or a 32-key piece of a
  // page longer than 32 keys (cpp pieces a page)
  const int ipp = max(1, kKeys / page);
  const int cpp = (page + kKeys - 1) / kKeys;

  for (int wi = blockIdx.x; wi < n_work; wi += gridDim.x) {
    const int unit = wi / per_unit;
    const int kvh = (wi % per_unit) / slices;
    const int m0 = (wi % slices) * kMRows;
    const int rows = min(u.rows[unit], q_tile);
    const int M = rows * G;
    if (m0 >= M) continue;
    const int row0 = u.row0[unit];
    const int items = u.items[unit];
    MSA_CHECK(rows >= 0 && row0 >= 0 && row0 + rows <= g_ext.rows);
    MSA_CHECK(items >= 0);
    const int head0 = kvh * G;
    if (items == 0) {  // rows no item covers: exact zeros (lse NEG_INF)
      for (int i = tid; i < min(M - m0, kMRows) * D; i += kThreadsF) {
        const int m = m0 + i / D;
        const size_t at = (size_t)(row0 + m / G) * n_heads + head0 + m % G;
        out[at * D + i % D] = from_f32<TO>(0.f);
        if constexpr (kLse)
          if (i % D == 0) lse[at] = kNegInf;
      }
      continue;
    }
    const int item0 = u.item0[unit];
    MSA_CHECK(item0 >= 0 && item0 + items <= g_ext.items);
    MSA_CHECK(u.seq[unit] >= 0 && u.seq[unit] < g_ext.seqs);
    MSA_CHECK(u.part[unit] >= -1 && u.part[unit] < g_ext.run_units);
    const int ctx = ctx_lens[u.seq[unit]];
    const int n_stages = page <= kKeys ? (items + ipp - 1) / ipp : items * cpp;

    __syncthreads();  // the previous work item is done with shared memory
    {  // the q tile: M-row m0 + i is row (m0 + i) / G, head (m0 + i) % G
      const int i = tid >> 1;
      const int m = m0 + i;
      const T* src = m < M ? q + ((size_t)(row0 + m / G) * n_heads + head0 +
                                  m % G) * D
                           : q;
      copy_row<T, kDP>(qs + i * L::kStride, src, m < M, D, wide, tid & 1, 2);
    }
    // where this thread's key slot of stage st comes from: the slot's
    // element offset in a pool, its kv position (INT_MAX: no key), and
    // whether it is a key of the unit
    struct Loc {
      size_t src;
      int kv;
      bool ok;
    };
    const int slot = tid >> 2;
    auto locate = [&](int st) {
      Loc c{0, INT_MAX, false};
      int it, off;
      if (page <= kKeys) {
        it = st * ipp + slot / page;
        off = slot % page;
        c.ok = slot < ipp * page && it < items;
      } else {
        it = st / cpp;
        off = (st % cpp) * kKeys + slot;
        c.ok = st < n_stages && off < page;
      }
      if (c.ok) {
        MSA_CHECK(wl_slot[item0 + it] >= 0 &&
                  wl_slot[item0 + it] < g_ext.pages);
        c.src = ((size_t)wl_slot[item0 + it] * page + off) * key_stride +
                (size_t)kvh * D;
        c.kv = wl_kvbase[item0 + it] + off;
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
      copy_row<T, kDP>(ks + slot * L::kStride, k_pages + c.src, c.ok, D,
                       wide, tid & 3, 4);
      copy_row<T, kDP>(vs + slot * L::kStride, v_pages + c.src, c.ok, D,
                       wide, tid & 3, 4);
    };
#pragma unroll
    for (int st = 0; st < L::kStages - 1; ++st) {
      if (st < n_stages) issue(st, locate(st));
      cp_async_commit();
    }
    // the indices of the next stage to issue are read a stage ahead, so
    // their latency hides behind the math
    Loc ahead = locate(L::kStages - 1);

    // A work item with more than 16 live M rows gives each warp 16 of
    // them against all of a stage's keys; one with at most 16 (a decode
    // unit: G of them) gives every warp the same rows against 8 of the
    // stage's 32 keys, and merges the four warps' states at the end.
    const bool split = M - m0 <= 16;
    const int mw = split ? m0 : m0 + warp * 16;
    const bool active = mw < M;
    // this thread's two M rows (lane / 4 and lane / 4 + 8 of its warp)
    int qp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mw + (lane >> 2) + 8 * h;
      qp[h] = m < M ? q_pos[row0 + m / G] : -1;  // -1: sees no key
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
                                vs + k0 * L::kStride, kv + k0, qp, ctx,
                                window, softcap, scale, D, lane);
      } else {
        stage_update<T, kDP, 4>(o, m_run, l_run, qs + warp * 16 * L::kStride,
                                ks, vs, kv, qp, ctx, window, softcap, scale,
                                D, lane);
      }
    }

    if (!active) continue;
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
          *reinterpret_cast<float2*>(
              xo + (warp * 16 + r) * kDP + nd * 8 + 2 * (lane & 3)) =
              make_float2(o[nd][2 * h], o[nd][2 * h + 1]);
        if ((lane & 3) == 0) {
          xm[warp * 16 + r] = m_run[h];
          xl[warp * 16 + r] = l_row[h];
        }
      }
      __syncthreads();
      if (warp != 0) continue;
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
    const int part = u.part[unit];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mw + (lane >> 2) + 8 * h;
      const float l = l_row[h];
      if (m >= M) continue;
      const size_t at = (size_t)(row0 + m / G) * n_heads + head0 + m % G;
      if (part < 0) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        TO* dst = out + at * D;
#pragma unroll
        for (int nd = 0; nd < kDP / 8; ++nd) {
          const int d = nd * 8 + 2 * (lane & 3);
          if (d < D) {
            dst[d] = from_f32<TO>(o[nd][2 * h] * inv);
            dst[d + 1] = from_f32<TO>(o[nd][2 * h + 1] * inv);
          }
        }
        if constexpr (kLse)
          if ((lane & 3) == 0)
            lse[at] = l > 0.f ? m_run[h] + logf(l) : kNegInf;
      } else {
        const size_t pat = (size_t)part * n_rows * n_heads + at;
        float* dst = part_o + pat * D;
#pragma unroll
        for (int nd = 0; nd < kDP / 8; ++nd) {
          const int d = nd * 8 + 2 * (lane & 3);
          if (d < D)
            *reinterpret_cast<float2*>(dst + d) =
                make_float2(o[nd][2 * h], o[nd][2 * h + 1]);
        }
        if ((lane & 3) == 0)
          *reinterpret_cast<float2*>(part_ml + pat * 2) =
              make_float2(m_run[h], l);
      }
    }
  }
}

// The runs that were cut: out = sum_k o_k e^(m_k - m) / max(sum_k l_k
// e^(m_k - m), 1e-30), m = max_k m_k, over units k = 0, 1, ... in order
// (kLse: also lse = m + log(l), NEG_INF where l == 0).  A block task is
// 256 output pairs of dims of one (run, row): one pair a thread, the
// units' partials read side by side.
template <typename T, bool kLse>
__global__ void __launch_bounds__(256) msa_fused_merge_kernel(
    std::conditional_t<kLse, float, T>* __restrict__ out,
    float* __restrict__ lse, const float* __restrict__ part_o,
    const float* __restrict__ part_ml, Units u, int n_rows, int n_heads,
    int D, int q_tile) {
  using TO = std::conditional_t<kLse, float, T>;
  const size_t plane = (size_t)n_rows * n_heads;
  const int pairs = n_heads * (D / 2);  // output pairs of a row
  const int chunks = (pairs + 255) / 256;
  const int n_tasks = u.counts[1] * q_tile * chunks;
  MSA_CHECK(u.counts[1] >= 0 && u.counts[1] <= g_ext.merges);
  for (int task = blockIdx.x; task < n_tasks; task += gridDim.x) {
    const int run = task / (q_tile * chunks);
    const int r = (task / chunks) % q_tile;
    const int i = (task % chunks) * 256 + threadIdx.x;
    if (r >= u.mg_rows[run] || i >= pairs) continue;
    const int n = u.mg_units[run];
    MSA_CHECK(n >= 0 && n <= g_ext.run_units);
    MSA_CHECK(u.mg_row0[run] >= 0 && u.mg_row0[run] + r < g_ext.rows);
    const size_t at = (size_t)(u.mg_row0[run] + r) * n_heads + i / (D / 2);
    const int d = 2 * (i % (D / 2));
    float m = kNegInf;
#pragma unroll 4
    for (int k = 0; k < n; ++k) m = fmaxf(m, part_ml[(k * plane + at) * 2]);
    float l = 0.f, x = 0.f, y = 0.f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float2 ml =
          *reinterpret_cast<const float2*>(part_ml + (k * plane + at) * 2);
      const float2 v = *reinterpret_cast<const float2*>(
          part_o + (k * plane + at) * D + d);
      const float w = expf(ml.x - m);
      l = fmaf(ml.y, w, l);
      x = fmaf(v.x, w, x);
      y = fmaf(v.y, w, y);
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    out[at * D + d] = from_f32<TO>(x * inv);
    out[at * D + d + 1] = from_f32<TO>(y * inv);
    if constexpr (kLse)
      if (d == 0) lse[at] = l > 0.f ? m + logf(l) : kNegInf;
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <typename T, int kDP, bool kLse>
int launch(const void* q, const void* k_pages, const void* v_pages, void* out,
           float* lse, float* part_o, float* part_ml, const int* ctx_lens,
           const int* q_pos, const int* wl_slot, const int* wl_kvbase,
           const Units& u, int n_rows, int n_heads, int n_kv_heads, int D,
           int page, int q_tile, int window, float softcap,
           cudaStream_t stream) {
  using L = Tile<T, kDP>;
  using TO = std::conditional_t<kLse, float, T>;
  static_assert(L::kSmem <= kMaxSmem, "shared memory");
  static int blocks_per_sm = 0;
  if (blocks_per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        msa_fused_kernel<T, kDP, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, msa_fused_kernel<T, kDP, kLse>, kThreadsF, L::kSmem);
    if (err != cudaSuccess) return (int)err;
    if (blocks_per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorNoDevice;
  const int G = n_heads / n_kv_heads;
  const int slices = (min(q_tile, n_rows) * G + kMRows - 1) / kMRows;
  // 16-byte copies need 16-byte aligned rows
  const bool wide = (D * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  const float scale = (float)(1.0 / sqrt((double)D));
  msa_fused_kernel<T, kDP, kLse><<<sms * blocks_per_sm, kThreadsF, L::kSmem,
                                   stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<TO*>(out), lse, part_o,
      part_ml, ctx_lens, q_pos, wl_slot, wl_kvbase, u, n_rows, n_heads,
      n_kv_heads, D, page, q_tile, slices, window, softcap, scale, wide);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msa_fused_merge_kernel<T, kLse><<<8 * sms, 256, 0, stream>>>(
      static_cast<TO*>(out), lse, part_o, part_ml, u, n_rows, n_heads, D,
      min(q_tile, n_rows));
  return (int)cudaGetLastError();
}

template <typename T, bool kLse>
int launch_for_dim(const void* q, const void* k_pages, const void* v_pages,
                   void* out, float* lse, float* part_o, float* part_ml,
                   const int* ctx_lens, const int* q_pos, const int* wl_slot,
                   const int* wl_kvbase, const Units& u, int n_rows,
                   int n_heads, int n_kv_heads, int D, int page, int q_tile,
                   int window, float softcap, cudaStream_t stream) {
#define MSA_LAUNCH(DP)                                                       \
  return launch<T, DP, kLse>(q, k_pages, v_pages, out, lse, part_o, part_ml, \
                             ctx_lens, q_pos, wl_slot, wl_kvbase, u, n_rows, \
                             n_heads, n_kv_heads, D, page, q_tile, window,   \
                             softcap, stream)
  if (D <= 32) MSA_LAUNCH(32);
  if (D <= 64) MSA_LAUNCH(64);
  if (D <= 128) MSA_LAUNCH(128);
  MSA_LAUNCH(256);
#undef MSA_LAUNCH
}

}  // namespace

extern "C" {

// Launches the kernel and the merge on `stream` without synchronising;
// returns cudaGetLastError() (0 on success).  dtype: 0 = float32, 1 =
// bfloat16.  D must be even and at most 256.  part_o / part_ml are f32
// scratch of (RUN_UNITS, n_rows, H, D) and (RUN_UNITS, n_rows, H, 2).
// lse == nullptr: out is (n_rows, H, D) in the input type; otherwise the
// (o, lse) mode, out f32 (n_rows, H, D) and lse f32 (n_rows, H).
int msa_fused_launch(const void* q, const void* k_pages, const void* v_pages,
                     void* out, void* part_o, void* part_ml, void* lse,
                     const int* ctx_lens, const int* q_pos,
                     const int* wl_slot, const int* wl_kvbase,
                     const int* u_item0, const int* u_items,
                     const int* u_row0, const int* u_rows, const int* u_seq,
                     const int* u_part, const int* mg_row0,
                     const int* mg_rows, const int* mg_units,
                     const int* unit_counts, int n_rows, int n_heads,
                     int n_kv_heads, int D, int page, int q_tile, int window,
                     float softcap, int dtype, void* stream) {
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || n_rows <= 0 ||
      q_tile <= 0 || page <= 0 || D <= 0 || D % 2 != 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  const Units u{u_item0, u_items, u_row0,  u_rows,   u_seq,
                u_part,  mg_row0, mg_rows, mg_units, unit_counts};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  float* ls = static_cast<float*>(lse);
#define MSA_DTYPE(T, LSE)                                                   \
  return launch_for_dim<T, LSE>(q, k_pages, v_pages, out, ls, po, pml,      \
                                ctx_lens, q_pos, wl_slot, wl_kvbase, u,     \
                                n_rows, n_heads, n_kv_heads, D, page, q_tile, \
                                window, softcap, st)
  if (dtype == 0 && ls == nullptr) MSA_DTYPE(float, false);
  if (dtype == 0) MSA_DTYPE(float, true);
  if (dtype == 1 && ls == nullptr) MSA_DTYPE(__nv_bfloat16, false);
  if (dtype == 1) MSA_DTYPE(__nv_bfloat16, true);
#undef MSA_DTYPE
  return (int)cudaErrorInvalidValue;
}

const char* msa_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
