// Fused varlen mixed-batch Multi-Segment Attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.msa.msa_fused._msa_fused_kernel
// (src/repro/kernels/msa/msa_fused.py:146, launched by msa_fused_pallas).
// It computes the same function: for every row of the flattened (T, H, D)
// token stream, softmax(q.k / sqrt(D) [softcapped]) . v over the paged
// K/V context of the row's own sequence, with the mask
//   row inside the item's sequence run, kv_pos <= q_pos, kv_pos < ctx,
//   q_pos - kv_pos < window (window > 0),
// GQA head h reading kv head h / (H / KH), f32 online softmax across the
// items of a q tile, output acc / max(l, 1e-30) in the input type, and
// exact zeros on rows no item covers (padding, all-padding tiles).
//
// Work decomposition.  The Pallas grid (H, W) ran the work-list axis W in
// order and carried acc/m/l in VMEM from one grid step to the next.  CUDA
// blocks run in no order, so here one block owns one (q tile, q head): it
// walks that tile's contiguous item range [tile_first[t], tile_first[t+1])
// and keeps the tile's f32 accumulators in shared memory for the whole
// walk, writing the tile once at the end.  Each block reads its own
// indices (there is no scalar prefetch).  Inside the block, row r of the
// tile belongs to warp (r - row0) % kWarps for the whole walk, and every
// warp walks the item range on its own: 32 items' indices at a time, one
// per lane, a ballot picks the items that touch the warp's rows, and the
// warp attends those rows to the item's page.  Items of different
// sequences touch different rows, so a decode-heavy tile (one row per
// sequence, ~100 pages each) runs kWarps sequences at once with no block
// barrier between items; a prefill tile spreads its rows over the warps.
// Within a warp, lane l holds dims {2l, 2l+1} (+64 i) of the q row and the
// accumulator: each key's K and V rows are read as whole coalesced rows,
// and a score is one warp reduction.
//
// What bounds it on the H100: bytes.  A step reads every needed K/V page
// of every sequence (16 x 128 bf16 = 4 KB per page per kv head at
// Llama-3.1-8B) and does ~2 flops per byte read, far below the ~295
// flop/byte at which the tensor cores would be the limit.  What this
// design does about it: only pages the work-list names (context, causal
// horizon) are read, straight from their pool slots.  A warp's work is a
// stream of (item, chunk of the page's keys); it loads a chunk's K and V
// rows into registers with every load in flight at once, uses the chunk
// for all of its rows, and issues the next chunk's loads before the
// current chunk's math, so a warp keeps a chunk in flight while it
// computes.  The other heads of a GQA group and the other warps of a
// prefill tile find the page in L2.  What it does not do yet: spread one
// tile's items over several blocks (a decode-only step has n_tiles x H
// blocks), keep more than one chunk in flight (cp.async / TMA into shared
// memory), or use the tensor cores (wgmma) for the prefill rows.  q.k in
// float32 is computed with plain FMAs in full float32 (never TF32).

#include "msa_common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

// The warp's rows first, first + kWarps, ... < hi of the tile against
// one chunk of keys of an item's page (kv positions kvbase + c0 + jj).
template <typename T, int kP, int kC>
__device__ __forceinline__ void attend_chunk(
    const typename PairOf<T>::type (&kk)[kC][kP],
    const typename PairOf<T>::type (&vv)[kC][kP], const T* __restrict__ q,
    int n_heads, int h, float* __restrict__ acc, float* __restrict__ m_s,
    float* __restrict__ l_s, const int* __restrict__ q_pos, int row0,
    int first, int hi, int D, int page, int c0, int kvbase, int ctx,
    int window, float softcap, float scale, int lane) {
  for (int r = first; r < hi; r += kWarps) {
    const int rr = r - row0;
    attend_row<T, kP, kC>(kk, vv, q + ((size_t)r * n_heads + h) * D,
                          q_pos[r], acc + (size_t)rr * D, m_s + rr, l_s + rr,
                          D, page, c0, kvbase, ctx, window, softcap, scale,
                          lane);
  }
}

// What a warp needs of one item: its rows of the tile and its page.
struct Item {
  int first, hi, kvbase, ctx;
  size_t page_off;  // element offset of the page's kv-head rows in a pool
};

template <typename T, int kP>
__global__ void __launch_bounds__(kThreads, 1) msa_fused_kernel(
    const T* __restrict__ q,            // (T, H, D)
    const T* __restrict__ k_pages,      // (P, page, KH, D)
    const T* __restrict__ v_pages,      // (P, page, KH, D)
    T* __restrict__ out,                // (T, H, D)
    const int* __restrict__ q_start,    // (N,)
    const int* __restrict__ q_len,      // (N,)
    const int* __restrict__ ctx_lens,   // (N,)
    const int* __restrict__ q_pos,      // (T,)
    const int* __restrict__ wl_seq,     // (W,)
    const int* __restrict__ wl_slot,    // (W,)
    const int* __restrict__ wl_kvbase,  // (W,)
    const int* __restrict__ tile_first, // (n_tiles + 1,)
    int n_rows, int n_heads, int n_kv_heads, int D, int page, int n_seqs,
    int q_tile, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  float* acc = smem;                    // (q_tile, D)
  float* m_s = acc + q_tile * D;        // (q_tile,)
  float* l_s = m_s + q_tile;            // (q_tile,)

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int kvh = h / (n_heads / n_kv_heads);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = tile * q_tile;

  for (int i = threadIdx.x; i < q_tile * D; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < q_tile; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const size_t key_stride = (size_t)n_kv_heads * D;
  const size_t page_stride = (size_t)page * key_stride;
  const int w_end = tile_first[tile + 1];
  int base = tile_first[tile];
  // lane i's view of item base - 32 + i, and the items of that group of
  // 32 that touch this warp's rows and are not done yet
  int g_first = 0, g_hi = 0, g_slot = 0, g_kvbase = 0, g_ctx = 0;
  unsigned todo = 0;
  auto next_item = [&](Item& it) -> bool {  // in item order
    while (!todo) {
      if (base >= w_end) return false;
      const int w = base + lane;
      const int s = w < w_end ? wl_seq[w] : n_seqs;
      g_first = 0;
      g_hi = 0;
      if (s < n_seqs) {  // the sentinel item (s == n_seqs) masks every row
        const int lo = max(q_start[s], row0);
        g_hi = min(min(q_start[s] + q_len[s], row0 + q_tile), n_rows);
        g_first = lo + ((warp - (lo - row0)) % kWarps + kWarps) % kWarps;
        g_slot = wl_slot[w];
        g_kvbase = wl_kvbase[w];
        g_ctx = ctx_lens[s];
      }
      todo = __ballot_sync(kFull, g_first < g_hi);
      base += 32;
    }
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    it.first = __shfl_sync(kFull, g_first, src);
    it.hi = __shfl_sync(kFull, g_hi, src);
    it.kvbase = __shfl_sync(kFull, g_kvbase, src);
    it.ctx = __shfl_sync(kFull, g_ctx, src);
    it.page_off = (size_t)__shfl_sync(kFull, g_slot, src) * page_stride +
                  (size_t)kvh * D;
    return true;
  };

  // The warp's work is a stream of (item, chunk of the page's keys); the
  // next chunk's loads are issued before the current chunk's math.
  using P2 = typename PairOf<T>::type;
  constexpr int kC = ChunkOf<T, kP>::value;
  P2 k_cur[kC][kP], v_cur[kC][kP], k_nxt[kC][kP], v_nxt[kC][kP];
  Item cur, nxt;
  int c0 = 0;
  bool have = next_item(cur);
  if (have)
    load_chunk<T, kP, kC>(k_cur, v_cur, k_pages + cur.page_off,
                          v_pages + cur.page_off, key_stride, 0, page, D,
                          lane);
  while (have) {
    nxt = cur;
    int c1 = c0 + kC;
    bool more = true;
    if (c1 >= page) {
      c1 = 0;
      more = next_item(nxt);
    }
    if (more)
      load_chunk<T, kP, kC>(k_nxt, v_nxt, k_pages + nxt.page_off,
                            v_pages + nxt.page_off, key_stride, c1, page, D,
                            lane);
    attend_chunk<T, kP, kC>(k_cur, v_cur, q, n_heads, h, acc, m_s, l_s,
                            q_pos, row0, cur.first, cur.hi, D, page, c0,
                            cur.kvbase, cur.ctx, window, softcap, scale,
                            lane);
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) {
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        k_cur[jj][i] = k_nxt[jj][i];
        v_cur[jj][i] = v_nxt[jj][i];
      }
    }
    cur = nxt;
    c0 = c1;
    have = more;
  }

  __syncthreads();
  const int rows = min(q_tile, n_rows - row0);
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int rr = i / D;
    const int d = i - rr * D;
    out[((size_t)(row0 + rr) * n_heads + h) * D + d] =
        from_f32<T>(acc[i] / fmaxf(l_s[rr], 1e-30f));
  }
}

template <typename T, int kP>
int launch(const void* q, const void* k_pages, const void* v_pages, void* out,
           const int* q_start, const int* q_len, const int* ctx_lens,
           const int* q_pos, const int* wl_seq, const int* wl_slot,
           const int* wl_kvbase, const int* tile_first, int n_rows,
           int n_heads, int n_kv_heads, int D, int page, int n_seqs,
           int q_tile, int n_tiles, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)q_tile * D + 2 * (size_t)q_tile);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      msa_fused_kernel<T, kP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid(n_tiles, n_heads);
  msa_fused_kernel<T, kP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), q_start, q_len,
      ctx_lens, q_pos, wl_seq, wl_slot, wl_kvbase, tile_first, n_rows,
      n_heads, n_kv_heads, D, page, n_seqs, q_tile, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for_dim(const void* q, const void* k_pages, const void* v_pages,
                   void* out, const int* q_start, const int* q_len,
                   const int* ctx_lens, const int* q_pos, const int* wl_seq,
                   const int* wl_slot, const int* wl_kvbase,
                   const int* tile_first, int n_rows, int n_heads,
                   int n_kv_heads, int D, int page, int n_seqs, int q_tile,
                   int n_tiles, int window, float softcap,
                   cudaStream_t stream) {
#define MSA_LAUNCH(P)                                                        \
  return launch<T, P>(q, k_pages, v_pages, out, q_start, q_len, ctx_lens,    \
                      q_pos, wl_seq, wl_slot, wl_kvbase, tile_first, n_rows, \
                      n_heads, n_kv_heads, D, page, n_seqs, q_tile, n_tiles, \
                      window, softcap, stream)
  if (D <= 64) MSA_LAUNCH(1);
  if (D <= 128) MSA_LAUNCH(2);
  MSA_LAUNCH(4);
#undef MSA_LAUNCH
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 on success).  dtype: 0 = float32, 1 = bfloat16.  D must be even and
// at most 256.
int msa_fused_launch(const void* q, const void* k_pages, const void* v_pages,
                     void* out, const int* q_start, const int* q_len,
                     const int* ctx_lens, const int* q_pos, const int* wl_seq,
                     const int* wl_slot, const int* wl_kvbase,
                     const int* tile_first, int n_rows, int n_heads,
                     int n_kv_heads, int D, int page, int n_seqs, int q_tile,
                     int n_tiles, int window, float softcap, int dtype,
                     void* stream) {
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || n_tiles <= 0 ||
      q_tile <= 0 || page <= 0 || D <= 0 || D % 2 != 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_for_dim<float>(q, k_pages, v_pages, out, q_start, q_len,
                                 ctx_lens, q_pos, wl_seq, wl_slot, wl_kvbase,
                                 tile_first, n_rows, n_heads, n_kv_heads, D,
                                 page, n_seqs, q_tile, n_tiles, window,
                                 softcap, st);
  if (dtype == 1)
    return launch_for_dim<__nv_bfloat16>(
        q, k_pages, v_pages, out, q_start, q_len, ctx_lens, q_pos, wl_seq,
        wl_slot, wl_kvbase, tile_first, n_rows, n_heads, n_kv_heads, D, page,
        n_seqs, q_tile, n_tiles, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}

const char* msa_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
