// Padded multi-segment prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.msa.msa_prefill._msa_prefill_kernel
// (src/repro/kernels/msa/msa_prefill.py:36, launched by msa_prefill_pallas).
// It computes the same function: q (R, QP, H, D) holds R prefill chunks of
// up to QP rows; row i of chunk r attends, through the chunk's block table
// (R, NP), to the paged K/V of its own sequence with the mask
//   i < q_lens[r], kv_pos <= q_pos[r, i], kv_pos < ctx[r],
//   q_pos - kv_pos < window (window > 0),
// softmax(q.k / sqrt(D) [softcapped]) . v with f32 online softmax, GQA head
// h reading kv head h / (H / KH), output acc / max(l, 1e-30) in the input
// type, and exact zeros on every row at or past q_lens (padding).  The
// chunks are multi-segment: their q_pos have gaps wherever an evicted
// history is recomputed, and the causal mask on q_pos is what makes that
// right.
//
// Work decomposition.  The Pallas grid (R, H, QP / TQ, NP) ran the page axis
// in order with acc/m/l in VMEM and skipped unneeded pages one grid step at
// a time.  Here a chunk is cut into q tiles of q_tile rows (the wrapper's
// 64 / G, so a tile's rows x the G heads of a GQA group fill the 64 M rows
// of a work item), and each tile's block first works out the range of
// pages its valid rows need, from the window's low edge (min valid q_pos -
// window + 1) to min(max valid q_pos, ctx - 1), both by page; padding rows
// (q_pos 0) take no part in it.  A block of the grid is one (chunk, q
// tile, kv head, piece of that range): the work item of msa_split.cuh,
// which stages the piece's pages once in shared memory for the whole group
// and runs both products on the tensor cores.  A tile with no valid row
// reads no page and writes exact zeros; its padding rows are written as
// exact zeros by the blocks of piece 0.  A range longer than piece_pages
// pages is cut into pieces (at most max_pieces, from NP alone) whose f32
// partials the merge kernel of the same call combines in piece order.
//
// What bounds it on the H100: bytes or operations, whichever is larger at
// the shapes used.  At Llama-3.1-8B (H 32, KH 8, D 128, page 16), R 4, QP
// 128 (353 valid rows) and contexts up to 4k, the needed pages, q of the
// valid rows and o of every row are ~41 MB in bf16 (~0.0122 ms at 3.35
// TB/s) and the products ~12.2 GFLOP (~0.0123 ms on the tensor cores at
// 989 TFLOP/s, so operations bound it by a hair; ~0.18 ms in f32 at 67
// TFLOP/s outside them, clearly operations).  What this design does about
// it: the products run on the tensor cores (mma.sync; P as hi + lo bf16
// costs a third more tensor work than the bound counts), each page of a
// tile's range comes into shared memory once per GQA group through
// cp.async, only pages the valid rows can see are read, and long ranges
// are spread over several blocks.  What it does not do yet: TMA, wgmma or
// warp specialisation; the partials of cut ranges go through device
// memory (L2 at these sizes).

#include "msa_split.cuh"

namespace {

template <typename T, int kDP>
__global__ void __launch_bounds__(kThreadsF, kBlocksPerSm<T, kDP>)
msa_prefill_kernel(
    const T* __restrict__ q,               // (R, QP, H, D)
    const T* __restrict__ k_pages,         // (P, page, KH, D)
    const T* __restrict__ v_pages,         // (P, page, KH, D)
    T* __restrict__ out,                   // (R, QP, H, D)
    float* __restrict__ part_o,            // (max_pieces, R, QP, H, D)
    float* __restrict__ part_ml,           // (max_pieces, R, QP, H, 2)
    int* __restrict__ tile_pieces,         // (R, tiles)
    const int* __restrict__ block_tables,  // (R, NP)
    const int* __restrict__ ctx_lens,      // (R,)
    const int* __restrict__ q_pos,         // (R, QP)
    const int* __restrict__ q_lens,        // (R,)
    int R, int QP, int n_heads, int n_kv_heads, int D, int page, int NP,
    int q_tile, int piece_pages, int max_pieces, int window,
    float softcap, float scale, bool wide) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_first, s_last;
  const int tiles = (QP + q_tile - 1) / q_tile;
  int wi = blockIdx.x;  // piece fastest, then kv head, tile, chunk
  const int pc = wi % max_pieces;
  wi /= max_pieces;
  const int kvh = wi % n_kv_heads;
  wi /= n_kv_heads;
  const int t = wi % tiles;
  const int r = wi / tiles;
  const int G = n_heads / n_kv_heads;
  const int head0 = kvh * G;
  const int row0 = t * q_tile;
  const int rows = min(q_tile, QP - row0);
  const int n_valid = max(0, min(q_lens[r] - row0, rows));
  const int ctx = ctx_lens[r];
  MSA_CHECK(r < g_ext.seqs && (long long)r * QP + row0 + rows <= g_ext.rows);
  const int* qp_row = q_pos + (size_t)r * QP + row0;

  if (threadIdx.x < 32) {
    // the page range the valid rows need; padding rows do not count
    const int lane = threadIdx.x;
    int hi = -1, lo = INT_MAX;
    for (int i = lane; i < n_valid; i += 32) {
      hi = max(hi, qp_row[i]);
      lo = min(lo, qp_row[i]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      hi = max(hi, __shfl_xor_sync(kFull, hi, o));
      lo = min(lo, __shfl_xor_sync(kFull, lo, o));
    }
    if (lane == 0) {
      const int last = min(min(hi, ctx - 1), NP * page - 1);
      const int first = window > 0 ? max(lo - window + 1, 0) : 0;
      s_first = first / page;
      s_last = (n_valid > 0 && last >= first) ? last / page : -1;
    }
  }
  __syncthreads();
  const int j0 = s_first;
  const int n_pages = max(0, s_last - j0 + 1);
  const int pieces = piece_count(n_pages, piece_pages, max_pieces);
  const size_t row_base = (size_t)r * QP + row0;
  T* out_tile = out + row_base * n_heads * D;
  if (pc == 0) {
    if (kvh == 0 && threadIdx.x == 0)
      tile_pieces[(size_t)r * tiles + t] = pieces;
    // rows no work item writes: the tile's padding rows, or all its rows
    // when it reads no page
    const int z0 = pieces == 0 ? 0 : n_valid;
    zero_rows<T>(out_tile + (size_t)z0 * n_heads * D, rows - z0, G, head0,
                 n_heads, D);
  }
  if (pc >= pieces) return;
  const int a = j0 + pc * n_pages / pieces;
  const int b = j0 + (pc + 1) * n_pages / pieces - 1;
  const bool cut = pieces > 1;
  const size_t plane = (size_t)pc * R * QP + row_base;
  paged_item<T, kDP>(
      smem, q + row_base * n_heads * D, k_pages, v_pages,
      block_tables + (size_t)r * NP, qp_row, 0, n_valid, G, head0,
      n_heads, n_kv_heads, kvh, D, page, a, b, ctx, window, softcap, scale,
      wide, out_tile, cut ? part_o + plane * n_heads * D : nullptr,
      cut ? part_ml + plane * n_heads * 2 : nullptr);
}

// The tiles whose range was cut: one block per 256 output pairs of a valid
// row, in piece order (merge_pair).
template <typename T>
__global__ void __launch_bounds__(256) msa_prefill_merge_kernel(
    T* __restrict__ out, const float* __restrict__ part_o,
    const float* __restrict__ part_ml, const int* __restrict__ tile_pieces,
    const int* __restrict__ q_lens, int R, int QP, int n_heads, int D,
    int q_tile) {
  const int pairs = n_heads * (D / 2);  // output pairs of a row
  const int chunks = (pairs + 255) / 256;
  const int row = blockIdx.x / chunks;
  const int i = (blockIdx.x % chunks) * 256 + threadIdx.x;
  const int r = row / QP, ri = row % QP;
  if (i >= pairs || ri >= q_lens[r]) return;
  const int tiles = (QP + q_tile - 1) / q_tile;
  MSA_CHECK(row < g_ext.rows);
  const int n = tile_pieces[(size_t)r * tiles + ri / q_tile];
  if (n <= 1) return;
  merge_pair<T>(out, part_o, part_ml, (size_t)R * QP * n_heads,
                (size_t)row * n_heads + i / (D / 2), 2 * (i % (D / 2)), D,
                n);
}

template <typename T, int kDP>
int launch(const void* q, const void* k_pages, const void* v_pages, void* out,
           float* part_o, float* part_ml, int* tile_pieces,
           const int* block_tables, const int* ctx_lens, const int* q_pos,
           const int* q_lens, int R, int QP, int n_heads, int n_kv_heads,
           int D, int page, int NP, int q_tile, int piece_pages,
           int max_pieces, int window, float softcap, cudaStream_t stream) {
  using L = Tile<T, kDP>;
  static_assert(L::kSmem <= kMaxSmem, "shared memory");
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        msa_prefill_kernel<T, kDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const long long tiles = (QP + q_tile - 1) / q_tile;
  const long long blocks = (long long)R * tiles * n_kv_heads * max_pieces;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  // 16-byte copies need 16-byte aligned rows
  const bool wide = (D * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  const float scale = (float)(1.0 / sqrt((double)D));
  msa_prefill_kernel<T, kDP><<<(unsigned)blocks, kThreadsF, L::kSmem,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), part_o, part_ml,
      tile_pieces, block_tables, ctx_lens, q_pos, q_lens, R, QP, n_heads,
      n_kv_heads, D, page, NP, q_tile, piece_pages, max_pieces,
      window, softcap, scale, wide);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || max_pieces == 1) return (int)err;
  const long long chunks = (n_heads * (D / 2) + 255) / 256;
  const long long merge_blocks = (long long)R * QP * chunks;
  if (merge_blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  msa_prefill_merge_kernel<T><<<(unsigned)merge_blocks, 256, 0, stream>>>(
      static_cast<T*>(out), part_o, part_ml, tile_pieces, q_lens, R, QP,
      n_heads, D, q_tile);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for_dim(const void* q, const void* k_pages, const void* v_pages,
                   void* out, float* part_o, float* part_ml, int* tile_pieces,
                   const int* block_tables, const int* ctx_lens,
                   const int* q_pos, const int* q_lens, int R, int QP,
                   int n_heads, int n_kv_heads, int D, int page, int NP,
                   int q_tile, int piece_pages, int max_pieces, int window,
                   float softcap, cudaStream_t stream) {
#define MSA_LAUNCH(DP)                                                       \
  return launch<T, DP>(q, k_pages, v_pages, out, part_o, part_ml,            \
                       tile_pieces, block_tables, ctx_lens, q_pos, q_lens, R, \
                       QP, n_heads, n_kv_heads, D, page, NP, q_tile,          \
                       piece_pages, max_pieces, window, softcap, stream)
  if (D <= 32) MSA_LAUNCH(32);
  if (D <= 64) MSA_LAUNCH(64);
  if (D <= 128) MSA_LAUNCH(128);
  MSA_LAUNCH(256);
#undef MSA_LAUNCH
}

}  // namespace

extern "C" {

// Launches the kernel and, when ranges can be cut (max_pieces > 1), the
// merge on `stream` without synchronising; returns cudaGetLastError() (0
// on success).  dtype: 0 = float32, 1 = bfloat16.  D must be even and at
// most 256; q_tile x G at most 64 M rows.  part_o /
// part_ml are f32 scratch of (max_pieces, R, QP, H, D) and (max_pieces, R,
// QP, H, 2) (unused when max_pieces is 1), tile_pieces int32 scratch of
// (R, ceil(QP / q_tile)).
int msa_prefill_launch(const void* q, const void* k_pages,
                       const void* v_pages, void* out, void* part_o,
                       void* part_ml, void* tile_pieces,
                       const int* block_tables, const int* ctx_lens,
                       const int* q_pos, const int* q_lens, int R, int QP,
                       int n_heads, int n_kv_heads, int D, int page, int NP,
                       int q_tile, int piece_pages, int max_pieces,
                       int window, float softcap, int dtype, void* stream) {
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 || R <= 0 || QP <= 0 ||
      q_tile <= 0 || q_tile * (n_heads / n_kv_heads) > kMRows ||
      page <= 0 || NP < 0 || D <= 0 || D % 2 != 0 || D > 256 ||
      piece_pages <= 0 || max_pieces <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  int* tp = static_cast<int*>(tile_pieces);
  if (dtype == 0)
    return launch_for_dim<float>(q, k_pages, v_pages, out, po, pml, tp,
                                 block_tables, ctx_lens, q_pos, q_lens, R, QP,
                                 n_heads, n_kv_heads, D, page, NP, q_tile,
                                 piece_pages, max_pieces, window, softcap,
                                 st);
  if (dtype == 1)
    return launch_for_dim<__nv_bfloat16>(
        q, k_pages, v_pages, out, po, pml, tp, block_tables, ctx_lens, q_pos,
        q_lens, R, QP, n_heads, n_kv_heads, D, page, NP, q_tile, piece_pages,
        max_pieces, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}

const char* msa_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
