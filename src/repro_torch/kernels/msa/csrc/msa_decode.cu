// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.msa.msa_decode._decode_kernel
// (src/repro/kernels/msa/msa_decode.py:26, launched by msa_decode_pallas).
// It computes the same function: q (B, H, D) holds one new token per
// sequence, at logical position ctx[b] - 1; it attends through the row's
// block table (B, NP) to the paged K/V of its sequence with the mask
//   kv_pos < ctx[b], ctx[b] - 1 - kv_pos < window (window > 0),
// softmax(q.k / sqrt(D) [softcapped]) . v with f32 online softmax, GQA head
// h reading kv head h / (H / KH), output acc / max(l, 1e-30) in the input
// type.  A row with ctx <= 0 comes out as exact zeros.
//
// Work decomposition.  The Pallas grid (B, KH, NP) gave each kv head a
// (G, D) q tile, so the G = H / KH heads of a group share every page it
// loads, and ran the page axis in order with acc/m/l in VMEM.  Here a
// row's range is the pages of [ctx - window, ctx) (all of [0, ctx) without
// a window), never the rest of its NP-wide block table, so a padding row
// of the serving engine (ctx 1, slot 0) costs one page.  The range is cut
// into pieces of about piece_pages pages (at most max_pieces, from NP
// alone), and a block of the grid is one (row, kv head, piece): the work
// item of msa_split.cuh with the group's G heads as its M rows, whose
// pages come into shared memory once for the whole group through the
// cp.async ring.  With G <= 16 live M rows the four warps each take 8 of
// every stage's 32 keys and merge their states at the end.  The pieces of
// a cut range write f32 partials that the merge kernel of the same call
// combines in piece order.
//
// What bounds it on the H100: bytes.  Each needed K/V page is read once
// per kv head (16 keys x 128 dims x 2 bytes = 4 KB each of K and V at
// Llama-3.1-8B in bf16) and the block does ~2 flops per byte read for each
// of the G heads, far below the ~295 flop/byte at which the tensor cores
// would be the limit.  The products still run on the tensor cores (G of
// the 16 rows of an mma.sync tile live): the same code as the prefill
// kernel's items, and a score costs one tile row instead of a warp
// reduction; the cores are idle either way.  What this design does about
// the bytes: only the pages in the row's window are read, each once for
// the whole GQA group, copies run two stages ahead of the math, and a long
// context is spread over several blocks, so the card is full at small
// batch.  What it does not do yet: TMA, or several rows of one sequence.

#include "msa_split.cuh"

namespace {

template <typename T, int kDP>
__global__ void __launch_bounds__(kThreadsF, kBlocksPerSm<T, kDP>)
msa_decode_kernel(
    const T* __restrict__ q,               // (B, H, D)
    const T* __restrict__ k_pages,         // (P, page, KH, D)
    const T* __restrict__ v_pages,         // (P, page, KH, D)
    T* __restrict__ out,                   // (B, H, D)
    float* __restrict__ part_o,            // (max_pieces, B, H, D)
    float* __restrict__ part_ml,           // (max_pieces, B, H, 2)
    int* __restrict__ row_pieces,          // (B,)
    const int* __restrict__ block_tables,  // (B, NP)
    const int* __restrict__ ctx_lens,      // (B,)
    int B, int n_heads, int n_kv_heads, int D, int page, int NP,
    int piece_pages, int max_pieces, int window, float softcap, float scale,
    bool wide) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pc = blockIdx.x % max_pieces;  // piece fastest, then kv head
  const int kvh = (blockIdx.x / max_pieces) % n_kv_heads;
  const int b = blockIdx.x / max_pieces / n_kv_heads;
  const int G = n_heads / n_kv_heads;
  const int head0 = kvh * G;
  MSA_CHECK(b < g_ext.seqs && b < g_ext.rows);
  const int ctx = ctx_lens[b];
  const int last = min(ctx - 1, NP * page - 1);
  const int first = window > 0 ? max(ctx - window, 0) : 0;
  const int j0 = first / page;
  const int n_pages = last >= first ? last / page - j0 + 1 : 0;
  const int pieces = piece_count(n_pages, piece_pages, max_pieces);
  T* out_row = out + (size_t)b * n_heads * D;
  if (pc == 0) {
    if (kvh == 0 && threadIdx.x == 0) row_pieces[b] = pieces;
    if (pieces == 0) zero_rows<T>(out_row, 1, G, head0, n_heads, D);
  }
  if (pc >= pieces) return;
  const int a = j0 + pc * n_pages / pieces;
  const int e = j0 + (pc + 1) * n_pages / pieces - 1;
  const bool cut = pieces > 1;
  const size_t plane = (size_t)pc * B + b;
  paged_item<T, kDP>(smem, q + (size_t)b * n_heads * D, k_pages, v_pages,
                     block_tables + (size_t)b * NP, nullptr, ctx - 1, 1, G,
                     head0, n_heads, n_kv_heads, kvh, D, page, a, e, ctx,
                     window, softcap, scale, wide, out_row,
                     cut ? part_o + plane * n_heads * D : nullptr,
                     cut ? part_ml + plane * n_heads * 2 : nullptr);
}

// The rows whose range was cut: one block per 256 output pairs of a row,
// in piece order (merge_pair).
template <typename T>
__global__ void __launch_bounds__(256) msa_decode_merge_kernel(
    T* __restrict__ out, const float* __restrict__ part_o,
    const float* __restrict__ part_ml, const int* __restrict__ row_pieces,
    int B, int n_heads, int D) {
  const int pairs = n_heads * (D / 2);  // output pairs of a row
  const int chunks = (pairs + 255) / 256;
  const int b = blockIdx.x / chunks;
  const int i = (blockIdx.x % chunks) * 256 + threadIdx.x;
  if (i >= pairs) return;
  MSA_CHECK(b < g_ext.rows);
  const int n = row_pieces[b];
  if (n <= 1) return;
  merge_pair<T>(out, part_o, part_ml, (size_t)B * n_heads,
                (size_t)b * n_heads + i / (D / 2), 2 * (i % (D / 2)), D, n);
}

template <typename T, int kDP>
int launch(const void* q, const void* k_pages, const void* v_pages, void* out,
           float* part_o, float* part_ml, int* row_pieces,
           const int* block_tables, const int* ctx_lens, int B, int n_heads,
           int n_kv_heads, int D, int page, int NP, int piece_pages,
           int max_pieces, int window, float softcap, cudaStream_t stream) {
  using L = Tile<T, kDP>;
  static_assert(L::kSmem <= kMaxSmem, "shared memory");
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        msa_decode_kernel<T, kDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const long long blocks = (long long)B * n_kv_heads * max_pieces;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  // 16-byte copies need 16-byte aligned rows
  const bool wide = (D * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  const float scale = (float)(1.0 / sqrt((double)D));
  msa_decode_kernel<T, kDP><<<(unsigned)blocks, kThreadsF, L::kSmem,
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), part_o, part_ml,
      row_pieces, block_tables, ctx_lens, B, n_heads, n_kv_heads, D, page,
      NP, piece_pages, max_pieces, window, softcap, scale, wide);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || max_pieces == 1) return (int)err;
  const long long chunks = (n_heads * (D / 2) + 255) / 256;
  if ((long long)B * chunks > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  msa_decode_merge_kernel<T><<<(unsigned)(B * chunks), 256, 0, stream>>>(
      static_cast<T*>(out), part_o, part_ml, row_pieces, B, n_heads, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for_dim(const void* q, const void* k_pages, const void* v_pages,
                   void* out, float* part_o, float* part_ml, int* row_pieces,
                   const int* block_tables, const int* ctx_lens, int B,
                   int n_heads, int n_kv_heads, int D, int page, int NP,
                   int piece_pages, int max_pieces, int window, float softcap,
                   cudaStream_t stream) {
#define MSA_LAUNCH(DP)                                                      \
  return launch<T, DP>(q, k_pages, v_pages, out, part_o, part_ml,           \
                       row_pieces, block_tables, ctx_lens, B, n_heads,      \
                       n_kv_heads, D, page, NP, piece_pages, max_pieces,    \
                       window, softcap, stream)
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
// most 256, H / KH at most 64.  part_o / part_ml are f32 scratch of
// (max_pieces, B, H, D) and (max_pieces, B, H, 2) (unused when max_pieces
// is 1), row_pieces int32 scratch of (B,).
int msa_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                      void* out, void* part_o, void* part_ml,
                      void* row_pieces, const int* block_tables,
                      const int* ctx_lens, int B, int n_heads, int n_kv_heads,
                      int D, int page, int NP, int piece_pages,
                      int max_pieces, int window, float softcap, int dtype,
                      void* stream) {
  if (n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
      n_heads / n_kv_heads > kMRows || B <= 0 || page <= 0 ||
      NP < 0 || D <= 0 || D % 2 != 0 || D > 256 || piece_pages <= 0 ||
      max_pieces <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  int* rp = static_cast<int*>(row_pieces);
  if (dtype == 0)
    return launch_for_dim<float>(q, k_pages, v_pages, out, po, pml, rp,
                                 block_tables, ctx_lens, B, n_heads,
                                 n_kv_heads, D, page, NP, piece_pages,
                                 max_pieces, window, softcap, st);
  if (dtype == 1)
    return launch_for_dim<__nv_bfloat16>(
        q, k_pages, v_pages, out, po, pml, rp, block_tables, ctx_lens, B,
        n_heads, n_kv_heads, D, page, NP, piece_pages, max_pieces, window,
        softcap, st);
  return (int)cudaErrorInvalidValue;
}

const char* msa_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
