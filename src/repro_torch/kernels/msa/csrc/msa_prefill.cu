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
// a time.  Here one block owns one (q tile, chunk, kv head) and serves the
// G = H / KH query heads of the group: its (row, head) pairs belong to
// warps (pair p to warp p % kWarps), every warp walks the tile's page range
// with a chunk of the page's keys in registers and the next chunk in
// flight, and the pairs' f32 state stays in shared memory until the tile
// is written once.  The block first works out the range of pages its valid
// rows need, from the window's low edge (min valid q_pos - window + 1) to
// min(max valid q_pos, ctx - 1), both by page, and walks only that range;
// padding rows (q_pos 0) take no part in it.  A tile with no valid row
// writes exact zeros and reads no page.  The q tile is the wrapper's (8
// rows: with G = 4, two pairs a warp); the result does not depend on it,
// since a row's sequence of updates is the same in any tile.
//
// What bounds it on the H100: bytes or operations, whichever is larger at
// the shapes used.  At Llama-3.1-8B (H 32, KH 8, D 128, page 16), R 4, QP
// 128 (353 valid rows) and contexts up to 4k, the needed pages, q of the
// valid rows and o of every row are ~41 MB in bf16 (~0.0122 ms at 3.35
// TB/s) and the products ~12.2 GFLOP (~0.0123 ms on the tensor cores at
// 989 TFLOP/s, so operations bound it by a hair; ~0.18 ms in f32 at 67
// TFLOP/s outside them, clearly operations).  What this design does about
// it: each page of the range is read from device memory by the blocks of
// its kv head only (the G heads of a group share it), only pages that the
// tile's valid rows can see are read, and loads are issued a chunk ahead
// of the math.  What it does not do yet: use the tensor cores
// (wgmma) for the two products, stage pages in shared memory (TMA) so that
// the 16 warps of a block do not each fetch the page from L2, or score a
// key with fewer than one warp reduction.

#include <climits>

#include "msa_common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

template <typename T, int kP>
__global__ void __launch_bounds__(kThreads, 1) msa_prefill_kernel(
    const T* __restrict__ q,             // (R, QP, H, D)
    const T* __restrict__ k_pages,       // (P, page, KH, D)
    const T* __restrict__ v_pages,       // (P, page, KH, D)
    T* __restrict__ out,                 // (R, QP, H, D)
    const int* __restrict__ block_tables,  // (R, NP)
    const int* __restrict__ ctx_lens,    // (R,)
    const int* __restrict__ q_pos,       // (R, QP)
    const int* __restrict__ q_lens,      // (R,)
    int QP, int n_heads, int n_kv_heads, int D, int page, int NP,
    int q_tile, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  __shared__ int s_first, s_last;
  const int G = n_heads / n_kv_heads;
  const int n_pairs = q_tile * G;       // pair p = (tile row p / G, head g)
  float* acc = smem;                    // (n_pairs, D)
  float* m_s = acc + (size_t)n_pairs * D;  // (n_pairs,)
  float* l_s = m_s + n_pairs;           // (n_pairs,)

  const int tile = blockIdx.x;
  const int r = blockIdx.y;
  const int kvh = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = tile * q_tile;
  const int rows = min(q_tile, QP - row0);
  // valid rows of the tile: row0 .. row0 + n_valid - 1
  const int n_valid = max(0, min(q_lens[r] - row0, rows));
  const int ctx = ctx_lens[r];
  const int* qp_row = q_pos + (size_t)r * QP;

  for (int i = threadIdx.x; i < n_pairs * D; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < n_pairs; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  if (warp == 0) {
    // the page range the valid rows need; padding rows do not count
    int hi = -1, lo = INT_MAX;
    for (int i = lane; i < n_valid; i += 32) {
      const int p = qp_row[row0 + i];
      hi = max(hi, p);
      lo = min(lo, p);
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

  const int n_work = n_valid * G;
  if (warp < n_work) {
    const size_t key_stride = (size_t)n_kv_heads * D;
    using P2 = typename PairOf<T>::type;
    constexpr int kC = ChunkOf<T, kP>::value;
    stream_pages<T, kP, kC>(
        k_pages, v_pages, block_tables + (size_t)r * NP, s_first, s_last, 1,
        (size_t)page * key_stride, key_stride, (size_t)kvh * D, page, D, lane,
        [&](const P2 (&kk)[kC][kP], const P2 (&vv)[kC][kP], int kvbase,
            int c0) {
          for (int p = warp; p < n_work; p += kWarps) {
            const int rr = p / G;
            const int h = kvh * G + (p - rr * G);
            const int row = row0 + rr;
            attend_row<T, kP, kC>(
                kk, vv, q + (((size_t)r * QP + row) * n_heads + h) * D,
                qp_row[row], acc + (size_t)p * D, m_s + p, l_s + p, D, page,
                c0, kvbase, ctx, window, softcap, scale, lane);
          }
        });
  }

  __syncthreads();
  // every row of the tile; rows no warp attended (padding) hold acc 0,
  // l 0 and come out as exact zeros
  for (int i = threadIdx.x; i < rows * G * D; i += kThreads) {
    const int p = i / D;
    const int d = i - p * D;
    const int rr = p / G;
    const int h = kvh * G + (p - rr * G);
    out[(((size_t)r * QP + row0 + rr) * n_heads + h) * D + d] =
        from_f32<T>(acc[i] / fmaxf(l_s[p], 1e-30f));
  }
}

template <typename T, int kP>
int launch(const void* q, const void* k_pages, const void* v_pages, void* out,
           const int* block_tables, const int* ctx_lens, const int* q_pos,
           const int* q_lens, int R, int QP, int n_heads, int n_kv_heads,
           int D, int page, int NP, int q_tile, int window, float softcap,
           cudaStream_t stream) {
  const size_t pairs = (size_t)q_tile * (n_heads / n_kv_heads);
  const size_t smem = sizeof(float) * (pairs * D + 2 * pairs);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      msa_prefill_kernel<T, kP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((QP + q_tile - 1) / q_tile, R, n_kv_heads);
  msa_prefill_kernel<T, kP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), block_tables,
      ctx_lens, q_pos, q_lens, QP, n_heads, n_kv_heads, D, page, NP, q_tile,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for_dim(const void* q, const void* k_pages, const void* v_pages,
                   void* out, const int* block_tables, const int* ctx_lens,
                   const int* q_pos, const int* q_lens, int R, int QP,
                   int n_heads, int n_kv_heads, int D, int page, int NP,
                   int q_tile, int window, float softcap,
                   cudaStream_t stream) {
#define MSA_LAUNCH(P)                                                        \
  return launch<T, P>(q, k_pages, v_pages, out, block_tables, ctx_lens,      \
                      q_pos, q_lens, R, QP, n_heads, n_kv_heads, D, page,    \
                      NP, q_tile, window, softcap, stream)
  if (D <= 64) MSA_LAUNCH(1);
  if (D <= 128) MSA_LAUNCH(2);
  MSA_LAUNCH(4);
#undef MSA_LAUNCH
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 on success).  dtype: 0 = float32, 1 = bfloat16.  D must be even and
// at most 256; R, QP and KH at least 1; R and KH at most 65535.
int msa_prefill_launch(const void* q, const void* k_pages,
                       const void* v_pages, void* out,
                       const int* block_tables, const int* ctx_lens,
                       const int* q_pos, const int* q_lens, int R, int QP,
                       int n_heads, int n_kv_heads, int D, int page, int NP,
                       int q_tile, int window, float softcap, int dtype,
                       void* stream) {
  if (n_kv_heads <= 0 || n_kv_heads > 65535 || n_heads % n_kv_heads != 0 ||
      R <= 0 || R > 65535 || QP <= 0 || q_tile <= 0 || page <= 0 ||
      NP < 0 || D <= 0 || D % 2 != 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_for_dim<float>(q, k_pages, v_pages, out, block_tables,
                                 ctx_lens, q_pos, q_lens, R, QP, n_heads,
                                 n_kv_heads, D, page, NP, q_tile, window,
                                 softcap, st);
  if (dtype == 1)
    return launch_for_dim<__nv_bfloat16>(
        q, k_pages, v_pages, out, block_tables, ctx_lens, q_pos, q_lens, R,
        QP, n_heads, n_kv_heads, D, page, NP, q_tile, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}

const char* msa_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
