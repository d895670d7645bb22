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
// loads, and ran the page axis in order with acc/m/l in VMEM.  Here one
// block owns one (sequence, kv head) and serves the G heads of the group,
// so each page is read once per group (4 heads a page at Llama-3.1-8B).
// The block walks only the pages in [ctx - window, ctx), by page, and
// never the rest of its NP-wide block table; a padding row of the serving
// engine (ctx 1, slot 0) costs one page.  The pages of that range are
// dealt to the block's warps in turn (page j to warp j % kWarps); each
// warp keeps its own f32 m, l and accumulator for the G heads, with a
// chunk of the page's keys in registers and the next chunk in flight, and
// the warps' partial states are merged once at the end (a log-sum-exp
// merge in shared memory).
//
// What bounds it on the H100: bytes.  Each needed K/V page is read once
// per kv head (16 keys x 128 dims x 2 bytes = 4 KB each of K and V at
// Llama-3.1-8B in bf16) and the block does ~2 flops per byte read for each
// of the G heads, far below the ~295 flop/byte at which the tensor cores
// would be the limit.  What this design does about it: only the pages in
// the row's window are read, each once for the whole GQA group, and kWarps
// pages are in flight per block so a long context is streamed by all of
// its block's warps at once.  What it does not do yet: split one long
// context over several blocks (B x KH blocks fill the card only at large
// batch), or stage pages in shared memory with TMA.

#include "msa_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <typename T, int kP>
__global__ void __launch_bounds__(kThreads, 2) msa_decode_kernel(
    const T* __restrict__ q,             // (B, H, D)
    const T* __restrict__ k_pages,       // (P, page, KH, D)
    const T* __restrict__ v_pages,       // (P, page, KH, D)
    T* __restrict__ out,                 // (B, H, D)
    const int* __restrict__ block_tables,  // (B, NP)
    const int* __restrict__ ctx_lens,    // (B,)
    int n_heads, int n_kv_heads, int D, int page, int NP, int window,
    float softcap, float scale) {
  extern __shared__ float smem[];
  const int G = n_heads / n_kv_heads;
  float* acc = smem;                          // (kWarps, G, D)
  float* m_s = acc + (size_t)kWarps * G * D;  // (kWarps, G)
  float* l_s = m_s + kWarps * G;              // (kWarps, G)

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kWarps * G * D; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < kWarps * G; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int ctx = ctx_lens[b];
  const int qp = ctx - 1;
  const int last = min(qp, NP * page - 1);
  const int first = window > 0 ? max(ctx - window, 0) : 0;
  const int j_last = last >= first ? last / page : -1;
  const size_t key_stride = (size_t)n_kv_heads * D;
  const T* q_grp = q + ((size_t)b * n_heads + (size_t)kvh * G) * D;
  float* w_acc = acc + (size_t)warp * G * D;
  float* w_m = m_s + warp * G;
  float* w_l = l_s + warp * G;
  using P2 = typename PairOf<T>::type;
  constexpr int kC = ChunkOf<T, kP>::value;
  stream_pages<T, kP, kC>(
      k_pages, v_pages, block_tables + (size_t)b * NP, first / page + warp,
      j_last, kWarps, (size_t)page * key_stride, key_stride, (size_t)kvh * D,
      page, D, lane,
      [&](const P2 (&kk)[kC][kP], const P2 (&vv)[kC][kP], int kvbase,
          int c0) {
        for (int g = 0; g < G; ++g)
          attend_row<T, kP, kC>(kk, vv, q_grp + (size_t)g * D, qp,
                                w_acc + (size_t)g * D, w_m + g, w_l + g, D,
                                page, c0, kvbase, ctx, window, softcap, scale,
                                lane);
      });

  __syncthreads();
  // merge the warps' partial states: out = sum_w e^(m_w - M) acc_w /
  // sum_w e^(m_w - M) l_w with M = max_w m_w (a warp that saw no key has
  // m_w = NEG_INF, l_w = 0 and weighs nothing)
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_s[w * G + g]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float s = expf(m_s[w * G + g] - m);
      l += s * l_s[w * G + g];
      a += s * acc[(size_t)w * G * D + i];
    }
    out[((size_t)b * n_heads + (size_t)kvh * G) * D + i] =
        from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int kP>
int launch(const void* q, const void* k_pages, const void* v_pages, void* out,
           const int* block_tables, const int* ctx_lens, int B, int n_heads,
           int n_kv_heads, int D, int page, int NP, int window, float softcap,
           cudaStream_t stream) {
  const size_t slots = (size_t)kWarps * (n_heads / n_kv_heads);
  const size_t smem = sizeof(float) * (slots * D + 2 * slots);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      msa_decode_kernel<T, kP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid(B, n_kv_heads);
  msa_decode_kernel<T, kP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), block_tables,
      ctx_lens, n_heads, n_kv_heads, D, page, NP, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for_dim(const void* q, const void* k_pages, const void* v_pages,
                   void* out, const int* block_tables, const int* ctx_lens,
                   int B, int n_heads, int n_kv_heads, int D, int page,
                   int NP, int window, float softcap, cudaStream_t stream) {
#define MSA_LAUNCH(P)                                                      \
  return launch<T, P>(q, k_pages, v_pages, out, block_tables, ctx_lens, B, \
                      n_heads, n_kv_heads, D, page, NP, window, softcap,   \
                      stream)
  if (D <= 64) MSA_LAUNCH(1);
  if (D <= 128) MSA_LAUNCH(2);
  MSA_LAUNCH(4);
#undef MSA_LAUNCH
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 on success).  dtype: 0 = float32, 1 = bfloat16.  D must be even and
// at most 256; B and KH at least 1, KH at most 65535.
int msa_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                      void* out, const int* block_tables,
                      const int* ctx_lens, int B, int n_heads, int n_kv_heads,
                      int D, int page, int NP, int window, float softcap,
                      int dtype, void* stream) {
  if (n_kv_heads <= 0 || n_kv_heads > 65535 || n_heads % n_kv_heads != 0 ||
      B <= 0 || page <= 0 || NP < 0 || D <= 0 || D % 2 != 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_for_dim<float>(q, k_pages, v_pages, out, block_tables,
                                 ctx_lens, B, n_heads, n_kv_heads, D, page,
                                 NP, window, softcap, st);
  if (dtype == 1)
    return launch_for_dim<__nv_bfloat16>(q, k_pages, v_pages, out,
                                         block_tables, ctx_lens, B, n_heads,
                                         n_kv_heads, D, page, NP, window,
                                         softcap, st);
  return (int)cudaErrorInvalidValue;
}

const char* msa_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
