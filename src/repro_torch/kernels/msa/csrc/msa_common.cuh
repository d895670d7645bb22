// Constants and conversions shared by the three Multi-Segment Attention
// kernels for Hopper (msa_fused.cu, msa_prefill.cu, msa_decode.cu).
//
// Layout every kernel shares: the pools are (P, page, KH, D), a key's K
// (or V) row of one kv head is D contiguous elements.  The mask and the
// arithmetic are those of the plain PyTorch version (ref.py): NEG_INF =
// -0.7 * f32max, softcap c * tanh(s / c), kv_pos <= q_pos, kv_pos < ctx,
// q_pos - kv_pos < window (window > 0).
//
// The checked build (-DMSA_CHECK_BOUNDS; _build.py builds it apart, under
// its own library name, when MSA_CHECK_BOUNDS=1 is in the environment):
// MSA_CHECK asserts on the device that every index a kernel reads or
// writes through (a page of the pools, a row of q and out, a work-list
// entry, a work-unit or merge field, a partial plane) lies inside the
// extents the wrapper set with msa_set_extents just before the launch.  In
// the release build MSA_CHECK is nothing and the code is as it was.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#ifdef MSA_CHECK_BOUNDS
#include <assert.h>
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
// NEG_INF of the plain version: -0.7 * float32 max (finite)
constexpr float kNegInf = -0.7f * 3.402823466e38f;
constexpr size_t kMaxSmem = 227 * 1024;

#ifdef MSA_CHECK_BOUNDS
// pages: P of the pools; rows: rows of q / out (T, R x QP or B); seqs:
// context_lens entries; items: work-list entries (fused) or block-table
// columns NP (split); units / merges: work-unit and merge-run fields
// (fused); run_units: partial planes (RUN_UNITS, or the split kernels'
// max_pieces)
struct Extents {
  long long pages, rows, seqs, items, units, run_units, merges;
};
__device__ Extents g_ext;
#define MSA_CHECK(cond) assert(cond)
#else
#define MSA_CHECK(cond) ((void)0)
#endif

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace

#ifdef MSA_CHECK_BOUNDS
// Sets the extents the next launch on `stream` is checked against (an
// asynchronous copy on that stream, so it lands before the launch).
extern "C" int msa_set_extents(long long pages, long long rows,
                               long long seqs, long long items,
                               long long units, long long run_units,
                               long long merges, void* stream) {
  const Extents e{pages, rows, seqs, items, units, run_units, merges};
  cudaMemcpyToSymbolAsync(g_ext, &e, sizeof(e), 0, cudaMemcpyHostToDevice,
                          static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
#endif
