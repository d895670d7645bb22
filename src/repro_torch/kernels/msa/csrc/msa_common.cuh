// Constants and conversions shared by the three Multi-Segment Attention
// kernels for Hopper (msa_fused.cu, msa_prefill.cu, msa_decode.cu).
//
// Layout every kernel shares: the pools are (P, page, KH, D), a key's K
// (or V) row of one kv head is D contiguous elements.  The mask and the
// arithmetic are those of the plain PyTorch version (ref.py): NEG_INF =
// -0.7 * f32max, softcap c * tanh(s / c), kv_pos <= q_pos, kv_pos < ctx,
// q_pos - kv_pos < window (window > 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// NEG_INF of the plain version: -0.7 * float32 max (finite)
constexpr float kNegInf = -0.7f * 3.402823466e38f;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace
