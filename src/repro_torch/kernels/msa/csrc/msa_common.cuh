// Device code shared by the three Multi-Segment Attention kernels for
// Hopper (msa_fused.cu, msa_prefill.cu, msa_decode.cu): loading a chunk of
// a KV page's keys into registers, and the f32 online-softmax update of
// one q row against such a chunk.
//
// Layout every kernel shares: the pools are (P, page, KH, D), a key's K
// (or V) row of one kv head is D contiguous elements, and lane l of a warp
// holds dims {2l, 2l+1} (+64 i) of a q row, of a K/V row and of the row's
// accumulator, so that each key's K and V rows are read as whole coalesced
// rows and a score is one warp reduction.  q.k runs in full float32 with
// plain FMAs (never TF32).  The mask and the arithmetic are those of the
// plain PyTorch version (ref.py): NEG_INF = -0.7 * f32max, softcap
// c * tanh(s / c), kv_pos <= q_pos, kv_pos < ctx, q_pos - kv_pos < window
// (window > 0).
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

// A lane reads K, V and q as pairs of neighbouring dims.
template <typename T>
struct PairOf;
template <>
struct PairOf<float> {
  using type = float2;
};
template <>
struct PairOf<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  return to_float2(*reinterpret_cast<const typename PairOf<T>::type*>(p));
}

// Keys of a page per register chunk: K and V of a chunk take 32 32-bit
// registers a lane, whatever the dtype and head dim, so that the chunk in
// use and the next one in flight fit without spilling.
template <typename T, int kP>
struct ChunkOf {
  static constexpr int value = 32 / (2 * kP * (int)(sizeof(T) / 2));
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same bits
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The K and V rows of keys c0 .. c0 + kC - 1 of one page (the lane's
// dims), loads issued and not waited for.
template <typename T, int kP, int kC>
__device__ __forceinline__ void load_chunk(
    typename PairOf<T>::type (&kk)[kC][kP],
    typename PairOf<T>::type (&vv)[kC][kP], const T* __restrict__ kp,
    const T* __restrict__ vp, size_t key_stride, int c0, int page, int D,
    int lane) {
  using P2 = typename PairOf<T>::type;
#pragma unroll
  for (int jj = 0; jj < kC; ++jj) {
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int e = 2 * lane + 64 * i;
      if (c0 + jj < page && e < D) {
        const size_t off = (size_t)(c0 + jj) * key_stride + e;
        kk[jj][i] = *reinterpret_cast<const P2*>(kp + off);
        vv[jj][i] = *reinterpret_cast<const P2*>(vp + off);
      }
    }
  }
}

// One q row (logical position qp) against one chunk of keys of a page (kv
// positions kvbase + c0 + jj): an online-softmax update of the row's m and
// l (*m_p, *l_p, one value each, shared by the warp) and of the lane's
// dims of its f32 accumulator arow.  A chunk with no key visible to the
// row leaves the state untouched.  kP = pairs of dims a lane holds.
template <typename T, int kP, int kC>
__device__ __forceinline__ void attend_row(
    const typename PairOf<T>::type (&kk)[kC][kP],
    const typename PairOf<T>::type (&vv)[kC][kP], const T* __restrict__ qrow,
    int qp, float* __restrict__ arow, float* __restrict__ m_p,
    float* __restrict__ l_p, int D, int page, int c0, int kvbase, int ctx,
    int window, float softcap, float scale, int lane) {
  float2 qv[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int e = 2 * lane + 64 * i;
    qv[i] = make_float2(0.f, 0.f);
    if (e < D) {
      qv[i] = load2(qrow + e);
      qv[i].x *= scale;
      qv[i].y *= scale;
    }
  }
  float sc[kC];
  unsigned ok = 0;
  float cmax = kNegInf;
#pragma unroll
  for (int jj = 0; jj < kC; ++jj) {
    sc[jj] = kNegInf;
    if (c0 + jj < page) {  // uniform across the warp
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        if (2 * lane + 64 * i < D) {
          const float2 k2 = to_float2(kk[jj][i]);
          part = fmaf(qv[i].x, k2.x, part);
          part = fmaf(qv[i].y, k2.y, part);
        }
      }
      float dot = warp_sum(part);
      if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
      const int kv = kvbase + c0 + jj;
      if (kv <= qp && kv < ctx && (window <= 0 || qp - kv < window)) {
        sc[jj] = dot;
        ok |= 1u << jj;
        cmax = fmaxf(cmax, dot);
      }
    }
  }
  if (!ok) return;  // no key of this chunk is visible to the row
  const float m_old = *m_p;
  const float m_new = fmaxf(m_old, cmax);
  const float alpha = expf(m_old - m_new);
  float l = *l_p * alpha;
  float2 a[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int e = 2 * lane + 64 * i;
    a[i] = make_float2(0.f, 0.f);
    if (e < D) {
      a[i] = *reinterpret_cast<const float2*>(arow + e);
      a[i].x *= alpha;
      a[i].y *= alpha;
    }
  }
#pragma unroll
  for (int jj = 0; jj < kC; ++jj) {
    if (!((ok >> jj) & 1u)) continue;
    const float p = expf(sc[jj] - m_new);
    l += p;
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      if (2 * lane + 64 * i < D) {
        const float2 v2 = to_float2(vv[jj][i]);
        a[i].x = fmaf(p, v2.x, a[i].x);
        a[i].y = fmaf(p, v2.y, a[i].y);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int e = 2 * lane + 64 * i;
    if (e < D) *reinterpret_cast<float2*>(arow + e) = a[i];
  }
  __syncwarp();  // every lane has read *m_p / *l_p before lane 0 rewrites
  if (lane == 0) {
    *m_p = m_new;
    *l_p = l;
  }
  __syncwarp();
}

// A warp's walk over the logical pages j_first, j_first + j_step, ...
// <= j_last of one sequence's block table (bt_row), a chunk of keys at a
// time: the next chunk's loads are issued before attend(kk, vv, kvbase,
// c0) runs on the current one, so a chunk is always in flight while the
// warp computes.  head_off is the element offset of the kv head's rows in
// a page.  Reads no page when j_first > j_last.
template <typename T, int kP, int kC, typename Attend>
__device__ __forceinline__ void stream_pages(
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ bt_row, int j_first, int j_last, int j_step,
    size_t page_stride, size_t key_stride, size_t head_off, int page, int D,
    int lane, Attend&& attend) {
  using P2 = typename PairOf<T>::type;
  if (j_first > j_last) return;
  P2 k_cur[kC][kP], v_cur[kC][kP], k_nxt[kC][kP], v_nxt[kC][kP];
  int j = j_first, c0 = 0;
  size_t off = (size_t)bt_row[j] * page_stride + head_off;
  load_chunk<T, kP, kC>(k_cur, v_cur, k_pages + off, v_pages + off,
                        key_stride, 0, page, D, lane);
  while (true) {
    int j1 = j, c1 = c0 + kC;
    bool more = true;
    if (c1 >= page) {
      c1 = 0;
      j1 = j + j_step;
      more = j1 <= j_last;
    }
    if (more) {
      const size_t off1 = (size_t)bt_row[j1] * page_stride + head_off;
      load_chunk<T, kP, kC>(k_nxt, v_nxt, k_pages + off1, v_pages + off1,
                            key_stride, c1, page, D, lane);
    }
    attend(k_cur, v_cur, j * page, c0);
    if (!more) break;
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) {
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        k_cur[jj][i] = k_nxt[jj][i];
        v_cur[jj][i] = v_nxt[jj][i];
      }
    }
    j = j1;
    c0 = c1;
  }
}

}  // namespace
