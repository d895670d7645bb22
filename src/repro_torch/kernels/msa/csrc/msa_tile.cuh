// The tensor-core tile machinery of the Multi-Segment Attention kernels
// for Hopper (sm_90a), shared by msa_fused.cu, msa_prefill.cu and
// msa_decode.cu: a work item's M rows (64: four warps of 16), its stages
// of 32 key slots in a cp.async ring (Tile), the copies into shared memory
// (cp_async, copy_row), the operand loads (ldmatrix) and products
// (mma.sync m16n8k16 / m16n8k8, bf16 in, f32 accumulate; f32 inputs run
// the same tiles through full-float32 FMAs, never TF32), and one warp's
// online-softmax update of its 16 M rows against a stage (stage_update).
#pragma once

#include "msa_common.cuh"

namespace {

constexpr int kWarpsF = 4;
constexpr int kThreadsF = kWarpsF * 32;
constexpr int kMRows = 16 * kWarpsF;  // M rows of one work item
constexpr int kKeys = 32;             // key slots of one stage

// Shared-memory layout of one instantiation: a row (of q, K or V) holds
// kDP >= D elements plus a skew that spreads ldmatrix rows over banks.
template <typename T, int kDP>
struct Tile {
  static constexpr int kStride = kDP + 16 / (int)sizeof(T);
  static constexpr int kStages = (sizeof(T) == 2 && kDP <= 128) ? 3 : 2;
  static constexpr size_t kRowBytes = (size_t)kStride * sizeof(T);
  static constexpr size_t kQBytes = kMRows * kRowBytes;
  static constexpr size_t kStageBytes = 2 * kKeys * kRowBytes + kKeys * 4;
  static constexpr size_t kSmem = kQBytes + kStages * kStageBytes;
  // the ring also holds the four warps' (o, m, l) of a key-split item
  static_assert(kWarpsF * 16 * (kDP + 2) * 4 <= kStages * kStageBytes,
                "ring too small for the warps' states");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copies of `bytes` (16 or 4) from global to shared memory, of which the
// first `src_bytes` are read and the rest zero-filled.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes, bool wide) {
  if (wide)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One row of D elements (src, in global memory) into a shared row of kDP
// elements (dst), zero-filled past D, or all zeros when !valid (src is
// then only a valid address that is not read); chunks part, part + parts,
// ... of the row.
template <typename T, int kDP>
__device__ __forceinline__ void copy_row(T* dst, const T* src, bool valid,
                                         int D, bool wide, int part,
                                         int parts) {
  const int chunk = wide ? 16 : 4;
  const int have = valid ? D * (int)sizeof(T) : 0;
  const int n = kDP * (int)sizeof(T) / chunk;
  for (int c = part; c < n; c += parts) {
    const int off = c * chunk;
    const int b = min(max(have - off, 0), chunk);
    cp_async(reinterpret_cast<char*>(dst) + off,
             reinterpret_cast<const char*>(src) + (b ? off : 0), b, wide);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a (16 x 8, row) . b (8 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], const unsigned (&a)[2],
                                            unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// A warp's scores S (16 M rows x NT * 8 keys) in the m16n8 accumulator
// layout: s[nt][e] is row lane / 4 (+ 8 for e >= 2), key nt * 8 +
// 2 * (lane % 4) + (e & 1).  NT is 4 (a stage's 32 keys) or 1 (8 keys).
template <typename T, int kDP, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const T* qs,
                                       const T* ks, int D, int lane) {
  using L = Tile<T, kDP>;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kb = 0; kb < kDP; kb += 16) {
      unsigned a[4];
      ldsm_x4(a, qs + (lane & 15) * L::kStride + kb + (lane >> 4) * 8);
      if constexpr (NT == 1) {
        unsigned b[2];
        ldsm_x2(b, ks + (lane & 7) * L::kStride + kb + ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], a, b[0], b[1]);
      } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned b[4];
          ldsm_x4(b, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                              L::kStride +
                         kb + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  } else {
    const float* qa = qs + (lane >> 2) * L::kStride;
    const float* qb = qa + 8 * L::kStride;
    const float* kr = ks + 2 * (lane & 3) * L::kStride;
    for (int d = 0; d < D; d += 2) {
      const float2 x = *reinterpret_cast<const float2*>(qa + d);
      const float2 y = *reinterpret_cast<const float2*>(qb + d);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 k = *reinterpret_cast<const float2*>(
              kr + (nt * 8 + e) * L::kStride + d);
          s[nt][e] = fmaf(x.x, k.x, fmaf(x.y, k.y, s[nt][e]));
          s[nt][2 + e] = fmaf(y.x, k.x, fmaf(y.y, k.y, s[nt][2 + e]));
        }
      }
    }
  }
}

// o (16 M rows x kDP dims, m16n8 layout: o[nd][e] is row lane / 4 (+ 8
// for e >= 2), dim nd * 8 + 2 * (lane % 4) + (e & 1)) += P . V over the
// warp's NT * 8 keys; p in the layout of scores().
template <typename T, int kDP, int NT>
__device__ __forceinline__ void accumulate(float (&o)[kDP / 8][4],
                                           const float (&p)[NT][4],
                                           const T* vs, int D, int lane) {
  using L = Tile<T, kDP>;
  if constexpr (sizeof(T) == 2) {
    // P as hi + lo bf16 A fragments: fragment i holds rows + 8 for odd i
    // and keys + 8 for i >= 2
    auto split_p = [](float x, float y, unsigned& hi, unsigned& lo) {
      hi = pack_bf16(x, y);
      const __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&hi);
      lo = pack_bf16(x - __low2float(h), y - __high2float(h));
    };
    if constexpr (NT == 1) {
      unsigned hi[2], lo[2];
      split_p(p[0][0], p[0][1], hi[0], lo[0]);
      split_p(p[0][2], p[0][3], hi[1], lo[1]);
#pragma unroll
      for (int nd = 0; nd < kDP / 8; nd += 4) {
        unsigned b[4];
        ldsm_x4_t(b, vs + (lane & 7) * L::kStride + nd * 8 + (lane >> 3) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16_k8(o[nd + j], hi, b[j]);
          mma_bf16_k8(o[nd + j], lo, b[j]);
        }
      }
    } else {
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        unsigned hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* f = p[2 * kc + (i >> 1)];
          split_p(f[2 * (i & 1)], f[2 * (i & 1) + 1], hi[i], lo[i]);
        }
#pragma unroll
        for (int nd = 0; nd < kDP / 8; nd += 2) {
          unsigned b[4];
          ldsm_x4_t(b, vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                L::kStride +
                           nd * 8 + (lane >> 4) * 8);
          mma_bf16(o[nd], hi, b[0], b[1]);
          mma_bf16(o[nd], lo, b[0], b[1]);
          mma_bf16(o[nd + 1], hi, b[2], b[3]);
          mma_bf16(o[nd + 1], lo, b[2], b[3]);
        }
      }
    }
  } else {
    const float* vr = vs + 2 * (lane & 3);
#pragma unroll
    for (int key = 0; key < NT * 8; ++key) {
      // p of (row, key) lives on quad lane (key % 8) / 2
      const int src = (lane & ~3) | ((key & 7) >> 1);
      const float pa = __shfl_sync(kFull, p[key >> 3][key & 1], src);
      const float pb = __shfl_sync(kFull, p[key >> 3][2 + (key & 1)], src);
#pragma unroll
      for (int nd = 0; nd < kDP / 8; ++nd) {
        if (nd * 8 < D) {
          const float2 v =
              *reinterpret_cast<const float2*>(vr + key * L::kStride + nd * 8);
          o[nd][0] = fmaf(pa, v.x, o[nd][0]);
          o[nd][1] = fmaf(pa, v.y, o[nd][1]);
          o[nd][2] = fmaf(pb, v.x, o[nd][2]);
          o[nd][3] = fmaf(pb, v.y, o[nd][3]);
        }
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// One warp's online-softmax update of its 16 M rows (q tile qs, logical
// positions qp of rows lane / 4 and lane / 4 + 8, -1: no row) against NT * 8
// keys of a stage (ks, vs, their kv positions kv; INT_MAX: no key).
template <typename T, int kDP, int NT>
__device__ __forceinline__ void stage_update(
    float (&o)[kDP / 8][4], float (&m_run)[2], float (&l_run)[2],
    const T* qs, const T* ks, const T* vs, const int* kv, const int (&qp)[2],
    int ctx, int window, float softcap, float scale, int D, int lane) {
  float s[NT][4];
  scores<T, kDP, NT>(s, qs, ks, D, lane);
  float cmax[2] = {kNegInf, kNegInf};
  unsigned vis = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int kvp = kv[nt * 8 + 2 * (lane & 3) + (e & 1)];
      float x = s[nt][e] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      if (kvp <= qp[h] && kvp < ctx && (window <= 0 || qp[h] - kvp < window)) {
        vis |= 1u << (nt * 4 + e);
        cmax[h] = fmaxf(cmax[h], x);
      }
      s[nt][e] = x;
    }
  }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m_run[h], quad_max(cmax[h]));
    alpha[h] = expf(m_run[h] - m_new);
    m_run[h] = m_new;
    l_run[h] *= alpha[h];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      // a masked key's p is 0, never exp(NEG_INF - NEG_INF)
      const float p =
          (vis >> (nt * 4 + e)) & 1u ? expf(s[nt][e] - m_run[h]) : 0.f;
      s[nt][e] = p;
      l_run[h] += p;
    }
  }
#pragma unroll
  for (int nd = 0; nd < kDP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] *= alpha[e >> 1];
  accumulate<T, kDP, NT>(o, s, vs, D, lane);
}

}  // namespace
