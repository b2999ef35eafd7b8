// Device helpers shared by the attention kernels on the tensor cores:
// attention_short.cu (the forward) and attention_short_bwd.cu (its fused
// backward). Async copies, ldmatrix, the bf16 and split 3xTF32 mma.sync
// products, the score tiles and the tile-by-tile softmax fold; both files
// include it, so the backward recomputes the forward's probabilities with
// the same instructions in the same order (the same bits). The build hashes
// this header with each source (ops/_build.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kKeyTile = 64;     // keys per tile
constexpr int kMaxRows = 128;    // query rows per block (16 per warp)

// Elements of T in 16 bytes: the cp.async chunk, the padding of a shared
// row, and half the k depth of one MMA (bf16: 8 of 16; tf32: 4 of 8).
template <typename T>
__host__ __device__ constexpr int chunk() {
  return 16 / (int)sizeof(T);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills the destination when !valid
// (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a . b, m16n8k16, bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b, m16n8k8, tf32 inputs (the low 13 bits of each f32 are not
// read), f32 accumulator. Fragments (g = lane / 4, t = lane % 4): a = rows
// (g, g + 8) x k (t, t + 4) as (g,t) (g+8,t) (g,t+4) (g+8,t+4); b = k (t,
// t + 4) of column g; c = (g,2t) (g,2t+1) (g+8,2t) (g+8,2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small in TF32, each rounded to nearest with ties away from zero
// (cvt.rna.tf32.f32 for finite x): half a TF32 ulp (0x1000) is added to the
// bits and the MMA, which does not read the low 13 bits, truncates; x - big
// is exact. Two integer adds, a mask and a subtraction, where cvt.rna also
// tests for Inf and NaN (3 instructions more per operand element; the
// ablation tool's cvt_rna_split variant times the difference).
struct Tf32Pair {
  uint32_t big, small;
};
__device__ __forceinline__ Tf32Pair split_tf32(uint32_t bits) {
  const uint32_t big = bits + 0x1000u;
  const float small = __uint_as_float(bits) - __uint_as_float(big & 0xffffe000u);
  return {big, __float_as_uint(small) + 0x1000u};
}

// The products of one route: operand() turns an A fragment as loaded (4
// registers) into the MMA's operand, run() adds a . b for one B fragment (2
// registers).
template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  struct A {
    uint32_t r[4];
  };
  static __device__ __forceinline__ A operand(const uint32_t (&x)[4]) {
    return {{x[0], x[1], x[2], x[3]}};
  }
  static __device__ __forceinline__ void run(float (&c)[4], const A& a, uint32_t b0,
                                             uint32_t b1) {
    mma_bf16(c, a.r, b0, b1);
  }
};

// 3xTF32: both operands split, the two cross terms before big . big.
template <>
struct Mma<float> {
  struct A {
    uint32_t big[4], small[4];
  };
  static __device__ __forceinline__ A operand(const uint32_t (&x)[4]) {
    A out;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Tf32Pair p = split_tf32(x[i]);
      out.big[i] = p.big;
      out.small[i] = p.small;
    }
    return out;
  }
  static __device__ __forceinline__ void run(float (&c)[4], const A& a, uint32_t b0,
                                             uint32_t b1) {
    const Tf32Pair s0 = split_tf32(b0), s1 = split_tf32(b1);
    mma_tf32(c, a.small, s0.big, s1.big);
    mma_tf32(c, a.big, s0.small, s1.small);
    mma_tf32(c, a.big, s0.big, s1.big);
  }
};

// Two f32 rounded (to nearest even) to bf16 and packed, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Two adjacent output values stored to shared memory in the route's type.
__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Async-copy rows [first, first + count) of one head's [L, HD] slice (row
// stride `sl` elements) into shared rows of stride HD + chunk<T>() (16 bytes
// of padding); rows >= L are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, long long sl,
                                          int first, int count, int L) {
  constexpr int C = chunk<T>();
  constexpr int RS = HD + C;
  constexpr int CPR = HD / C;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < count * CPR; i += blockDim.x) {
    const int r = i / CPR;
    const int c = (i % CPR) * C;
    const int j = first + r;
    const bool ok = j < L;
    cp_async16(dst + r * RS + c, src + (long long)(ok ? j : 0) * sl + c, ok);
  }
}

// S (16 query rows x NT * 64 keys, f32) = Q_w . K^T for one warp, where Q_w
// is the warp's 16 shared rows and K holds NT 64-key shared tiles; each
// k-step's Q fragment is loaded (and, in f32, split) once for all tiles.
// `valid` keys (counted from the first tile) are real; 8-key column groups
// past them are skipped (left 0). A k-step is 32 bytes of a row in either
// route (16 bf16 or 8 f32), so the ldmatrix addresses are the same in bytes.
// Fragment layout (C): s[t][j][0..1] are row lane/4, keys 64t + 8j +
// 2(lane%4) + {0,1}; s[t][j][2..3] the same keys of row lane/4 + 8. ALL:
// the caller guarantees nt == NT and valid >= NT * 64, so no step is tested
// (straight-line code the compiler schedules across steps; the same
// products in the same order).
template <typename T, int HD, int NT, bool ALL = false>
__device__ __forceinline__ void score_tiles(float (&s)[NT][8][4], const T* sq_w, const T* sk,
                                            int nt, int valid, int lane) {
  constexpr int C = chunk<T>();
  constexpr int RS = HD + C;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[t][j][0] = s[t][j][1] = s[t][j][2] = s[t][j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / (2 * C); ++kk) {
    uint32_t x[4];
    // A: matrices (rows 0-7 | 8-15) x (first | second 16 bytes) of this k-step
    ldsm_x4(x, sq_w + (lane & 15) * RS + kk * 2 * C + (lane >> 4) * C);
    const typename Mma<T>::A a = Mma<T>::operand(x);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (ALL || t < nt) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const int key = t * kKeyTile + jp * 16;
          if (ALL || key < valid) {
            uint32_t b[4];
            // B (K rows are B's columns): keys key + (0-7 | 8-15) x (first |
            // second 16 bytes)
            ldsm_x4(b, sk + (key + (lane & 7) + ((lane >> 4) << 3)) * RS + kk * 2 * C +
                           ((lane >> 3) & 1) * C);
            Mma<T>::run(s[t][2 * jp], a, b[0], b[1]);
            if (ALL || key + 8 < valid) Mma<T>::run(s[t][2 * jp + 1], a, b[2], b[3]);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void tile_max(const float (&s)[8][4], float& m0, float& m1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
}

// e = exp(s - m) in place, for the two rows a thread holds.
__device__ __forceinline__ void exp_tile(float (&s)[8][4], float m0, float m1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = expf(s[j][0] - m0);
    s[j][1] = expf(s[j][1] - m0);
    s[j][2] = expf(s[j][2] - m1);
    s[j][3] = expf(s[j][3] - m1);
  }
}

// Fold one masked score tile into the running row max m and the thread's
// part l of the row sum of exp(s - m): l is rescaled by exp(m - n) for the
// new max n, then the tile's exp(s - n) are added in key order. A masked or
// pad key adds exactly 0 and leaves m alone, so folding every tile (both
// routes do) gives a row's sum the same bits at any padded length; a
// one-pass sum with the final max rounds otherwise once m grows after the
// first tile. With KEEP, s becomes exp(s - n) in place: the tile's
// numerators when n is the final max.
template <bool KEEP>
__device__ __forceinline__ void fold_tile(float (&s)[8][4], float& m0, float& m1, float& l0,
                                          float& l1) {
  float t0 = -CUDART_INF_F, t1 = -CUDART_INF_F;
  tile_max(s, t0, t1);
  const float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
  l0 *= expf(m0 - n0);
  l1 *= expf(m1 - n1);
  if constexpr (KEEP) {
    exp_tile(s, n0, n1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l0 += expf(s[j][0] - n0) + expf(s[j][1] - n0);
      l1 += expf(s[j][2] - n1) + expf(s[j][3] - n1);
    }
  }
  m0 = n0;
  m1 = n1;
}

// The correctly rounded quotient e / l, given r = RN(1 / l): q = RN(e * r)
// is within an ulp of e / l, and one FMA correction makes it exact
// (Markstein) whenever e / l is a normal float; a subnormal prob may be one
// subnormal ulp off. Three operations in place of the ~10 and the branch of
// the compiler's division, which took 45% of the bf16 kernel's time.
__device__ __forceinline__ float div_rn(float e, float l, float r) {
  const float q = __fmul_rn(e, r);
  return fmaf(fmaf(-q, l, e), r, q);
}

}  // namespace
