// Device code of the attention backward (attention_short_bwd.cu; design,
// bound and routes in its header note): the fused route's kernel
// attention_bwd_fused and the two-pass route's attention_two_pass_dq and
// attention_two_pass_dkv with their launcher. attention_short_bwd.cu
// instantiates them for 16-byte copies; attention_any.cu instantiates them
// at any copy width (the fused kernel with ANY) and in column blocks.

#pragma once

#include "attention_tc.cuh"

namespace {


constexpr int kSmemLimit = 232448;  // dynamic shared memory a Hopper block may use

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  const void* out;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // two-pass route: [3, B, H, L] row max, row sum, D; null on the fused route
  long long B;
  int L, H, hd;  // hd: the head's real width (<= the instantiation's HD)
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl, g_sb, g_sl, m_sb;
  float scale;
  int vb;  // the copy width in bytes (16 in attention_short_bwd.cu)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }


// ---------------------------------------------------------------------------
// The fused route
// ---------------------------------------------------------------------------

// Shared bytes of one fused block, mirrored by
// ops/attention_kernel.py::backward_launch_geometry: the Q, K, V and dO
// tiles and the rows x rows staging buffer, in T, rows padded by 16 bytes.
template <typename T, int HD>
__host__ __device__ constexpr size_t fused_smem_bytes(int rows) {
  return ((size_t)4 * rows * (HD + chunk<T>()) + (size_t)rows * (rows + chunk<T>())) * sizeof(T);
}

// The fused route exists for (T, HD) when its block fits at 128 rows.
template <typename T, int HD>
__host__ __device__ constexpr bool fused_fits() {
  return fused_smem_bytes<T, HD>(kMaxRows) <= (size_t)kSmemLimit;
}

// Bit 16t + 2j + e: key 64t + 8j + 2(lane % 4) + e (the thread's column e of
// 8-key group j of tile t) is < L and kept by the mask.
__device__ __forceinline__ uint32_t kept_keys(const uint8_t* __restrict__ mrow, int L, int lane) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int key = 64 * (i >> 4) + 8 * ((i >> 1) & 7) + 2 * (lane & 3) + (i & 1);
    if (key < L && mrow[key]) bits |= 1u << i;
  }
  return bits;
}

// The forward's mask_tile for tile t, each key's fill taken from `kept`: 0
// for a kept key, -1e30 for a masked key, -inf past L.
__device__ __forceinline__ void mask_keys(float (&s)[8][4], uint32_t kept, int t, int L,
                                          float scale, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = kKeyTile * t + 8 * j + 2 * (lane & 3);
    const float f0 = (kept >> (16 * t + 2 * j)) & 1u ? 0.f : key < L ? -1e30f : -CUDART_INF_F;
    const float f1 = (kept >> (16 * t + 2 * j + 1)) & 1u ? 0.f : key + 1 < L ? -1e30f : -CUDART_INF_F;
    s[j][0] = fmaf(s[j][0], scale, f0);
    s[j][1] = fmaf(s[j][1], scale, f1);
    s[j][2] = fmaf(s[j][2], scale, f0);
    s[j][3] = fmaf(s[j][3], scale, f1);
  }
}

// Stage one 64-key tile of the warp's C fragments (16 rows x 64 keys, f32)
// into its rows of the staging buffer (row stride PS) in T (bf16: rounded to
// nearest even); keys >= rows are not stored. FULL (here and below): L =
// rows = 128, so no key, step or row is tested.
template <typename T, bool FULL>
__device__ __forceinline__ void stage_tile(T* sp_w, int PS, const float (&x)[8][4], int t, int rows,
                                           int lane) {
  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = kKeyTile * t + 8 * j + c2;
    if (FULL || key < rows) {
      store2(sp_w + g * PS + key, x[j][0], x[j][1]);
      store2(sp_w + (g + 8) * PS + key, x[j][2], x[j][3]);
    }
  }
}

// The warp's dS (16 query rows x 128 keys) held as the dQ product takes it:
// bf16 packed into m16n8k16 A operands (a[t][kk]: keys 64t + 16kk .. + 15;
// the C layout of two 8-key groups is the A layout), f32 as the C fragments.
template <typename T>
struct DsRegs;
template <>
struct DsRegs<bf16> {
  uint32_t a[2][4][4];
};
template <>
struct DsRegs<float> {
  float c[2][8][4];
};

__device__ __forceinline__ void hold(DsRegs<bf16>& r, int t, const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* c = x[2 * kk + half];
      r.a[t][kk][2 * half] = pack_bf16(c[0], c[1]);
      r.a[t][kk][2 * half + 1] = pack_bf16(c[2], c[3]);
    }
  }
}
__device__ __forceinline__ void hold(DsRegs<float>& r, int t, const float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) r.c[t][j][e] = x[j][e];
  }
}

// Stage the held dS (tiles < nt, keys < rows) into the warp's buffer rows.
template <bool FULL>
__device__ __forceinline__ void stage_ds(bf16* sp_w, int PS, const DsRegs<bf16>& r, int nt,
                                         int rows, int lane) {
  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (FULL || t < nt) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = kKeyTile * t + 16 * kk + 8 * half + c2;
          if (FULL || key < rows) {
            *reinterpret_cast<uint32_t*>(sp_w + g * PS + key) = r.a[t][kk][2 * half];
            *reinterpret_cast<uint32_t*>(sp_w + (g + 8) * PS + key) = r.a[t][kk][2 * half + 1];
          }
        }
      }
    }
  }
}
template <bool FULL>
__device__ __forceinline__ void stage_ds(float* sp_w, int PS, const DsRegs<float>& r, int nt,
                                         int rows, int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (FULL || t < nt) stage_tile<float, FULL>(sp_w, PS, r.c[t], t, rows, lane);
  }
}

// o (16 query rows x HD, f32) += dS_t . K_t for one 64-key tile of K (row
// stride HD + 16 / size), dS from registers; 16-key (bf16) or 8-key (f32)
// steps past `valid` are skipped (their dS is 0 and their K rows zero).
template <int HD, bool FULL>
__device__ __forceinline__ void ds_times_k(float (&o)[HD / 8][4], const DsRegs<bf16>& r, int t,
                                           const bf16* sk_t, int valid, int lane) {
  constexpr int RS = HD + chunk<bf16>();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (FULL || kk * 16 < valid) {
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        // B = K (keys x dims), transposed: keys (0-7 | 8-15) x dims 16dp + (0-7 | 8-15)
        ldsm_x4_trans(b, sk_t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + dp * 16 +
                             (lane >> 4) * 8);
        mma_bf16(o[2 * dp], r.a[t][kk], b[0], b[1]);
        mma_bf16(o[2 * dp + 1], r.a[t][kk], b[2], b[3]);
      }
    }
  }
}
template <int HD, bool FULL>
__device__ __forceinline__ void ds_times_k(float (&o)[HD / 8][4], const DsRegs<float>& r, int t,
                                           const float* sk_t, int valid, int lane) {
  // the forward's f32 P . V: per 8-key group kk, A = (c0, c2, c1, c3) with the
  // k index permuted (k = t: key 2t; k = t + 4: key 2t + 1), B = K rows 2t and
  // 2t + 1 at column g
  constexpr int RS = HD + chunk<float>();
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (FULL || kk * 8 < valid) {
      const float* c = r.c[t][kk];
      const uint32_t x[4] = {__float_as_uint(c[0]), __float_as_uint(c[2]), __float_as_uint(c[1]),
                             __float_as_uint(c[3])};
      const Mma<float>::A a = Mma<float>::operand(x);
      const float* k0 = sk_t + (kk * 8 + 2 * tq) * RS + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        Mma<float>::run(o[n], a, __float_as_uint(k0[8 * n]), __float_as_uint(k0[RS + 8 * n]));
    }
  }
}

// o (16 keys x HD, f32) += B^T . X for the warp's keys key0 .. key0 + 15,
// summed over the query rows < L: B is the staging buffer [query][key] (row
// stride PS), X a shared [query][HD] tile (row stride HD + 16 / size).
template <int HD, bool FULL>
__device__ __forceinline__ void keys_product(float (&o)[HD / 8][4], const bf16* sp, int PS,
                                             const bf16* sx, int key0, int L, int lane) {
  constexpr int RS = HD + chunk<bf16>();
  const int steps = FULL ? kMaxRows / 16 : (L + 15) / 16;
  // unrolled by 2 only: fully unrolled at L = 128 the kernel spills more
  // (128 registers, two blocks an SM) and ran slower
#pragma unroll 2
  for (int kk = 0; kk < steps; ++kk) {
    uint32_t a[4];
    // A = B^T (keys x queries): matrices (keys 0-7 | 8-15) x (queries 0-7 |
    // 8-15), each read transposed from 8 buffer rows (queries)
    ldsm_x4_trans(a, sp + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * PS + key0 +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, sx + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + dp * 16 +
                           (lane >> 4) * 8);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}
template <int HD, bool FULL>
__device__ __forceinline__ void keys_product(float (&o)[HD / 8][4], const float* sp, int PS,
                                             const float* sx, int key0, int L, int lane) {
  // per 8-query step kk, the k index permuted as in ds_times_k (k = t: query
  // 8kk + 2t; k = t + 4: query 8kk + 2t + 1): A (keys g, g + 8) from buffer
  // rows 2t and 2t + 1, B from X rows 2t and 2t + 1 at column g. Row strides
  // of 4 or 20 words mod 32 put the lanes of a load on 32 banks.
  constexpr int RS = HD + chunk<float>();
  const int g = lane >> 2, tq = lane & 3;
  const int steps = FULL ? kMaxRows / 8 : (L + 7) / 8;
  // not unrolled: unrolled at L = 128 the f32 kernel reached 255 registers
  // and ran well below this loop's speed
#pragma unroll 1
  for (int kk = 0; kk < steps; ++kk) {
    const float* p0 = sp + (kk * 8 + 2 * tq) * PS + key0 + g;
    const uint32_t x[4] = {__float_as_uint(p0[0]), __float_as_uint(p0[8]), __float_as_uint(p0[PS]),
                           __float_as_uint(p0[PS + 8])};
    const Mma<float>::A a = Mma<float>::operand(x);
    const float* x0 = sx + (kk * 8 + 2 * tq) * RS + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      Mma<float>::run(o[n], a, __float_as_uint(x0[8 * n]), __float_as_uint(x0[RS + 8 * n]));
  }
}

// sum_d x[d] * y[d] over 16 bytes of each, added to acc in order.
__device__ __forceinline__ float dot16(const float* x, const float* y, float acc) {
  const float4 a = *reinterpret_cast<const float4*>(x);
  const float4 b = __ldg(reinterpret_cast<const float4*>(y));
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot16(const bf16* x, const bf16* y, float acc) {
  const uint4 a = *reinterpret_cast<const uint4*>(x);
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(y));
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[i]));
    const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[i]));
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// D = rowsum(dO * O) of one query row: this lane's 16-byte chunks tq, tq + 4,
// ... below hd of the dO row (shared) and of the O row (device memory); the
// caller sums the quad.
template <typename T, int HD>
__device__ __forceinline__ float row_dot(const T* srow, const T* __restrict__ grow, int tq, int hd) {
  constexpr int C = chunk<T>();
  float acc = 0.f;
#pragma unroll
  for (int c = tq; c < HD / C; c += 4)
    if (c * C < hd) acc = dot16(srow + c * C, grow + c * C, acc);
  return acc;
}

// row_dot at any copy width: elements tq, tq + 4, ... below hd, read one
// by one (the O row need not be 16-byte aligned); the caller sums the quad.
template <typename T>
__device__ __forceinline__ float row_dot_any(const T* srow, const T* __restrict__ grow, int tq,
                                             int hd) {
  float acc = 0.f;
  for (int d = tq; d < hd; d += 4) acc = fmaf(to_f32(srow[d]), to_f32(grow[d]), acc);
  return acc;
}

// Stage the warp's 16 output rows (o * mul, rounded to T) in its own shared
// rows stage_w (row stride HD + 16 / size), then copy the rows row0 + r < L,
// columns < hd, to dst (row stride D elements) in 16-byte pieces.
template <typename T, int HD, bool FULL>
__device__ __forceinline__ void write_rows(T* stage_w, const float (&o)[HD / 8][4], float mul,
                                           T* __restrict__ dst, long long D, int row0, int L,
                                           int hd, int lane) {
  constexpr int C = chunk<T>();
  constexpr int RS = HD + C;
  constexpr int CPR = HD / C;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    store2(stage_w + g * RS + 8 * n + c2, o[n][0] * mul, o[n][1] * mul);
    store2(stage_w + (g + 8) * RS + 8 * n + c2, o[n][2] * mul, o[n][3] * mul);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR;
    const int c = (i % CPR) * C;
    const int row = row0 + r;
    if ((FULL || row < L) && c < hd)
      *reinterpret_cast<uint4*>(dst + row * D + c) =
          *reinterpret_cast<const uint4*>(stage_w + r * RS + c);
  }
}

// write_rows at the copy width vb (store_rows_any), for the ANY blocks.
template <typename T, int HD>
__device__ __forceinline__ void write_rows_any(T* stage_w, const float (&o)[HD / 8][4], float mul,
                                               T* __restrict__ dst, long long D, int row0, int L,
                                               int hd, int vb, int lane) {
  constexpr int RS = HD + chunk<T>();
  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    store2(stage_w + g * RS + 8 * n + c2, o[n][0] * mul, o[n][1] * mul);
    store2(stage_w + (g + 8) * RS + 8 * n + c2, o[n][2] * mul, o[n][3] * mul);
  }
  __syncwarp();
  store_rows_any<T, HD>(dst + row0 * D, D, stage_w, L - row0, hd, vb, lane);
}

// Two blocks per SM where their shared memory allows it (bf16 up to
// HD = 64), which caps a thread at 128 registers; one block otherwise.
// FULL: L = 128 (the train step's and the bert block's length), every
// test of a key, step or row resolved at compile time. ANY (never with
// FULL; attention_any.cu): the copies in and out at the copy width a.vb
// (any head width up to HD, any alignment of the rows), and D from single
// elements of the O row.
template <typename T, int HD, bool FULL, bool ANY = false>
__global__ void __launch_bounds__(kMaxRows / 16 * 32, (sizeof(T) == 2 && HD <= 64) ? 2 : 1)
attention_bwd_fused(Args a) {
  static_assert(fused_fits<T, HD>(), "the fused block must fit shared memory");
  static_assert(!(FULL && ANY), "FULL blocks copy 16 bytes at a time");
  constexpr int C = chunk<T>();
  constexpr int RS = HD + C;
  constexpr int NO = HD / 8;  // 8-column groups of an output row

  const long long b = blockIdx.x;
  const int L = FULL ? kMaxRows : a.L;
  const int rows = FULL ? kMaxRows : blockDim.x / 2;  // 16 query rows per 32-thread warp
  const int PS = rows + C;                            // row stride of the staging buffer
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's first query row and first key
  const int nt = FULL ? 2 : (L + kKeyTile - 1) / kKeyTile;
  // FULL is launched only at hd == HD (the train step's widths), so its
  // column count is a constant: a runtime one cost the bf16 FULL blocks 60
  // bytes of spill more at their 128 registers
  const int hd = FULL ? HD : a.hd;
  const long long D = (long long)a.H * hd;
  const long long col = (long long)blockIdx.y * hd;

  // (its own name: the two-pass kernels declare smem_tp)
  extern __shared__ __align__(16) unsigned char smem_tc[];
  T* sq = reinterpret_cast<T*>(smem_tc);  // [rows][RS]
  T* sk = sq + rows * RS;                 // [rows][RS]; then dQ's and dK's staging
  T* sv = sk + rows * RS;                 // [rows][RS]; then dV's staging
  T* sg = sv + rows * RS;                 // [rows][RS]: dO
  T* sp = sg + rows * RS;                 // [rows][PS]: round(P), then dS
  T* sp_w = sp + r0 * PS;

  if constexpr (ANY) {
    load_rows_any<T, HD>(sq, static_cast<const T*>(a.q) + b * a.q_sb + col, a.q_sl, 0, rows, L, hd, a.vb);
    load_rows_any<T, HD>(sk, static_cast<const T*>(a.k) + b * a.k_sb + col, a.k_sl, 0, rows, L, hd, a.vb);
    cp_async_commit();
    load_rows_any<T, HD>(sv, static_cast<const T*>(a.v) + b * a.v_sb + col, a.v_sl, 0, rows, L, hd, a.vb);
    load_rows_any<T, HD>(sg, static_cast<const T*>(a.dout) + b * a.g_sb + col, a.g_sl, 0, rows, L, hd,
                         a.vb);
    cp_async_commit();
  } else {
    load_rows<T, HD>(sq, static_cast<const T*>(a.q) + b * a.q_sb + col, a.q_sl, 0, rows, L, hd);
    load_rows<T, HD>(sk, static_cast<const T*>(a.k) + b * a.k_sb + col, a.k_sl, 0, rows, L, hd);
    cp_async_commit();
    load_rows<T, HD>(sv, static_cast<const T*>(a.v) + b * a.v_sb + col, a.v_sl, 0, rows, L, hd);
    load_rows<T, HD>(sg, static_cast<const T*>(a.dout) + b * a.g_sb + col, a.g_sl, 0, rows, L, hd);
    cp_async_commit();
  }
  const uint32_t kept = kept_keys(a.mask + b * a.m_sb, L, lane);
  cp_async_wait<1>();
  __syncthreads();

  // P: the forward's scores, fold and division, so the forward's bits
  float s[2][8][4];
  score_tiles<T, HD, 2, FULL>(s, sq + r0 * RS, sk, nt, L, lane);
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  mask_keys(s[0], kept, 0, L, a.scale, lane);
  if (nt == 2) {
    fold_tile<false>(s[0], m0, m1, l0, l1);
    mask_keys(s[1], kept, 1, L, a.scale, lane);
    fold_tile<true>(s[1], m0, m1, l0, l1);
    exp_tile(s[0], m0, m1);
  } else {
    fold_tile<true>(s[0], m0, m1, l0, l1);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float rc0 = __frcp_rn(l0), rc1 = __frcp_rn(l1);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (FULL || t < nt) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[t][j][0] = div_rn(s[t][j][0], l0, rc0);
        s[t][j][1] = div_rn(s[t][j][1], l0, rc0);
        s[t][j][2] = div_rn(s[t][j][2], l1, rc1);
        s[t][j][3] = div_rn(s[t][j][3], l1, rc1);
      }
      stage_tile<T, FULL>(sp_w, PS, s[t], t, rows, lane);  // round(P), for dV
    }
  }

  cp_async_wait<0>();
  __syncthreads();

  // D of the thread's rows g and g + 8 (0 past L)
  float dd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + (lane >> 2) + 8 * half;
    float x = 0.f;
    if constexpr (ANY) {
      if (row < L)
        x = row_dot_any<T>(sg + row * RS,
                           static_cast<const T*>(a.out) + b * a.o_sb + row * a.o_sl + col, lane & 3,
                           hd);
    } else {
      if (FULL || row < L)
        x = row_dot<T, HD>(sg + row * RS,
                           static_cast<const T*>(a.out) + b * a.o_sb + row * a.o_sl + col, lane & 3,
                           hd);
    }
    dd[half] = quad_sum(x);
  }

  // dP = dO_w . V^T per 64-key tile, then dS = P * (dP - D) at kept keys
  DsRegs<T> ds;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (FULL || t < nt) {
      float dp[1][8][4];
      score_tiles<T, HD, 1, FULL>(dp, sg + r0 * RS, sv + t * kKeyTile * RS, 1, L - t * kKeyTile,
                                  lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool k0 = (kept >> (16 * t + 2 * j)) & 1u, k1 = (kept >> (16 * t + 2 * j + 1)) & 1u;
        s[t][j][0] = k0 ? s[t][j][0] * (dp[0][j][0] - dd[0]) : 0.f;
        s[t][j][1] = k1 ? s[t][j][1] * (dp[0][j][1] - dd[0]) : 0.f;
        s[t][j][2] = k0 ? s[t][j][2] * (dp[0][j][2] - dd[1]) : 0.f;
        s[t][j][3] = k1 ? s[t][j][3] * (dp[0][j][3] - dd[1]) : 0.f;
      }
      hold(ds, t, s[t]);
    }
  }

  // dQ_w = scale * dS . K
  float dq[NO][4] = {};
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (FULL || t < nt)
      ds_times_k<HD, FULL>(dq, ds, t, sk + t * kKeyTile * RS, L - t * kKeyTile, lane);
  }
  __syncthreads();  // every warp is done with K and V: their rows stage outputs
  if constexpr (ANY)
    write_rows_any<T, HD>(sk + r0 * RS, dq, a.scale, static_cast<T*>(a.dq) + b * L * D + col, D, r0, L,
                          hd, a.vb, lane);
  else
    write_rows<T, HD, FULL>(sk + r0 * RS, dq, a.scale, static_cast<T*>(a.dq) + b * L * D + col, D, r0,
                            L, hd, lane);

  // dV = round(P)^T . dO for the warp's 16 keys
  float dv[NO][4] = {};
  keys_product<HD, FULL>(dv, sp, PS, sg, r0, L, lane);
  if constexpr (ANY)
    write_rows_any<T, HD>(sv + r0 * RS, dv, 1.f, static_cast<T*>(a.dv) + b * L * D + col, D, r0, L,
                          hd, a.vb, lane);
  else
    write_rows<T, HD, FULL>(sv + r0 * RS, dv, 1.f, static_cast<T*>(a.dv) + b * L * D + col, D, r0,
                            L, hd, lane);
  __syncthreads();  // every warp is done with round(P): the buffer takes dS
  stage_ds<FULL>(sp_w, PS, ds, nt, rows, lane);
  __syncthreads();

  // dK = scale * dS^T . Q for the warp's 16 keys
  float dk[NO][4] = {};
  keys_product<HD, FULL>(dk, sp, PS, sq, r0, L, lane);
  if constexpr (ANY)
    write_rows_any<T, HD>(sk + r0 * RS, dk, a.scale, static_cast<T*>(a.dk) + b * L * D + col, D, r0, L,
                          hd, a.vb, lane);
  else
    write_rows<T, HD, FULL>(sk + r0 * RS, dk, a.scale, static_cast<T*>(a.dk) + b * L * D + col, D, r0,
                            L, hd, lane);
}

// ---------------------------------------------------------------------------
// The two-pass route
// ---------------------------------------------------------------------------
//
// Two kernels on the tensor cores, templated on the column-block width W,
// so that one design serves attention_short_bwd.cu (16-byte copies, hd <=
// 128 in W = kernel_width(hd): one block) and attention_any.cu (any copy
// width; a head wider than 128 in ncb = col_blocks(hd) blocks of W =
// any_width(hd)). Each block has 4 warps, one per 16 rows of a 64-row tile:
//   attention_two_pass_dq: one block per (batch row, head, 64 query rows,
//     output column block ob). The 64-key K and V tiles stream through a
//     ring of shared slots, two where they fit (the next step's cp.async
//     under this step's products), in steps of one key tile and one column
//     block. Pass 1 folds S = Q . K^T (tp_scores: score_tiles' products,
//     the column blocks' k-steps summed into the same registers in column
//     order, the forward's order) tile by tile with fold_tile, exactly as
//     the forward, forms D = rowsum(dO * O) on the tensor cores in dP's own
//     products (the diagonal of dO . O^T), and writes the row max, the row
//     sum and D to the [3, B, H, L] f32 stats scratch. Pass 2 recomputes S
//     and P = exp(S - m) / l (div_rn: the forward's bits), dP = dO . V^T
//     and dS = P * (dP - D), 0 at masked
//     keys, and adds dS . K_ob with dS as the A operand straight from the
//     accumulators (the fused route's C -> A step, ds_times_k).
//   attention_two_pass_dkv: one block per (batch row, head, 64 keys, output
//     column block). The query tiles stream through the same kind of ring;
//     each warp recomputes S and dP for its 16 query rows of the tile
//     against the block's 64 keys (the same instructions as the dQ pass, so
//     the same P), P from the stats, then round(P) and dS are staged in turn
//     in one 64 x 64 shared buffer and each warp adds, for its 16 keys, dV
//     += round(P)^T . dO and dK += dS^T . Q (keys_product: bf16 reads the
//     transposed operand with ldmatrix.trans).
// Heads wider than 128 (ncb > 1): a grid over output column blocks, each
// block recomputing S and dP over every column block (ncb + 1 score passes
// of the dQ pass, ncb of the dK/dV pass), with each column block of a
// streamed tile staged once per step. Why: the accumulators of one output
// block (16 rows x W, f32: W / 2 registers a thread, twice that for dK and
// dV) already take half of a thread's 255 registers at W = 128 (the W =
// 128 kernels use 202-255), so a block holding every output column of a
// 256-wide head would spill. The recomputation is what the f32 head of
// 256 pays most for (PERF.md, PR 19). The block's own
// tiles (Q and dO of the dQ pass, K and V of the dK/dV pass) are then
// staged per column block in the ring too, and the output block's tile (K
// for dQ; Q and dO for dK and dV) rides with the tile's last column block.
// No atomics and no sums across blocks: the result is deterministic, and a
// text's gradient has the same bits in any batch. bf16 rounds P for dV and
// dS for dQ and dK; f32 runs every product in 3xTF32; sums are in f32.

constexpr int kTpRows = 64;                    // query rows (dQ) or keys (dK/dV) per block
constexpr int kTpThreads = kTpRows / 16 * 32;  // one warp per 16 of them

// Bytes of one shared 64-row tile of one column block, rows padded by 16
// bytes.
template <typename T, int W>
__host__ __device__ constexpr size_t tp_tile_bytes() {
  return (size_t)kTpRows * (W + chunk<T>()) * sizeof(T);
}

// Shared bytes of one block at `slots` ring slots; mirrored by
// ops/attention_kernel.py::_two_pass_geometry. dQ: Q and dO (ncb == 1) or
// K of the output block (ncb > 1), then per slot K and V (and Q and dO of
// the step's column block when ncb > 1) and the tile's 64 f32 fills. dK/dV:
// K and V (ncb == 1) or Q and dO of the output block, per slot Q and dO
// (and K and V), the 64 x 64 staging buffer and the block's 64 fills.
template <typename T, int W>
__host__ __device__ constexpr size_t dq_pass_bytes(int ncb, int slots) {
  return (size_t)(ncb == 1 ? 2 + 2 * slots : 1 + 4 * slots) * tp_tile_bytes<T, W>() +
         (size_t)slots * kKeyTile * sizeof(float);
}
template <typename T, int W>
__host__ __device__ constexpr size_t dkv_pass_bytes(int ncb, int slots) {
  return (size_t)(ncb == 1 ? 2 + 2 * slots : 2 + 4 * slots) * tp_tile_bytes<T, W>() +
         (size_t)kTpRows * (kKeyTile + chunk<T>()) * sizeof(T) + kKeyTile * sizeof(float);
}

// Two ring slots (the next step's copy under this step's products) where
// they fit and leave as many blocks an SM as one slot would, up to the
// blocks the kernels' registers allow (three at widths up to 64: 127-168
// registers a thread; two above: 202-255); else one, and the other blocks'
// products cover this block's copies. 4 warps a block hide too little
// alone: one slot ran bf16 in column blocks of 128 (157,184 B and 183,552
// B at two slots) 1.71x faster, the f32 dK/dV pass at width 64 1.59x, the
// f32 dQ pass at width 64 (three blocks, not two) 1.30x
// (tools/backward_ablation.py; PERF.md, PR 19). An SM holds 233,472 B of
// shared memory, 1,024 B of it reserved per block.
__host__ __device__ constexpr int tp_blocks_per_sm(size_t bytes) { return (int)(233472 / (bytes + 1024)); }
__host__ __device__ constexpr int tp_slots(size_t two, size_t one, int cap) {
  const int want = tp_blocks_per_sm(one) < cap ? tp_blocks_per_sm(one) : cap;
  return two <= (size_t)kSmemLimit && tp_blocks_per_sm(two) >= want ? 2 : 1;
}
template <typename T, int W>
__host__ __device__ constexpr int dq_slots(int ncb) {
  return tp_slots(dq_pass_bytes<T, W>(ncb, 2), dq_pass_bytes<T, W>(ncb, 1), W <= 64 ? 3 : 2);
}
template <typename T, int W>
__host__ __device__ constexpr int dkv_slots(int ncb) {
  return tp_slots(dkv_pass_bytes<T, W>(ncb, 2), dkv_pass_bytes<T, W>(ncb, 1), W <= 64 ? 3 : 2);
}

// s (16 rows x 64 keys) += Q_w . K^T over one column block of width W:
// score_tiles<T, W, 1, false, true>'s loads, skips and products, each
// score's mma.sync in the same order (so S keeps the forward's bits), with
// the k-steps unrolled 4 at a time rather than in full: fully unrolled,
// the f32 kernels ran 1.34x slower at 3 heads of 256 (width 128) and 1.12x
// at 1,024 keys (tools/backward_ablation.py; PERF.md, PR 19).
template <typename T, int W>
__device__ __forceinline__ void tp_scores(float (&s)[1][8][4], const T* sq_w, const T* sk, int valid,
                                          int lane) {
  constexpr int C = chunk<T>();
  constexpr int RS = W + C;
#pragma unroll 4
  for (int kk = 0; kk < W / (2 * C); ++kk) {
    uint32_t x[4];
    ldsm_x4(x, sq_w + (lane & 15) * RS + kk * 2 * C + (lane >> 4) * C);
    const typename Mma<T>::A a = Mma<T>::operand(x);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int key = jp * 16;
      if (key < valid) {
        uint32_t b[4];
        ldsm_x4(b, sk + (key + (lane & 7) + ((lane >> 4) << 3)) * RS + kk * 2 * C + ((lane >> 3) & 1) * C);
        Mma<T>::run(s[0][2 * jp], a, b[0], b[1]);
        if (key + 8 < valid) Mma<T>::run(s[0][2 * jp + 1], a, b[2], b[3]);
      }
    }
  }
}

// f32 products of the dK/dV pass at widths up to 64: the 3xTF32 products of
// keys_product, but its (at most 8) accumulators take their three TF32
// passes in turn (a_small . b_big for every accumulator, then a_big .
// b_small, then a_big . b_big) where Mma<float>::run issues one
// accumulator's three back to back. Each accumulator sees run's order, so
// the sums have run's bits; the dK/dV pass at width 64 ran up to 1.14x
// faster (tools/backward_ablation.py; PERF.md, PR 19). Above 64 the 16
// accumulators' split operands would not fit beside the 202-255
// registers those kernels use: keys_product stays.
template <int N>
__device__ __forceinline__ void mma3(float (*c)[4], const Mma<float>::A& a, const Tf32Pair (&b0)[N],
                                     const Tf32Pair (&b1)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.small, b0[n].big, b1[n].big);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.big, b0[n].small, b1[n].small);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.big, b0[n].big, b1[n].big);
}

// o (16 keys x W) += B^T . X over the query rows < L of the staging buffer
// (keys_product<W, false>).
template <int W>
__device__ __forceinline__ void tp_keys_product(float (&o)[W / 8][4], const bf16* sp, int PS, const bf16* sx,
                                                int key0, int L, int lane) {
  keys_product<W, false>(o, sp, PS, sx, key0, L, lane);
}
template <int W>
__device__ __forceinline__ void tp_keys_product(float (&o)[W / 8][4], const float* sp, int PS, const float* sx,
                                                int key0, int L, int lane) {
  if constexpr (W > 64) {
    keys_product<W, false>(o, sp, PS, sx, key0, L, lane);
  } else {
    constexpr int RS = W + chunk<float>();
    const int g = lane >> 2, tq = lane & 3;
    const int steps = (L + 7) / 8;
#pragma unroll 1
    for (int kk = 0; kk < steps; ++kk) {
      const float* p0 = sp + (kk * 8 + 2 * tq) * PS + key0 + g;
      const uint32_t x[4] = {__float_as_uint(p0[0]), __float_as_uint(p0[8]), __float_as_uint(p0[PS]),
                             __float_as_uint(p0[PS + 8])};
      const Mma<float>::A a = Mma<float>::operand(x);
      const float* x0 = sx + (kk * 8 + 2 * tq) * RS + g;
      Tf32Pair b0[W / 8], b1[W / 8];
#pragma unroll
      for (int n = 0; n < W / 8; ++n) {
        b0[n] = split_tf32(__float_as_uint(x0[8 * n]));
        b1[n] = split_tf32(__float_as_uint(x0[RS + 8 * n]));
      }
      mma3<W / 8>(o, a, b0, b1);
    }
  }
}

// D of the warp's rows g and g + 8 (lane / 4 = g) from the diagonal of the
// 16 x 16 product dO_w . O_w^T, which score_tiles took with the warp's 16 O
// rows as its keys: row g's entry sits in lane 4g + g / 2 (column g of the
// first 8-key group), row g + 8's in the same lane (column g of the second).
// (Each element picked by a select: a runtime index would put x in local
// memory.)
__device__ __forceinline__ void diag_rows(const float (&x)[1][8][4], float (&d)[2], int lane) {
  const int g = lane >> 2, src = 4 * g + (g >> 1);
  const bool odd = g & 1;
  d[0] = __shfl_sync(0xffffffffu, odd ? x[0][0][1] : x[0][0][0], src);
  d[1] = __shfl_sync(0xffffffffu, odd ? x[0][1][3] : x[0][1][2], src);
}

// P = exp(s - m) / l in place (the forward's exp_tile and div_rn), rows g
// and g + 8 of the C layout; a row that is not real (v0, v1 false) gets 0.
__device__ __forceinline__ void prob_tile(float (&s)[8][4], float m0, float m1, float l0, float l1,
                                          bool v0, bool v1) {
  exp_tile(s, m0, m1);
  const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = v0 ? div_rn(s[j][0], l0, r0) : 0.f;
    s[j][1] = v0 ? div_rn(s[j][1], l0, r0) : 0.f;
    s[j][2] = v1 ? div_rn(s[j][2], l1, r1) : 0.f;
    s[j][3] = v1 ? div_rn(s[j][3], l1, r1) : 0.f;
  }
}

// dS = P * (dP - D) in place at the kept keys of the tile (fill 0), 0 at
// masked keys and past L; d0, d1: D of rows g and g + 8.
__device__ __forceinline__ void ds_tile(float (&p)[8][4], const float (&dp)[8][4], const float* sf,
                                        float d0, float d1, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 f = *reinterpret_cast<const float2*>(sf + 8 * j + 2 * (lane & 3));
    p[j][0] = f.x == 0.f ? p[j][0] * (dp[j][0] - d0) : 0.f;
    p[j][1] = f.y == 0.f ? p[j][1] * (dp[j][1] - d0) : 0.f;
    p[j][2] = f.x == 0.f ? p[j][2] * (dp[j][2] - d1) : 0.f;
    p[j][3] = f.y == 0.f ? p[j][3] * (dp[j][3] - d1) : 0.f;
  }
}

__device__ __forceinline__ void clear_tile(float (&s)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
}

// COLS: the head may take more than one column block (attention_any.cu);
// without it ncb is the constant 1 (attention_short_bwd.cu), so the ring's
// slot count and the step arithmetic fold at compile time: the bf16 dK/dV
// pass at width 64 ran 1.41x faster with them constant
// (tools/backward_ablation.py; PERF.md, PR 19).
template <typename T, int W, bool COLS>
__global__ void __launch_bounds__(kTpThreads) attention_two_pass_dq(Args a) {
  constexpr int RS = W + chunk<T>();
  constexpr int TILE = kTpRows * RS;  // elements of one shared tile
  constexpr int NO = W / 8;

  const long long b = blockIdx.x;
  const int L = a.L, hd = a.hd;
  const int ncb = COLS ? (hd + W - 1) / W : 1;
  const int ob = blockIdx.z % ncb;
  const int q0 = blockIdx.z / ncb * kTpRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = (L + kKeyTile - 1) / kKeyTile;
  const int per_pass = nt * ncb, steps = 2 * per_pass;
  const int slots = dq_slots<T, W>(ncb);
  const int per_slot = ncb == 1 ? 2 : 4;
  const long long col = (long long)blockIdx.y * hd;
  const T* qh = static_cast<const T*>(a.q) + b * a.q_sb + col;
  const T* kh = static_cast<const T*>(a.k) + b * a.k_sb + col;
  const T* vh = static_cast<const T*>(a.v) + b * a.v_sb + col;
  const T* gh = static_cast<const T*>(a.dout) + b * a.g_sb + col;
  const T* oh = static_cast<const T*>(a.out) + b * a.o_sb + col;
  const uint8_t* mrow = a.mask + b * a.m_sb;

  // (its own name: the other kernels of a source declare theirs)
  extern __shared__ __align__(16) unsigned char smem_tp[];
  T* own = reinterpret_cast<T*>(smem_tp);     // ncb == 1: Q, dO; else K of the output block
  T* ring = own + (ncb == 1 ? 2 : 1) * TILE;  // slots x (K, V[, Q, dO])
  float* fills = reinterpret_cast<float*>(ring + slots * per_slot * TILE);  // slots x 64

  // Step st < per_pass is pass 1 on key tile st / ncb, column block st %
  // ncb; step per_pass + r is pass 2 on the same. A step's fills are
  // written with its last column block (read after the step's barrier).
  // Pass 1's steps on key tile 0 also stage the column block's O rows in
  // V's place (and, with ncb > 1, its dO rows), for D.
  auto issue = [&](int st) {
    const bool p2 = st >= per_pass;
    const int r = p2 ? st - per_pass : st;
    const int t = r / ncb, cb = r % ncb;
    const int c0 = cb * W, w = min(W, hd - c0);
    T* sl = ring + (st % slots) * per_slot * TILE;
    load_rows_any<T, W>(sl, kh + c0, a.k_sl, t * kKeyTile, kKeyTile, L, w, a.vb);
    if (p2) load_rows_any<T, W>(sl + TILE, vh + c0, a.v_sl, t * kKeyTile, kKeyTile, L, w, a.vb);
    if (!p2 && t == 0) load_rows_any<T, W>(sl + TILE, oh + c0, a.o_sl, q0, kTpRows, L, w, a.vb);
    if (ncb > 1) {
      load_rows_any<T, W>(sl + 2 * TILE, qh + c0, a.q_sl, q0, kTpRows, L, w, a.vb);
      if (p2 || t == 0) load_rows_any<T, W>(sl + 3 * TILE, gh + c0, a.g_sl, q0, kTpRows, L, w, a.vb);
      if (p2 && cb == ncb - 1 && ob != cb)
        load_rows_any<T, W>(own, kh + ob * W, a.k_sl, t * kKeyTile, kKeyTile, L, min(W, hd - ob * W), a.vb);
    }
    if (cb == ncb - 1) fill_tile(fills + (st % slots) * kKeyTile, mrow, t * kKeyTile, L);
  };

  if (ncb == 1) {
    load_rows_any<T, W>(own, qh, a.q_sl, q0, kTpRows, L, hd, a.vb);
    load_rows_any<T, W>(own + TILE, gh, a.g_sl, q0, kTpRows, L, hd, a.vb);
  }
  issue(0);
  cp_async_commit();

  const int row0 = q0 + warp * 16;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float dq[NO][4] = {};
  float s[1][8][4], dp[1][8][4];
  float dd_acc[1][8][4], dd[2] = {0.f, 0.f};  // D of the thread's rows g and g + 8 (0 past L)
  for (int st = 0; st < steps; ++st) {
    if (slots == 2 && st + 1 < steps) issue(st + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bool p2 = st >= per_pass;
    const int r = p2 ? st - per_pass : st;
    const int t = r / ncb, cb = r % ncb;
    const int slot = st % slots;
    const T* sl = ring + slot * per_slot * TILE;
    const T* sq_w = (ncb == 1 ? own : sl + 2 * TILE) + warp * 16 * RS;
    const T* sg_w = (ncb == 1 ? own + TILE : sl + 3 * TILE) + warp * 16 * RS;
    const int valid = L - t * kKeyTile;
    if (cb == 0) {
      clear_tile(s[0]);
      clear_tile(dp[0]);
    }
    tp_scores<T, W>(s, sq_w, sl, valid, lane);
    if (p2) tp_scores<T, W>(dp, sg_w, sl + TILE, valid, lane);
    if (!p2 && t == 0) {
      // D = rowsum(dO * O) on the tensor cores, the warp's 16 O rows (in
      // V's place) as its keys: the products, column blocks and order of
      // dP, so dP - D cancels exactly where the two agree (a row with one
      // kept key has O = V of that key: its dS is 0, as the plain version's)
      if (cb == 0) clear_tile(dd_acc[0]);
      tp_scores<T, W>(dd_acc, sg_w, sl + TILE + warp * 16 * RS, 16, lane);
      if (cb == ncb - 1) diag_rows(dd_acc, dd, lane);
    }
    if (cb == ncb - 1) {
      const float* sf = fills + slot * kKeyTile;
      mask_tile(s[0], sf, a.scale, lane);
      if (!p2) {
        fold_tile<false>(s[0], m0, m1, l0, l1);
        if (t == nt - 1) {
          l0 = quad_sum(l0);
          l1 = quad_sum(l1);
          // the statistics the dK/dV pass reads (every output block has the
          // same; the first writes them)
          if (ob == 0 && (lane & 3) == 0) {
            const long long plane = a.B * (long long)a.H * L;
            float* srow = a.stats + (b * a.H + blockIdx.y) * (long long)L;
            const int g = row0 + (lane >> 2);
            if (g < L) {
              srow[g] = m0;
              srow[plane + g] = l0;
              srow[2 * plane + g] = dd[0];
            }
            if (g + 8 < L) {
              srow[g + 8] = m1;
              srow[plane + g + 8] = l1;
              srow[2 * plane + g + 8] = dd[1];
            }
          }
        }
      } else {
        prob_tile(s[0], m0, m1, l0, l1, true, true);
        ds_tile(s[0], dp[0], sf, dd[0], dd[1], lane);
        DsRegs<T> ds;
        hold(ds, 0, s[0]);
        ds_times_k<W, false>(dq, ds, 0, ncb == 1 || ob == cb ? sl : own, valid, lane);
      }
    }
    __syncthreads();  // every warp is done with the slot: the next copy may refill it
    if (slots == 1 && st + 1 < steps) {
      issue(st + 1);
      cp_async_commit();
    }
  }

  // the warp's 16 rows of this output block leave through its own rows of
  // the first tile
  const long long D = (long long)a.H * hd;
  write_rows_any<T, W>(own + warp * 16 * RS, dq, a.scale, static_cast<T*>(a.dq) + b * L * D + col + ob * W,
                       D, row0, L, min(W, hd - ob * W), a.vb, lane);
}

template <typename T, int W, bool COLS>
__global__ void __launch_bounds__(kTpThreads) attention_two_pass_dkv(Args a) {
  constexpr int C = chunk<T>();
  constexpr int RS = W + C;
  constexpr int TILE = kTpRows * RS;
  constexpr int PS = kKeyTile + C;  // row stride of the staging buffer
  constexpr int NO = W / 8;

  const long long b = blockIdx.x;
  const int L = a.L, hd = a.hd;
  const int ncb = COLS ? (hd + W - 1) / W : 1;
  const int ob = blockIdx.z % ncb;
  const int k0 = blockIdx.z / ncb * kTpRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int steps = (L + kTpRows - 1) / kTpRows * ncb;
  const int slots = dkv_slots<T, W>(ncb);
  const int per_slot = ncb == 1 ? 2 : 4;
  const long long col = (long long)blockIdx.y * hd;
  const T* qh = static_cast<const T*>(a.q) + b * a.q_sb + col;
  const T* kh = static_cast<const T*>(a.k) + b * a.k_sb + col;
  const T* vh = static_cast<const T*>(a.v) + b * a.v_sb + col;
  const T* gh = static_cast<const T*>(a.dout) + b * a.g_sb + col;
  const long long plane = a.B * (long long)a.H * L;
  const float* srow = a.stats + (b * a.H + blockIdx.y) * (long long)L;

  extern __shared__ __align__(16) unsigned char smem_tp[];
  T* own = reinterpret_cast<T*>(smem_tp);  // ncb == 1: K, V; else Q and dO of the output block
  T* ring = own + 2 * TILE;                // slots x (Q, dO[, K, V])
  T* sp = ring + slots * per_slot * TILE;  // [64 queries][PS]: round(P), then dS
  float* fills = reinterpret_cast<float*>(sp + kTpRows * PS);  // the block's 64 keys

  // Step st: query tile st / ncb, column block st % ncb.
  auto issue = [&](int st) {
    const int u = st / ncb, cb = st % ncb;
    const int c0 = cb * W, w = min(W, hd - c0);
    T* sl = ring + (st % slots) * per_slot * TILE;
    load_rows_any<T, W>(sl, qh + c0, a.q_sl, u * kTpRows, kTpRows, L, w, a.vb);
    load_rows_any<T, W>(sl + TILE, gh + c0, a.g_sl, u * kTpRows, kTpRows, L, w, a.vb);
    if (ncb > 1) {
      load_rows_any<T, W>(sl + 2 * TILE, kh + c0, a.k_sl, k0, kTpRows, L, w, a.vb);
      load_rows_any<T, W>(sl + 3 * TILE, vh + c0, a.v_sl, k0, kTpRows, L, w, a.vb);
      if (cb == ncb - 1 && ob != cb) {
        const int wo = min(W, hd - ob * W);
        load_rows_any<T, W>(own, qh + ob * W, a.q_sl, u * kTpRows, kTpRows, L, wo, a.vb);
        load_rows_any<T, W>(own + TILE, gh + ob * W, a.g_sl, u * kTpRows, kTpRows, L, wo, a.vb);
      }
    }
  };

  if (ncb == 1) {
    load_rows_any<T, W>(own, kh, a.k_sl, k0, kTpRows, L, hd, a.vb);
    load_rows_any<T, W>(own + TILE, vh, a.v_sl, k0, kTpRows, L, hd, a.vb);
  }
  issue(0);
  cp_async_commit();
  fill_tile(fills, a.mask + b * a.m_sb, k0, L);

  float dk[NO][4] = {}, dv[NO][4] = {};
  float s[1][8][4], dp[1][8][4];
  for (int st = 0; st < steps; ++st) {
    if (slots == 2 && st + 1 < steps) issue(st + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int u = st / ncb, cb = st % ncb;
    const T* sl = ring + (st % slots) * per_slot * TILE;
    const T* sk = ncb == 1 ? own : sl + 2 * TILE;
    const T* sv = ncb == 1 ? own + TILE : sl + 3 * TILE;
    if (cb == 0) {
      clear_tile(s[0]);
      clear_tile(dp[0]);
    }
    tp_scores<T, W>(s, sl + warp * 16 * RS, sk, L - k0, lane);
    tp_scores<T, W>(dp, sl + TILE + warp * 16 * RS, sv, L - k0, lane);
    if (cb == ncb - 1) {
      // the row statistics of the warp's rows g and g + 8 of this query tile
      const int g = u * kTpRows + warp * 16 + (lane >> 2);
      const bool v0 = g < L, v1 = g + 8 < L;
      const float m0 = v0 ? srow[g] : 0.f, m1 = v1 ? srow[g + 8] : 0.f;
      const float l0 = v0 ? srow[plane + g] : 1.f, l1 = v1 ? srow[plane + g + 8] : 1.f;
      const float d0 = v0 ? srow[2 * plane + g] : 0.f, d1 = v1 ? srow[2 * plane + g + 8] : 0.f;
      mask_tile(s[0], fills, a.scale, lane);
      prob_tile(s[0], m0, m1, l0, l1, v0, v1);
      T* sp_w = sp + warp * 16 * PS;
      stage_tile<T, false>(sp_w, PS, s[0], 0, kKeyTile, lane);  // round(P), for dV
      ds_tile(s[0], dp[0], fills, d0, d1, lane);
      __syncthreads();
      const bool here = ncb == 1 || ob == cb;  // the output block's Q and dO are the step's
      const int rows = min(kTpRows, L - u * kTpRows);
      tp_keys_product<W>(dv, sp, PS, here ? sl + TILE : own + TILE, warp * 16, rows, lane);
      __syncthreads();  // every warp is done with round(P): the buffer takes dS
      stage_tile<T, false>(sp_w, PS, s[0], 0, kKeyTile, lane);
      __syncthreads();
      tp_keys_product<W>(dk, sp, PS, here ? sl : own, warp * 16, rows, lane);
    }
    __syncthreads();
    if (slots == 1 && st + 1 < steps) {
      issue(st + 1);
      cp_async_commit();
    }
  }

  const long long D = (long long)a.H * hd;
  const int row0 = k0 + warp * 16, wo = min(W, hd - ob * W);
  write_rows_any<T, W>(own + warp * 16 * RS, dk, a.scale, static_cast<T*>(a.dk) + b * L * D + col + ob * W,
                       D, row0, L, wo, a.vb, lane);
  write_rows_any<T, W>(own + TILE + warp * 16 * RS, dv, 1.f,
                       static_cast<T*>(a.dv) + b * L * D + col + ob * W, D, row0, L, wo, a.vb, lane);
}

// The dQ pass, then the dK/dV pass, on `stream`; a.stats is the f32
// scratch of 3 * B * H * L, a.vb the copy width. Any L >= 1; hd <= W, or
// with COLS any hd >= 1 (ncb = ceil(hd / W) column blocks).
template <typename T, int W, bool COLS>
cudaError_t launch_two_pass(const Args& a, cudaStream_t stream) {
  if (a.L < 1 || a.hd < 1 || !a.stats || (!COLS && a.hd > W)) return cudaErrorInvalidValue;
  const int ncb = COLS ? (a.hd + W - 1) / W : 1;
  const size_t dq_bytes = dq_pass_bytes<T, W>(ncb, dq_slots<T, W>(ncb));
  const size_t dkv_bytes = dkv_pass_bytes<T, W>(ncb, dkv_slots<T, W>(ncb));
  if (dq_bytes > (size_t)kSmemLimit || dkv_bytes > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_two_pass_dq<T, W, COLS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_two_pass_dkv<T, W, COLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)a.B, (unsigned)a.H, (unsigned)((a.L + kTpRows - 1) / kTpRows * ncb));
  attention_two_pass_dq<T, W, COLS><<<grid, kTpThreads, dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_two_pass_dkv<T, W, COLS><<<grid, kTpThreads, dkv_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
