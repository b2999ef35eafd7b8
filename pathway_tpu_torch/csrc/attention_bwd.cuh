// Device code of the attention backward (attention_short_bwd.cu; design,
// bound and routes in its header note): the fused route's kernel
// attention_bwd_fused and the two-pass route's bwd_dq and bwd_dkv with
// their helpers. attention_short_bwd.cu instantiates them for 16-byte
// copies; attention_any.cu instantiates the fused kernel at any copy width
// (ANY) and builds the column-blocked two-pass kernels from the helpers.

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
  int vb;  // the fused route's copy width in bytes (16 unless ANY)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// The probability as the forward multiplies it with v: rounded to T.
template <typename T>
__device__ __forceinline__ float rounded(float p) { return to_f32(from_f32<T>(p)); }


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

  // (its own name: the two-pass kernels declare `smem` as float)
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

constexpr int kTile = 32;      // query rows and key rows per tile
constexpr int kThreads = 256;  // 8 warps
constexpr float kMaskFill = -1e30f;

// Shared tile [kTile][HD + 1] of f32 loaded from rows row0.. of a strided
// [B, L, D] tensor at batch b and column offset col; rows >= L and columns
// >= hd are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long b, int row0,
                                          int L, long long sb, long long sl, int col, int hd) {
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int row = row0 + r;
    dst[r * (HD + 1) + d] =
        row < L && d < hd ? to_f32(src[b * sb + (long long)row * sl + col + d]) : 0.0f;
  }
}

// s[i][j] = sum_d a[i][d] * c[j][d] for the thread's 4 entries of a 32 x 32
// tile: row i = tid / 8, columns j = tid % 8 + 8 * u.
template <int HD>
__device__ __forceinline__ void dot_rows(const float* a, const float* c, float acc[4]) {
  const int i = threadIdx.x >> 3, j0 = threadIdx.x & 7;
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = 0.0f;
  for (int d = 0; d < HD; ++d) {
    const float x = a[i * (HD + 1) + d];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] = fmaf(x, c[(j0 + 8 * u) * (HD + 1) + d], acc[u]);
  }
}

// dot_rows without clearing acc: the column blocks of a head wider than one
// block add into the same scores, each column in order.
template <int HD>
__device__ __forceinline__ void dot_rows_acc(const float* a, const float* c, float acc[4]) {
  const int i = threadIdx.x >> 3, j0 = threadIdx.x & 7;
  for (int d = 0; d < HD; ++d) {
    const float x = a[i * (HD + 1) + d];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] = fmaf(x, c[(j0 + 8 * u) * (HD + 1) + d], acc[u]);
  }
}

// acc[u] += sum_j w[r][j] * c[j][d] for the thread's row r = tid / 8 and
// columns d = tid % 8 + 8 * u of a 32 x HD tile; transpose_w reads w[j][r].
template <int HD, bool kTransposeW>
__device__ __forceinline__ void accum_rows(const float* w, const float* c, float* acc) {
  const int r = threadIdx.x >> 3, d0 = threadIdx.x & 7;
  for (int j = 0; j < kTile; ++j) {
    const float x = kTransposeW ? w[j * (kTile + 1) + r] : w[r * (kTile + 1) + j];
#pragma unroll
    for (int u = 0; u < HD / 8; ++u) acc[u] = fmaf(x, c[j * (HD + 1) + d0 + 8 * u], acc[u]);
  }
}

template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* dst, const float* acc, long long b, int row0,
                                           int L, int D, int col, int hd, float mul) {
  const int r = threadIdx.x >> 3, d0 = threadIdx.x & 7;
  const int row = row0 + r;
  if (row >= L) return;
  T* p = dst + (b * L + row) * (long long)D + col;
#pragma unroll
  for (int u = 0; u < HD / 8; ++u)
    if (d0 + 8 * u < hd) p[d0 + 8 * u] = from_f32<T>(acc[u] * mul);
}



template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) bwd_dq(Args a) {
  extern __shared__ float smem[];
  constexpr int kRow = HD + 1;
  float* Qs = smem;                 // [32][HD + 1]
  float* Gs = Qs + kTile * kRow;    // dO
  float* Ks = Gs + kTile * kRow;
  float* Vs = Ks + kTile * kRow;
  float* Ss = Vs + kTile * kRow;    // [32][33]: scores, then dS
  float* m_row = Ss + kTile * (kTile + 1);
  float* l_row = m_row + kTile;
  float* d_row = l_row + kTile;
  float* keep = d_row + kTile;      // 1 for a kept key of the tile, 0 masked, -1 past L

  const long long b = blockIdx.x;
  const int h = blockIdx.y, L = a.L, H = a.H, hd = a.hd, D = H * hd, col = h * hd;
  const int q0 = blockIdx.z * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.out);
  const T* g = static_cast<const T*>(a.dout);

  load_tile<T, HD>(Qs, q, b, q0, L, a.q_sb, a.q_sl, col, hd);
  load_tile<T, HD>(Gs, g, b, q0, L, a.g_sb, a.g_sl, col, hd);
  __syncthreads();
  // D_i = rowsum(dO * O): warp w takes rows w, w + 8, ...
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int row = q0 + r;
    float s = 0.0f;
    if (row < L)
      for (int d = lane; d < hd; d += 32)
        s = fmaf(Gs[r * kRow + d], to_f32(o[b * a.o_sb + (long long)row * a.o_sl + col + d]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      d_row[r] = s;
      m_row[r] = -CUDART_INF_F;
      l_row[r] = 0.0f;
    }
  }
  const int n_tiles = (L + kTile - 1) / kTile;
  const int ti = threadIdx.x >> 3, tj = threadIdx.x & 7;
  float acc[4];

  // pass 1: row max and rescaled row sum over the key tiles
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, HD>(Ks, k, b, k0, L, a.k_sb, a.k_sl, col, hd);
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      keep[threadIdx.x] = key < L ? (a.mask[b * a.m_sb + key] ? 1.0f : 0.0f) : -1.0f;
    }
    __syncthreads();
    dot_rows<HD>(Qs, Ks, acc);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tj + 8 * u;
      const float kp = keep[j];
      Ss[ti * (kTile + 1) + j] =
          kp > 0.5f ? acc[u] * a.scale : (kp == 0.0f ? kMaskFill : -CUDART_INF_F);
    }
    __syncthreads();
    for (int r = warp; r < kTile; r += kThreads / 32) {
      const float s = Ss[r * (kTile + 1) + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_row[r], mx);
      float e = s == -CUDART_INF_F ? 0.0f : expf(s - m_new);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
      __syncwarp();
      if (lane == 0) {
        const float m_old = m_row[r];
        l_row[r] = (m_old == -CUDART_INF_F ? 0.0f : l_row[r] * expf(m_old - m_new)) + e;
        m_row[r] = m_new;
      }
    }
  }
  __syncthreads();
  // the statistics the dK/dV kernel reads
  if (threadIdx.x < kTile && q0 + threadIdx.x < L) {
    const long long at = ((b * H + h) * (long long)L) + q0 + threadIdx.x;
    const long long plane = a.B * (long long)H * L;
    a.stats[at] = m_row[threadIdx.x];
    a.stats[plane + at] = l_row[threadIdx.x];
    a.stats[2 * plane + at] = d_row[threadIdx.x];
  }

  // pass 2: dS and dQ
  float dq[HD / 8];
#pragma unroll
  for (int u = 0; u < HD / 8; ++u) dq[u] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, HD>(Ks, k, b, k0, L, a.k_sb, a.k_sl, col, hd);
    load_tile<T, HD>(Vs, v, b, k0, L, a.v_sb, a.v_sl, col, hd);
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      keep[threadIdx.x] = key < L ? (a.mask[b * a.m_sb + key] ? 1.0f : 0.0f) : -1.0f;
    }
    __syncthreads();
    float dp[4];
    dot_rows<HD>(Qs, Ks, acc);
    dot_rows<HD>(Gs, Vs, dp);
    const float m = m_row[ti], l = l_row[ti], dd = d_row[ti];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tj + 8 * u;
      const float kp = keep[j];
      const float s = kp > 0.5f ? acc[u] * a.scale : kMaskFill;
      const float p = kp < 0.0f ? 0.0f : expf(s - m) / l;
      Ss[ti * (kTile + 1) + j] = kp > 0.5f ? p * (dp[u] - dd) : 0.0f;
    }
    __syncthreads();
    accum_rows<HD, false>(Ss, Ks, dq);
  }
  store_rows<T, HD>(static_cast<T*>(a.dq), dq, b, q0, L, D, col, hd, a.scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) bwd_dkv(Args a) {
  extern __shared__ float smem[];
  constexpr int kRow = HD + 1;
  float* Ks = smem;
  float* Vs = Ks + kTile * kRow;
  float* Qs = Vs + kTile * kRow;
  float* Gs = Qs + kTile * kRow;
  float* Ps = Gs + kTile * kRow;        // [32 queries][33]: round(P)
  float* Ds = Ps + kTile * (kTile + 1); // [32 queries][33]: dS
  float* m_row = Ds + kTile * (kTile + 1);
  float* l_row = m_row + kTile;
  float* d_row = l_row + kTile;
  float* keep = d_row + kTile;

  const long long b = blockIdx.x;
  const int h = blockIdx.y, L = a.L, H = a.H, hd = a.hd, D = H * hd, col = h * hd;
  const int k0 = blockIdx.z * kTile;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.dout);
  const long long plane = a.B * (long long)H * L;
  const long long base = (b * H + h) * (long long)L;

  load_tile<T, HD>(Ks, k, b, k0, L, a.k_sb, a.k_sl, col, hd);
  load_tile<T, HD>(Vs, v, b, k0, L, a.v_sb, a.v_sl, col, hd);
  if (threadIdx.x < kTile) {
    const int key = k0 + threadIdx.x;
    keep[threadIdx.x] = key < L ? (a.mask[b * a.m_sb + key] ? 1.0f : 0.0f) : -1.0f;
  }
  // the score tile here is [query i][key j] with i = tid / 8, j = tid % 8 + 8u
  const int ti = threadIdx.x >> 3, tj = threadIdx.x & 7;
  float dk[HD / 8], dv[HD / 8];
#pragma unroll
  for (int u = 0; u < HD / 8; ++u) dk[u] = dv[u] = 0.0f;
  const int n_tiles = (L + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    load_tile<T, HD>(Qs, q, b, q0, L, a.q_sb, a.q_sl, col, hd);
    load_tile<T, HD>(Gs, g, b, q0, L, a.g_sb, a.g_sl, col, hd);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool in = row < L;
      m_row[threadIdx.x] = in ? a.stats[base + row] : 0.0f;
      l_row[threadIdx.x] = in ? a.stats[plane + base + row] : 1.0f;
      d_row[threadIdx.x] = in ? a.stats[2 * plane + base + row] : 0.0f;
    }
    __syncthreads();
    float s[4], dp[4];
    dot_rows<HD>(Qs, Ks, s);
    dot_rows<HD>(Gs, Vs, dp);
    const bool row_in = q0 + ti < L;
    const float m = m_row[ti], l = l_row[ti], dd = d_row[ti];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tj + 8 * u;
      const float kp = keep[j];
      const float sc = kp > 0.5f ? s[u] * a.scale : kMaskFill;
      const float p = (kp < 0.0f || !row_in) ? 0.0f : expf(sc - m) / l;
      Ps[ti * (kTile + 1) + j] = rounded<T>(p);
      Ds[ti * (kTile + 1) + j] = kp > 0.5f ? p * (dp[u] - dd) : 0.0f;
    }
    __syncthreads();
    // dV[j] += sum_i round(P)[i][j] dO[i]; dK[j] += sum_i dS[i][j] Q[i]
    accum_rows<HD, true>(Ps, Gs, dv);
    accum_rows<HD, true>(Ds, Qs, dk);
  }
  store_rows<T, HD>(static_cast<T*>(a.dk), dk, b, k0, L, D, col, hd, a.scale);
  store_rows<T, HD>(static_cast<T*>(a.dv), dv, b, k0, L, D, col, hd, 1.0f);
}

template <int HD>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (HD + 1) + kTile * (kTile + 1) + 4 * kTile) * 4;
}
template <int HD>
constexpr int dkv_smem_bytes() {
  return (4 * kTile * (HD + 1) + 2 * kTile * (kTile + 1) + 4 * kTile) * 4;
}

}  // namespace
