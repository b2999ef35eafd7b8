// Masked multi-head attention for short sequences, flat [B, L, D] layout.
//
// Replaces the JAX package's Pallas TPU kernel
// pathway_tpu/ops/attention_kernel.py::_attention_short_impl. Heads are
// hd-wide column slices of the flat activation (no [B, H, L, hd] transpose);
// per head:
//   scores = q . k^T * scale            (f32 accumulation)
//   masked keys -> -1e30                (finite: a fully masked row gives mean(v))
//   probs  = exp(s - max) / sum         (f32), THEN rounded to the input type
//   ctx    = probs . v                  (f32 accumulation), stored as the input type
// The probabilities are normalised before they are rounded, exactly as the
// reference does. An online (flash) softmax that normalises at the end would
// round at another place, so the kernel does not use one.
//
// One kernel (attention_tc_kernel<T, HD, RESIDENT>) on the tensor cores,
// with two routes by input type T that share the tiling, the copies, the
// softmax and the division, and differ only in the products:
//
// bf16: mma.sync.m16n8k16 bf16 -> f32, operands from ldmatrix (.trans for V).
// f32 ("3xTF32"): mma.sync.m16n8k8 tf32 -> f32 on split operands. One TF32
// product keeps 10 mantissa bits of each operand and misses the f32 contract
// (rtol = atol = 1e-5); the split product does not: x = big + small with
// big = rna_tf32(x) and small = rna_tf32(x - big) (x - big is exact), and
// a . b ~ a_small . b_big + a_big . b_small + a_big . b_big, the two cross
// terms accumulated before big . big (the order of CUTLASS's
// OpMultiplyAddFastF32, which PyTorch's f32 SDPA uses). The dropped
// small . small term is ~2^-22 of a product. Both products (q . k^T and
// probs . v) are split; q and k come from ldmatrix like bf16 (an 8 x 8 b16
// matrix is an 8 x 4 f32 block), v by 32-bit shared loads.
//
// Geometry: one block per (batch row, head, tile of up to 128 query rows),
// one warp per 16 query rows. q/k/v are read straight from the strided qkv
// projection (row stride 3D) with cp.async into shared memory whose rows are
// padded by 16 bytes (ldmatrix and the f32 V loads then hit 32 distinct
// banks); key rows >= L are zero-filled. The score accumulator is turned, in
// registers, into the A operand of probs . v, so the probs never touch
// shared or device memory (bf16: the m16n8k16 C layout of two 8-key groups
// is the A layout; f32: the m16n8k8 C fragment holds keys 2t, 2t + 1 of a
// group where A wants t, t + 4, so the k index is permuted: logical k = t is
// key 2t and k = t + 4 is key 2t + 1, A = (c0, c2, c1, c3) with no data
// movement, and the V fragment reads rows 2t and 2t + 1).
//   - L <= 128 (every shape on the main path): K and V of the (b, h) fit in
//     shared memory at once. K (with Q) and V are two async copy groups, so
//     V's copy overlaps the score products and the softmax. Each warp keeps
//     its 16 x L score rows in registers (two 64-key tiles), folds them into
//     the row max and sum as pass 1 below does, normalises, rounds, and
//     multiplies by V.
//   - 128 < L <= 512: an exact softmax in two passes over 64-key tiles
//     staged through a double-buffered ring (the next tile's copy overlaps
//     this tile's products). Pass 1 keeps a running row max and rescaled
//     sum; pass 2 recomputes the scores, normalises with the final max and
//     sum, rounds and accumulates probs . v.
// Both fold the row sum tile by tile in the same order (fold_tile), so a row
// gets the same bits whatever length its launch is padded to: a text alone
// (L = 128, resident) and in a batch (L = 256, streamed) embed alike.
// Key columns past L (tile padding) score -inf, not -1e30, so a fully masked
// row averages the L real keys only. Shared memory per block: (rows + 2 x 128
// key rows) x (HD x size + 16) bytes; f32 at HD = 128 takes ~199 KB (one
// block per SM), at HD = 64 ~103 KB (two).
//
// Bound on an H100 SXM (3.35 TB/s HBM; dense 989 TFLOP/s bf16, 495 TF32).
// One call must read q, k, v and the mask and write ctx: 4 * B * L * D
// elements + B * L bytes; its work is 4 * B * L^2 * D FLOP, three times that
// on the tensor cores in 3xTF32.
//   embed  (B=1024, L=128, D=384), bf16: 403 MB -> 0.120 ms; 25.8 GFLOP ->
//          0.026 ms: bytes-bound.
//   embed, f32: 805 MB -> 0.240 ms; 3 x 25.8 GFLOP of TF32 -> 0.156 ms:
//          bytes-bound (on the FP32 pipes, 67 TFLOP/s, the same work would
//          need 0.385 ms).
//   query  (B=1,    L=16):  49 KB (bf16) -> 15 ns: bound in practice by the
//          launch (a few microseconds).
//   rerank (B=10,   L=128 on the main path, 256 at most): 3.9 MB (bf16) ->
//          1.2 us: bytes-bound, a handful of blocks.
// What the design does about it: q, k, v are read from device memory once
// per block (once per (b, h) at L <= 128), ctx is written once through
// shared memory in 16-byte rows, and no [B, H, L, L] tensor exists. The
// products run on the tensor cores (at L <= 128 one pass of 4 * B * L^2 * D
// FLOP; above, pass 2 recomputes the scores: +50%). What is left on the
// other pipes per score is one expf (two above 128 keys, and for the first
// tile of 65-128: the sum's fold, then the numerator), a correctly rounded
// division (one reciprocal per row, then a product and two FMAs per prob)
// and a few operations, plus, in f32, the splits (two conversions and a
// subtraction per operand element, each warp splitting the K and V it
// reads).
//
// Supported: bf16 or f32, HD in {32, 64, 128} (template parameter),
// L <= 512, rows of q/k/v 16-byte aligned. The Python wrapper checks all of
// it and computes the launch geometry (rows per block, shared bytes) with
// the same formulas as the launcher below. The copies, ldmatrix, the
// products, score_tiles, fold_tile and div_rn live in attention_tc.cuh,
// which the backward (attention_short_bwd.cu) includes too.

// ---------------------------------------------------------------------------
// Device code (both routes)
// ---------------------------------------------------------------------------

#include "attention_tc.cuh"

namespace {

constexpr int kResidentLen = 2 * kKeyTile;  // L up to which K and V stay resident

// Scale and mask a score tile: s = s * scale + f per key column, where the
// fill f is 0 for a kept key, -1e30 for a masked key and -inf for a padding
// column past L. Exact: s * scale + 0 is the reference's product, and a
// score's |s * scale| is far below half an ulp of 1e30 (2^75), so a masked
// key scores exactly -1e30.
__device__ __forceinline__ void mask_tile(float (&s)[8][4], const float* sf_t, float scale,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 f = *reinterpret_cast<const float2*>(sf_t + 8 * j + 2 * (lane & 3));
    s[j][0] = fmaf(s[j][0], scale, f.x);
    s[j][1] = fmaf(s[j][1], scale, f.y);
    s[j][2] = fmaf(s[j][2], scale, f.x);
    s[j][3] = fmaf(s[j][3], scale, f.y);
  }
}

// o (16 rows x HD, f32) += P . V_t for one 64-key shared V tile, with
// P = e / l (rows lane/4 and lane/4 + 8: l0, l1 and their reciprocals r0,
// r1), normalised, then rounded to T. 16-key (bf16) or 8-key (f32) steps
// past `valid` are skipped (their probs are 0 and their V rows zero).
template <typename T, int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 8][4], const float (&e)[8][4], float l0,
                                        float l1, float r0, float r1, const T* sv_t, int valid,
                                        int lane) {
  constexpr int RS = HD + chunk<T>();
  if constexpr (std::is_same_v<T, bf16>) {
    // pa[kk] covers keys 16kk .. 16kk + 15: the C layout of the two 8-key
    // groups 2kk, 2kk + 1 is exactly the m16n8k16 A layout.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* c = e[2 * kk + half];
        pa[kk][2 * half] = pack_bf16(div_rn(c[0], l0, r0), div_rn(c[1], l0, r0));
        pa[kk][2 * half + 1] = pack_bf16(div_rn(c[2], l1, r1), div_rn(c[3], l1, r1));
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk * 16 < valid) {
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t b[4];
          // B = V (keys x dims), transposed: keys (0-7 | 8-15) x dims 16dp + (0-7 | 8-15)
          ldsm_x4_trans(b, sv_t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                               dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], pa[kk], b[0], b[1]);
          mma_bf16(o[2 * dp + 1], pa[kk], b[2], b[3]);
        }
      }
    }
  } else {
    // Per 8-key group kk, the C fragment (keys 2t, 2t + 1) is the m16n8k8 A
    // fragment with the k index permuted (k = t: key 2t; k = t + 4: key
    // 2t + 1): A = (c0, c2, c1, c3), and B reads V rows 2t and 2t + 1 at
    // column g. With rows padded to HD + 4 floats, lane (g, t) reads bank
    // 8t + g (+4): the 32 lanes hit 32 banks.
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk * 8 < valid) {
        const float* c = e[kk];
        const uint32_t p[4] = {
            __float_as_uint(div_rn(c[0], l0, r0)), __float_as_uint(div_rn(c[2], l1, r1)),
            __float_as_uint(div_rn(c[1], l0, r0)), __float_as_uint(div_rn(c[3], l1, r1))};
        const Mma<float>::A a = Mma<float>::operand(p);
        const float* v0 = sv_t + (kk * 8 + 2 * tq) * RS + g;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          Mma<float>::run(o[n], a, __float_as_uint(v0[8 * n]), __float_as_uint(v0[RS + 8 * n]));
      }
    }
  }
}

// Shared bytes of one block; mirrored by ops/attention_kernel.py::launch_geometry:
// the Q rows, K and V (resident) or their 2-tile rings (streaming), in rows
// padded by 16 bytes, and one f32 fill per key.
__host__ __device__ __forceinline__ int tc_kv_rows(int L) {
  return L <= kKeyTile ? kKeyTile : 2 * kKeyTile;
}
template <typename T, int HD>
__host__ __device__ __forceinline__ size_t tc_smem_bytes(int rows, int L) {
  const int nt = (L + kKeyTile - 1) / kKeyTile;
  return (size_t)(rows + 2 * tc_kv_rows(L)) * (HD + chunk<T>()) * sizeof(T) +
         (size_t)nt * kKeyTile * sizeof(float);
}

// Two blocks per SM where their shared memory allows it (every bf16 case,
// f32 up to HD = 64), which caps a thread at 128 registers; f32 at HD = 128
// takes ~199 KB of shared memory, so one block, and the registers it needs.
template <typename T, int HD, bool RESIDENT>
__global__ void __launch_bounds__(kMaxRows / 16 * 32, (sizeof(T) == 2 || HD <= 64) ? 2 : 1)
attention_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    T* __restrict__ out, int L, int H, long long q_sb, long long q_sl,
                    long long k_sb, long long k_sl, long long v_sb, long long v_sl,
                    long long m_sb, float scale) {
  static_assert(HD % 32 == 0 && HD <= 128, "HD must be 32, 64 or 128");
  constexpr int C = chunk<T>();
  constexpr int RS = HD + C;
  constexpr int NO = HD / 8;  // 8-column groups of the output
  constexpr int CPR = HD / C;  // 16-byte chunks per row

  const long long b = blockIdx.x;
  const int h = blockIdx.y;
  const int rows = blockDim.x / 2;  // 16 query rows per 32-thread warp
  const int row0 = blockIdx.z * rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nt = (L + kKeyTile - 1) / kKeyTile;
  const int kv_rows = tc_kv_rows(L);

  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);  // [rows][RS]; later the output rows
  T* sk = sq + rows * RS;              // [kv_rows][RS]: K, or a 2-tile ring of K
  T* sv = sk + kv_rows * RS;           // [kv_rows][RS]: V, or a 2-tile ring of V
  float* sf = reinterpret_cast<float*>(sv + kv_rows * RS);  // [nt * 64] fill per key

  const T* kh = k + b * k_sb + (long long)h * HD;
  const T* vh = v + b * v_sb + (long long)h * HD;
  T* sq_w = sq + warp * 16 * RS;

  load_rows<T, HD>(sq, q + b * q_sb + (long long)h * HD, q_sl, row0, rows, L);
  load_rows<T, HD>(sk, kh, k_sl, 0, RESIDENT ? nt * kKeyTile : kKeyTile, L);
  cp_async_commit();
  for (int j = threadIdx.x; j < nt * kKeyTile; j += blockDim.x) {
    sf[j] = j >= L ? -CUDART_INF_F : mask[b * m_sb + j] ? 0.f : -1e30f;
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  if constexpr (RESIDENT) {
    // V's copy runs while the scores and the softmax are computed.
    load_rows<T, HD>(sv, vh, v_sl, 0, nt * kKeyTile, L);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[2][8][4];
    score_tiles<T, HD, 2>(s, sq_w, sk, nt, L, lane);
    // the streaming route's pass 1, tile by tile; the last tile's max is the
    // final one, so its exponentials are kept, and a first tile of two is
    // exponentiated again with the final max
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
    mask_tile(s[0], sf, scale, lane);
    if (nt == 2) {
      fold_tile<false>(s[0], m0, m1, l0, l1);
      mask_tile(s[1], sf + kKeyTile, scale, lane);
      fold_tile<true>(s[1], m0, m1, l0, l1);
      exp_tile(s[0], m0, m1);
    } else {
      fold_tile<true>(s[0], m0, m1, l0, l1);
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);

    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t < nt)
        pv_tile<T, HD>(o, s[t], l0, l1, r0, r1, sv + t * kKeyTile * RS, L - t * kKeyTile,
                       lane);
    }
  } else {
    // Two passes over nt >= 3 key tiles through a 2-slot ring: step st < nt
    // is pass 1 on tile st, step st >= nt pass 2 on tile st - nt; the copy
    // for step st + 1 is in flight while step st computes.
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f, r0 = 0.f, r1 = 0.f;
    for (int st = 0; st < 2 * nt; ++st) {
      if (st + 1 < 2 * nt) {
        const int tn = st + 1 < nt ? st + 1 : st + 1 - nt;
        const int slot = (st + 1) & 1;
        load_rows<T, HD>(sk + slot * kKeyTile * RS, kh, k_sl, tn * kKeyTile, kKeyTile, L);
        if (st + 1 >= nt)
          load_rows<T, HD>(sv + slot * kKeyTile * RS, vh, v_sl, tn * kKeyTile, kKeyTile, L);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();

      const int t = st < nt ? st : st - nt;
      const int slot = st & 1;
      float s[1][8][4];
      score_tiles<T, HD, 1>(s, sq_w, sk + slot * kKeyTile * RS, 1, L - t * kKeyTile, lane);
      mask_tile(s[0], sf + t * kKeyTile, scale, lane);
      if (st < nt) {
        fold_tile<false>(s[0], m0, m1, l0, l1);
        if (st == nt - 1) {
          l0 = quad_sum(l0);
          l1 = quad_sum(l1);
          r0 = __frcp_rn(l0);
          r1 = __frcp_rn(l1);
        }
      } else {
        exp_tile(s[0], m0, m1);
        pv_tile<T, HD>(o, s[0], l0, l1, r0, r1, sv + slot * kKeyTile * RS, L - t * kKeyTile, lane);
      }
      __syncthreads();  // the slot is refilled by the next step's copy
    }
  }

  // Stage the warp's 16 output rows in its own (consumed) Q rows, then
  // write the rows < L to device memory in 16-byte pieces.
  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    store2(sq_w + g * RS + 8 * n + c2, o[n][0], o[n][1]);
    store2(sq_w + (g + 8) * RS + 8 * n + c2, o[n][2], o[n][3]);
  }
  __syncwarp();
  const long long D = (long long)H * HD;
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR;
    const int c = (i % CPR) * C;
    const int row = row0 + warp * 16 + r;
    if (row < L)
      *reinterpret_cast<uint4*>(out + (b * L + row) * D + (long long)h * HD + c) =
          *reinterpret_cast<const uint4*>(sq_w + r * RS + c);
  }
}

template <typename T, int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* mask, void* out,
                      long long B, int L, int H, int rows, long long q_sb, long long q_sl,
                      long long k_sb, long long k_sl, long long v_sb, long long v_sl,
                      long long m_sb, float scale, cudaStream_t stream) {
  if (rows % 16 || rows < 16 || rows > kMaxRows) return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes<T, HD>(rows, L);
  auto kern =
      L <= kResidentLen ? attention_tc_kernel<T, HD, true> : attention_tc_kernel<T, HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B, (unsigned)H, (unsigned)((L + rows - 1) / rows));
  kern<<<grid, rows * 2, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), L, H, q_sb, q_sl, k_sb, k_sl,
      v_sb, v_sl, m_sb, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* mask,
                   void* out, long long B, int L, int H, int rows, long long q_sb,
                   long long q_sl, long long k_sb, long long k_sl, long long v_sb,
                   long long v_sl, long long m_sb, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_tc<float, HD>(q, k, v, mask, out, B, L, H, rows, q_sb, q_sl, k_sb, k_sl,
                                v_sb, v_sl, m_sb, scale, stream);
  if (dtype == 1)
    return launch_tc<bf16, HD>(q, k, v, mask, out, B, L, H, rows, q_sb, q_sl, k_sb, k_sl, v_sb,
                               v_sl, m_sb, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32 (3xTF32
// route), 1 = bfloat16. `rows` is the query rows per block from
// launch_geometry. Strides are in elements; `out` is a contiguous
// [B, L, H * hd] tensor. Returns the launch's cudaError_t (0 = success).
extern "C" int pw_attention_short_flat(int dtype, int hd, const void* q, const void* k,
                                       const void* v, const void* mask, void* out,
                                       long long B, int L, int H, int rows, long long q_sb,
                                       long long q_sl, long long k_sb, long long k_sl,
                                       long long v_sb, long long v_sl, long long m_sb,
                                       float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return (int)launch<32>(dtype, q, k, v, mask, out, B, L, H, rows, q_sb, q_sl, k_sb, k_sl,
                             v_sb, v_sl, m_sb, scale, s);
    case 64:
      return (int)launch<64>(dtype, q, k, v, mask, out, B, L, H, rows, q_sb, q_sl, k_sb, k_sl,
                             v_sb, v_sl, m_sb, scale, s);
    case 128:
      return (int)launch<128>(dtype, q, k, v, mask, out, B, L, H, rows, q_sb, q_sl, k_sb, k_sl,
                              v_sb, v_sl, m_sb, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
