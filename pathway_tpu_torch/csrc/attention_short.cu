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
// One kernel (attention_tc_kernel<T, HD, RESIDENT, EXACT>) on the tensor cores,
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
//   - L > 128 (any length): an exact softmax in two passes over 64-key
//     tiles staged through a double-buffered ring (the next tile's copy,
//     and its 64 key fills, overlap this tile's products). Pass 1 keeps a
//     running row max and rescaled sum; pass 2 recomputes the scores,
//     normalises with the final max and sum, rounds and accumulates
//     probs . v. Shared memory does not grow with L: the per-key fill
//     (0, -1e30 or -inf) rides in the ring with its K tile.
// Both fold the row sum tile by tile in the same order (fold_tile), so a row
// gets the same bits whatever length its launch is padded to: a text alone
// (L = 128, resident) and in a batch (L = 256, streamed) embed alike.
// Key columns past L (tile padding) score -inf, not -1e30, so a fully masked
// row averages the L real keys only. Shared memory per block: (rows + 2 x 128
// key rows) x (HD x size + 16) bytes and 128 f32 fills; f32 at HD = 128
// takes ~199 KB (one block per SM), at HD = 64 ~103 KB (two), at any L.
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
// Supported here: bf16 or f32, any head width hd up to 128 whose q/k/v
// rows, head offsets (h * hd elements) and pointers are 16-byte aligned (hd
// a multiple of 8 in bf16, of 4 in f32, on the encoder's [B, L, 3D]
// projection), any L >= 1. Every other head (a width whose rows are not
// 16-byte aligned, or wider than 128) runs in attention_any.cu, which the
// Python wrapper picks from the pointers, the strides and hd
// (ops/attention_kernel.py::launch_geometry). The kernel is instantiated at
// HD = 16, 32, ..., 128 (template parameter), each twice: EXACT for
// hd == HD, with the column count a constant, and for hd < HD. A head of hd
// columns runs in HD = kernel_width(hd), hd rounded up to 16: columns
// hd .. HD - 1 of Q, K and V are zero-filled in shared memory (load_rows)
// and never stored, so they add exactly 0 to q . k^T and leave the scores'
// bits alone; the scale is hd^-0.5 of the real width (the caller's). At
// HD = 16 Q . K^T is one m16n8k16 k-step in bf16 (two m16n8k8 in f32) and
// P . V two n8 tiles; at HD = 48, 80, 96 and 112, HD / 16 k-steps and
// ldmatrix.x4.trans reads of V, each covering 16 columns. A shared row is
// HD / 8 + 1 (bf16) or HD / 4 + 1 (f32) 16-byte units, an odd number at
// every HD, so the 8 rows of an ldmatrix hit 32 distinct banks. The Python
// wrapper checks all of it and computes the launch geometry (rows per
// block, shared bytes) with the same formulas as the launcher below. The
// copies, ldmatrix, the products, score_tiles, fold_tile, the tile steps
// (mask_tile, pv_tile, fill_tile) and div_rn live in attention_tc.cuh,
// which the backward (attention_short_bwd.cu) and attention_any.cu include
// too.

// ---------------------------------------------------------------------------
// Device code (both routes)
// ---------------------------------------------------------------------------

#include "attention_tc.cuh"

namespace {

constexpr int kResidentLen = 2 * kKeyTile;  // L up to which K and V stay resident

// Shared bytes of one block; mirrored by ops/attention_kernel.py::launch_geometry:
// the Q rows, K and V (resident) or their 2-tile rings (streaming), in rows
// padded by 16 bytes, and one f32 fill per key of the resident tiles or of
// the ring's two tiles: at most 128 keys, whatever L is.
__host__ __device__ __forceinline__ int tc_kv_rows(int L) {
  return L <= kKeyTile ? kKeyTile : 2 * kKeyTile;
}
template <typename T, int HD>
__host__ __device__ __forceinline__ size_t tc_smem_bytes(int rows, int L) {
  return (size_t)(rows + 2 * tc_kv_rows(L)) * (HD + chunk<T>()) * sizeof(T) +
         (size_t)tc_kv_rows(L) * sizeof(float);
}

// Two blocks per SM where their shared memory allows it (every bf16 case,
// f32 up to HD = 64), which caps a thread at 128 registers; f32 at HD = 80
// and above takes 126-199 KB of shared memory, so one block, and the
// registers it needs.
// EXACT: hd == HD (every width of the main path), so the column count is a
// constant and every column test compiles away; without it the block ran
// ~4% slower at embed in bf16 (PERF.md, the widened kernels' findings).
template <typename T, int HD, bool RESIDENT, bool EXACT>
__global__ void __launch_bounds__(kMaxRows / 16 * 32, (sizeof(T) == 2 || HD <= 64) ? 2 : 1)
attention_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    T* __restrict__ out, int L, int H, int hd_arg, long long q_sb, long long q_sl,
                    long long k_sb, long long k_sl, long long v_sb, long long v_sl,
                    long long m_sb, float scale) {
  static_assert(HD % 16 == 0 && HD <= 128, "HD must be a multiple of 16 up to 128");
  const int hd = EXACT ? HD : hd_arg;
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
  float* sf = reinterpret_cast<float*>(sv + kv_rows * RS);  // [kv_rows]: fill per key

  const long long col = (long long)h * hd;
  const T* kh = k + b * k_sb + col;
  const T* vh = v + b * v_sb + col;
  const uint8_t* mrow = mask + b * m_sb;
  T* sq_w = sq + warp * 16 * RS;

  load_rows<T, HD>(sq, q + b * q_sb + col, q_sl, row0, rows, L, hd);
  load_rows<T, HD>(sk, kh, k_sl, 0, RESIDENT ? nt * kKeyTile : kKeyTile, L, hd);
  cp_async_commit();
  if constexpr (RESIDENT) {
    // every tile's fills in one pass of the block (two fill_tile passes cost
    // 2% at embed in bf16)
    for (int j = threadIdx.x; j < nt * kKeyTile; j += blockDim.x)
      sf[j] = j >= L ? -CUDART_INF_F : mrow[j] ? 0.f : -1e30f;
  } else {
    fill_tile(sf, mrow, 0, L);  // tile 0's, in ring slot 0
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  if constexpr (RESIDENT) {
    // V's copy runs while the scores and the softmax are computed.
    load_rows<T, HD>(sv, vh, v_sl, 0, nt * kKeyTile, L, hd);
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
    // for step st + 1 is in flight while step st computes, and its tile's
    // fills are written to the same slot (read after the next barrier; the
    // slot's last reader was step st - 1, before the barrier ending it).
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f, r0 = 0.f, r1 = 0.f;
    for (int st = 0; st < 2 * nt; ++st) {
      if (st + 1 < 2 * nt) {
        const int tn = st + 1 < nt ? st + 1 : st + 1 - nt;
        const int slot = (st + 1) & 1;
        load_rows<T, HD>(sk + slot * kKeyTile * RS, kh, k_sl, tn * kKeyTile, kKeyTile, L, hd);
        if (st + 1 >= nt)
          load_rows<T, HD>(sv + slot * kKeyTile * RS, vh, v_sl, tn * kKeyTile, kKeyTile, L, hd);
        fill_tile(sf + slot * kKeyTile, mrow, tn * kKeyTile, L);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();

      const int t = st < nt ? st : st - nt;
      const int slot = st & 1;
      float s[1][8][4];
      score_tiles<T, HD, 1>(s, sq_w, sk + slot * kKeyTile * RS, 1, L - t * kKeyTile, lane);
      mask_tile(s[0], sf + slot * kKeyTile, scale, lane);
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
  // write the rows < L, columns < hd, to device memory in 16-byte pieces.
  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    store2(sq_w + g * RS + 8 * n + c2, o[n][0], o[n][1]);
    store2(sq_w + (g + 8) * RS + 8 * n + c2, o[n][2], o[n][3]);
  }
  __syncwarp();
  const long long D = (long long)H * hd;
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR;
    const int c = (i % CPR) * C;
    const int row = row0 + warp * 16 + r;
    if (row < L && c < hd)
      *reinterpret_cast<uint4*>(out + (b * L + row) * D + col + c) =
          *reinterpret_cast<const uint4*>(sq_w + r * RS + c);
  }
}

template <typename T, int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* mask, void* out,
                      long long B, int L, int H, int hd, int rows, long long q_sb, long long q_sl,
                      long long k_sb, long long k_sl, long long v_sb, long long v_sl,
                      long long m_sb, float scale, cudaStream_t stream) {
  if (rows % 16 || rows < 16 || rows > kMaxRows) return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes<T, HD>(rows, L);
  const bool exact = hd == HD;
  auto kern = L <= kResidentLen
                  ? (exact ? attention_tc_kernel<T, HD, true, true> : attention_tc_kernel<T, HD, true, false>)
                  : (exact ? attention_tc_kernel<T, HD, false, true> : attention_tc_kernel<T, HD, false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B, (unsigned)H, (unsigned)((L + rows - 1) / rows));
  kern<<<grid, rows * 2, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), L, H, hd, q_sb, q_sl, k_sb, k_sl,
      v_sb, v_sl, m_sb, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* mask,
                   void* out, long long B, int L, int H, int hd, int rows, long long q_sb,
                   long long q_sl, long long k_sb, long long k_sl, long long v_sb,
                   long long v_sl, long long m_sb, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_tc<float, HD>(q, k, v, mask, out, B, L, H, hd, rows, q_sb, q_sl, k_sb, k_sl,
                                v_sb, v_sl, m_sb, scale, stream);
  if (dtype == 1)
    return launch_tc<bf16, HD>(q, k, v, mask, out, B, L, H, hd, rows, q_sb, q_sl, k_sb, k_sl,
                               v_sb, v_sl, m_sb, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32 (3xTF32
// route), 1 = bfloat16. `rows` is the query rows per block from
// launch_geometry. Strides are in elements and every row, head offset and
// pointer 16-byte aligned; `out` is a contiguous [B, L, H * hd] tensor. Returns the launch's cudaError_t (0 = success).
extern "C" int pw_attention_short_flat(int dtype, int hd, const void* q, const void* k,
                                       const void* v, const void* mask, void* out,
                                       long long B, int L, int H, int rows, long long q_sb,
                                       long long q_sl, long long k_sb, long long k_sl,
                                       long long v_sb, long long v_sl, long long m_sb,
                                       float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > 128 || L < 1) return (int)cudaErrorInvalidValue;
#define PW_CASE(HD)                                                                            \
  case HD:                                                                                     \
    return (int)launch<HD>(dtype, q, k, v, mask, out, B, L, H, hd, rows, q_sb, q_sl, k_sb,    \
                           k_sl, v_sb, v_sl, m_sb, scale, s);
  switch (kernel_width(hd)) {
    PW_CASE(16)
    PW_CASE(32)
    PW_CASE(48)
    PW_CASE(64)
    PW_CASE(80)
    PW_CASE(96)
    PW_CASE(112)
    PW_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PW_CASE
}
