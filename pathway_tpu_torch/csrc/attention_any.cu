// Masked short-sequence attention and its backward for every head the
// kernels of attention_short.cu and attention_short_bwd.cu do not take: a
// head whose rows, head offsets or pointers are not 16-byte aligned (a bf16
// head of 12 columns starts every 24 bytes; a [B, L, 3D] projection with
// D = 36 has rows of 216 bytes), and a head wider than 128 columns. Same
// flat [B, L, D] layout and the same arithmetic: f32 scores, masked keys
// filled with -1e30 (padding columns past L with -inf), an f32 softmax
// folded tile by tile in key order (fold_tile), normalised and then rounded
// to the input type, P . V summed in f32; the backward's dP, D, dS, dQ, dK
// and dV as attention_short_bwd.cu states them.
//
// Replaces, for those heads, the JAX package's Pallas TPU kernel
// pathway_tpu/ops/attention_kernel.py::_attention_short_impl (whose own
// envelope sends every head but hd % 64 == 0, L <= 128 to XLA's attention,
// pathway_tpu/ops/encoder.py::_sdpa, which takes any width) and, for the
// gradient, the backward of _sdpa that the reference gets from XLA.
//
// Bound on an H100 SXM: as the aligned kernels' (attention_short.cu,
// attention_short_bwd.cu): bytes-bound at every shape of the main path; a
// call must read q, k, v and the mask and write ctx, 4 * B * L * D elements
// (the backward 8 * B * L * D), and do 4 * B * L^2 * D FLOP (the backward
// 10 * B * H * L^2 * hd), three times that in TF32 products on the f32
// route.
//
// Copy width. The host (ops/attention_kernel.py::copy_width) picks the
// widest of 16, 8, 4 and 2 bytes that divides every pointer, row stride and
// hd * sizeof(T); load_rows_any copies 16, 8 and 4 bytes with cp.async and
// 2 bytes (a bf16 head of odd width, or rows at odd elements) with plain
// loads and stores, and the outputs leave in pieces of the same width
// (store_rows_any). Columns hd .. width - 1 of a block are zero-filled in
// shared memory, so they add exactly 0, as in the aligned kernels.
//
// Column blocks. A head runs in ncb = ceil(hd / 128) blocks of width W =
// any_width(hd) (instantiated at W = 16, 32, 64, 128; block j holds columns
// jW .. jW + W - 1): shared memory and registers do not grow with hd.
//   - Forward (attention_any_kernel<T, W>): one block per (batch row, head,
//     tile of up to 128 query rows), one warp per 16 query rows, K and V
//     streamed one 64-key tile at a time (shared memory for the rows, one
//     K tile and one V tile: f32 at W = 128 takes 135,424 B at 128 rows).
//     Q . K^T sums the k-steps of every column block into the same score
//     registers (score_tiles<ACC>), the Q and K blocks staged in turn. Pass
//     0 folds the row max and sum over the key tiles; pass 1 + j recomputes
//     the scores, normalises them with the final max and sum, and
//     accumulates P . V_j for output column block j, stored before the next
//     block. Choice: the scores are recomputed per output block rather than
//     P kept in shared memory: P of 128 rows at any L does not fit, and the
//     work of a wide head is bound by its bytes, not its products (ncb + 1
//     score passes in all; a 16-byte aligned head of at most 128 columns
//     keeps attention_short.cu's single score pass where L <= 128).
//   - Fused backward (attention_bwd_fused<T, W, false, true>, L <= 128,
//     hd <= 128): attention_short_bwd.cu's kernel with its copies at the
//     copy width (ANY).
//   - Two-pass backward (attention_two_pass_dq, attention_two_pass_dkv of
//     attention_bwd.cuh at block width W: any L, any copy width; hd > 128 in
//     column blocks): the scores and dP sum every column block's k-steps in
//     column order, and the grid covers the output column blocks (the grid's
//     third dimension is 64-row tiles x ncb), each block recomputing the
//     scores for its output block, for the same reason as the forward.
//
// Entry points (plain C, loaded with ctypes): pw_attention_any_flat and
// pw_attention_any_flat_backward. The Python wrapper picks this file's
// kernels from the shape, the pointers and the strides
// (ops/attention_kernel.py::launch_geometry, backward_launch_geometry) and
// computes the launch geometry with the same formulas (any_smem_bytes,
// fused_smem_bytes, dq_pass_bytes, dkv_pass_bytes).

#include "attention_bwd.cuh"
#include "attention_tc.cuh"

namespace {

// Shared bytes of one forward block; mirrored by
// ops/attention_kernel.py::launch_geometry: the Q rows of one column block,
// one K and one V tile of 64 keys, rows padded by 16 bytes, and the tile's
// 64 f32 fills.
template <typename T, int HD>
__host__ __device__ constexpr size_t any_smem_bytes(int rows) {
  return (size_t)(rows + 2 * kKeyTile) * (HD + chunk<T>()) * sizeof(T) +
         (size_t)kKeyTile * sizeof(float);
}

// Two blocks per SM where their shared memory allows it (every bf16 width,
// f32 up to 64), as the aligned forward.
template <typename T, int HD>
__global__ void __launch_bounds__(kMaxRows / 16 * 32, (sizeof(T) == 2 || HD <= 64) ? 2 : 1)
attention_any_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ mask, T* __restrict__ out, int L, int H, int hd,
                     int vb, long long q_sb, long long q_sl, long long k_sb, long long k_sl,
                     long long v_sb, long long v_sl, long long m_sb, float scale) {
  constexpr int C = chunk<T>();
  constexpr int RS = HD + C;
  constexpr int NO = HD / 8;  // 8-column groups of an output block

  const long long b = blockIdx.x;
  const int h = blockIdx.y;
  const int rows = blockDim.x / 2;  // 16 query rows per 32-thread warp
  const int row0 = blockIdx.z * rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nt = (L + kKeyTile - 1) / kKeyTile;
  const int ncb = (hd + HD - 1) / HD;

  // (its own name: attention_bwd.cuh's kernels declare theirs)
  extern __shared__ __align__(16) unsigned char smem_any[];
  T* sq = reinterpret_cast<T*>(smem_any);  // [rows][RS]: a column block of Q; then output rows
  T* sk = sq + rows * RS;                   // [64][RS]: a column block of one K tile
  T* sv = sk + kKeyTile * RS;               // [64][RS]: an output column block of one V tile
  float* sf = reinterpret_cast<float*>(sv + kKeyTile * RS);  // [64]: the tile's fills

  const long long col = (long long)h * hd;
  const T* qh = q + b * q_sb + col;
  const T* kh = k + b * k_sb + col;
  const T* vh = v + b * v_sb + col;
  const uint8_t* mrow = mask + b * m_sb;
  T* sq_w = sq + warp * 16 * RS;
  const long long D = (long long)H * hd;
  const int wrow0 = row0 + warp * 16;  // the warp's first query row

  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f, r0 = 0.f, r1 = 0.f;
  float o[NO][4];
  // pass 0: the row max and sum; pass 1 + ob: output column block ob
  for (int pass = 0; pass <= ncb; ++pass) {
    const int ob = pass - 1;
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    for (int t = 0; t < nt; ++t) {
      float s[1][8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[0][j][0] = s[0][j][1] = s[0][j][2] = s[0][j][3] = 0.f;
      for (int cb = 0; cb < ncb; ++cb) {
        const int c0 = cb * HD;
        // every warp is done with the tiles (and, a pass later, with the
        // output rows staged in Q's rows)
        __syncthreads();
        // one column block: Q once for the whole call, else Q's block anew
        if (ncb > 1 || (pass == 0 && t == 0))
          load_rows_any<T, HD>(sq, qh + c0, q_sl, row0, rows, L, min(HD, hd - c0), vb);
        load_rows_any<T, HD>(sk, kh + c0, k_sl, t * kKeyTile, kKeyTile, L, min(HD, hd - c0), vb);
        if (pass > 0 && cb == ncb - 1)
          load_rows_any<T, HD>(sv, vh + ob * HD, v_sl, t * kKeyTile, kKeyTile, L,
                               min(HD, hd - ob * HD), vb);
        if (cb == 0) fill_tile(sf, mrow, t * kKeyTile, L);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        score_tiles<T, HD, 1, false, true>(s, sq_w, sk, 1, L - t * kKeyTile, lane);
      }
      mask_tile(s[0], sf, scale, lane);
      if (pass == 0) {
        fold_tile<false>(s[0], m0, m1, l0, l1);
      } else {
        exp_tile(s[0], m0, m1);
        pv_tile<T, HD>(o, s[0], l0, l1, r0, r1, sv, L - t * kKeyTile, lane);
      }
    }
    if (pass == 0) {
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      r0 = __frcp_rn(l0);
      r1 = __frcp_rn(l1);
    } else {
      // stage the warp's 16 output rows of this block in its own Q rows,
      // then write rows < L, columns < the block's width, at the copy width
      const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        store2(sq_w + g * RS + 8 * n + c2, o[n][0], o[n][1]);
        store2(sq_w + (g + 8) * RS + 8 * n + c2, o[n][2], o[n][3]);
      }
      __syncwarp();
      store_rows_any<T, HD>(out + (b * L + wrow0) * D + col + ob * HD, D, sq_w, L - wrow0,
                            min(HD, hd - ob * HD), vb, lane);
      __syncwarp();
    }
  }
}

template <typename T, int HD>
cudaError_t launch_any(const void* q, const void* k, const void* v, const void* mask, void* out,
                       long long B, int L, int H, int hd, int vb, int rows, long long q_sb,
                       long long q_sl, long long k_sb, long long k_sl, long long v_sb,
                       long long v_sl, long long m_sb, float scale, cudaStream_t stream) {
  if (rows % 16 || rows < 16 || rows > kMaxRows) return cudaErrorInvalidValue;
  const size_t smem = any_smem_bytes<T, HD>(rows);
  cudaError_t err = cudaFuncSetAttribute(attention_any_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B, (unsigned)H, (unsigned)((L + rows - 1) / rows));
  attention_any_kernel<T, HD><<<grid, rows * 2, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), L, H, hd, vb, q_sb, q_sl, k_sb,
      k_sl, v_sb, v_sl, m_sb, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

template <typename T, int HD>
cudaError_t launch_fused_any(const Args& a, cudaStream_t stream) {
  if constexpr (!fused_fits<T, HD>()) {
    return cudaErrorInvalidValue;
  } else {
    if (a.L < 1 || a.L > kMaxRows || a.hd > HD) return cudaErrorInvalidValue;
    const int rows = (a.L + 15) / 16 * 16;
    const size_t smem = fused_smem_bytes<T, HD>(rows);
    auto kern = attention_bwd_fused<T, HD, false, true>;
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((unsigned)a.B, (unsigned)a.H), rows * 2, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

// A copy width the kernels take for dtype (0 = f32, 1 = bf16) and hd.
bool copy_width_ok(int dtype, int hd, int vb) {
  const int es = dtype == 0 ? 4 : 2;
  return (vb == 2 || vb == 4 || vb == 8 || vb == 16) && vb >= es && (hd * es) % vb == 0;
}

}  // namespace

// Plain C entry point of the forward (loaded with ctypes). dtype: 0 =
// float32 (3xTF32), 1 = bfloat16; vb: the copy width in bytes (16, 8, 4 or
// 2), dividing every pointer, row stride and hd * size; `rows` the query
// rows per block from launch_geometry. Strides are in elements; `out` is a
// contiguous [B, L, H * hd] tensor. Any hd >= 1 and L >= 1. Returns the
// launch's cudaError_t (0 = success).
extern "C" int pw_attention_any_flat(int dtype, int hd, int vb, const void* q, const void* k,
                                     const void* v, const void* mask, void* out, long long B,
                                     int L, int H, int rows, long long q_sb, long long q_sl,
                                     long long k_sb, long long k_sl, long long v_sb,
                                     long long v_sl, long long m_sb, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || L < 1 || (dtype != 0 && dtype != 1) || !copy_width_ok(dtype, hd, vb))
    return (int)cudaErrorInvalidValue;
#define PW_CASE(W)                                                                              \
  case W:                                                                                       \
    return (int)(dtype == 0 ? launch_any<float, W>(q, k, v, mask, out, B, L, H, hd, vb, rows,   \
                                                   q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, m_sb,    \
                                                   scale, s)                                    \
                            : launch_any<bf16, W>(q, k, v, mask, out, B, L, H, hd, vb, rows,    \
                                                  q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, m_sb,     \
                                                  scale, s));
  switch (any_width(hd)) {
    PW_CASE(16)
    PW_CASE(32)
    PW_CASE(64)
    PW_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PW_CASE
}

// Plain C entry point of the backward. As pw_attention_short_flat_backward
// (attention_short_bwd.cu), with the copy width vb: stats = null launches
// the fused route at any copy width (L <= 128, hd <= 128, where the block
// fits: every bf16 width, f32 up to a block width of 64); else the
// two-pass route at block width any_width(hd) (any hd and L; above 128
// columns in column blocks), stats an f32 scratch of 3 * B * H * L.
extern "C" int pw_attention_any_flat_backward(
    int dtype, int hd, int vb, const void* q, const void* k, const void* v, const void* mask,
    const void* out, const void* d_out, void* dq, void* dk, void* dv, void* stats, long long B,
    int L, int H, long long q_sb, long long q_sl, long long k_sb, long long k_sl,
    long long v_sb, long long v_sl, long long o_sb, long long o_sl, long long g_sb,
    long long g_sl, long long m_sb, float scale, void* stream) {
  Args a{q, k, v, static_cast<const uint8_t*>(mask), out, d_out, dq, dk, dv,
         static_cast<float*>(stats), B, L, H, hd, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb,
         o_sl, g_sb, g_sl, m_sb, scale, vb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || L < 1 || (dtype != 0 && dtype != 1) || !copy_width_ok(dtype, hd, vb))
    return (int)cudaErrorInvalidValue;
  if (stats) {
#define PW_CASE(W)                                                                              \
  case W:                                                                                       \
    return (int)(dtype == 0 ? launch_two_pass<float, W, true>(a, s) : launch_two_pass<bf16, W, true>(a, s));
    switch (any_width(hd)) {
      PW_CASE(16)
      PW_CASE(32)
      PW_CASE(64)
      PW_CASE(128)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef PW_CASE
  }
  if (hd > kMaxColBlock) return (int)cudaErrorInvalidValue;
  switch (any_width(hd)) {
    case 16:
      return (int)(dtype == 0 ? launch_fused_any<float, 16>(a, s) : launch_fused_any<bf16, 16>(a, s));
    case 32:
      return (int)(dtype == 0 ? launch_fused_any<float, 32>(a, s) : launch_fused_any<bf16, 32>(a, s));
    case 64:
      return (int)(dtype == 0 ? launch_fused_any<float, 64>(a, s) : launch_fused_any<bf16, 64>(a, s));
    case 128:
      return (int)(dtype == 0 ? launch_fused_any<float, 128>(a, s) : launch_fused_any<bf16, 128>(a, s));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
