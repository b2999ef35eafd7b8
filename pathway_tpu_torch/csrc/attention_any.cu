// Masked short-sequence attention and its backward for every head the
// kernels of attention_short.cu and attention_short_bwd.cu do not take: a
// head whose rows, head offsets or pointers are not 16-byte aligned (a bf16
// head of 12 columns starts every 24 bytes; a [B, L, 3D] projection with
// D = 36 has rows of 216 bytes), and a head wider than 128 columns. Same
// flat [B, L, D] layout and the same arithmetic: f32 scores, masked keys
// filled with -1e30 (padding columns past L with -inf), an f32 softmax
// folded tile by tile in key order (fold_tile), normalised and then rounded
// to the input type (no online rescaling: attention_short.cu says why), P .
// V summed in f32; the backward's dP, D, dS, dQ, dK and dV as
// attention_short_bwd.cu states them.
//
// Replaces, for those heads, the JAX package's Pallas TPU kernel
// pathway_tpu/ops/attention_kernel.py::_attention_short_impl (whose own
// envelope sends every head but hd % 64 == 0, L <= 128 to XLA's attention,
// pathway_tpu/ops/encoder.py::_sdpa, which takes any width) and, for the
// gradient, the backward of _sdpa that the reference gets from XLA.
//
// Copy width. The host (ops/attention_kernel.py::copy_width) picks the
// widest of 16, 8, 4 and 2 bytes that divides every pointer, row stride and
// hd * sizeof(T); load_rows_any copies 16, 8 and 4 bytes with cp.async and
// 2 bytes (a bf16 head of odd width, or rows at odd elements) with plain
// loads and stores, and the outputs leave in pieces of the same width
// (store_rows_any). Columns hd .. width - 1 are zero-filled in shared
// memory, so they add exactly 0, as in the aligned kernels.
//
// Column blocks. A head has ncb = ceil(hd / 128) blocks of width W =
// any_width(hd) (16, 32, 64 or 128; block j holds columns jW .. jW + W -
// 1). Every score sums the k-steps of all of them in column order, so a
// kernel that holds two blocks at once and one that takes them in turn give
// a score the same bits.
//
// The forward (attention_any_kernel<T, HD>, HD = ncb * W: 16, 32, 64, 128
// or 256, i.e. every head up to 256 columns).
//   Bound on an H100 SXM (3.35 TB/s; dense 989 TFLOP/s bf16, 495 TF32), a
//   call reading q, k, v and the mask and writing ctx (4 * B * L * D
//   elements) and doing 4 * B * L^2 * D FLOP (three TF32 products each in
//   f32): at 3 heads of 256, B 1,024, L 128 (encoder_widths' encoder) the
//   bytes, 0.2404 ms bf16 and 0.4808 ms f32; at B 4, L 600 the operations,
//   4.5 us bf16 and 27 us f32, and in practice the launch and each warp's
//   chain of 30 tile steps (12 heads x 4 texts give 120 blocks).
//   What held PR 18's kernel back: copies that never overlapped a product,
//   ncb + 1 score passes (K read three times at 256 columns), Q reloaded
//   for every key tile of every pass, 60 blocks at B 4, L 600. The design
//   (ratios: tools/attention_ablation.py --any on an H100 80GB HBM3 at
//   700 W, PERF.md, PR 20):
//   - One block per (text, head, tile of up to 64 query rows), one warp
//     per 16 rows owning all HD output columns of its rows.
//   - Q of the block's rows is loaded once, at the full head width, and stays
//     in shared memory; every score sums all HD / 16 (bf16) or HD / 8 (f32)
//     k-steps at once (any_scores; in f32 a k-step's 8 key groups take
//     their three TF32 products in turn: each group's three back to back
//     ran 1.5x slower). K and V arrive as 64-key tiles at the full width
//     through one ring of `slots` 64-key slots (any_slots: 4, 3 or 2, the
//     most that keep as many blocks an SM as the grid can use): a step
//     waits for its tile, passes one barrier and starts the copy of the
//     tile `slots` - 1 steps on into the slot the step before freed, so
//     copies run under the products; a K tile's 64 key fills ride in its
//     slot.
//   - Copies at a width known when compiled (load_rows_vb: load_rows at 16
//     bytes, load_rows_at at 8, 4 and 2 up to 128 columns), so a piece's
//     row and column fold to shifts.
//   - L <= 128: one score pass. The tiles come as K_0 [K_1] V_0 [V_1]; the
//     warp keeps its 16 x L scores in registers, folds them as
//     attention_short.cu's resident route does, and turns them into
//     normalised, rounded P (probs) kept in registers; P . V then runs in
//     two parts of 128 output columns at 256 (64 accumulators, not 128:
//     all 256 at once ran 1.8x slower in f32 at B 1,024), V's tiles
//     resident.
//   - L > 128: two passes, K_0 .. K_{nt-1} (the row max and sum), then K_0
//     V_0 K_1 V_1 ... (the scores again, P, P . V over every output
//     column, the accumulators in registers), as the aligned streaming
//     route.
//   - Outputs: staged in the warp's consumed Q rows and written at the
//     copy width (write_rows).
//   - Rows per block: 64 (fewer only where L is shorter), never cut to
//     fill the card at small batch: a warp's chain of tile steps is as long
//     at any row count, and two blocks of 32 rows an SM stream K and V
//     twice (32 rows ran 1.2x slower in bf16 at B 4, L 600, 3 x 256 and
//     2.2x in f32).
//   - Heads above 256 columns (ncb > 2) change over to
//     attention_any_cols_kernel<T, 128>, which streams Q's and K's column
//     blocks per key tile and makes ncb + 1 score passes (a pass for the
//     row max and sum, then one per output block, stored before the next):
//     Q and one 64-key K tile at 384 or more f32 columns would leave no room
//     for V in 227 KB.
//   - The fused backward (attention_bwd_fused<T, W, false, true>, L <= 128,
//     hd <= 128): attention_short_bwd.cu's kernel with its copies at the
//     copy width (ANY).
//   - The two-pass backward (attention_two_pass_dq, attention_two_pass_dkv
//     of attention_bwd.cuh at block width W: any L, any copy width; hd >
//     128 in column blocks): the scores and dP sum every column block's
//     k-steps in column order, and the grid covers the output column blocks
//     (the grid's third dimension is 64-row tiles x ncb), each block
//     recomputing the scores for its output block.
//
// Entry points (plain C, loaded with ctypes): pw_attention_any_flat and
// pw_attention_any_flat_backward. The Python wrapper picks this file's
// kernels from the shape, the pointers and the strides
// (ops/attention_kernel.py::launch_geometry, backward_launch_geometry) and
// computes the launch geometry with the same formulas (any_smem_bytes,
// any_slots, any_cols_smem_bytes, fused_smem_bytes, dq_pass_bytes,
// dkv_pass_bytes).

#include "attention_bwd.cuh"
#include "attention_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// The forward
// ---------------------------------------------------------------------------

constexpr int kAnyRows = 64;     // query rows per block at most (one warp per 16)
constexpr int kAnyFullCols = 2;  // column blocks attention_any_kernel holds: heads up to 256

// Blocks of 64 rows (4 warps) an SM the launch bound makes the registers
// allow: the 16-row accumulator of HD f32 columns, the scores of two 64-key
// tiles and the operands take up to 128 registers a thread at 16 columns
// and bf16 at 32 (f32 at 32 spilled 8 bytes there), 168 at 64, ~200 at 128
// and ~250 at 256 (ptxas -v, PERF.md, PR 20).
template <typename T, int HD>
__host__ __device__ constexpr int any_min_blocks() {
  return HD == 16 || (HD == 32 && sizeof(T) == 2) ? 4 : HD <= 64 ? 3 : HD == 128 ? 2 : sizeof(T) == 2 ? 2 : 1;
}
// The launch bound's blocks an SM at kAnyRows rows.
template <typename T, int HD>
__host__ __device__ constexpr int any_launch_blocks() {
  return any_min_blocks<T, HD>() * 64 / kAnyRows > 1 ? any_min_blocks<T, HD>() * 64 / kAnyRows : 1;
}

// Shared bytes of one forward block; mirrored by
// ops/attention_kernel.py::_any_smem_bytes: Q's rows and the ring's slots
// of 64 keys at the full width, rows padded by 16 bytes, and 64 f32 fills a
// slot.
template <typename T, int HD>
__host__ __device__ constexpr size_t any_smem_bytes(int rows, int slots) {
  return (size_t)(rows + slots * kKeyTile) * (HD + chunk<T>()) * sizeof(T) +
         (size_t)slots * kKeyTile * sizeof(float);
}

// Blocks of `rows` query rows an SM holds: by shared memory, and by the
// registers the launch bound grants (64 / rows times any_min_blocks).
template <typename T, int HD>
__host__ __device__ constexpr int any_blocks_per_sm(int rows, int slots) {
  const int by_regs = any_min_blocks<T, HD>() * 64 / rows;
  const int by_smem = tp_blocks_per_sm(any_smem_bytes<T, HD>(rows, slots));
  return by_regs < by_smem ? by_regs : by_smem;
}

// The ring's slots for a grid of `blocks`: the most of 4 and 3 whose block
// fits and leaves an SM as many blocks as the grid can use (as two slots
// allow, and no more than blocks / 132 rounded up: a grid of at most 132
// blocks wants one an SM); else 2.
constexpr int kSms = 132;  // streaming multiprocessors of an H100 SXM
template <typename T, int HD>
__host__ __device__ constexpr int any_slots(int rows, long long blocks) {
  const long long waves = (blocks + kSms - 1) / kSms;
  const int two = any_blocks_per_sm<T, HD>(rows, 2);
  const int want = waves < two ? (int)waves : two;
  for (int s = 4; s > 2; --s)
    if (any_smem_bytes<T, HD>(rows, s) <= (size_t)kSmemLimit && any_blocks_per_sm<T, HD>(rows, s) >= want)
      return s;
  return 2;
}

// cp.async.wait_group takes an immediate: the ring's pending count (slots - 2).
__device__ __forceinline__ void wait_ring(int pending) {
  if (pending <= 0) {
    cp_async_wait<0>();
  } else if (pending == 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<2>();
  }
}

// P of one 64-key tile of a warp's 16 rows, normalised and rounded to T, in
// the A-operand layout of P . V: pv_tile's operands, made before its V tile
// arrives. bf16: pa[kk] holds keys 16kk .. 16kk + 15 packed; f32: p[kk] the
// 8-key group kk in the permuted order (c0, c2, c1, c3), split at use.
template <typename T>
struct ProbTile;
template <>
struct ProbTile<bf16> {
  uint32_t pa[4][4];
};
template <>
struct ProbTile<float> {
  uint32_t p[8][4];
};

template <typename T>
__device__ __forceinline__ ProbTile<T> probs(const float (&e)[8][4], float l0, float l1, float r0,
                                             float r1) {
  ProbTile<T> P;
  if constexpr (std::is_same_v<T, bf16>) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* c = e[2 * kk + half];
        P.pa[kk][2 * half] = pack_bf16(div_rn(c[0], l0, r0), div_rn(c[1], l0, r0));
        P.pa[kk][2 * half + 1] = pack_bf16(div_rn(c[2], l1, r1), div_rn(c[3], l1, r1));
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float* c = e[kk];
      P.p[kk][0] = __float_as_uint(div_rn(c[0], l0, r0));
      P.p[kk][1] = __float_as_uint(div_rn(c[2], l1, r1));
      P.p[kk][2] = __float_as_uint(div_rn(c[1], l0, r0));
      P.p[kk][3] = __float_as_uint(div_rn(c[3], l1, r1));
    }
  }
  return P;
}

// s (16 rows x 64 keys) = Q_w . K^T over the full width HD: tp_scores'
// loads, skips and products, each score's mma.sync in score_tiles' order
// (k-steps in column order; in f32 small . big, big . small, big . big), so
// the scores keep their bits. f32: a k-step's 8 key groups take their three
// TF32 products in turn (every group's small . big, then big . small, then
// big . big), 8 independent products in flight where run() chains a group's
// three.
template <typename T, int HD>
__device__ __forceinline__ void any_scores(float (&s)[1][8][4], const T* sq_w, const T* sk, int valid,
                                           int lane) {
  if constexpr (std::is_same_v<T, bf16>) {
    tp_scores<T, HD>(s, sq_w, sk, valid, lane);
  } else {
    constexpr int C = chunk<float>();
    constexpr int RS = HD + C;
#pragma unroll 2
    for (int kk = 0; kk < HD / (2 * C); ++kk) {
      uint32_t x[4];
      ldsm_x4(x, sq_w + (lane & 15) * RS + kk * 2 * C + (lane >> 4) * C);
      const Mma<float>::A a = Mma<float>::operand(x);
      Tf32Pair b0[8], b1[8];
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4] = {0u, 0u, 0u, 0u};
        const int key = jp * 16;
        if (key < valid)
          ldsm_x4(b, sk + (key + (lane & 7) + ((lane >> 4) << 3)) * RS + kk * 2 * C + ((lane >> 3) & 1) * C);
        b0[2 * jp] = split_tf32(b[0]);
        b1[2 * jp] = split_tf32(b[1]);
        b0[2 * jp + 1] = split_tf32(b[2]);
        b1[2 * jp + 1] = split_tf32(b[3]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (8 * j < valid) mma_tf32(s[0][j], a.small, b0[j].big, b1[j].big);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (8 * j < valid) mma_tf32(s[0][j], a.big, b0[j].small, b1[j].small);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (8 * j < valid) mma_tf32(s[0][j], a.big, b0[j].big, b1[j].big);
    }
  }
}

// o (16 rows x W, f32) += P . V_t for W output columns of a tile of rows of
// HD (sv_t points at the first of the W): pv_tile's products on P made
// ahead, each output's mma.sync in pv_tile's order. f32: the B operands of
// up to 4 output groups are split together and the groups' three TF32
// products issued in turn (mma3: each accumulator still sees small . big,
// big . small, big . big).
template <typename T, int HD, int W>
__device__ __forceinline__ void pv_probs(float (&o)[W / 8][4], const ProbTile<T>& P,
                                         const T* sv_t, int valid, int lane) {
  constexpr int RS = HD + chunk<T>();
  if constexpr (std::is_same_v<T, bf16>) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk * 16 < valid) {
#pragma unroll
        for (int dp = 0; dp < W / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, sv_t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + dp * 16 +
                               (lane >> 4) * 8);
          mma_bf16(o[2 * dp], P.pa[kk], b[0], b[1]);
          mma_bf16(o[2 * dp + 1], P.pa[kk], b[2], b[3]);
        }
      }
    }
  } else {
    constexpr int G = W / 8 < 4 ? W / 8 : 4;
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk * 8 < valid) {
        const Mma<float>::A a = Mma<float>::operand(P.p[kk]);
        const float* v0 = sv_t + (kk * 8 + 2 * tq) * RS + g;
#pragma unroll
        for (int n0 = 0; n0 < W / 8; n0 += G) {
          Tf32Pair b0[G], b1[G];
#pragma unroll
          for (int j = 0; j < G; ++j) {
            b0[j] = split_tf32(__float_as_uint(v0[8 * (n0 + j)]));
            b1[j] = split_tf32(__float_as_uint(v0[RS + 8 * (n0 + j)]));
          }
          mma3<G>(o + n0, a, b0, b1);
        }
      }
    }
  }
}

// load_rows_any at a copy width VB known when compiled (its pieces a row
// a constant, so a piece's row and column fold to shifts): 8 and 4 bytes
// by cp.async, 2 bytes (bf16 only) by plain loads, four in flight.
template <typename T, int HD, int VB>
__device__ __forceinline__ void load_rows_at(T* dst, const T* __restrict__ src, long long sl, int first,
                                             int count, int L, int hd) {
  constexpr int RS = HD + chunk<T>();
  constexpr int E = VB / (int)sizeof(T);  // elements a piece
  constexpr int PPR = HD / E;              // pieces a row
#pragma unroll 4
  for (int i = threadIdx.x; i < count * PPR; i += blockDim.x) {
    const int r = i / PPR;
    const int c = (i % PPR) * E;
    const int j = first + r;
    const bool ok = j < L && c < hd;
    T* d = dst + r * RS + c;
    const T* s = src + (long long)(ok ? j : 0) * sl + (ok ? c : 0);
    if constexpr (VB == 8) {
      cp_async8(d, s, ok);
    } else if constexpr (VB == 4) {
      cp_async4(d, s, ok);
    } else {
      *reinterpret_cast<uint16_t*>(d) = ok ? *reinterpret_cast<const uint16_t*>(s) : (uint16_t)0;
    }
  }
}

// The forward's row copies at the copy width vb: 16 bytes through
// load_rows; narrower through load_rows_at up to 128 columns (at 256 its
// loops cost the f32 kernel, at 255 registers, a spill) and load_rows_any
// above. The pieces loop of load_rows_any with the width read at run time
// cost 1.3x at 3 x 256 in bf16 (tools/attention_ablation.py --any's
// runtime_copies).
template <typename T, int HD>
__device__ __forceinline__ void load_rows_vb(T* dst, const T* __restrict__ src, long long sl, int first,
                                             int count, int L, int hd, int vb) {
  if (vb == 16) {
    load_rows<T, HD>(dst, src, sl, first, count, L, hd);
  } else if constexpr (HD > 128) {
    load_rows_any<T, HD>(dst, src, sl, first, count, L, hd, vb);
  } else if (vb == 8) {
    load_rows_at<T, HD, 8>(dst, src, sl, first, count, L, hd);
  } else if (vb == 4) {
    load_rows_at<T, HD, 4>(dst, src, sl, first, count, L, hd);
  } else if constexpr (sizeof(T) == 2) {
    load_rows_at<T, HD, 2>(dst, src, sl, first, count, L, hd);
  }
}

// Stage a warp's 16 output rows of W columns (o) in its own consumed Q rows
// (stride HD + chunk), then write rows < n, columns < ncols, to dst (row
// stride ld) at the copy width; 16-byte pieces with a constant count a row.
template <typename T, int HD, int W>
__device__ __forceinline__ void write_rows(const float (&o)[W / 8][4], T* stage, T* __restrict__ dst,
                                           long long ld, int n, int ncols, int vb, int lane) {
  constexpr int C = chunk<T>();
  constexpr int RS = HD + C;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    store2(stage + g * RS + 8 * j + c2, o[j][0], o[j][1]);
    store2(stage + (g + 8) * RS + 8 * j + c2, o[j][2], o[j][3]);
  }
  __syncwarp();
  if (vb == 16) {
    constexpr int CPR = W / C;
    for (int i = lane; i < 16 * CPR; i += 32) {
      const int r = i / CPR;
      const int c = (i % CPR) * C;
      if (r < n && c < ncols)
        *reinterpret_cast<uint4*>(dst + r * ld + c) = *reinterpret_cast<const uint4*>(stage + r * RS + c);
    }
  } else {
    store_rows_any<T, HD>(dst, ld, stage, n, ncols, vb, lane);
  }
  __syncwarp();
}

template <typename T, int HD>
__global__ void __launch_bounds__(kAnyRows / 16 * 32, any_launch_blocks<T, HD>())
attention_any_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ mask, T* __restrict__ out, int L, int H, int hd,
                     int vb, int slots, long long q_sb, long long q_sl, long long k_sb,
                     long long k_sl, long long v_sb, long long v_sl, long long m_sb,
                     float scale) {
  constexpr int RS = HD + chunk<T>();
  constexpr int NO = HD / 8;  // 8-column groups of the output

  const int rows = blockDim.x / 2;  // 16 query rows per 32-thread warp
  const int nz = (L + rows - 1) / rows;
  const long long bh = blockIdx.x / nz;  // row tile fastest, then head, then text
  const int row0 = (int)(blockIdx.x - bh * nz) * rows;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nt = (L + kKeyTile - 1) / kKeyTile;
  // the ring's tiles: K_0 .. K_{nt-1}, then V_0 .. V_{nt-1} (L <= 128) or
  // K_0 V_0 K_1 V_1 ... (the second pass)
  const int items = nt <= 2 ? 2 * nt : 3 * nt;

  // (its own name: attention_bwd.cuh's kernels declare theirs)
  extern __shared__ __align__(16) unsigned char smem_any[];
  T* sq = reinterpret_cast<T*>(smem_any);  // [rows][RS]: Q at the full width; then output rows
  T* ring = sq + rows * RS;                 // [slots][64][RS]: K or V tiles
  float* sf = reinterpret_cast<float*>(ring + slots * kKeyTile * RS);  // [slots][64]: K's fills

  const long long col = (long long)h * hd;
  const T* kh = k + b * k_sb + col;
  const T* vh = v + b * v_sb + col;
  const uint8_t* mrow = mask + b * m_sb;
  T* sq_w = sq + warp * 16 * RS;

  auto slot = [&](int i) { return ring + (i % slots) * kKeyTile * RS; };
  auto fills = [&](int i) { return sf + (i % slots) * kKeyTile; };
  // start the copy of tile i (if there is one) as one async group
  auto issue = [&](int i) {
    if (i < items) {
      const int j = i - nt;
      const bool is_v = j >= 0 && (nt <= 2 || (j & 1));
      const int t = j < 0 ? i : nt <= 2 ? j : j >> 1;
      if (is_v) {
        load_rows_vb<T, HD>(slot(i), vh, v_sl, t * kKeyTile, kKeyTile, L, hd, vb);
      } else {
        load_rows_vb<T, HD>(slot(i), kh, k_sl, t * kKeyTile, kKeyTile, L, hd, vb);
        fill_tile(fills(i), mrow, t * kKeyTile, L);
      }
    }
    cp_async_commit();
  };
  // step i: tile i has landed for every thread and every warp is done with
  // tile i - 1, whose slot takes tile i + slots - 1
  auto arrive = [&](int i) {
    wait_ring(slots - 2);
    __syncthreads();
    issue(i + slots - 1);
  };
  // the scores of key tile t (ring tile i), scaled and masked
  auto scores = [&](float (&s)[1][8][4], int i, int t) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[0][j][0] = s[0][j][1] = s[0][j][2] = s[0][j][3] = 0.f;
    any_scores<T, HD>(s, sq_w, slot(i), L - t * kKeyTile, lane);
    mask_tile(s[0], fills(i), scale, lane);
  };

  load_rows_vb<T, HD>(sq, q + b * q_sb + col, q_sl, row0, rows, L, hd, vb);  // with tile 0
  for (int i = 0; i < slots - 1; ++i) issue(i);

  const int wrow0 = row0 + warp * 16;  // the warp's first query row
  const long long D = (long long)H * hd;
  T* out_w = out + (b * L + wrow0) * D + col;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  if (nt <= 2) {
    // attention_short.cu's resident route: both tiles' scores, folded in
    // key order; the last tile's max is the final one, so its exponentials
    // are kept, and a first tile of two is exponentiated again
    float s0[1][8][4], s1[1][8][4];
    arrive(0);
    scores(s0, 0, 0);
    if (nt == 2) {
      arrive(1);
      scores(s1, 1, 1);
      fold_tile<false>(s0[0], m0, m1, l0, l1);
      fold_tile<true>(s1[0], m0, m1, l0, l1);
      exp_tile(s0[0], m0, m1);
    } else {
      fold_tile<true>(s0[0], m0, m1, l0, l1);
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
    const ProbTile<T> p0 = probs<T>(s0[0], l0, l1, r0, r1);
    ProbTile<T> p1;
    if (nt == 2) p1 = probs<T>(s1[0], l0, l1, r0, r1);
    // P . V in NP parts of W output columns, P kept in registers and V's
    // tiles resident (the ring takes no tile after them): one part's
    // accumulators at a time, half the registers at 256 columns; each
    // output still sums its keys in order
    constexpr int NP = HD == 256 ? 2 : 1;
    constexpr int W = HD / NP;
    for (int part = 0; part < NP; ++part) {
      float o[W / 8][4];
#pragma unroll
      for (int j = 0; j < W / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
      if (part == 0) arrive(nt);
      pv_probs<T, HD, W>(o, p0, slot(nt) + part * W, L, lane);
      if (nt == 2) {
        if (part == 0) arrive(nt + 1);
        pv_probs<T, HD, W>(o, p1, slot(nt + 1) + part * W, L - kKeyTile, lane);
      }
      write_rows<T, HD, W>(o, sq_w, out_w + part * W, D, L - wrow0, min(W, hd - part * W), vb, lane);
    }
  } else {
    // pass 1: the row max and sum, tile by tile
    float s[1][8][4];
    for (int t = 0; t < nt; ++t) {
      arrive(t);
      scores(s, t, t);
      fold_tile<false>(s[0], m0, m1, l0, l1);
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
    // pass 2: the scores again, normalised with the final max and sum, and
    // P . V over every output column (accumulators zeroed here: the scores
    // of a 256-column head and its 128 accumulators do not both fit a
    // thread's registers)
    float o[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int t = 0; t < nt; ++t) {
      const int i = nt + 2 * t;
      arrive(i);
      scores(s, i, t);
      exp_tile(s[0], m0, m1);
      const ProbTile<T> p = probs<T>(s[0], l0, l1, r0, r1);
      arrive(i + 1);
      pv_probs<T, HD, HD>(o, p, slot(i + 1), L - t * kKeyTile, lane);
    }
    write_rows<T, HD, HD>(o, sq_w, out_w, D, L - wrow0, hd, vb, lane);
  }
}

template <typename T, int HD>
cudaError_t launch_any(const void* q, const void* k, const void* v, const void* mask, void* out,
                       long long B, int L, int H, int hd, int vb, int rows, long long q_sb,
                       long long q_sl, long long k_sb, long long k_sl, long long v_sb,
                       long long v_sl, long long m_sb, float scale, cudaStream_t stream) {
  if (rows % 16 || rows < 16 || rows > kAnyRows) return cudaErrorInvalidValue;
  const long long blocks = B * H * ((L + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int slots = any_slots<T, HD>(rows, blocks);
  const size_t smem = any_smem_bytes<T, HD>(rows, slots);
  const cudaError_t err = cudaFuncSetAttribute(
      attention_any_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_any_kernel<T, HD><<<(unsigned)blocks, rows * 2, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), L, H, hd, vb, slots, q_sb, q_sl,
      k_sb, k_sl, v_sb, v_sl, m_sb, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The forward above 256 columns: column blocks in turn
// ---------------------------------------------------------------------------

// Shared bytes of one block; mirrored by
// ops/attention_kernel.py::_any_cols_smem_bytes: the rows of one column
// block of Q, one K and one V tile of 64 keys, rows padded by 16 bytes, and
// the tile's 64 f32 fills.
template <typename T, int HD>
__host__ __device__ constexpr size_t any_cols_smem_bytes(int rows) {
  return (size_t)(rows + 2 * kKeyTile) * (HD + chunk<T>()) * sizeof(T) +
         (size_t)kKeyTile * sizeof(float);
}

// One block per (text, head, tile of up to 128 query rows), one warp per 16
// rows, ncb + 1 passes over the key tiles: pass 0 folds the row max and sum,
// pass 1 + j recomputes the scores (Q's and K's column blocks staged in
// turn, their k-steps summed into the same registers), normalises them and
// accumulates P . V_j for output block j, stored before the next.
template <typename T, int HD>
__global__ void __launch_bounds__(kMaxRows / 16 * 32, (sizeof(T) == 2 || HD <= 64) ? 2 : 1)
attention_any_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const uint8_t* __restrict__ mask,
                          T* __restrict__ out, int L, int H, int hd, int vb, long long q_sb,
                          long long q_sl, long long k_sb, long long k_sl, long long v_sb,
                          long long v_sl, long long m_sb, float scale) {
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

template <typename T>
cudaError_t launch_any_cols(const void* q, const void* k, const void* v, const void* mask,
                            void* out, long long B, int L, int H, int hd, int vb, int rows,
                            long long q_sb, long long q_sl, long long k_sb, long long k_sl,
                            long long v_sb, long long v_sl, long long m_sb, float scale,
                            cudaStream_t stream) {
  constexpr int HD = kMaxColBlock;
  if (rows % 16 || rows < 16 || rows > kMaxRows) return cudaErrorInvalidValue;
  const size_t smem = any_cols_smem_bytes<T, HD>(rows);
  cudaError_t err = cudaFuncSetAttribute(attention_any_cols_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B, (unsigned)H, (unsigned)((L + rows - 1) / rows));
  attention_any_cols_kernel<T, HD><<<grid, rows * 2, smem, stream>>>(
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
// rows per block from launch_geometry (at most 64 up to 256 columns, 128
// above). Strides are in elements; `out` is a contiguous [B, L, H * hd]
// tensor. Any hd >= 1 and L >= 1. Returns the launch's cudaError_t (0 =
// success).
extern "C" int pw_attention_any_flat(int dtype, int hd, int vb, const void* q, const void* k,
                                     const void* v, const void* mask, void* out, long long B,
                                     int L, int H, int rows, long long q_sb, long long q_sl,
                                     long long k_sb, long long k_sl, long long v_sb,
                                     long long v_sl, long long m_sb, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || L < 1 || (dtype != 0 && dtype != 1) || !copy_width_ok(dtype, hd, vb))
    return (int)cudaErrorInvalidValue;
  if (col_blocks(hd) > kAnyFullCols)
    return (int)(dtype == 0 ? launch_any_cols<float>(q, k, v, mask, out, B, L, H, hd, vb, rows, q_sb,
                                                     q_sl, k_sb, k_sl, v_sb, v_sl, m_sb, scale, s)
                            : launch_any_cols<bf16>(q, k, v, mask, out, B, L, H, hd, vb, rows, q_sb,
                                                    q_sl, k_sb, k_sl, v_sb, v_sl, m_sb, scale, s));
#define PW_CASE(HD)                                                                             \
  case HD:                                                                                      \
    return (int)(dtype == 0 ? launch_any<float, HD>(q, k, v, mask, out, B, L, H, hd, vb, rows,  \
                                                    q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, m_sb,   \
                                                    scale, s)                                   \
                            : launch_any<bf16, HD>(q, k, v, mask, out, B, L, H, hd, vb, rows,   \
                                                   q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, m_sb,    \
                                                   scale, s));
  switch (col_blocks(hd) * any_width(hd)) {
    PW_CASE(16)
    PW_CASE(32)
    PW_CASE(64)
    PW_CASE(128)
    PW_CASE(256)
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
