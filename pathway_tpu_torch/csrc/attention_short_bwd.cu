// Backward of the masked short-sequence attention of attention_short.cu, in
// the same flat [B, L, D] layout.
//
// It replaces no TPU kernel: the JAX package's Pallas attention has no VJP,
// and its training step differentiates XLA's attention
// (pathway_tpu/ops/encoder.py::_sdpa). The port's train step runs the
// hand-written forward, so its gradient needs a hand-written backward. Per
// head, with the forward recomputed from q and k (f32 products, masked keys
// filled with -1e30, f32 softmax, probabilities normalised and then rounded
// to the input type for the product with v):
//   dP = dO . V^T                         (f32)
//   D_i = rowsum(dO_i * O_i)              (f32)
//   dS = P * (dP - D), 0 at masked keys   (the fill blocks the gradient)
//   dQ = scale * dS . K,  dK = scale * dS^T . Q,  dV = round(P)^T . dO
// all summed in f32 and stored in the input type. A fully masked query row
// has uniform probabilities: its dQ is 0 and it adds P = 1/L to dV.
//
// Design (simple first, both routes on the f32 pipes): two kernels.
//   bwd_dq<T, HD>: one block per (batch row, head, tile of 32 query rows).
//     Pass 1 over 32-key tiles folds the row max and the rescaled row sum
//     (the forward's exact two-pass softmax); the row's max, sum and D go to
//     a scratch buffer. Pass 2 recomputes the scores, forms P, dP and dS and
//     accumulates dQ.
//   bwd_dkv<T, HD>: one block per (batch row, head, tile of 32 key rows). It
//     walks the query tiles, recomputes P from the scratch statistics, and
//     accumulates dV = round(P)^T . dO and dK = dS^T . Q.
// Tiles live in shared memory as f32 in rows padded by one word (the dot
// products of a warp then read 32 distinct banks); 256 threads a block, each
// owning 4 entries of a 32 x 32 score tile and HD / 8 entries of a 32 x HD
// output tile. Query and key rows past L are zero and take no part.
//
// Bound on an H100 SXM (3.35 TB/s HBM; dense 989 TFLOP/s bf16, 495 TF32):
// it must read q, k, v, out and d_out and write dq, dk and dv, 8 * B * L * D
// elements, and the gradient's work is 5 * 2 * B * H * L^2 * hd FLOP. At the
// train step's shape (B = 512 texts, L = 128, D = 384, bf16) that is 403 MB
// -> 0.120 ms against 32.2 GFLOP -> 0.033 ms on the tensor cores: bytes-bound.
// This kernel does 16 * B * H * L^2 * hd FLOP (the scores twice in bwd_dq
// and once in bwd_dkv) as f32 FMAs from shared memory, so it is bound by
// the FP32 pipes and shared-memory reads, several times its bound; moving
// the products onto wgmma is later work.
//
// Supported: bf16 or f32 (dtype 1 / 0), HD in {32, 64, 128}, L <= 512, last
// dimension contiguous; strides in elements. The Python wrapper checks it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 32;      // query rows and key rows per tile
constexpr int kThreads = 256;  // 8 warps
constexpr float kMaskFill = -1e30f;

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

// Shared tile [kTile][HD + 1] of f32 loaded from rows row0.. of a strided
// [B, L, D] tensor at batch b and column offset col; rows >= L are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long b, int row0,
                                          int L, long long sb, long long sl, int col) {
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int row = row0 + r;
    dst[r * (HD + 1) + d] =
        row < L ? to_f32(src[b * sb + (long long)row * sl + col + d]) : 0.0f;
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
                                           int L, int D, int col, float mul) {
  const int r = threadIdx.x >> 3, d0 = threadIdx.x & 7;
  const int row = row0 + r;
  if (row >= L) return;
  T* p = dst + (b * L + row) * (long long)D + col;
#pragma unroll
  for (int u = 0; u < HD / 8; ++u) p[d0 + 8 * u] = from_f32<T>(acc[u] * mul);
}

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
  float* stats;  // [3, B, H, L]: row max, row sum, D
  long long B;
  int L, H;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl, g_sb, g_sl, m_sb;
  float scale;
};

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
  const int h = blockIdx.y, L = a.L, H = a.H, D = H * HD, col = h * HD;
  const int q0 = blockIdx.z * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.out);
  const T* g = static_cast<const T*>(a.dout);

  load_tile<T, HD>(Qs, q, b, q0, L, a.q_sb, a.q_sl, col);
  load_tile<T, HD>(Gs, g, b, q0, L, a.g_sb, a.g_sl, col);
  __syncthreads();
  // D_i = rowsum(dO * O): warp w takes rows w, w + 8, ...
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int row = q0 + r;
    float s = 0.0f;
    if (row < L)
      for (int d = lane; d < HD; d += 32)
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
    load_tile<T, HD>(Ks, k, b, k0, L, a.k_sb, a.k_sl, col);
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
    load_tile<T, HD>(Ks, k, b, k0, L, a.k_sb, a.k_sl, col);
    load_tile<T, HD>(Vs, v, b, k0, L, a.v_sb, a.v_sl, col);
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
  store_rows<T, HD>(static_cast<T*>(a.dq), dq, b, q0, L, D, col, a.scale);
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
  const int h = blockIdx.y, L = a.L, H = a.H, D = H * HD, col = h * HD;
  const int k0 = blockIdx.z * kTile;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.dout);
  const long long plane = a.B * (long long)H * L;
  const long long base = (b * H + h) * (long long)L;

  load_tile<T, HD>(Ks, k, b, k0, L, a.k_sb, a.k_sl, col);
  load_tile<T, HD>(Vs, v, b, k0, L, a.v_sb, a.v_sl, col);
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
    load_tile<T, HD>(Qs, q, b, q0, L, a.q_sb, a.q_sl, col);
    load_tile<T, HD>(Gs, g, b, q0, L, a.g_sb, a.g_sl, col);
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
  store_rows<T, HD>(static_cast<T*>(a.dk), dk, b, k0, L, D, col, a.scale);
  store_rows<T, HD>(static_cast<T*>(a.dv), dv, b, k0, L, D, col, 1.0f);
}

template <int HD>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (HD + 1) + kTile * (kTile + 1) + 4 * kTile) * 4;
}
template <int HD>
constexpr int dkv_smem_bytes() {
  return (4 * kTile * (HD + 1) + 2 * kTile * (kTile + 1) + 4 * kTile) * 4;
}

template <typename T, int HD>
cudaError_t launch_bwd(const Args& a, cudaStream_t stream) {
  const int dq_bytes = dq_smem_bytes<HD>(), dkv_bytes = dkv_smem_bytes<HD>();
  cudaError_t err =
      cudaFuncSetAttribute(bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dkv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)a.B, (unsigned)a.H, (unsigned)((a.L + kTile - 1) / kTile));
  bwd_dq<T, HD><<<grid, kThreads, dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkv<T, HD><<<grid, kThreads, dkv_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0) return launch_bwd<float, HD>(a, stream);
  if (dtype == 1) return launch_bwd<bf16, HD>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32, 1 =
// bfloat16. q/k/v/out/d_out are strided [B, L, H * hd] views (strides in
// elements, last dimension contiguous); dq/dk/dv are contiguous
// [B, L, H * hd] outputs; stats is an f32 scratch of 3 * B * H * L. Launches
// bwd_dq, then bwd_dkv, on `stream`; returns the first cudaError_t (0 =
// success).
extern "C" int pw_attention_short_flat_backward(
    int dtype, int hd, const void* q, const void* k, const void* v, const void* mask,
    const void* out, const void* d_out, void* dq, void* dk, void* dv, void* stats, long long B,
    int L, int H, long long q_sb, long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, long long o_sb, long long o_sl, long long g_sb, long long g_sl,
    long long m_sb, float scale, void* stream) {
  Args a{q, k, v, static_cast<const uint8_t*>(mask), out, d_out, dq, dk, dv,
         static_cast<float*>(stats), B, L, H, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb,
         o_sl, g_sb, g_sl, m_sb, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return (int)launch<32>(dtype, a, s);
    case 64:
      return (int)launch<64>(dtype, a, s);
    case 128:
      return (int)launch<128>(dtype, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
