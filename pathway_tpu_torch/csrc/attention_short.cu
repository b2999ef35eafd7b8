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
// reference does; an online (flash) softmax that normalises at the end would
// round at another place, so it is deliberately not used here.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 dense). At the
// embedding shape (B=1024, L=128, D=384, bf16) one call must read q, k, v and
// write ctx: 4 * B * L * D * 2 B = 403 MB -> 0.120 ms; its work is
// 4 * B * L^2 * D = 25.8 GFLOP -> 0.026 ms. The kernel is memory-bound, and
// its bound is ~0.12 ms per layer call.
//
// What the design does about that bound: no [B, H, L, L] tensor ever reaches
// device memory (scores and probs live in shared memory), and q, k, v are read
// straight from the strided qkv projection (row stride 3D), so the three
// .contiguous() copies a [B, H, L, hd] path would make never happen. Each
// block owns one (batch row, head, tile of query rows): it stages that head's
// K slice and the key mask in shared memory, computes and normalises all
// scores of its query rows, then stages V over K and accumulates probs . v.
// K and V are re-read once per row tile (ceil(L / rows) times, from L2);
// q is read once and ctx written once. Products run on the FP32 pipes, not the
// tensor cores: wgmma, TMA and a fused single pass are later work.
//
// Supported: T in {float, bf16}, HD in {32, 64, 128} (template parameters),
// L <= 512, rows of q/k/v 16-byte aligned. The Python wrapper checks all of
// it, and picks `rows` so the shared memory below fits the block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_as(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store_as(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}

// Round an f32 value to T and back: the probs' cast to the input dtype.
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// N consecutive elements of T moved as one aligned access (N * sizeof(T) <= 16).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy one head's [L, HD] slice (row stride `sl` elements) into shared memory
// rows of stride HD + one 16-byte chunk (the pad keeps the per-key row reads
// of the score loop free of bank conflicts); rows L..LP-1 are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, long long sl,
                                           int L, int LP) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int KS = HD + CH;
  constexpr int NC = HD / CH;
  for (int i = threadIdx.x; i < LP * NC; i += kThreads) {
    const int j = i / NC;
    const int c = (i % NC) * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j < L) val = *reinterpret_cast<const uint4*>(src + (long long)j * sl + c);
    *reinterpret_cast<uint4*>(dst + (size_t)j * KS + c) = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ mask,
                       T* __restrict__ out, int L, int H, int rows, long long q_sb,
                       long long q_sl, long long k_sb, long long k_sl, long long v_sb,
                       long long v_sl, long long m_sb, float scale) {
  static_assert(HD % 32 == 0, "HD must be a multiple of 32");
  constexpr int CH = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int KS = HD + CH;         // shared-memory row stride of K / V
  constexpr int PER_LANE = HD / 32;   // output columns per lane
  static_assert(HD % CH == 0, "HD must fill whole 16-byte chunks");

  const long long b = blockIdx.x;
  const int h = blockIdx.y;
  const int row0 = blockIdx.z * rows;
  const int LP = (L + 31) & ~31;
  const long long D = (long long)H * HD;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nrows = min(rows, L - row0);

  extern __shared__ __align__(16) unsigned char smem[];
  T* kv = reinterpret_cast<T*>(smem);                                        // [LP][KS]
  float* p = reinterpret_cast<float*>(smem + (size_t)LP * KS * sizeof(T));   // [rows][LP]
  uint8_t* msk = reinterpret_cast<uint8_t*>(p + (size_t)rows * LP);          // [LP]

  stage_rows<T, HD>(kv, k + b * k_sb + (long long)h * HD, k_sl, L, LP);
  for (int j = threadIdx.x; j < LP; j += kThreads) msk[j] = j < L ? mask[b * m_sb + j] : 0;
  __syncthreads();

  // Phase 1: one warp per query row; lanes split the keys.
  for (int r = warp; r < nrows; r += kWarps) {
    const T* qrow = q + b * q_sb + (long long)(row0 + r) * q_sl + (long long)h * HD;
    float qr[HD];
#pragma unroll
    for (int c = 0; c < HD; c += CH) {
      const Pack<T, CH> pk = *reinterpret_cast<const Pack<T, CH>*>(qrow + c);
#pragma unroll
      for (int e = 0; e < CH; ++e) qr[c + e] = to_float(pk.v[e]);
    }
    float* prow = p + (size_t)r * LP;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < L; j += 32) {
      const T* krow = kv + (size_t)j * KS;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += CH) {
        const Pack<T, CH> pk = *reinterpret_cast<const Pack<T, CH>*>(krow + c);
#pragma unroll
        for (int e = 0; e < CH; ++e) acc = fmaf(qr[c + e], to_float(pk.v[e]), acc);
      }
      const float s = msk[j] ? acc * scale : -1e30f;
      prow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < LP; j += 32) prow[j] = j < L ? round_to(prow[j] / sum, T()) : 0.f;
  }
  __syncthreads();

  stage_rows<T, HD>(kv, v + b * v_sb + (long long)h * HD, v_sl, L, LP);
  __syncthreads();

  // Phase 2: one warp per query row; each lane owns PER_LANE adjacent columns.
  const int d0 = lane * PER_LANE;
  for (int r = warp; r < nrows; r += kWarps) {
    const float* prow = p + (size_t)r * LP;
    float acc[PER_LANE];
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) acc[e] = 0.f;
    for (int j = 0; j < LP; j += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(prow + j);
      const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const Pack<T, PER_LANE> vv =
            *reinterpret_cast<const Pack<T, PER_LANE>*>(kv + (size_t)(j + u) * KS + d0);
#pragma unroll
        for (int e = 0; e < PER_LANE; ++e) acc[e] = fmaf(pj[u], to_float(vv.v[e]), acc[e]);
      }
    }
    Pack<T, PER_LANE> o;
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) store_as(acc[e], &o.v[e]);
    *reinterpret_cast<Pack<T, PER_LANE>*>(out + (b * L + row0 + r) * D + (long long)h * HD + d0) = o;
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   long long B, int L, int H, int rows, long long q_sb, long long q_sl,
                   long long k_sb, long long k_sl, long long v_sb, long long v_sl,
                   long long m_sb, float scale, cudaStream_t stream) {
  constexpr int KS = HD + 16 / (int)sizeof(T);
  const int LP = (L + 31) & ~31;
  const size_t smem = (size_t)LP * KS * sizeof(T) + (size_t)rows * LP * sizeof(float) + LP;
  auto kern = attention_short_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B, (unsigned)H, (unsigned)((L + rows - 1) / rows));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), L, H, rows, q_sb, q_sl, k_sb,
      k_sl, v_sb, v_sl, m_sb, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, const void* mask,
                      void* out, long long B, int L, int H, int rows, long long q_sb,
                      long long q_sl, long long k_sb, long long k_sl, long long v_sb,
                      long long v_sl, long long m_sb, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, mask, out, B, L, H, rows, q_sb, q_sl, k_sb, k_sl, v_sb,
                           v_sl, m_sb, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, mask, out, B, L, H, rows, q_sb, q_sl, k_sb, k_sl, v_sb,
                           v_sl, m_sb, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, mask, out, B, L, H, rows, q_sb, q_sl, k_sb, k_sl, v_sb,
                            v_sl, m_sb, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Strides are in elements; `out` is a contiguous [B, L, H * hd] tensor.
// Returns the launch's cudaError_t (0 = success).
extern "C" int pw_attention_short_flat(int dtype, int hd, const void* q, const void* k,
                                       const void* v, const void* mask, void* out,
                                       long long B, int L, int H, int rows, long long q_sb,
                                       long long q_sl, long long k_sb, long long k_sl,
                                       long long v_sb, long long v_sl, long long m_sb,
                                       float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_hd<float>(hd, q, k, v, mask, out, B, L, H, rows, q_sb, q_sl, k_sb,
                                 k_sl, v_sb, v_sl, m_sb, scale, s);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, mask, out, B, L, H, rows, q_sb, q_sl,
                                         k_sb, k_sl, v_sb, v_sl, m_sb, scale, s);
  return (int)cudaErrorInvalidValue;
}
