// Backward of the masked short-sequence attention of attention_short.cu, in
// the same flat [B, L, D] layout.
//
// It replaces no TPU kernel: the JAX package's Pallas attention has no VJP,
// and its training step differentiates XLA's attention
// (pathway_tpu/ops/encoder.py::_sdpa, lines 150-174). The port's train step
// runs the hand-written forward, so its gradient needs a hand-written
// backward. Per head, with the forward recomputed from q and k (f32
// products, masked keys filled with -1e30, f32 softmax, probabilities
// normalised and then rounded to the input type for the product with v):
//   dP = dO . V^T                         (f32)
//   D_i = rowsum(dO_i * O_i)              (f32)
//   dS = P * (dP - D), 0 at masked keys   (the fill blocks the gradient)
//   dQ = scale * dS . K,  dK = scale * dS^T . Q,  dV = round(P)^T . dO
// all summed in f32 and stored in the input type. A fully masked query row
// has uniform probabilities: its dQ is 0 and it adds P = 1/L to dV.
//
// Bound on an H100 SXM (3.35 TB/s HBM; dense 989 TFLOP/s bf16, 495 TF32):
// a call must read q, k, v, out and d_out and write dq, dk and dv, 8 * B * L
// * D elements, and the gradient's work is 5 products of 2 * B * H * L^2 *
// hd FLOP. At the train step's shape (B = 512 texts, L = 128, 6 heads of
// 64): bf16 403 MB -> 0.120 ms against 32.2 GFLOP -> 0.033 ms; f32 805 MB
// -> 0.240 ms against 3 x 32.2 GFLOP of TF32 -> 0.195 ms. Both are
// bytes-bound, so a kernel near its bound reads each input once, keeps
// every intermediate on chip and runs its products where they cost little
// beside the copies: on the tensor cores.
//
// The fused route (attention_bwd_fused<T, HD, FULL>; L <= 128, every dtype and
// head width whose block fits shared memory: all but f32 at HD = 128). One
// block per (batch row, head), one warp per 16 query rows (and per 16 keys
// on the key side), rows = 16 * ceil(L / 16):
//   1. cp.async copies the head's Q and K as one group, V and dO as a
//      second, into shared rows padded by 16 bytes (rows >= L zero-filled);
//      the second copy runs under the score products.
//   2. Per warp, on the tensor cores (bf16: mma.sync m16n8k16; f32: 3xTF32,
//      m16n8k8 TF32 products on split operands, as the forward): S = Q_w .
//      K^T, masked and folded tile by tile exactly as the forward does
//      (attention_tc.cuh: score_tiles, fold_tile, div_rn), so P has the
//      forward's bits; round(P) is staged in a rows x rows buffer. D_i is
//      formed from O (read once, straight from device memory) and the dO
//      rows. dP = dO_w . V^T and dS = P * (dP - D) per 64-key tile, in
//      registers (bf16: packed into the A operands of the next product);
//      dQ_w = scale * dS . K with dS as the A operand straight from the
//      accumulators (the forward's C -> A register trick, in f32 with its k
//      permutation).
//   3. The key side through the one staging buffer: each warp owns 16 keys;
//      dV = round(P)^T . dO (bf16 reads P^T with ldmatrix.trans, f32 with
//      32-bit shared loads in the permuted k order); then dS is staged in
//      the same buffer and dK = scale * dS^T . Q.
//   4. Every output leaves through shared memory (the warp's own rows of K
//      or V, free by then) in 16-byte rows. Nothing goes through device
//      memory between the products, nothing is reduced across blocks and
//      no atomics run: the result is deterministic, and a text's gradient
//      has the same bits in any batch.
// The scores are computed once (10 * B * H * L^2 * hd FLOP in all). The only
// rounding the plain version lacks is dS in bf16 as an operand of dQ and dK.
// At L = 128 (the train step's and the bert block's length) and a head
// width that is its instantiation's (hd == HD) the kernel is instantiated
// with FULL, which resolves every test of a key, step, row or column at
// compile time, so each phase's products are straight-line code the
// compiler schedules across steps: at the train shape on an H100 (700 W),
// 1.20x faster in bf16 and 2.54x in f32 than without it, and 1.07x and
// 1.04x faster than with L alone made a constant (PERF.md, the fused
// backward's findings).
// Shared memory per block: (4 * rows * (HD + 16 / size) + rows * (rows + 16
// / size)) * size bytes; bf16 at HD 64, L 128: 108,544 B (two blocks per SM);
// f32 at HD 64: 206,848 B (one); at f32 and HD 128 the four tiles alone
// take 270,336 B, above the 232,448 B a block may use.
//
// The two-pass route (attention_two_pass_dq, then attention_two_pass_dkv:
// L > 128, and f32 at HD = 80-128, whose fused block does not fit; design
// in attention_bwd.cuh), on the tensor cores with the fused route's
// products and roundings: the dQ pass takes 64 query rows, folds the
// scores over 64-key tiles streamed through a double-buffered cp.async
// ring exactly as the forward does, forms D in dP's own products (so dP - D
// cancels exactly where the two agree: a row with one kept key), writes
// each row's max, sum and D to a [3, B, H, L] f32 scratch, then recomputes
// S and P and adds dS . K; the
// dK/dV pass takes 64 keys, streams the query tiles, recomputes P from the
// scratch, stages round(P) and then dS in shared memory and adds round(P)^T
// . dO and dS^T . Q. The scores are computed three times (16 * B * H * L^2
// * hd FLOP in all), every product on the tensor cores.
//
// Supported here: bf16 or f32 (dtype 1 / 0), any head width hd up to 128,
// any L >= 1 (the two-pass route above 128 keys), last dimension
// contiguous; strides in elements. Both routes copy 16 bytes at a time, so
// the wrapper sends this file only heads whose rows, head offsets and
// pointers are 16-byte aligned. Both routes are instantiated at HD =
// 16, 32, ..., 128 and a head of hd columns runs in HD = kernel_width(hd)
// (hd rounded up to 16) with columns hd .. HD - 1 zero in shared memory and
// never stored, as in the forward; the fused route exists where its block
// fits at 128 rows: every bf16 HD and f32 up to HD = 64 (f32 at HD = 80
// needs 239,616 B). Unaligned heads and heads wider than 128 run in
// attention_any.cu, on both routes. The device code lives in
// attention_bwd.cuh, which attention_any.cu includes too. The Python
// wrapper checks it and picks the route
// (ops/attention_kernel.py::backward_launch_geometry, the same formulas as
// fused_smem_bytes, dq_pass_bytes and dkv_pass_bytes); launch_fused refuses
// a shape outside the fused route.

#include "attention_bwd.cuh"
#include "attention_tc.cuh"

namespace {

template <typename T, int HD>
cudaError_t launch_fused(const Args& a, cudaStream_t stream) {
  if constexpr (!fused_fits<T, HD>()) {
    return cudaErrorInvalidValue;
  } else {
    if (a.L < 1 || a.L > kMaxRows) return cudaErrorInvalidValue;
    const int rows = (a.L + 15) / 16 * 16;
    const size_t smem = fused_smem_bytes<T, HD>(rows);
    auto kern = a.L == kMaxRows && a.hd == HD ? attention_bwd_fused<T, HD, true>
                                              : attention_bwd_fused<T, HD, false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((unsigned)a.B, (unsigned)a.H), rows * 2, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

template <int HD>
cudaError_t launch(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0) return a.stats ? launch_two_pass<float, HD, false>(a, stream) : launch_fused<float, HD>(a, stream);
  if (dtype == 1) return a.stats ? launch_two_pass<bf16, HD, false>(a, stream) : launch_fused<bf16, HD>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32, 1 =
// bfloat16. q/k/v/out/d_out are strided [B, L, H * hd] views (strides in
// elements, last dimension contiguous; on the fused route rows, head
// offsets and pointers 16-byte aligned); dq/dk/dv are
// contiguous [B, L, H * hd] outputs. stats = null launches the fused route
// (L <= 128, 16 * ceil(L / 16) query rows per block; an error where the
// block does not fit); else the two-pass route's dQ pass, then its dK/dV
// pass, with stats an f32 scratch of 3 * B * H * L. All on `stream`; returns the first cudaError_t (0 =
// success).
extern "C" int pw_attention_short_flat_backward(
    int dtype, int hd, const void* q, const void* k, const void* v, const void* mask,
    const void* out, const void* d_out, void* dq, void* dk, void* dv, void* stats, long long B,
    int L, int H, long long q_sb, long long q_sl, long long k_sb, long long k_sl,
    long long v_sb, long long v_sl, long long o_sb, long long o_sl, long long g_sb,
    long long g_sl, long long m_sb, float scale, void* stream) {
  Args a{q, k, v, static_cast<const uint8_t*>(mask), out, d_out, dq, dk, dv,
         static_cast<float*>(stats), B, L, H, hd, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb,
         o_sl, g_sb, g_sl, m_sb, scale, 16};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > 128 || L < 1) return (int)cudaErrorInvalidValue;
  switch (kernel_width(hd)) {
    case 16:
      return (int)launch<16>(dtype, a, s);
    case 32:
      return (int)launch<32>(dtype, a, s);
    case 48:
      return (int)launch<48>(dtype, a, s);
    case 64:
      return (int)launch<64>(dtype, a, s);
    case 80:
      return (int)launch<80>(dtype, a, s);
    case 96:
      return (int)launch<96>(dtype, a, s);
    case 112:
      return (int)launch<112>(dtype, a, s);
    case 128:
      return (int)launch<128>(dtype, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
