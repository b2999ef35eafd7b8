"""Where the attention kernel's time goes, by source-level ablation, on one CUDA card.

    python -m pathway_tpu_torch.tools.attention_ablation

Builds variants of ``csrc/attention_short.cu`` that differ in one place of
the kernel or of the helpers it includes from ``csrc/attention_tc.cuh``
(a variant carries the header inline), each with ``nvcc`` into
``build/ablation/`` (all compiles started together), and times each at the embed shape (B=1024, L=128, D=384,
H=6) with CUDA events, in turns, beside ``F.scaled_dot_product_attention``
with an additive mask, in both routes: bf16 and f32 (3xTF32). Each variant
is held against the plain version with its route's tolerance (bf16
2^-7 (|ref| + max|v|), f32 rtol = atol = 1e-5). Variants:

- ``as_built``: the source as it is;
- ``compiler_division``: probs as ``e / l`` by the compiler's division in
  place of the reciprocal-and-correction division;
- ``exp2_folded``: ``exp2f`` with log2(e) folded into the scale and the
  mask fill, in place of ``expf``;
- ``no_softmax``: no exponential and no division (wrong answers by design):
  what the copies, the products and the masking cost alone;
- ``one_tf32_product`` (f32 only): the big . big product alone, without the
  two cross terms and the small parts' splits (misses 1e-5 by design): what
  the two extra products and their operands cost;
- ``no_split`` (f32 only): the three products on unsplit operands (wrong
  answers by design): the split arithmetic's cost, the products kept;
- ``cvt_rna_split`` (f32 only): the same split by ``cvt.rna.tf32.f32``,
  which also tests for Inf and NaN, in place of the integer rounding;
- ``rz_big`` (f32 only): the big part rounded toward zero (the MMA's own
  truncation, no instruction), CUTLASS's ``OpMultiplyAddFastF32`` choice:
  fewer instructions, a larger error.

Prints one JSON line per variant and route, and one per route for the
library call. A variant whose substitution no longer matches the source
fails the run.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

#: the variants' substitutions apply below this line of the source (the
#: header note is never touched)
ROUTES_MARKER = "// Device code (both routes)"
#: the shared helpers' include, below the marker: a variant inlines the
#: header there, so a substitution reaches the helpers too
INCLUDE = '#include "attention_tc.cuh"'
LOG2E = "1.4426950408889634f"
EXP_TILE = (
    "    s[j][0] = expf(s[j][0] - m0);\n    s[j][1] = expf(s[j][1] - m0);\n"
    "    s[j][2] = expf(s[j][2] - m1);\n    s[j][3] = expf(s[j][3] - m1);\n"
)
DIVISION = "  const float q = __fmul_rn(e, r);\n  return fmaf(fmaf(-q, l, e), r, q);"
CROSS_TERMS = (
    "    mma_tf32(c, a.small, s0.big, s1.big);\n    mma_tf32(c, a.big, s0.small, s1.small);\n"
)
SPLIT = (
    "  const uint32_t big = bits + 0x1000u;\n"
    "  const float small = __uint_as_float(bits) - __uint_as_float(big & 0xffffe000u);\n"
    "  return {big, __float_as_uint(small) + 0x1000u};"
)
BOTH = ("bfloat16", "float32")
#: variant -> (routes it is timed in, (old, new) substitutions in the kernel)
VARIANTS = {
    "as_built": (BOTH, []),
    "compiler_division": (BOTH, [(DIVISION, "  return e / l;")]),
    "exp2_folded": (BOTH, [
        ("expf(", "exp2f("),
        ("? 0.f : -1e30f;", f"? 0.f : -1e30f * {LOG2E};"),
        ("scale, lane)", f"scale * {LOG2E}, lane)"),
    ]),
    "no_softmax": (BOTH, [(EXP_TILE, ""), (DIVISION, "  return e;")]),
    "one_tf32_product": (("float32",), [(CROSS_TERMS, "")]),
    "no_split": (("float32",), [(SPLIT, "  return {bits, bits};")]),
    "cvt_rna_split": (("float32",), [(SPLIT, (
        "  const float x = __uint_as_float(bits);\n  uint32_t big, small;\n"
        '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));\n'
        '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(x - __uint_as_float(big)));\n'
        "  return {big, small};"
    ))]),
    "rz_big": (("float32",), [(SPLIT, (
        "  const float small = __uint_as_float(bits) - __uint_as_float(bits & 0xffffe000u);\n"
        "  return {bits, __float_as_uint(small) + 0x1000u};"
    ))]),
}


def _variant_source(src: str, subs) -> str:
    """The source with each substitution made below ROUTES_MARKER, the
    shared header inlined in place of its include (the source itself when
    there is none)."""
    if not subs:
        return src
    from pathway_tpu_torch.ops import _build

    start = src.index(ROUTES_MARKER)
    head, kernel = src[:start], src[start:]
    kernel = kernel.replace(INCLUDE, (_build.CSRC / "attention_tc.cuh").read_text())
    for old, new in subs:
        if old not in kernel:
            raise RuntimeError(f"attention_ablation: {old[:40]!r} is no longer in the kernel")
        kernel = kernel.replace(old, new)
    return head + kernel


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_ablation: CUDA is not available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops import attention_kernel as A

    out_dir = _build.BUILD_DIR.parent / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / _build.SOURCES["attention_short"]).read_text()
    procs = {}
    for name, (_routes, subs) in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(_variant_source(src, subs))
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out_dir / f"{name}.so"),
             str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"attention_ablation: {name} did not build:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).pw_attention_short_flat
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
            + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 7 + [ctypes.c_float, ctypes.c_void_p]
        )
        fns[name] = fn

    B, L, H, hd = 1024, 128, 6, 64
    D, scale = H * hd, hd ** -0.5
    stream = torch.cuda.current_stream().cuda_stream

    def timed(run, iters=50):
        for _ in range(3):
            run()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            run()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    for dname in BOTH:
        dtype = getattr(torch, dname)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        qkv = torch.randn(B, L, 3 * D, device="cuda", generator=gen).to(dtype)
        q, k, v = qkv.split(D, dim=-1)
        lens = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
        mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
        mask[0] = False
        ref = A.attention_short_flat_plain(q, k, v, mask, H, scale)
        out = torch.empty(B, L, D, dtype=dtype, device="cuda")
        rows = A.launch_geometry(B, L, H, hd, dtype).rows

        def launcher(fn):
            args = (
                A._DTYPES[dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr(), B, L, H, rows, q.stride(0), q.stride(1), k.stride(0),
                k.stride(1), v.stride(0), v.stride(1), mask.stride(0), scale, stream,
            )
            return lambda: fn(*args)

        def within(got):
            if dtype == torch.float32:
                return bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-5))
            bound = 2.0 ** -7 * (ref.float().abs() + v.float().abs().max())
            return bool(((got.float() - ref.float()).abs() <= bound).all())

        runs = {name: launcher(fn) for name, fn in fns.items() if dname in VARIANTS[name][0]}
        qh, kh, vh = (t.view(B, L, H, hd).transpose(1, 2) for t in (q, k, v))
        bias = torch.zeros(B, 1, 1, L, device="cuda", dtype=dtype).masked_fill(
            ~mask[:, None, None, :], -1e30
        )
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias, scale=scale)
        ok = {}
        for name, run in runs.items():
            if name == "sdpa":
                continue
            if run() != 0:
                raise RuntimeError(f"attention_ablation: {name} did not launch")
            torch.cuda.synchronize()
            ok[name] = (within(out), (out.float() - ref.float()).abs().max().item())
        ms = {name: [] for name in runs}
        for _ in range(3):  # in turns, so drift hits every variant alike
            for name, run in runs.items():
                ms[name].append(timed(run))
        for name in runs:
            rec = {"variant": name, "ms": ms[name], "shape": f"B=1024 L=128 D=384 H=6 {dname}"}
            if name in ok:
                rec["within_tolerance"], rec["max_abs_err"] = ok[name]
            print(json.dumps(rec), flush=True)
        del q, k, v, qkv, out, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
