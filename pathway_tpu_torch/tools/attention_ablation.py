"""Where the attention kernel's time goes, by source-level ablation, on one CUDA card.

    python -m pathway_tpu_torch.tools.attention_ablation [--any]

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

``--any`` ablates the any-width forward (``attention_any_kernel`` in
``csrc/attention_any.cu``) instead: each variant is a copy of ``csrc/``
under ``build/ablation_any/`` with ``attention_any.cu`` built by ``nvcc``
(all compiles started together), timed with CUDA events in turns (three
rounds) at ``ANY_SHAPES`` (q, k, v the column views of one [B, L, 3D]
projection) in both dtypes where the head takes ``attention_any.cu``,
beside SDPA, each held to the plain version at its route's tolerance.
Variants (``ANY_VARIANTS``):

- ``as_built``, at the rows per block ``launch_geometry`` picks, and
  ``rows_16`` / ``rows_32`` / ``rows_64``: the same library launched at
  that many query rows a block (the ring's slots follow, as the launcher
  computes them);
- ``rows_128`` (bf16): blocks of up to 128 rows (8 warps), launched at
  ``min(128, L)`` rows;
- ``two_slots``: a ring of two slots wherever more would fit;
- ``copies_then_products``: every step waits for the copy it started, so
  no copy overlaps a product (PR 18's kernel's order);
- ``no_copies`` (wrong answers by design): no K or V tile copied (Q and
  the fills still are): what the ring's copies cost;
- ``runtime_copies``: every copy and 16-byte store through the pieces
  loop of any copy width (the width, and so the pieces a row, read at run
  time);
- ``pv_one_part``: P . V over all 256 columns of a wide head at once at
  L <= 128 (as built: two parts of 128, half the accumulators);
- ``pv_groups_8`` (f32): P . V's B operands split for 8 output groups at
  a time (as built: 4);
- ``scores_unroll_4`` (f32): the interleaved score products' k-steps
  unrolled 4 at a time (as built: 2);
- ``scores_run_order`` (f32): each 8-key group's three TF32 score
  products back to back (``tp_scores``), not in turn across the groups;
- ``one_tf32_product`` (f32, misses 1e-5 by design): the big . big
  product alone;
- ``no_mma`` (wrong answers by design): every ``mma.sync`` replaced by a
  register update of its operands: what the copies, the barriers and the
  softmax cost alone.
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


CROSS_TERMS_TP = (
    "#pragma unroll\n  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.small, b0[n].big, b1[n].big);\n"
    "#pragma unroll\n  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.big, b0[n].small, b1[n].small);\n"
)
MMA_ASM = '  asm volatile(\n      "mma.sync.aligned.m16n8k'
NO_MMA = (
    "  c[0] += __uint_as_float(a[0] ^ b0);\n  c[1] += __uint_as_float(a[1] ^ b1);\n"
    "  c[2] += __uint_as_float(a[2]);\n  c[3] += __uint_as_float(a[3]);\n  return;\n"
)
#: the any-width forward's variants: (dtypes, (file, old, new) substitutions)
ANY_VARIANTS = {
    "as_built": (BOTH, []),
    "rows_128": (("bfloat16",), [("attention_any.cu", "constexpr int kAnyRows = 64;", "constexpr int kAnyRows = 128;")]),
    "two_slots": (BOTH, [("attention_any.cu", "  for (int s = 4; s > 2; --s)", "  for (int s = 2; s > 2; --s)")]),
    "copies_then_products": (BOTH, [("attention_any.cu", "    issue(i + slots - 1);\n  };",
                                     "    issue(i + slots - 1);\n    cp_async_wait<0>();\n    __syncthreads();\n  };")]),
    "no_copies": (BOTH, [
        ("attention_any.cu", "        load_rows_vb<T, HD>(slot(i), vh, v_sl, t * kKeyTile, kKeyTile, L, hd, vb);\n", ""),
        ("attention_any.cu", "        load_rows_vb<T, HD>(slot(i), kh, k_sl, t * kKeyTile, kKeyTile, L, hd, vb);\n", ""),
    ]),
    "runtime_copies": (BOTH, [
        ("attention_any.cu", "  if (vb == 16) {\n    load_rows<T, HD>(dst, src, sl, first, count, L, hd);\n  } else if constexpr",
         "  if (true) {\n    load_rows_any<T, HD>(dst, src, sl, first, count, L, hd, vb);\n  } else if constexpr"),
        ("attention_any.cu", "  if (vb == 16) {\n    constexpr int CPR = W / C;", "  if (false) {\n    constexpr int CPR = W / C;"),
    ]),
    "pv_one_part": (BOTH, [("attention_any.cu", "constexpr int NP = HD == 256 ? 2 : 1;", "constexpr int NP = 1;")]),
    "pv_groups_8": (("float32",), [("attention_any.cu", "constexpr int G = W / 8 < 4 ? W / 8 : 4;",
                                    "constexpr int G = W / 8 < 8 ? W / 8 : 8;")]),
    "scores_unroll_4": (("float32",), [("attention_any.cu", "#pragma unroll 2\n    for (int kk = 0; kk < HD / (2 * C); ++kk) {",
                                        "#pragma unroll 4\n    for (int kk = 0; kk < HD / (2 * C); ++kk) {")]),
    "scores_run_order": (("float32",), [("attention_any.cu", "    any_scores<T, HD>(s, sq_w, slot(i),",
                                         "    tp_scores<T, HD>(s, sq_w, slot(i),")]),
    "one_tf32_product": (("float32",), [("attention_tc.cuh", CROSS_TERMS, ""),
                                        ("attention_bwd.cuh", CROSS_TERMS_TP, "")]),
    "no_mma": (BOTH, [("attention_tc.cuh", MMA_ASM, NO_MMA + MMA_ASM)]),
}
#: rows per block the as-built library is also launched at
ANY_ROWS = (16, 32, 64)
#: variants launched at a row count of their own (at most L rounded up to 16)
ANY_VARIANT_ROWS = {"rows_128": 128}
#: (B, L, heads, hd): chip_smoke.py's encoder_widths attention shapes (3
#: heads of 256; 32 of 12, bf16 rows of 24 bytes) and 3 heads of 256 and of
#: 6 (4- and 8-byte copies) at 600 keys, 4 texts
ANY_SHAPES = {"enc_hd256": (1024, 128, 3, 256), "hd256_l600": (4, 600, 3, 256),
              "enc_hd12": (1024, 128, 32, 12), "hd6_l600": (4, 600, 3, 6)}


def main_any() -> int:
    """The ``--any`` ablation (module docstring)."""
    import shutil

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attention_ablation: CUDA is not available", file=sys.stderr)
        return 2

    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops import attention_kernel as A

    torch.backends.cuda.matmul.allow_tf32 = False
    root = _build.BUILD_DIR.parent / "ablation_any"
    procs = {}
    for name, (_dtypes, subs) in ANY_VARIANTS.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        files = {f.name: f.read_text() for f in _build.CSRC.iterdir() if f.is_file()}
        for fname, old, new in subs:
            if old not in files[fname]:
                raise RuntimeError(f"attention_ablation: {old[:40]!r} is no longer in {fname}")
            files[fname] = files[fname].replace(old, new)
        for fname, text in files.items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "attention_any.so"), str(d / "attention_any.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"attention_ablation: {name} did not build:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(root / name / "attention_any.so")).pw_attention_any_flat
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 3 + A._FWD_ARGS
        fns[name] = fn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else None
    stream = torch.cuda.current_stream().cuda_stream

    def timed(run, iters=20):
        for _ in range(3):
            run()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            run()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for dname in BOTH:
        dtype = getattr(torch, dname)
        es = torch.empty(0, dtype=dtype).element_size()
        for case, (B, L, H, hd) in ANY_SHAPES.items():
            D, scale = H * hd, hd ** -0.5
            qkv = torch.randn(B, L, 3 * D, device="cuda", generator=gen).to(dtype)
            q, k, v = qkv.split(D, dim=-1)
            lens = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
            mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
            mask[0] = False
            vb = A.copy_width(hd, es, q, k, v)
            geo = A.launch_geometry(B, L, H, hd, dtype, vb)
            if geo.route not in A._ANY_FORWARD_ROUTES:
                continue
            ref = A.attention_short_flat_plain(q, k, v, mask, H, scale)
            out = torch.empty(B, L, D, dtype=dtype, device="cuda")

            def launcher(fn, rows):
                args = (A._DTYPES[dtype], hd, vb, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                        out.data_ptr(), B, L, H, rows, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                        v.stride(0), v.stride(1), mask.stride(0), scale, stream)
                return lambda: fn(*args)

            if geo.col_blocks > 2:
                continue
            runs = {name: launcher(fn, min(ANY_VARIANT_ROWS.get(name, geo.rows), -(-L // 16) * 16))
                    for name, fn in fns.items() if dname in ANY_VARIANTS[name][0]}
            runs.update({f"rows_{r}": launcher(fns["as_built"], r) for r in ANY_ROWS if r != geo.rows})
            qh, kh, vh = (t.view(B, L, H, hd).transpose(1, 2) for t in (q, k, v))
            bias = torch.zeros(B, 1, 1, L, device="cuda", dtype=dtype).masked_fill(~mask[:, None, None, :], -1e30)
            runs["sdpa"] = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias, scale=scale)
            ok = {}
            for name, run in runs.items():
                if name == "sdpa":
                    continue
                if run() != 0:
                    raise RuntimeError(f"attention_ablation: {name} did not launch at {case} {dname}")
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs()
                if dtype == torch.float32:
                    good = bool(torch.allclose(out, ref, rtol=1e-5, atol=1e-5))
                else:
                    good = bool((err <= 2.0 ** -7 * (ref.float().abs() + v.float().abs().max())).all())
                ok[name] = (good, err.max().item())
            ms = {name: [] for name in runs}
            for _ in range(3):  # in turns, so drift hits every variant alike
                for name, run in runs.items():
                    ms[name].append(timed(run))
            for name in runs:
                rec = {"variant": name, "dtype": dname, "case": case, "B": B, "L": L, "H": H, "hd": hd,
                       "copy_bytes": vb, "rows": min(int(name[5:]), -(-L // 16) * 16) if name.startswith("rows_") else geo.rows,
                       "ms": ms[name], "card": card}
                if name in ok:
                    rec["within_tolerance"], rec["max_abs_err"] = ok[name]
                print(json.dumps(rec), flush=True)
            del q, k, v, qkv, out, ref
    return 0


def main() -> int:
    if "--any" in sys.argv[1:]:
        return main_any()
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
