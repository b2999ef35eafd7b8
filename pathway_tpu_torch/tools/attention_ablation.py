"""Where the bf16 attention kernel's time goes, by source-level ablation, on one CUDA card.

    python -m pathway_tpu_torch.tools.attention_ablation

Builds variants of ``csrc/attention_short.cu`` that differ in one place of
the tensor-core (bf16) route, each with ``nvcc`` into ``build/ablation/``
(all compiles started together), and times each at the embed shape
(B=1024, L=128, D=384, H=6, bf16) with CUDA events, in turns, beside
``F.scaled_dot_product_attention`` with an additive mask. Each variant is
held against the plain version with the kernel's bf16 tolerance. Variants:

- ``as_built``: the source as it is;
- ``compiler_division``: probs as ``e / l`` by the compiler's division in
  place of the reciprocal-and-correction division;
- ``exp2_folded``: ``exp2f`` with log2(e) folded into the scale and the
  mask fill, in place of ``expf``;
- ``no_softmax``: no exponential and no division (wrong answers by design):
  what the copies, the products and the masking cost alone.

Prints one JSON line per variant and one for the library call. A variant
whose substitution no longer matches the source fails the run.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

LOG2E = "1.4426950408889634f"
EXP_TILE = (
    "    s[j][0] = expf(s[j][0] - m0);\n    s[j][1] = expf(s[j][1] - m0);\n"
    "    s[j][2] = expf(s[j][2] - m1);\n    s[j][3] = expf(s[j][3] - m1);\n"
)
DIVISION = "  const float q = __fmul_rn(e, r);\n  return fmaf(fmaf(-q, l, e), r, q);"
#: variant -> (old, new) substitutions inside the bf16 route's source
VARIANTS = {
    "as_built": [],
    "compiler_division": [(DIVISION, "  return e / l;")],
    "exp2_folded": [
        ("expf(", "exp2f("),
        ("? 0.f : -1e30f;", f"? 0.f : -1e30f * {LOG2E};"),
        ("scale, lane)", f"scale * {LOG2E}, lane)"),
    ],
    "no_softmax": [(EXP_TILE, ""), (DIVISION, "  return e;")],
}


def _variant_source(src: str, subs) -> str:
    start = src.index("// bf16 route: tensor cores")
    head, route = src[:start], src[start:]
    for old, new in subs:
        if old not in route:
            raise RuntimeError(f"attention_ablation: {old[:40]!r} is no longer in the bf16 route")
        route = route.replace(old, new)
    return head + route


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
    for name, subs in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(_variant_source(src, subs))
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(cu)],
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
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    qkv = torch.randn(B, L, 3 * D, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    lens = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
    mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    mask[0] = False
    ref = A.attention_short_flat_plain(q, k, v, mask, H, scale).float()
    bound = 2.0 ** -7 * (ref.abs() + v.float().abs().max())
    out = torch.empty(B, L, D, dtype=torch.bfloat16, device="cuda")
    rows = A.launch_geometry(B, L, H, hd, torch.bfloat16).rows
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(fn):
        args = (
            1, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            B, L, H, rows, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), mask.stride(0), scale, stream,
        )
        return lambda: fn(*args)

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

    runs = {name: launcher(fn) for name, fn in fns.items()}
    qh, kh, vh = (t.view(B, L, H, hd).transpose(1, 2) for t in (q, k, v))
    bias = torch.zeros(B, 1, 1, L, device="cuda", dtype=torch.bfloat16).masked_fill(
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
        err = (out.float() - ref).abs()
        ok[name] = (bool((err <= bound).all()), err.max().item())
    ms = {name: [] for name in runs}
    for _ in range(3):  # in turns, so drift hits every variant alike
        for name, run in runs.items():
            ms[name].append(timed(run))
    for name in runs:
        rec = {"variant": name, "ms": ms[name], "shape": "B=1024 L=128 D=384 H=6 bf16"}
        if name in ok:
            rec["within_tolerance"], rec["max_abs_err"] = ok[name]
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
