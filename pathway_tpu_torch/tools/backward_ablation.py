"""Where the attention backward's two-pass route spends its time, by
source-level ablation, on one CUDA card.

    python -m pathway_tpu_torch.tools.backward_ablation

Builds variants of ``csrc/`` that differ in one place of the two-pass
kernels (``attention_two_pass_dq``, ``attention_two_pass_dkv`` in
``csrc/attention_bwd.cuh``) or of the products they share with the forward
(``csrc/attention_tc.cuh``), each a copy under ``build/ablation_bwd/`` with
both backward libraries built by ``nvcc`` (all compiles started together).
It times each kernel of the route with ``torch.profiler`` at four shapes,
in turns (the variants in order, then in reverse), both dtypes, and holds
each variant against the plain backward at the route's tolerance (f32 1e-5,
bf16 2^-7, times |ref| + max|ref|). Variants:

- ``as_built``: the sources as they are;
- ``two_slots``: two ring slots wherever they fit, whatever they cost in
  blocks an SM;
- ``two_blocks_cap``: two slots where they keep as many blocks an SM as one
  slot, counted up to two at every width (as_built counts up to three at
  widths up to 64);
- ``runtime_ncb``: the column-block count read from the head width in
  ``attention_short_bwd.cu`` too, where it is always 1 (as_built makes it a
  constant there, so the ring's slots and the step arithmetic fold);
- ``full_unroll``: the score products' k-steps fully unrolled;
- ``no_interleave`` (f32): the dK/dV pass's products at widths up to 64
  issue each accumulator's three TF32 products back to back;
- ``one_tf32_product`` (f32, misses 1e-5 by design): the big . big product
  alone, in both files;
- ``no_mma`` (wrong answers by design): every ``mma.sync`` replaced by a
  register update of the same operands: what the copies, the barriers and
  the softmax cost alone.

Prints one JSON line per (round, variant, dtype, shape). A variant whose
substitution no longer matches the source fails the run.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

#: (file, old, new) substitutions per variant, and the dtypes it runs in
TP_SLOTS = "  const int want = tp_blocks_per_sm(one) < cap ? tp_blocks_per_sm(one) : cap;"
CAPS = "W <= 64 ? 3 : 2);"
CROSS_TERMS_TC = (
    "    mma_tf32(c, a.small, s0.big, s1.big);\n    mma_tf32(c, a.big, s0.small, s1.small);\n"
)
CROSS_TERMS_TP = (
    "#pragma unroll\n  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.small, b0[n].big, b1[n].big);\n"
    "#pragma unroll\n  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.big, b0[n].small, b1[n].small);\n"
)
MMA_ASM = '  asm volatile(\n      "mma.sync.aligned.m16n8k'
NO_MMA = (
    "  c[0] += __uint_as_float(a[0] ^ b0);\n  c[1] += __uint_as_float(a[1] ^ b1);\n"
    "  c[2] += __uint_as_float(a[2]);\n  c[3] += __uint_as_float(a[3]);\n  return;\n"
)
BOTH = ("bfloat16", "float32")
VARIANTS = {
    "as_built": (BOTH, []),
    "two_slots": (BOTH, [("attention_bwd.cuh", TP_SLOTS, "  const int want = 1;")]),
    "two_blocks_cap": (BOTH, [("attention_bwd.cuh", CAPS, "2);")]),
    "runtime_ncb": (BOTH, [("attention_bwd.cuh", "  const int ncb = COLS ? (hd + W - 1) / W : 1;",
                            "  const int ncb = (hd + W - 1) / W;")]),
    "full_unroll": (BOTH, [("attention_bwd.cuh", "#pragma unroll 4\n  for (int kk = 0; kk < W / (2 * C); ++kk)",
                            "#pragma unroll\n  for (int kk = 0; kk < W / (2 * C); ++kk)")]),
    "no_interleave": (("float32",), [("attention_bwd.cuh", "  if constexpr (W > 64) {\n    keys_product",
                                      "  if constexpr (true) {\n    keys_product")]),
    "one_tf32_product": (("float32",), [("attention_tc.cuh", CROSS_TERMS_TC, ""),
                                        ("attention_bwd.cuh", CROSS_TERMS_TP, "")]),
    "no_mma": (BOTH, [("attention_tc.cuh", MMA_ASM, NO_MMA + MMA_ASM)]),
}
#: (B texts, L, heads, hd): the train step's shape forced to two passes, the
#: train phase's long leg (512 keys), 1,024 keys, 3 heads of 256 (column
#: blocks, attention_any.cu)
SHAPES = {"train": (512, 128, 6, 64), "long_leg": (64, 512, 6, 64), "l1024": (8, 1024, 6, 64),
          "train_hd256": (256, 128, 3, 256)}
ROOT = Path(__file__).resolve().parents[2] / "build" / "ablation_bwd"
LIBS = ("attention_short_bwd", "attention_any")


def variant_sources(csrc: Path, subs) -> dict[str, str]:
    """Every file of ``csrc`` with the variant's substitutions applied (each
    must match exactly once)."""
    files = {f.name: f.read_text() for f in csrc.iterdir() if f.is_file()}
    for name, old, new in subs:
        if files[name].count(old) < 1:
            raise SystemExit(f"backward_ablation: a substitution no longer matches {name}: {old[:60]!r}")
        files[name] = files[name].replace(old, new)
    return files


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("backward_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.ops import attention_kernel as A

    tree = _build.CSRC
    dirs = {}
    for name, (_dtypes, subs) in VARIANTS.items():
        d = ROOT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for fname, text in variant_sources(tree, subs).items():
            (d / fname).write_text(text)
        dirs[name] = d
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, d in dirs.items():
        _build.CSRC = d
        for lib in LIBS:
            out = _build.library_path(lib)
            if not out.exists():
                procs.append((name, lib, subprocess.Popen(_build.nvcc_command(lib, out), stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT, text=True)))
    _build.CSRC = tree
    _build.build(["attention_short"])
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"backward_ablation: {name} {lib} failed to build:\n{log[-3000:]}", file=sys.stderr)
            return 1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    inputs = {}
    for dname in BOTH:
        dtype = getattr(torch, dname)
        for case, (B, L, H, hd) in SHAPES.items():
            D = H * hd
            qkv = torch.randn(B, L, 3 * D, device="cuda", generator=gen).to(dtype)
            q, k, v = qkv.split(D, dim=-1)
            lens = torch.randint(1, L + 1, (B,), device="cuda", generator=gen)
            mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
            mask[0] = False
            out = A.attention_short_flat(q, k, v, mask, H, hd ** -0.5)
            g = torch.randn(B, L, D, device="cuda", generator=gen).to(dtype)
            want = A.attention_short_flat_backward_plain(q, k, v, mask, out, g, H, hd ** -0.5)
            inputs[(dname, case)] = (q, k, v, mask, out, g, H, hd, want)
    order = list(VARIANTS)
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            _build.CSRC = dirs[name]
            for lib in LIBS:
                _build._libs.pop(lib, None)
            A._backward_fn = A._backward_any_fn = None
            for (dname, case), (q, k, v, mask, out, g, H, hd, want) in inputs.items():
                if dname not in VARIANTS[name][0]:
                    continue
                B, L = q.shape[:2]
                geo = A._two_pass_geometry(B, L, H, hd, q.dtype, A.copy_width(hd, q.element_size(), q, k, v, out))
                run = lambda: A._launch_backward(q, k, v, mask, out, g, H, hd ** -0.5, hd, geo)  # noqa: E731
                got = run()
                rel = 1e-5 if dname == "float32" else 2.0 ** -7
                ok = all(bool(((a.float() - b.float()).abs() <= rel * (b.float().abs() + b.float().abs().max())).all())
                         for a, b in zip(got, want))
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        run()
                    torch.cuda.synchronize()
                ms = {("dq" if "two_pass_dq" in ev.key else "dkv"): ev.device_time_total / 1e3 / 5
                      for ev in prof.key_averages() if "two_pass" in ev.key}
                print(json.dumps({"round": rnd, "variant": name, "dtype": dname, "case": case, "route": geo.route,
                                  "ok": ok, "ms": ms, "total_ms": sum(ms.values()), "card": card}), flush=True)
    _build.CSRC = tree
    return 0


if __name__ == "__main__":
    sys.exit(main())
