"""Does the plain attention keep its f32 accuracy on a loaded CPU?

    python -m pathway_tpu_torch.tools.cpu_attention_stress [--processes 400] [--parallel 4] [--calls 4]

Runs two arms of ``--processes`` Python processes each, one arm after the
other, at the same load in threads: first with torch's default intra-op
threads, ``--parallel`` processes at a time, then pinned to one thread
(``torch.set_num_threads(1)``), ``--parallel`` times the default thread
count at a time. Each process calls
``ops.attention_kernel.attention_short_flat_plain`` ``--calls`` times on the
CPU inputs of ``tests/test_torch_attention.py``'s Pallas comparison (seed 3,
B 16, L 64, 6 heads of 64) and measures each call's largest error against
the same attention in float64. Prints one JSON line: per arm, the processes
run, those with a call more than 5e-6 off (f32 rounding reads ~8e-7), and
the errors seen. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_OFF = 5e-6


def _errors(calls: int) -> list[float]:
    import numpy as np
    import torch

    from pathway_tpu_torch.ops import attention_kernel as A

    rng = np.random.default_rng(3)
    B, L, H, hd = 16, 64, 6, 64
    D = H * hd
    q, k, v = (rng.standard_normal((B, L, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, L), bool)
    mask[:, L - L // 4:] = False
    mask[0, :] = False
    q64, k64, v64 = (a.astype(np.float64).reshape(B, L, H, hd) for a in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q64, k64) * hd ** -0.5
    s = np.where(mask[:, None, None, :], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bkhd->bqhd", p, v64).reshape(B, L, D)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    return [
        float(np.abs(A.attention_short_flat_plain(tq, tk, tv, tm, H, hd ** -0.5).numpy() - want).max())
        for _ in range(calls)
    ]


def _child(threads: str, calls: int) -> None:
    if threads != "default":
        import torch

        torch.set_num_threads(int(threads))
    print(json.dumps(_errors(calls)), flush=True)


def _run_one(threads: str, calls: int) -> list[float]:
    proc = subprocess.run(
        [sys.executable, "-m", "pathway_tpu_torch.tools.cpu_attention_stress", "--child", threads,
         "--calls", str(calls)],
        capture_output=True, text=True, timeout=600, env=dict(os.environ),
    )
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-2000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=400)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        _child(args.child, args.calls)
        return 0
    import torch

    out = {}
    for arm, at_once in (("default", args.parallel), ("1", args.parallel * torch.get_num_threads())):
        with ThreadPoolExecutor(max_workers=at_once) as pool:
            runs = list(pool.map(lambda _: _run_one(arm, args.calls), range(args.processes)))
        bad = [errs for errs in runs if max(errs) > _OFF]
        out[f"threads_{arm}"] = {
            "processes": len(runs),
            "at_once": at_once,
            "processes_off": len(bad),
            "off_errors": bad,
            "largest_error_of_the_rest": max((max(e) for e in runs if max(e) <= _OFF), default=None),
        }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
