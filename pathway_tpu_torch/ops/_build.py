"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point. At first use
it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the root of the checkout and loaded with ``ctypes``; no
PyTorch headers are involved, so a build takes seconds. The library's name
carries a digest of its source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header builds anew.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

#: kernel name -> its source under csrc/
SOURCES = {"attention_short": "attention_short.cu", "attention_short_bwd": "attention_short_bwd.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: dict[str, ctypes.CDLL] = {}
#: nvcc's output per built kernel (ptxas register / shared-memory / spill report)
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of pathway_tpu_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where the kernel's library is built: its name carries a digest of the
    source, of every header under ``csrc/`` (a source may include any of
    them) and of the flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / SOURCES[name])]


def build(names=None) -> dict[str, float]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes started together; returns seconds per kernel built. Raises with
    the compiler's output when one fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                nvcc_command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out, time.perf_counter(),
        )
    times = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic publish: concurrent builders write identical files
        # the device plane counts each build under ``compiles``
        from pathway_tpu_torch.observability import device as _dev_prof

        _dev_prof.note_build(SOURCES[name], times[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib
