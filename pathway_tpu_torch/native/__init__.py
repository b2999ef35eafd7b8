"""Host C kernels of the port, built lazily with the system C compiler into
``native/_build/``. Every kernel has a bit-identical pure-Python path in its
caller, so a missing compiler costs speed, never correctness. This is host
code, not a device fallback.

:data:`last_error` keeps why a kernel did not load, and :data:`build_seconds`
how long its build took in this process (the first call pays it, so a caller
that times the kernel builds it first with :func:`try_load`)."""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sysconfig
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "_build")

#: kernel name -> why it could not be built or loaded (absent once it loads)
last_error: dict[str, str] = {}
#: kernel name -> seconds its compile took in this process
build_seconds: dict[str, float] = {}


def compiler() -> str | None:
    """``$CC``, else ``cc``, found on PATH; None when there is none."""
    return shutil.which(os.environ.get("CC", "cc"))


def _load(name: str):
    so_path = os.path.join(_BUILD, f"{name}.so")
    src = os.path.join(_DIR, f"{name}.c")
    src_mtime = os.path.getmtime(src)
    marker = os.path.join(_BUILD, f"{name}.failed")
    if not os.path.exists(so_path) or os.path.getmtime(so_path) < src_mtime:
        # a recorded failure for this exact source skips the doomed compile on
        # every later process start (cleared by touching the source); the
        # marker keeps the compiler's message
        if os.path.exists(marker):
            with open(marker) as f:
                stamp, _, msg = f.read().partition("\n")
            if stamp.strip() == str(src_mtime):
                raise RuntimeError(f"native build of {name} previously failed: {msg}")
        cc = compiler()
        if cc is None:
            raise RuntimeError(f"no C compiler ({os.environ.get('CC', 'cc')}) on PATH")
        os.makedirs(_BUILD, exist_ok=True)
        import numpy as np

        tmp = f"{so_path}.{os.getpid()}.tmp"  # unique: concurrent builders don't clobber
        cmd = [
            cc, "-O2", "-shared", "-fPIC",
            f"-I{sysconfig.get_path('include')}",
            f"-I{np.get_include()}",
            src, "-o", tmp,
        ]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            msg = f"{' '.join(cmd)} exited {proc.returncode}: {proc.stderr.strip()[-2000:]}"
            try:
                with open(marker, "w") as f:
                    f.write(f"{src_mtime}\n{msg}")
            except OSError:
                pass
            raise RuntimeError(msg)
        build_seconds[name] = time.perf_counter() - t0
        os.replace(tmp, so_path)  # atomic publish; racing winners are identical
        # the device plane counts each build under ``compiles``
        from pathway_tpu_torch.observability import device as _dev_prof

        _dev_prof.note_build(f"{name}.c", build_seconds[name])
    spec = importlib.util.spec_from_file_location(name, so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def try_load(name: str):
    """Compiled module, or None when it cannot be built or loaded (the caller
    then runs its pure-Python path); the reason lands in :data:`last_error`."""
    try:
        mod = _load(name)
    except (OSError, ImportError, RuntimeError) as exc:
        last_error[name] = f"{type(exc).__name__}: {exc}"
        return None
    last_error.pop(name, None)
    return mod
