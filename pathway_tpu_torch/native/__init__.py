"""Host C kernels of the port, built lazily with the system C compiler into
``native/_build/``. Every kernel has a bit-identical pure-Python path in its
caller, so a missing compiler costs speed, never correctness. This is host
code, not a device fallback."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sysconfig

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "_build")


def _load(name: str):
    so_path = os.path.join(_BUILD, f"{name}.so")
    src = os.path.join(_DIR, f"{name}.c")
    src_mtime = os.path.getmtime(src)
    marker = os.path.join(_BUILD, f"{name}.failed")
    if not os.path.exists(so_path) or os.path.getmtime(so_path) < src_mtime:
        # a recorded failure for this exact source skips the doomed compile on
        # every later process start (cleared by touching the source)
        if os.path.exists(marker):
            with open(marker) as f:
                if f.read().strip() == str(src_mtime):
                    raise RuntimeError(f"native build of {name} previously failed")
        os.makedirs(_BUILD, exist_ok=True)
        import numpy as np

        tmp = f"{so_path}.{os.getpid()}.tmp"  # unique: concurrent builders don't clobber
        cmd = [
            os.environ.get("CC", "cc"), "-O2", "-shared", "-fPIC",
            f"-I{sysconfig.get_path('include')}",
            f"-I{np.get_include()}",
            src, "-o", tmp,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            try:
                with open(marker, "w") as f:
                    f.write(str(src_mtime))
            except OSError:
                pass
            raise
        os.replace(tmp, so_path)  # atomic publish; racing winners are identical
    spec = importlib.util.spec_from_file_location(name, so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def try_load(name: str):
    """Compiled module, or None when it cannot be built or loaded (the caller
    then runs its pure-Python path)."""
    try:
        return _load(name)
    except (OSError, ImportError, RuntimeError, subprocess.CalledProcessError):
        return None
