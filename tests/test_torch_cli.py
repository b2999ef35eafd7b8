"""The port's command line (``python -m pathway_tpu_torch``): a mirror of the
reference's ``tests/test_cli.py``, run in a subprocess with ``click`` made
unimportable (the card's machine has none; the port's CLI is built on
``argparse``).

``spawn`` of the join → groupby / window pipeline on 2 processes x 2 threads
writes the same files as one process, and as the reference's ``spawn`` of
the same pipeline; ``spawn --record`` then ``replay`` with a live source
that emits more rows gives the recording's output, as the reference's
does.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import torch_cluster_helpers as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: runs the port's CLI with ``click`` unimportable; the reference's, as is
_NO_CLICK = "import runpy, sys; sys.modules['click'] = None; runpy.run_module('pathway_tpu_torch', run_name='__main__')"


def _cli(package, args, extra_env=None, timeout=120):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
               JAX_PLATFORMS="cpu", PATHWAY_BARRIER_TIMEOUT="45")
    env.update(extra_env or {})
    argv = [sys.executable, "-c", _NO_CLICK] if package == "pathway_tpu_torch" else [sys.executable, "-m", package]
    return subprocess.run([*argv, *args], env=env, capture_output=True, text=True, timeout=timeout)


def test_spawn_multiprocess_matches_solo(tmp_path):
    script = [sys.executable, tc.__file__, "groupby_window"]
    solo = str(tmp_path / "solo")
    r = _cli("pathway_tpu_torch", ["spawn", *script, solo])
    assert r.returncode == 0, r.stdout + r.stderr
    dist = str(tmp_path / "dist")
    r = _cli("pathway_tpu_torch", ["spawn", "-t", "2", "-n", "2", "--first-port", str(tc.first_port(2)), *script, dist])
    assert r.returncode == 0, r.stdout + r.stderr
    for suffix in (".groupby.csv", ".window.csv"):
        assert open(solo + suffix).read() == open(dist + suffix).read()
    # the reference's pipeline through the reference's spawn: the same files
    ref_script = tmp_path / "ref_pipeline.py"
    ref_script.write_text(
        "import sys\nimport pathway_tpu\nimport torch_cluster_helpers as tc\n"
        "tc.groupby_window(pathway_tpu, sys.argv[1])\n"
    )
    ref = str(tmp_path / "ref")
    r = _cli("pathway_tpu", ["spawn", sys.executable, str(ref_script), ref])
    assert r.returncode == 0, r.stdout + r.stderr
    for suffix in (".groupby.csv", ".window.csv"):
        assert open(solo + suffix).read() == open(ref + suffix).read()


_RECORDABLE = textwrap.dedent(
    """
    import os
    import sys

    import {package} as pw

    class Subj(pw.io.python.ConnectorSubject):
        def run(self):
            n = int(os.environ.get("N_EVENTS", "6"))
            for i in range(n):
                self.next(k=i % 3, v=i)

    S = pw.schema_from_types(k=int, v=int)
    t = pw.io.python.read(Subj(), schema=S, name="events")
    g = t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v))
    pw.io.fs.write(g, sys.argv[1], format="csv")
    pw.run()
    """
)


def test_record_then_replay(tmp_path):
    outs = {}
    for package in ("pathway_tpu_torch", "pathway_tpu"):
        d = tmp_path / package
        d.mkdir()
        script = d / "rec.py"
        script.write_text(_RECORDABLE.format(package=package))
        rec_root = str(d / "recording")
        out1 = str(d / "out1.csv")
        r = _cli(package, ["spawn", "--record", "--record-path", rec_root, sys.executable, str(script), out1],
                 extra_env={"N_EVENTS": "6"})
        assert r.returncode == 0, r.stdout + r.stderr
        # replay with the live source emitting MORE rows: the recording is
        # the whole input, so the extra live rows must be ignored
        out2 = str(d / "out2.csv")
        r = _cli(package, ["replay", "--record-path", rec_root, sys.executable, str(script), out2],
                 extra_env={"N_EVENTS": "50"})
        assert r.returncode == 0, r.stdout + r.stderr
        assert open(out1).read() == open(out2).read()
        outs[package] = open(out2).read()
    assert outs["pathway_tpu_torch"] == outs["pathway_tpu"]
