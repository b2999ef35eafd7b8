"""``pw.demo`` on the port against the reference: the synthetic streams
(``range_stream``, ``noisy_linear_stream``, ``generate_custom_stream``) give
the same final rows under the same keys on both packages, and the CSV
replays (``replay_csv``, ``replay_csv_with_time``) give the rows a static
CSV read of the same file gives on the reference."""

from __future__ import annotations

import pytest

import pathway_tpu
import pathway_tpu_torch
from pathway_tpu.debug import _capture as ref_capture
from pathway_tpu_torch.debug import _capture as port_capture

SIDES = ((pathway_tpu, ref_capture), (pathway_tpu_torch, port_capture))


def _final(pw, cap, build):
    pw.G.clear()
    t = build(pw)
    rows = sorted((int(k), tuple(r)) for k, r in cap(t).rows.items())
    pw.G.clear()
    return rows


@pytest.mark.parametrize("stream", ["range", "noisy_linear", "custom"])
def test_demo_stream_matches_the_reference(stream):
    builds = {
        "range": lambda pw: pw.demo.range_stream(nb_rows=12, offset=3, input_rate=5000.0),
        "noisy_linear": lambda pw: pw.demo.noisy_linear_stream(nb_rows=10, input_rate=5000.0),
        "custom": lambda pw: pw.demo.generate_custom_stream(
            {"a": lambda i: i * i, "b": lambda i: f"r{i % 3}"},
            schema=pw.schema_from_types(a=int, b=str), nb_rows=9, input_rate=5000.0,
        ),
    }
    got = [_final(pw, cap, builds[stream]) for pw, cap in SIDES]
    assert got[1] == got[0]
    assert len(got[0]) == {"range": 12, "noisy_linear": 10, "custom": 9}[stream]


@pytest.mark.parametrize("timed", [False, True])
def test_demo_csv_replay_matches_a_static_read(tmp_path, timed):
    path = tmp_path / "in.csv"
    path.write_text("t,word,n\n" + "".join(f"{i},w{i % 4},{i * 10}\n" for i in range(8)))

    def static(pw):
        return pw.io.csv.read(str(path), schema=pw.schema_from_types(t=int, word=str, n=int), mode="static")

    def replay(pw):
        schema = pw.schema_from_types(t=int, word=str, n=int)
        if timed:
            return pw.demo.replay_csv_with_time(str(path), schema=schema, time_column="t", unit="ms")
        return pw.demo.replay_csv(str(path), schema=schema, input_rate=5000.0)

    want = sorted(r for _k, r in _final(pathway_tpu, ref_capture, static))
    got = sorted(r for _k, r in _final(pathway_tpu_torch, port_capture, replay))
    assert got == want and len(got) == 8
