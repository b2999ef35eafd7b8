"""Zero-hop fabric serving under the shard-map plane, on the port: the
mirror of the reference's ``tests/test_fabric_shardmap.py`` with the doors
the port's fabric tests use (``torch_fabric_helpers``: the embed → KNN →
rerank ``/v1/retrieve`` pipeline on the tiny encoder, the CPU).

With ``PATHWAY_SHARDMAP=on`` (and ``PATHWAY_ELASTIC=manual``, as the
reference runs it) every door of a 3-process fabric routes each request
into its local ingest copy under a key it owns: every door answers the same
bytes as the one-process fabric-off run, every answer is stamped
``owner:p<pid>`` by the door it reached, request ids stay unique pod-wide,
and the coordinator's serving rollup counts 9 requests, 9 responses and no
forward.
"""

from __future__ import annotations

import torch_fabric_helpers as tf
from test_torch_fabric import single_retrieve  # noqa: F401  (fixture)


def test_shardmap_zero_hop_three_doors_byte_identity(tmp_path, single_retrieve):  # noqa: F811
    fabric = tf.run("retrieve", tmp_path, 3,
                    {"PATHWAY_FABRIC": "on", "PATHWAY_SHARDMAP": "on", "PATHWAY_ELASTIC": "manual"}, timeout=180)
    doors = sorted(fabric["answers"], key=int)
    assert len(doors) == 3
    for i, door in enumerate(doors):
        assert fabric["answers"][door] == single_retrieve, door
        assert fabric["fabric"][door] == [f"owner:p{i}"] * 3
    rids = [r for per_door in fabric["rids"].values() for r in per_door]
    assert len(set(rids)) == len(rids) == 9
    cluster = fabric["status"]["serving"]["cluster"]
    assert cluster["n_reporting"] == 3
    route = cluster["routes"]["/v1/retrieve"]
    assert (route["requests"], route["responses"]) == (9, 9)
    assert (route["forwarded_out"], route["forwarded_in"]) == (0, 0)
    assert fabric["status"]["fabric"]["enabled"] is True
    assert fabric["status"]["fabric"]["shardmap_version"] == 0
