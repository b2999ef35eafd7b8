"""Hidden-Markov-Model decoding reducer (reference: ``stdlib/ml/hmm.py``).

``create_hmm_reducer(graph)`` returns a ``pw.reducers.udf_reducer``-style
reducer running ONLINE Viterbi: each appended observation advances the
log-probability front one transition (optionally beam-trimmed) and the
accumulator's result is the most likely hidden-state path so far.

Graph contract (same as the reference): a ``networkx.DiGraph`` whose nodes
carry ``calc_emission_log_ppb(observation) -> float``, whose edges carry
``log_transition_ppb``, and whose graph dict names ``start_nodes``. Only
``nodes``, ``successors``, ``get_edge_data`` and ``graph`` are read, so any
object with them serves and ``networkx`` is not needed.

Carried from ``pathway_tpu/stdlib/ml/hmm.py`` with imports rewritten.
"""

from __future__ import annotations

from collections import deque

import numpy as np

import pathway_tpu_torch as pw


def create_hmm_reducer(graph, beam_size: int | None = None, num_results_kept: int | None = None):
    nodes = list(graph.nodes)
    idx_of = {node: i for i, node in enumerate(nodes)}
    n = len(nodes)
    emit = [graph.nodes[node]["calc_emission_log_ppb"] for node in nodes]
    succs = [
        [
            (idx_of[t], graph.get_edge_data(node, t)["log_transition_ppb"])
            for t in graph.successors(node)
        ]
        for node in nodes
    ]
    start_idx = [idx_of[s] for s in graph.graph["start_nodes"]]
    beam = beam_size if beam_size is not None else n + 1

    class HmmAccumulator(pw.BaseCustomAccumulator):
        def __init__(self, observation):
            self._obs = observation
            self.ppb = np.full(n, -np.inf)
            for i in start_idx:
                self.ppb[i] = emit[i](observation)
            self.live = list(start_idx)
            # num_results_kept bounds state, not just the returned path —
            # an unbounded stream would otherwise grow O(T * n) per key
            self.backpointers: deque[np.ndarray] = deque(maxlen=num_results_kept)
            self._trim()

        @classmethod
        def from_row(cls, row):
            [observation] = row
            return cls(observation)

        def _trim(self) -> None:
            if len(self.live) > beam:
                costs = self.ppb[self.live]
                keep = np.argsort(costs)[-beam:]
                kept = {self.live[int(i)] for i in keep}
                for i in self.live:
                    if i not in kept:
                        self.ppb[i] = -np.inf
                self.live = sorted(kept)

        def update(self, other) -> None:
            # other is a freshly-seeded accumulator for ONE observation; its
            # start distribution is ignored — we advance OUR front with its
            # observation (append-only online decoding, like the reference)
            observation = other._obs
            new_ppb = np.full(n, -np.inf)
            back = np.full(n, -1, dtype=np.int64)
            for i in self.live:
                base = self.ppb[i]
                for j, log_t in succs[i]:
                    cand = base + log_t
                    if cand > new_ppb[j] or (cand == new_ppb[j] and i < back[j]):
                        new_ppb[j] = cand
                        back[j] = i
            live = [j for j in range(n) if np.isfinite(new_ppb[j])]
            for j in live:
                new_ppb[j] += emit[j](observation)
            self.ppb = new_ppb
            self.live = live
            self.backpointers.append(back)
            self._trim()

        def compute_result(self):
            if not self.live:
                return ()
            cur = int(max(self.live, key=lambda j: (self.ppb[j], -j)))
            path = [nodes[cur]]
            for back in reversed(self.backpointers):
                cur = int(back[cur])
                if cur < 0:
                    break
                path.append(nodes[cur])
            path.reverse()
            if num_results_kept is not None:
                path = path[-num_results_kept:]
            return tuple(path)

    return pw.reducers.udf_reducer(HmmAccumulator)
