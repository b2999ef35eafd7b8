"""Universe promises (reference ``pathway_tpu/universes.py``): a later slice.

Each function raises ``NotImplementedError("later slice: universes")``.
"""

from __future__ import annotations

from pathway_tpu_torch.internals.later_slice import cut_callable

promise_are_equal = cut_callable("universes", "universes.promise_are_equal")
promise_is_subset_of = cut_callable("universes", "universes.promise_is_subset_of")
promise_are_pairwise_disjoint = cut_callable("universes", "universes.promise_are_pairwise_disjoint")

__all__ = ["promise_are_equal", "promise_is_subset_of", "promise_are_pairwise_disjoint"]
