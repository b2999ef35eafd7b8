"""``pw.universes`` — user promises about key-set relations
(reference: ``python/pathway/universes.py``).

Carried from ``pathway_tpu/universes.py`` with imports rewritten."""

from __future__ import annotations

from pathway_tpu_torch.internals.universe import solver


def promise_are_equal(*tables) -> None:
    for t in tables[1:]:
        solver().register_equal(tables[0]._universe, t._universe)


def promise_is_subset_of(table, *others) -> None:
    for o in others:
        solver().register_subset(table._universe, o._universe)


def promise_are_pairwise_disjoint(*tables) -> None:
    pass  # tracked implicitly; concat validates at runtime


__all__ = ["promise_are_equal", "promise_is_subset_of", "promise_are_pairwise_disjoint"]
