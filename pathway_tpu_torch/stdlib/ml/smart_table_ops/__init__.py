"""Fuzzy joins (reference: ``stdlib/ml/smart_table_ops/``): match rows of two
tables by shared text features, weighted by rarity, keeping mutually-best
pairs.

Own-design pipeline (the reference iterates heavy/light hitters over a
normalizer matrix; this build reaches the same contract with the engine's
vectorized primitives): tokenize each row's columns into word features →
weight each feature by ``1 / log(1 + global count)`` (LOGWEIGHT) or
``1 / count`` (WEIGHT) → candidate pairs via an equi-join on the feature →
score = sum of shared feature weights → keep pairs that are the best match
for BOTH sides (mutual argmax, deterministic tie-breaks), optionally seeded /
overridden by a ``by_hand_match`` table.
"""

from __future__ import annotations

import re
from typing import Any

import pathway_tpu_torch as pw


class FuzzyJoinNormalization:
    WEIGHT = "weight"
    LOGWEIGHT = "logweight"
    NONE = "none"


class FuzzyJoinFeatureGeneration:
    AUTO = "auto"
    WORDS = "words"


class JoinResult(pw.Schema):
    left: Any
    right: Any
    weight: float


def _featurize(table: "pw.Table") -> "pw.Table":
    cols = table.column_names()

    def words(*vals):
        toks: list[str] = []
        for v in vals:
            if v is None:
                continue
            toks.extend(re.findall(r"[a-z0-9]+", str(v).lower()))
        return tuple(sorted(set(toks)))

    feats = table.select(
        feats=pw.apply(words, *[table[c] for c in cols])
    )
    flat = feats.flatten(feats.feats, origin_id="row")
    return flat.select(row=flat.row, feature=flat.feats)


def _weighted(features: "pw.Table", normalization: str) -> "pw.Table":
    counts = features.groupby(features.feature).reduce(
        feature=features.feature, n=pw.reducers.count()
    )

    if normalization == FuzzyJoinNormalization.WEIGHT:
        def w(n):
            return 1.0 / n
    elif normalization == FuzzyJoinNormalization.LOGWEIGHT:
        import math

        def w(n):
            return 1.0 / math.log(1.0 + n)
    else:
        def w(n):
            return 1.0

    return counts.select(feature=counts.feature, weight=pw.apply(w, counts.n))


def fuzzy_match(
    left_features: "pw.Table",
    right_features: "pw.Table",
    normalization: str = FuzzyJoinNormalization.LOGWEIGHT,
    _exclude_same_row: bool = False,
) -> "pw.Table":
    """Match by precomputed (row, feature) tables; returns JoinResult rows."""
    all_feats = pw.Table.concat_reindex(
        left_features.select(feature=left_features.feature),
        right_features.select(feature=right_features.feature),
    )
    weights = _weighted(all_feats, normalization)

    lw = left_features.join(weights, left_features.feature == weights.feature).select(
        row=left_features.row, feature=left_features.feature, weight=weights.weight
    )
    pairs = lw.join(right_features, lw.feature == right_features.feature).select(
        left=lw.row, right=right_features.row, weight=lw.weight
    )
    scored = pairs.groupby(pairs.left, pairs.right).reduce(
        left=pairs.left, right=pairs.right, weight=pw.reducers.sum(pairs.weight)
    )
    if _exclude_same_row:
        # self-match: the trivial identity pair would always win the argmax
        scored = scored.filter(
            pw.apply(lambda l, r: int(l) != int(r), scored.left, scored.right)
        )

    # mutual best: each side keeps its argmax partner; negated key in the
    # packed tuple makes max() break weight ties toward the SMALLER key
    packed = scored.select(
        left=scored.left,
        right=scored.right,
        weight=scored.weight,
        wr=pw.apply(lambda w, r: (w, -int(r)), scored.weight, scored.right),
        wl=pw.apply(lambda w, l: (w, -int(l)), scored.weight, scored.left),
    )
    best_r = packed.groupby(packed.left).reduce(
        left=packed.left, best=pw.reducers.max(packed.wr)
    )
    best_l = packed.groupby(packed.right).reduce(
        right=packed.right, best=pw.reducers.max(packed.wl)
    )
    joined = (
        packed.join(best_r, packed.left == best_r.left)
        .select(
            left=packed.left,
            right=packed.right,
            weight=packed.weight,
            wr=packed.wr,
            wl=packed.wl,
            best_r=best_r.best,
        )
    )
    joined = joined.join(best_l, joined.right == best_l.right).select(
        left=joined.left,
        right=joined.right,
        weight=joined.weight,
        keep=pw.apply(
            lambda wr, br, wl, bl: wr == br and wl == bl,
            joined.wr,
            joined.best_r,
            joined.wl,
            best_l.best,
        ),
    )
    return joined.filter(joined.keep).select(
        left=joined.left, right=joined.right, weight=joined.weight
    )


def fuzzy_match_tables(
    left_table: "pw.Table",
    right_table: "pw.Table",
    *,
    by_hand_match: "pw.Table" = None,
    normalization: str = FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation: str = FuzzyJoinFeatureGeneration.AUTO,
    left_projection: dict | None = None,
    right_projection: dict | None = None,
) -> "pw.Table":
    """Match rows of two tables by fuzzy text similarity over all columns
    (or the projected subsets)."""
    lt = left_table
    rt = right_table
    if left_projection:
        lt = left_table.select(**{c: left_table[c] for c in left_projection})
    if right_projection:
        rt = right_table.select(**{c: right_table[c] for c in right_projection})
    result = fuzzy_match(_featurize(lt), _featurize(rt), normalization)
    if by_hand_match is not None:
        forced = by_hand_match.select(
            left=by_hand_match.left,
            right=by_hand_match.right,
            weight=by_hand_match.weight,
        )
        # forced pairs replace any computed pair for the same left row
        keep = result.join_left(forced, result.left == forced.left).select(
            left=result.left,
            right=result.right,
            weight=result.weight,
            overridden=forced.right.is_not_none(),
        )
        surviving = keep.filter(~keep.overridden).select(
            left=keep.left, right=keep.right, weight=keep.weight
        )
        result = pw.Table.concat_reindex(surviving, forced)
    return result


def fuzzy_self_match(
    table: "pw.Table",
    normalization: str = FuzzyJoinNormalization.LOGWEIGHT,
) -> "pw.Table":
    """Match rows of a table against itself (excluding the trivial self-pair)."""
    feats = _featurize(table)
    return fuzzy_match(feats, feats, normalization, _exclude_same_row=True)
