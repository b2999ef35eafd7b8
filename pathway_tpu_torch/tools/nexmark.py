"""A Nexmark-shaped event stream and the windowed queries Q5, Q7 and Q8 as
Pathway pipelines, with the temporal Table API's other operators over it.

The stream follows the generator defaults of Apache Beam's
``NexmarkConfiguration`` (``sdks/java/testing/nexmark``): persons, auctions
and bids in the proportion 1:3:46, event time advancing at 10,000 events/s,
hot auction ratio 2, hot seller and hot bidder ratios 4, 100 auctions in
flight, 1,000 active people, the auction and person id leads of 10, and
prices of ``round(10^(6u) * 100)`` cents. The ids follow Beam's
``lastBase0PersonId`` / ``lastBase0AuctionId`` arithmetic; the random draws
come from numpy's generator seeded with ``seed``, not from Java's. One
departure: Nexmark's events arrive in event-time order; here a share of the
bids (``late_share``, chosen by the seed) carry an event time 1-8 s before
their arrival, so temporal behaviors have late data to act on.

Event times are integer milliseconds. The queries, as in the nexmark-flink
suite:
- Q5 (hot items): ``sliding(hop=2 s, duration=10 s)`` over bids, the count
  per auction, then the auctions with the highest count in each window;
- Q7 (highest bid): ``tumbling(10 s)``, the highest price per window joined
  back to its bids, with or without a temporal behavior;
- Q8 (monitor new users): persons joined to the auctions they sell inside
  the same ``tumbling(10 s)`` window (``window_join``);
- ``surface``: an ``asof_join`` of each bid to its bidder's person row, an
  ``interval_join`` of bids to their auction's creation within [0, 10 s],
  ``diff`` of each auction's bid prices in event-time order, and
  ``deduplicate`` keeping a bid only when it beats its auction's kept price.

Every builder takes the package as ``pw`` (this module imports neither
package), so the same pipeline runs on the port and on the JAX package.
Each query also counts the bids (or persons and auctions) it reads: that
gives the split's filter/select chain a second consumer, so it stays one
fused segment of numeric expressions, the fused device tier's input.
"""

from __future__ import annotations

from importlib import import_module

import numpy as np

PERSON, AUCTION, BID = 0, 1, 2
COLUMNS = ("kind", "eid", "auction", "bidder", "seller", "category", "price", "reserve", "city", "t")

# Beam NexmarkConfiguration defaults and generator constants
PROPORTIONS = (1, 3, 46)  # person, auction, bid
EVENTS_PER_S = 10_000
HOT_AUCTION_RATIO = 2
HOT_SELLER_RATIO = 4
HOT_BIDDER_RATIO = 4
IN_FLIGHT_AUCTIONS = 100
ACTIVE_PEOPLE = 1000
AUCTION_ID_LEAD = 10
PERSON_ID_LEAD = 10
FIRST_PERSON_ID = 1000
FIRST_AUCTION_ID = 1000
FIRST_CATEGORY_ID = 10
N_CATEGORIES = 5
N_CITIES = 10

#: window widths of the queries, in event-time milliseconds
Q5_HOP_MS, Q5_DURATION_MS = 2_000, 10_000
Q7_WINDOW_MS = 10_000
Q8_WINDOW_MS = 10_000
Q7_CUTOFF_MS = 5_000
SURFACE_INTERVAL_MS = 10_000


def _price(rng, n: int) -> np.ndarray:
    """Beam ``nextPrice``: ``round(10^(6u) * 100)`` cents."""
    return np.round(10.0 ** (rng.random(n) * 6.0) * 100.0).astype(np.int64)


def _next_person(rng, last_person: np.ndarray) -> np.ndarray:
    """Beam ``nextBase0PersonId``: one of the active people, or a little ahead."""
    n_people = last_person + 1
    active = np.minimum(n_people, ACTIVE_PEOPLE)
    return n_people - active + (rng.random(len(last_person)) * (active + PERSON_ID_LEAD)).astype(np.int64)


def generate(n: int, seed: int = 0, late_share: float = 0.02, late_ms=(1_000, 8_000)) -> dict:
    """``n`` events as int64 columns (``COLUMNS``) in arrival order, plus
    ``late`` (bool: a bid whose event time was moved back)."""
    rng = np.random.default_rng(seed)
    total = sum(PROPORTIONS)
    n_person, n_auction = PROPORTIONS[0], PROPORTIONS[1]
    idx = np.arange(n, dtype=np.int64)
    epoch, off = idx // total, idx % total
    kind = np.where(off < n_person, PERSON, np.where(off < n_person + n_auction, AUCTION, BID))
    # lastBase0PersonId / lastBase0AuctionId
    last_person = epoch * n_person + np.minimum(off, n_person - 1)
    a_epoch = np.where(off < n_person, epoch - 1, epoch)
    a_off = np.where(
        off < n_person, n_auction - 1, np.minimum(off - n_person, n_auction - 1)
    )
    last_auction = a_epoch * n_auction + a_off
    t = idx * 1000 // EVENTS_PER_S

    col = {c: np.zeros(n, np.int64) for c in COLUMNS}
    col["kind"] = kind.astype(np.int64)
    col["t"] = t
    is_p, is_a, is_b = kind == PERSON, kind == AUCTION, kind == BID
    # persons
    col["eid"][is_p] = last_person[is_p] + FIRST_PERSON_ID
    col["city"][is_p] = rng.integers(0, N_CITIES, int(is_p.sum()))
    # auctions
    na = int(is_a.sum())
    col["eid"][is_a] = last_auction[is_a] + FIRST_AUCTION_ID
    hot = rng.integers(0, HOT_SELLER_RATIO, na) > 0
    lp = last_person[is_a]
    col["seller"][is_a] = np.where(
        hot, (lp // HOT_SELLER_RATIO) * HOT_SELLER_RATIO, _next_person(rng, lp)
    ) + FIRST_PERSON_ID
    col["category"][is_a] = FIRST_CATEGORY_ID + rng.integers(0, N_CATEGORIES, na)
    col["reserve"][is_a] = _price(rng, na) + _price(rng, na)
    # bids
    nb = int(is_b.sum())
    la = last_auction[is_b]
    hot = rng.integers(0, HOT_AUCTION_RATIO, nb) > 0
    lo = np.maximum(la - IN_FLIGHT_AUCTIONS, 0)
    cold = lo + (rng.random(nb) * (la - lo + 1 + AUCTION_ID_LEAD)).astype(np.int64)
    col["auction"][is_b] = np.where(hot, (la // HOT_AUCTION_RATIO) * HOT_AUCTION_RATIO, cold) + FIRST_AUCTION_ID
    lp = last_person[is_b]
    hot = rng.integers(0, HOT_BIDDER_RATIO, nb) > 0
    col["bidder"][is_b] = np.where(
        hot, (lp // HOT_BIDDER_RATIO) * HOT_BIDDER_RATIO + 1, _next_person(rng, lp)
    ) + FIRST_PERSON_ID
    col["price"][is_b] = _price(rng, nb)
    # the departure from Nexmark: a share of the bids arrive late
    late = np.zeros(n, bool)
    bid_rows = np.flatnonzero(is_b)
    chosen = bid_rows[rng.random(nb) < late_share]
    late[chosen] = True
    col["t"][chosen] = np.maximum(col["t"][chosen] - rng.integers(late_ms[0], late_ms[1] + 1, len(chosen)), 0)
    col["late"] = late
    return col


def events_table(pw, ev: dict, tick_rows: int | None = None):
    """The events as a table: one static tick (``tick_rows=None``), or
    arriving ``tick_rows`` at a time at logical times 2, 4, 6, ..."""
    schema = pw.schema_from_types(**{c: int for c in COLUMNS})
    cols = [ev[c].tolist() for c in COLUMNS]
    if tick_rows is None:
        return pw.debug.table_from_rows(schema, list(zip(*cols)))
    n = len(ev["t"])
    times = (2 * (1 + np.arange(n) // tick_rows)).tolist()
    return pw.debug.table_from_rows(schema, list(zip(*cols, times, [1] * n)), is_stream=True)


def split(pw, events):
    """(persons, auctions, bids): one filter + select each, numeric only."""
    e, this = events, pw.this
    persons = e.filter(e.kind == PERSON).select(person=this.eid, city=this.city, t=this.t)
    auctions = e.filter(e.kind == AUCTION).select(
        auction=this.eid, seller=this.seller, category=this.category, reserve=this.reserve, t=this.t
    )
    bids = e.filter(e.kind == BID).select(this.auction, this.bidder, this.price, this.t)
    return persons, auctions, bids


def q5(pw, bids) -> dict:
    counts = bids.windowby(
        bids.t,
        window=pw.temporal.sliding(hop=Q5_HOP_MS, duration=Q5_DURATION_MS),
        instance=bids.auction,
    ).reduce(auction=pw.this._pw_instance, start=pw.this._pw_window_start, n=pw.reducers.count())
    best = counts.groupby(counts.start).reduce(counts.start, top=pw.reducers.max(counts.n))
    hot = counts.join(best, counts.start == best.start, counts.n == best.top).select(
        counts.start, counts.auction, counts.n
    )
    return {"q5_counts": counts, "q5_hot": hot, "bids": bids.reduce(n=pw.reducers.count())}


def q7(pw, bids, behavior=None) -> dict:
    top = bids.windowby(
        bids.t, window=pw.temporal.tumbling(duration=Q7_WINDOW_MS), behavior=behavior
    ).reduce(start=pw.this._pw_window_start, top=pw.reducers.max(pw.this.price), n=pw.reducers.count())
    b = bids.select(
        bids.auction, bids.bidder, bids.price, start=(bids.t // Q7_WINDOW_MS) * Q7_WINDOW_MS
    )
    highest = b.join(top, b.start == top.start, b.price == top.top).select(
        b.start, b.auction, b.bidder, b.price
    )
    return {"q7_top": top, "q7_highest": highest, "bids": bids.reduce(n=pw.reducers.count())}


def q7_cutoff(pw, bids) -> dict:
    return q7(pw, bids, pw.temporal.common_behavior(cutoff=Q7_CUTOFF_MS))


def q8(pw, persons, auctions) -> dict:
    pairs = pw.temporal.window_join(
        persons, auctions, persons.t, auctions.t,
        pw.temporal.tumbling(duration=Q8_WINDOW_MS),
        persons.person == auctions.seller,
    ).select(persons.person, persons.city, auctions.auction, pt=persons.t, at=auctions.t)
    return {
        "q8_pairs": pairs,
        "persons": persons.reduce(n=pw.reducers.count()),
        "auctions": auctions.reduce(n=pw.reducers.count()),
    }


def surface(pw, persons, auctions, bids) -> dict:
    asof = pw.temporal.asof_join(
        bids, persons, bids.t, persons.t, bids.bidder == persons.person, how="left"
    ).select(bids.auction, bids.bidder, bids.price, bids.t, city=persons.city, pt=persons.t)
    interval = pw.temporal.interval_join(
        auctions, bids, auctions.t, bids.t,
        pw.temporal.interval(0, SURFACE_INTERVAL_MS),
        auctions.auction == bids.auction,
    ).select(auctions.auction, auctions.seller, bidder=bids.bidder, price=bids.price, dt=bids.t - auctions.t)
    diffs = bids.diff(bids.t, bids.price, instance=bids.auction)
    kept = bids.deduplicate(value=bids.price, instance=bids.auction, acceptor=lambda new, old: new > old)
    return {"asof": asof, "interval": interval, "diff": diffs, "dedup": kept}


#: query name -> builder over the split tables
QUERIES = {
    "q5": lambda pw, p, a, b: q5(pw, b),
    "q7": lambda pw, p, a, b: q7(pw, b),
    "q7_cutoff": lambda pw, p, a, b: q7_cutoff(pw, b),
    "q8": lambda pw, p, a, b: q8(pw, p, a),
    "surface": lambda pw, p, a, b: surface(pw, p, a, b),
}


def build(pw, query: str, ev: dict, tick_rows: int | None = None) -> dict:
    """The output tables of ``query`` over the events ``ev``."""
    pw.G.clear()
    persons, auctions, bids = split(pw, events_table(pw, ev, tick_rows))
    return QUERIES[query](pw, persons, auctions, bids)


def capture(pw, tables: dict) -> dict:
    """Run every table of ``tables`` in ONE engine run of ``pw``'s runtime;
    returns name -> its capture node (``.deltas``: the update stream)."""
    ops = import_module(pw.__name__ + ".engine.operators")
    LogicalNode = import_module(pw.__name__ + ".internals.logical").LogicalNode
    make_runtime = import_module(pw.__name__ + ".internals.run").make_runtime
    nodes, lnodes = {}, []
    for name, table in tables.items():
        def factory(name=name, cols=table.column_names()):
            nodes[name] = ops.CaptureNode(cols)
            return nodes[name]

        lnodes.append(LogicalNode(factory, [table._node], name="capture"))
    make_runtime(n_workers=None, autocommit_duration_ms=5).run(lnodes)
    return nodes
