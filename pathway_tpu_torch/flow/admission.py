"""Priority admission: interactive vs bulk service classes.

The input plane carries two kinds of traffic with opposite objectives: RAG
*query* streams want bounded end-to-end latency (the ``PATHWAY_LATENCY_SLO_MS``
deadline), *backfill*/bulk-ingest streams want throughput and tolerate delay.
Before r9 both shared one FIFO path — a backfill burst ahead of a query in the
connector queue added its entire drain time to the query's latency.

This scheduler separates them at **tick granularity**: every tick, interactive
inputs drain fully (their rows always make the next tick — queries overtake),
while each bulk input's drain is capped by a budget derived from the current
pressure signal (the AIMD controller's blend of sink-latency-vs-SLO and queue
occupancy). Under no pressure bulk drains fully too — zero cost; under full
pressure bulk degrades to ``PATHWAY_FLOW_BULK_MIN_ROWS`` per tick, so backfill
keeps progressing (never starved) instead of being paused. Budgeted rows left
in the queue keep holding their credits — they still occupy producer memory,
so admission never un-bounds the queue.

Deadline-awareness lives in the pressure signal: the controller scales it by
how close the recent interactive sink p99 sits to the SLO (DS2-style measured
feedback, Kalavri et al., OSDI '18), so bulk throttling engages *before* the
deadline is broken, proportionally to how endangered it is.

Carried from ``pathway_tpu/flow/admission.py`` with imports rewritten.
"""

from __future__ import annotations

from typing import Any

INTERACTIVE = "interactive"
BULK = "bulk"

SERVICE_CLASSES = (INTERACTIVE, BULK)

#: below this pressure bulk traffic is not throttled at all (hysteresis floor:
#: an idle pipeline pays nothing for having the plane on)
_PRESSURE_FLOOR = 0.25


def validate_service_class(service_class: str) -> str:
    sc = str(service_class).strip().lower()
    if sc not in SERVICE_CLASSES:
        raise ValueError(
            f"service_class must be one of {SERVICE_CLASSES}, got {service_class!r}"
        )
    return sc


class AdmissionScheduler:
    """Writes per-tick admission budgets onto the gates."""

    def __init__(self, bulk_min_rows: int, bulk_max_rows: int = 0):
        self.bulk_min_rows = max(1, int(bulk_min_rows))
        #: standing per-tick bulk drain ceiling (0 = none, the r9 behavior).
        #: The pressure signal is REACTIVE — it engages only after interactive
        #: latency has already degraded — so when bulk rows carry real device
        #: cost (doc-ingest embeds in a serving tier), a flood's first ticks
        #: drain unbudgeted and stall the query path before the controller
        #: can respond. The ceiling bounds that window unconditionally.
        self.bulk_max_rows = max(0, int(bulk_max_rows))

    def plan(self, gates: list[Any], pressure: float) -> None:
        """Set each gate's budget for the NEXT tick from the current pressure
        in [0, 1]. Interactive gates are never budgeted."""
        cap = self.bulk_max_rows or None
        if cap is not None:
            # the ceiling never undercuts the starvation floor: bulk_min_rows
            # is the under-pressure progress GUARANTEE, a lower cap would
            # silently void it
            cap = max(cap, self.bulk_min_rows)
        for gate in gates:
            if getattr(gate.node, "service_class", INTERACTIVE) != BULK:
                gate.budget = None
                continue
            if pressure <= _PRESSURE_FLOOR:
                gate.budget = cap
                continue
            # linear back-off from a full queue's worth of admission down to
            # the guaranteed minimum at pressure >= 1
            frac = max(0.0, 1.0 - min(1.0, pressure))
            budget = max(
                self.bulk_min_rows, int(gate.effective_bound() * frac)
            )
            gate.budget = min(budget, cap) if cap is not None else budget
