"""Fault injection for the audit plane's tests and chaos drills
(``PATHWAY_FAULT_PLAN``).

Carried from ``pathway_tpu/resilience/__init__.py``: only
:mod:`.faults` (the plan's ``flip_diff``, ``drop_retract`` and ``drop_poll``
steps on this process). The reference's package also holds the coordinated
checkpoint epochs, the heartbeat failure detector and the supervised restart
(``heartbeat.py``, ``supervisor.py``, ``last_committed_epoch``); they need
the cluster and persistence planes and come with ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

from pathway_tpu_torch.resilience.faults import FaultPlan, FaultSpec

__all__ = ["FaultPlan", "FaultSpec"]
