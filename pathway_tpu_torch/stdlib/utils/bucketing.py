"""Time bucketing helpers (reference: ``python/pathway/stdlib/utils/bucketing.py``).

Carried from ``pathway_tpu/stdlib/utils/bucketing.py``.
"""

from __future__ import annotations

import datetime


def truncate_to_minutes(time: datetime.datetime) -> datetime.datetime:
    return time - datetime.timedelta(seconds=time.second, microseconds=time.microsecond)


def truncate_to_hours(time: datetime.datetime) -> datetime.datetime:
    return time.replace(minute=0, second=0, microsecond=0)


def truncate_to_days(time: datetime.datetime) -> datetime.datetime:
    return time.replace(hour=0, minute=0, second=0, microsecond=0)
