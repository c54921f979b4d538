"""Retry schedule of the port's worker fleets.

Port of the part of ``consensuscruncher_tpu/utils/faults.py`` that
``parallel.hostshard.run_workers`` calls: the exponential backoff between
retry rounds.  The fault-injection registry comes with the serve plane.
"""

from __future__ import annotations


def backoff_delay(attempt: int, base: float, cap: float) -> float:
    """Exponential backoff schedule shared by the retry loops: delay before
    attempt ``attempt+1`` after ``attempt`` failures (attempt >= 1)."""
    return min(cap, base * (2.0 ** max(0, attempt - 1)))
