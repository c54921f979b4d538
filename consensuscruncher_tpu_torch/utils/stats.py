"""Stage statistics, family-size distributions, and wall-clock tracking.

Reference parity: the per-stage ``*_stats.txt``, ``*.read_families.txt`` and
``*.time_tracker.txt`` outputs (SURVEY.md §5 "Metrics/logging").  Formats are
pinned here: stats files are ``key: value`` lines, family
files are ``size<TAB>count`` sorted by size, and every stage also emits a
structured JSON sidecar (``*_stats.json``) for machines.
"""

from __future__ import annotations

import json
import os
import time
from collections import Counter


class StageStats:
    """Ordered key->value stats with text + JSON emission."""

    def __init__(self, stage: str):
        self.stage = stage
        self._items: dict[str, object] = {}

    def set(self, key: str, value) -> None:
        self._items[key] = value

    def incr(self, key: str, by: int = 1) -> None:
        self._items[key] = self._items.get(key, 0) + by

    def get(self, key: str, default=0):
        return self._items.get(key, default)

    def write(self, path) -> None:
        # Sorted keys: backends touch counters in different orders (e.g. the
        # device path batches sscs_written increments), and stats files are
        # parity artifacts — emission order must not encode execution order.
        with open(path, "w") as fh:
            fh.write(f"# {self.stage} stats\n")
            for key in sorted(self._items):
                fh.write(f"{key}: {self._items[key]}\n")
        root, ext = os.path.splitext(str(path))
        json_path = root + ".json" if ext == ".txt" else str(path) + ".json"
        with open(json_path, "w") as fh:
            json.dump({"stage": self.stage, **dict(sorted(self._items.items()))},
                      fh, indent=2)
            fh.write("\n")


class FamilySizeHistogram:
    def __init__(self):
        self._counts: Counter = Counter()

    def add(self, size: int) -> None:
        self._counts[size] += 1

    def add_array(self, sizes) -> None:
        """Bulk add (one bincount instead of a per-family loop)."""
        import numpy as np

        b = np.bincount(np.asarray(sizes, dtype=np.int64))
        for s in np.nonzero(b)[0]:
            self._counts[int(s)] += int(b[s])

    def write(self, path) -> None:
        with open(path, "w") as fh:
            fh.write("family_size\tcount\n")
            for size in sorted(self._counts):
                fh.write(f"{size}\t{self._counts[size]}\n")

    @property
    def counts(self) -> Counter:
        return self._counts

    @staticmethod
    def read(path) -> Counter:
        out: Counter = Counter()
        with open(path) as fh:
            next(fh)
            for line in fh:
                size, count = line.split("\t")
                out[int(size)] = int(count)
        return out


class TimeTracker:
    """Human-readable wall-clock tracker (reference: ``*.time_tracker.txt``)."""

    def __init__(self):
        self._t0 = time.time()
        self._marks: list[tuple[str, float]] = []

    def mark(self, label: str) -> None:
        self._marks.append((label, time.time() - self._t0))

    def as_phases(self) -> dict[str, float]:
        """Per-phase durations (seconds) between consecutive marks."""
        out, prev = {}, 0.0
        for label, t in self._marks:
            out[label] = t - prev
            prev = t
        return out

    def write(self, path) -> None:
        with open(path, "w") as fh:
            prev = 0.0
            for label, t in self._marks:
                fh.write(f"{label}: {t - prev:.2f} s (cumulative {t:.2f} s)\n")
                prev = t
