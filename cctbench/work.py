"""The work a kernel's roofline is counted from, and the card's peaks.

Counted from the cell's inputs, not from the program's wire or its
kernel's instruction mix, so that the yardstick stays where it is whatever
implements the step.  Bytes: each live member's base and quality read
once, as handed over (one byte each), and each output plane written once.
Integer operations: ``FOLD_OPS`` per live member-position (the quality
test, the lane select, the count, the first-seen update, the agreement
test, the quality add), ``FINALIZE_OPS`` per output position of each
strand's vote (the largest count over five lanes, the first-seen tie
break, the cutoff's cross-multiply and compare, the cap), ``COMBINE_OPS``
per pair-position of the duplex combine (two agreement tests, the select,
the add, the cap).
"""

from __future__ import annotations

import json
import os

import numpy as np

FOLD_OPS, FINALIZE_OPS, COMBINE_OPS = 6, 30, 6
OUTPUT_PLANES = 6  # SSCS a, its quals, SSCS b, its quals, DCS, its quals


def duplex_step(sizes_a, sizes_b, length: int) -> dict:
    """Bytes and int32 operations of one whole-pipeline duplex step."""
    return duplex_work(int(np.sum(sizes_a)) + int(np.sum(sizes_b)), len(sizes_a), length)


def duplex_work(live: int, pairs: int, length: int) -> dict:
    """:func:`duplex_step` from the step's live members and pairs."""
    return {"bytes": 2 * live * length + OUTPUT_PLANES * pairs * length,
            "ops": FOLD_OPS * live * length + (2 * FINALIZE_OPS + COMBINE_OPS) * pairs * length,
            "live_members": live, "pairs": pairs}


def peaks(kind: str) -> dict:
    """The published peaks of the card ``kind`` (``peaks.json``)."""
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as fh:
        table = json.load(fh)
    if kind not in table:
        raise KeyError(f"no published peaks for {kind!r} in peaks.json")
    return table[kind]


def least_seconds(w: dict, card: dict) -> tuple[float, str]:
    """The least time the card could take for ``w``, and which bound binds."""
    by_bytes = w["bytes"] / card["hbm_bytes_per_s"]
    by_ops = w["ops"] / card["int32_ops_per_s"]
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")
