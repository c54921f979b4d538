"""Read what the program wrote and hold it to the reference.

Every number this module returns is compared with a limit of 0: the
configurations state exact outputs.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os

import numpy as np

from cctbench import bamio
from cctbench.reference import record_keys

# the outputs the comparison reads, under <out>/<name>/
OUTPUT_BAMS = {
    "sscs": "sscs/{n}.sscs.sorted.bam",
    "sscs_rescue": "singleton/{n}.sscs.rescue.sorted.bam",
    "singleton_rescue": "singleton/{n}.singleton.rescue.sorted.bam",
    "dcs": "dcs/{n}.dcs.sorted.bam",
    "all_unique_sscs": "all_unique/{n}.all.unique.sscs.bam",
    "all_unique_dcs": "all_unique/{n}.all.unique.dcs.bam",
}
STATS_FILES = {
    "sscs": "sscs/{n}.sscs_stats.json",
    "singleton": "singleton/{n}.singleton_stats.json",
    "dcs": "dcs/{n}.dcs_stats.json",
}


def bam_records(path: str, length: int) -> tuple[list[bytes], int]:
    """The records of a BAM as :func:`reference.record_keys` forms them,
    and how many records sit before one at a lower position."""
    recs = bamio.read_bam(path)
    codes, quals = recs.codes_quals(length)
    keys = record_keys(recs.qnames(), recs.flag, recs.ref, recs.pos, recs.mapq, recs.cigars(),
                       recs.mate_ref, recs.mate_pos, recs.tlen, codes, quals, recs.tags())
    key = recs.ref.astype(np.int64) * (1 << 32) + recs.pos
    return keys, int((key[1:] < key[:-1]).sum())


def observed_outputs(base: str, name: str, length: int) -> dict:
    records, unsorted = {}, 0
    for out, rel in OUTPUT_BAMS.items():
        records[out], bad = bam_records(os.path.join(base, rel.format(n=name)), length)
        unsorted += bad
    stats = {}
    for step, rel in STATS_FILES.items():
        with open(os.path.join(base, rel.format(n=name))) as fh:
            stats[step] = json.load(fh)
    return {"records": records, "stats": stats, "unsorted": unsorted}


def records_wrong(want: list[bytes], got: list[bytes]) -> int:
    """Records of one output that the other side lacks, counted on both
    sides (a duplicate counts as an extra record)."""
    a, b = collections.Counter(want), collections.Counter(got)
    return sum((a - b).values()) + sum((b - a).values())


def compare_consensus(expected: dict, observed: dict) -> dict:
    """``records_wrong``: records missing or extra over every output;
    ``stats_wrong``: stats counts that differ; ``records_unsorted``:
    records out of coordinate order."""
    wrong = sum(records_wrong(expected["records"][k], observed["records"][k])
                for k in OUTPUT_BAMS)
    stats_wrong = 0
    for step, counts in expected["stats"].items():
        got = observed["stats"].get(step, {})
        stats_wrong += sum(int(got.get(key, 0)) != int(v) for key, v in counts.items())
    return {"records_wrong": wrong, "stats_wrong": stats_wrong,
            "records_unsorted": observed.get("unsorted", 0)}


def output_digest(base: str, name: str) -> str:
    """One digest over the bytes of every output the comparison reads: a
    command run again on the same input writes the same bytes."""
    h = hashlib.sha256()
    for rel in list(OUTPUT_BAMS.values()) + list(STATS_FILES.values()):
        with open(os.path.join(base, rel.format(n=name)), "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 22), b""):
                h.update(chunk)
    return h.hexdigest()
