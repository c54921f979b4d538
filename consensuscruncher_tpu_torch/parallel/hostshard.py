"""Host-side data parallelism: coordinate-range sharding across processes.

Port of ``consensuscruncher_tpu/parallel/hostshard.py``.  The pipeline's
whole consensus flow is position-local — family members, rescue partners
and duplex pairs all share one ``(ref, pos)`` anchor (``core/tags.py``) —
so any coordinate boundary partitions the work exactly: N workers each run
the FULL SSCS -> rescue -> DCS chain on a disjoint coordinate range of the
input and the outputs concatenate.  This module owns the range split, the
worker command lines and environments, the fleet launcher and the result
aggregation; ``cli.consensus --host_workers N`` orchestrates the worker
processes around it.

Design notes:
- Each worker is a real process with its own interpreter (no shared GIL)
  and its own native codec pool.  On the card, the workers share the
  visible CUDA cards, worker *i* on card *i mod count*, each with a context
  of its own (:func:`worker_env`); CUDA contexts share a card, so nothing
  caps the worker count at the card count.
- Splitting is index arithmetic, not I/O: :func:`plan_bai_ranges` picks
  boundaries from the input's BAI linear index and each worker reads its
  coordinate range DIRECTLY from the shared input via virtual offsets
  (``io.columnar.BamRange``) — no slice files, no extra decode+rewrite
  pass.  Boundaries fall only where ``(rid, pos)`` changes (never inside a
  family); the unplaced tail (rid < 0) belongs to the final range.
- Aggregation = merge per output class (disjoint sorted ranges — the merge
  degenerates to ordered concatenation), summed stats counters, summed
  family-size histograms.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from consensuscruncher_tpu_torch.io.bam import BamWriter
from consensuscruncher_tpu_torch.utils import faults
from consensuscruncher_tpu_torch.utils.stats import FamilySizeHistogram, StageStats


def run_workers(workers: list[dict], retries: int = 1) -> None:
    """Launch the worker fleet, wait, and retry failures with backoff.

    ``workers``: one dict per worker — ``cmd`` (argv list), ``err_path``
    (stderr log file), optional ``env`` and ``retry_cmd`` (normally the
    same invocation plus ``--resume``, so a retried worker reuses the
    stages it already committed instead of recomputing them).  A failing
    worker is relaunched up to ``retries`` times; if failures remain,
    raises SystemExit carrying every failing worker's stderr tail.

    The fleet runs concurrently within a round; retry rounds are a
    recovery path (transient node pressure), not the throughput path, so
    their backoff delay is shared, not per-worker.
    """
    def launch(w: dict, cmd: list, mode: str):
        with open(w["err_path"], mode) as err_f:
            return subprocess.Popen(cmd, env=w.get("env"),
                                    stdout=subprocess.DEVNULL, stderr=err_f)

    base = float(os.environ.get("CCT_RETRY_BASE_S", "0.5"))
    live = [(w, launch(w, w["cmd"], "wb")) for w in workers]
    failed: list[tuple[dict, int]] = []
    for round_no in range(retries + 1):
        failed = []
        for w, p in live:
            p.wait()
            if p.returncode != 0:
                failed.append((w, p.returncode))
        if not failed:
            return
        if round_no >= retries:
            break
        delay = faults.backoff_delay(round_no + 1, base, cap=30.0)
        names = ", ".join(w.get("name", "?") for w, _rc in failed)
        print(f"WARNING: {len(failed)} worker(s) failed ({names}); "
              f"retrying in {delay:.1f}s (round {round_no + 2}/{retries + 1})",
              file=sys.stderr, flush=True)
        time.sleep(delay)
        live = [(w, launch(w, w.get("retry_cmd", w["cmd"]), "ab"))
                for w, _rc in failed]
    msgs = []
    for w, rc in failed:
        try:
            with open(w["err_path"], "rb") as f:
                tail = f.read().decode(errors="replace").strip().splitlines()[-8:]
        except OSError:
            tail = ["<stderr file unreadable>"]
        msgs.append(f"worker {w.get('name', '?')} rc={rc} "
                    f"(full log: {w['err_path']}): " + " | ".join(tail))
    raise SystemExit("host-sharded consensus failed:\n" + "\n".join(msgs))


def plan_bai_ranges(in_bam: str, n: int) -> list["BamRange"]:
    """Plan ``n`` disjoint coordinate ranges of a sorted BAM from its BAI —
    workers read their range straight out of the SHARED input via virtual
    offsets, with no materialized slice files (which would cost a full
    decode+re-encode pass).

    Split points are 16 kb linear-index windows whose compressed offset
    best partitions the file bytes into ``n`` even spans.  Every boundary
    is a (rid, window_pos) key: records sharing a (rid, pos) anchor — and
    therefore families, rescue pairs, and duplex pairs — always land in
    exactly one range.  The unplaced tail (rid < 0) belongs to the final
    range.  Deterministic for a given (input, n) — the property
    ``--resume`` relies on.
    """
    from consensuscruncher_tpu_torch.io.bai import BaiIndex, index_bam
    from consensuscruncher_tpu_torch.io.columnar import BamRange, pack_coord_key

    bai_path = index_bam(in_bam, skip_if_fresh=True)
    idx = BaiIndex.load(bai_path)
    # (coffset, key, voffset) per populated linear window, in key order.
    entries: list[tuple[int, int, int]] = []
    for rid, lin in enumerate(idx.linear):
        prev = 0
        for w, voff in enumerate(lin):
            if voff and voff != prev:
                entries.append((voff >> 16, pack_coord_key(rid, w << 14), voff))
                prev = voff
    csize = os.path.getsize(in_bam)
    ranges: list[BamRange] = []
    start_voff, start_key = 0, -1  # range 0: from the first record
    used = 0
    for i in range(1, n):
        target = csize * i // n
        j = np.searchsorted([e[0] for e in entries[used:]], target) + used
        if j >= len(entries):
            break
        coff, key, voff = entries[j]
        if key <= start_key:
            continue
        ranges.append(BamRange(start_voff, start_key, key))
        start_voff, start_key = voff, key
        used = j + 1
    ranges.append(BamRange(start_voff, start_key, None))
    # degenerate inputs (few/no indexed windows) yield fewer ranges; pad
    # with empty ranges so workers/aggregation stay uniform
    while len(ranges) < n:
        ranges.append(BamRange(start_voff, start_key, start_key))
    return ranges


def range_argv(r) -> str:
    """Serialize a BamRange for the worker command line."""
    end = "eof" if r.end_key is None else str(r.end_key)
    return f"{r.start_voffset}:{r.start_key}:{end}"


def parse_range_argv(spec: str):
    from consensuscruncher_tpu_torch.io.columnar import BamRange

    voff, start, end = spec.split(":")
    return BamRange(int(voff), int(start),
                    None if end == "eof" else int(end))


_NON_SUMMED = {"stage", "backend", "jax_backend", "cutoff", "max_mismatch"}


def aggregate_stats(json_paths: list[str], stage: str, out_txt: str) -> StageStats:
    """Sum worker stats JSONs into one stage-stats file pair."""
    agg = StageStats(stage)
    for p in json_paths:
        if not os.path.exists(p):
            continue
        with open(p) as fh:
            data = json.load(fh)
        for key, value in data.items():
            if key == "stage":
                continue  # StageStats carries the stage itself
            if key in _NON_SUMMED:
                if agg.get(key, None) in (None, 0):
                    agg.set(key, value)
            elif isinstance(value, (int, float)):
                agg.incr(key, value)
    agg.write(out_txt)
    return agg


def aggregate_histograms(paths: list[str], out_path: str) -> None:
    """Sum worker family-size histograms into one ``read_families.txt``."""
    agg = FamilySizeHistogram()
    for p in paths:
        if not os.path.exists(p):
            continue
        for size, count in FamilySizeHistogram.read(p).items():
            agg.counts[size] += count
    agg.write(out_path)


def concat_bams(paths: list[str], out_path: str, header, level: int = 6) -> None:
    """Ordered raw concatenation of BAMs (disjoint, already-ordered inputs
    — e.g. per-range badReads in range order).  No sorting, no decode."""
    from consensuscruncher_tpu_torch.io.columnar import ColumnarReader

    writer = BamWriter(os.fspath(out_path), header, level=level, atomic=True)
    try:
        for p in paths:
            if not os.path.exists(p):
                continue
            with ColumnarReader(p) as r:
                for b in r.batches():
                    writer.write_encoded(b.buf[: int(b.rec_off[-1])])
    except BaseException:
        writer.abort()
        raise
    writer.close()


def worker_argv(input_path: str, out_dir: str, name: str, args,
                range_spec: str | None = None,
                resume: bool = False) -> list[str]:
    """Build a worker's ``consensus`` argv from the parent's parsed args
    (workers re-run the normal CLI).  ``range_spec`` points the worker at
    its BAI coordinate range of the shared input; ``resume`` lets an
    intact worker skip via its own manifest.

    The JAX package's argv, with ``--device`` in place of ``--backend``
    (a host backend passes ``--backend cpu|reference`` on, as the JAX
    package passes its backend): as there, ``--policy``, ``--residency``, ``--pipeline``,
    ``--intermediate_taps`` and ``--cleanup`` are not passed on, so every
    worker runs its defaults (the majority vote, staged, residency on), and
    the two packages' sharded runs agree."""
    argv = [
        "consensus", "-i", input_path, "-o", out_dir, "-n", name,
        *(["--backend", host] if (host := getattr(args, "host_backend", None))
          else ["--device", str(args.device)]),
        "--cutoff", str(args.cutoff),
        "--qualscore", str(args.qualscore),
        "--scorrect", str(args.scorrect),
        "--max_mismatch", str(args.max_mismatch),
        "--bdelim", args.bdelim,
        "--compress_level", str(args.compress_level),
        "--wire", str(getattr(args, "wire", "stream")),
    ]
    if getattr(args, "intermediate_level", None) is not None:
        argv += ["--intermediate_level", str(args.intermediate_level)]
    if range_spec is not None:
        argv += ["--input_range", range_spec]
    if resume:
        argv += ["--resume", "True"]
    if getattr(args, "devices", None):
        argv += ["--devices", str(args.devices)]
    return argv


def worker_env(base_env: dict, i: int, device: str, n_cards: int, devices: int = 1) -> dict:
    """Worker ``i``'s environment: ``base_env``, and on the card
    ``CUDA_VISIBLE_DEVICES`` naming the distinct cards among ``(i * devices
    + j) mod n_cards`` for ``j < devices``, in that order, of those visible
    to the parent (its own ``CUDA_VISIBLE_DEVICES`` list, else cards ``0 ..
    n_cards - 1``).  Where the JAX package partitions chips
    (``TPU_VISIBLE_DEVICES``, chips ``[i * d, (i + 1) * d)`` per worker),
    workers here share cards: each opens its own CUDA context, and a
    worker's ``--devices d`` mesh lays its shards over the cards it sees."""
    env = dict(base_env)
    if device == "cuda":
        visible = [c for c in base_env.get("CUDA_VISIBLE_DEVICES", "").split(",") if c]
        cards = visible or [str(c) for c in range(max(1, n_cards))]
        d = max(1, devices)
        mine = [cards[(i * d + j) % len(cards)] for j in range(d)]
        env["CUDA_VISIBLE_DEVICES"] = ",".join(dict.fromkeys(mine))
    return env
