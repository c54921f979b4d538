"""Perf-regression sentinel: compare a fresh loadgen artifact against a
baseline artifact and fail when the fleet got slower or its wall went
somewhere new.

Port of the JAX package's ``tools/perf_gate.py``: the same flags,
checks, verdict document, messages and exit codes, and its own copy of
them (stdlib and json only; the gate runs standalone against two JSON
files).  One departure: the committed ``BENCH_LOADGEN_r*.json`` files
are another silicon's throughput, so this gate takes no default
baseline — without ``--baseline`` it exits 2 naming the flag, as the JAX
gate does when it finds no baseline (:func:`find_baseline` still names
the newest such file for a caller that wants it).  Checks, in order of
how hard they gate:

- **structural** (always strict, even ``--smoke``): no lost jobs at any
  level; recompile counter flat past level 0 (in the port the counter
  is the kernel-library builds, which a warm daemon never repeats); when
  the fresh artifact carries a CCT_PROF ``attribution`` doc, per-node
  coverage >= --min_coverage (the profiler must explain where the wall
  went).
- **throughput** (tolerance-gated): peak throughput and knee offered
  rate may not fall below ``baseline * (1 - --throughput_tol)``.
- **attribution drift** (tolerance-gated, only when BOTH artifacts
  carry ``attribution``): each fleet bucket share (queue / routing /
  host / device / deflate / io) may not move more than --attr_tol
  absolute from the baseline share — a regression that keeps
  throughput but doubles queue-wait still trips.

``--smoke`` widens the tolerance-gated checks for shared boxes
(wall-clock there is weather, not signal) but keeps every structural
check strict.  The verdict is one machine-readable JSON doc on stdout::

    {"ok": false, "checks": [{"name": ..., "ok": false, "got": ...,
                              "want": ..., "detail": ...}, ...]}

and the exit code is 0 iff every check passed (2 on usage errors, e.g.
no ``--baseline``).  Sweep artifacts (``runs`` keyed by worker count)
are compared run-by-run against matching counts in the baseline.

  python -m consensuscruncher_tpu_torch.utils.perf_gate --fresh B.json \\
      --baseline A.json --smoke
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# fleet attribution buckets compared for drift: obs.prof's buckets,
# without importing the package (the gate must run standalone against two
# JSON files).
ATTR_BUCKETS = ("queue_ms", "routing_ms", "host_cpu_ms",
                "device_dispatch_ms", "deflate_ms", "io_ms")


def find_baseline(repo: str = _REPO) -> str | None:
    """Newest committed ``BENCH_LOADGEN_r*.json`` by revision number."""
    best, best_rev = None, -1
    for path in sorted(glob.glob(os.path.join(repo,
                                              "BENCH_LOADGEN_r*.json"))):
        m = re.search(r"BENCH_LOADGEN_r(\d+)\.json$", path)
        if m and int(m.group(1)) > best_rev:
            best, best_rev = path, int(m.group(1))
    return best


def _runs(doc: dict) -> dict[str, dict]:
    """Normalize plain and sweep artifacts to ``{label: run_doc}``."""
    if "runs" in doc:
        return dict(doc["runs"])
    return {"": doc}


def _check(checks: list, name: str, ok: bool, got, want, detail: str = ""):
    entry = {"name": name, "ok": bool(ok), "got": got, "want": want}
    if detail:
        entry["detail"] = detail
    checks.append(entry)


def check_structural(checks: list, label: str, run: dict,
                     min_coverage: float) -> None:
    prefix = f"{label}:" if label else ""
    lost = sum((lv.get("aggregate") or {}).get("lost", 0)
               for lv in run.get("levels", []))
    _check(checks, f"{prefix}lost_jobs", lost == 0, lost, 0,
           "accepted jobs must never vanish, at any offered load")
    # recompiles flat past level 0: level 0 may still warm shapes the
    # preflight could not form; the steady-state levels may not.  Only
    # gated for single-daemon runs — fleet workers legitimately warm
    # shapes at different times as routing spreads load (the committed
    # sweep baselines show it), and ci_check's own zero-recompile
    # assertion already polices the warmed single-daemon pass.
    totals = [lv.get("recompiles_total") for lv in run.get("levels", [])]
    totals = [t for t in totals if t is not None]
    if len(totals) >= 2 and run.get("fleet") is None:
        _check(checks, f"{prefix}recompiles_flat", totals[-1] == totals[0],
               totals, "flat past level 0",
               "the learned autotune table may not mint shapes mid-run")
    attr = run.get("attribution")
    if attr:
        # coverage is None for nodes seen only in stack samples (no
        # jobs, no routing) — nothing to attribute, nothing to gate
        worst = min((n["coverage"]
                     for n in (attr.get("nodes") or {}).values()
                     if n.get("coverage") is not None),
                    default=1.0)
        _check(checks, f"{prefix}attribution_coverage",
               worst >= min_coverage, round(worst, 4),
               f">= {min_coverage}",
               "the profiler must explain where each node's wall went")


def check_throughput(checks: list, label: str, fresh: dict, base: dict,
                     tol: float) -> None:
    prefix = f"{label}:" if label else ""
    for key in ("max_throughput_jobs_per_s", "knee_offered_jobs_per_s"):
        b = (base.get("knee") or {}).get(key)
        f = (fresh.get("knee") or {}).get(key)
        if not b or f is None:
            continue
        floor = b * (1.0 - tol)
        _check(checks, f"{prefix}{key}", f >= floor,
               round(f, 6), f">= {round(floor, 6)} (baseline {b} - {tol:.0%})")


def check_attr_drift(checks: list, label: str, fresh: dict, base: dict,
                     tol: float) -> None:
    prefix = f"{label}:" if label else ""
    fa = ((fresh.get("attribution") or {}).get("fleet") or {}).get("shares")
    ba = ((base.get("attribution") or {}).get("fleet") or {}).get("shares")
    if not fa or not ba:
        return
    for bucket in ATTR_BUCKETS:
        got, want = fa.get(bucket, 0.0), ba.get(bucket, 0.0)
        _check(checks, f"{prefix}attr_share:{bucket}",
               abs(got - want) <= tol, round(got, 4),
               f"{round(want, 4)} +/- {tol}",
               "wall share drift vs baseline attribution")


def gate(fresh_doc: dict, base_doc: dict, *, throughput_tol: float,
         attr_tol: float, min_coverage: float) -> list[dict]:
    checks: list[dict] = []
    fresh_runs, base_runs = _runs(fresh_doc), _runs(base_doc)
    for label, run in sorted(fresh_runs.items()):
        check_structural(checks, label, run, min_coverage)
        base = base_runs.get(label)
        if base is None and len(base_runs) == 1:
            base = next(iter(base_runs.values()))
        if base is None:
            continue
        check_throughput(checks, label, run, base, throughput_tol)
        check_attr_drift(checks, label, run, base, attr_tol)
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fresh", required=True,
                    help="the just-produced loadgen artifact to judge")
    ap.add_argument("--baseline", default="",
                    help="artifact to compare against (required: the "
                         "committed BENCH_LOADGEN_r*.json files are another "
                         "silicon's throughput, so there is no default)")
    ap.add_argument("--throughput_tol", type=float, default=0.25,
                    help="allowed fractional drop in knee / peak "
                         "throughput vs baseline")
    ap.add_argument("--attr_tol", type=float, default=0.15,
                    help="allowed absolute drift per attribution bucket "
                         "share vs baseline")
    ap.add_argument("--min_coverage", type=float, default=0.95,
                    help="minimum per-node profiler wall coverage when "
                         "the fresh artifact carries attribution")
    ap.add_argument("--smoke", action="store_true",
                    help="shared-CI-box mode: widen tolerance-gated "
                         "checks (throughput_tol 0.75, attr_tol 0.40); "
                         "structural checks stay strict")
    ap.add_argument("--out", default="",
                    help="also write the JSON verdict to this path")
    args = ap.parse_args(argv)

    if args.smoke:
        args.throughput_tol = max(args.throughput_tol, 0.75)
        args.attr_tol = max(args.attr_tol, 0.40)

    baseline = args.baseline
    if not baseline:
        print("perf_gate: no baseline given (pass --baseline; the committed "
              "BENCH_LOADGEN_r*.json files are another silicon's)",
              file=sys.stderr)
        return 2
    try:
        with open(args.fresh) as fh:
            fresh_doc = json.load(fh)
        with open(baseline) as fh:
            base_doc = json.load(fh)
    except (OSError, ValueError) as e:
        print(f"perf_gate: cannot load artifacts: {e}", file=sys.stderr)
        return 2

    checks = gate(fresh_doc, base_doc,
                  throughput_tol=args.throughput_tol,
                  attr_tol=args.attr_tol,
                  min_coverage=args.min_coverage)
    verdict = {
        "ok": all(c["ok"] for c in checks),
        "baseline": os.path.basename(baseline),
        "fresh": os.path.basename(args.fresh),
        "smoke": bool(args.smoke),
        "tolerances": {"throughput": args.throughput_tol,
                       "attr": args.attr_tol,
                       "min_coverage": args.min_coverage},
        "checks": checks,
    }
    text = json.dumps(verdict, indent=1, sort_keys=True)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    if not verdict["ok"]:
        bad = [c["name"] for c in checks if not c["ok"]]
        print(f"perf_gate: FAIL ({', '.join(bad)})", file=sys.stderr)
        return 1
    print(f"perf_gate: ok ({len(checks)} check(s) vs "
          f"{os.path.basename(baseline)})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
