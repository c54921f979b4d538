"""Quality-drift sentinel: compare a fresh QC/accuracy artifact (from
``python -m consensuscruncher_tpu_torch.utils.accuracy_harness``) against a
committed baseline and fail when consensus quality drifted — even if every
output file is still produced and every perf number still holds.

Port of the JAX package's ``tools/qc_gate.py``: the same flags, defaults,
checks, verdict document, messages and exit codes, and its own copy of
them (stdlib and json only; the gate runs standalone against two JSON
files).  The newest committed ``BENCH_QC_r*.json`` at the repo root stays
the default baseline: those files hold quality tables (rates of integer
counts, which the port reproduces exactly on the same seeded truth BAM),
not times.  Checks, in order of how hard they gate:

- **structural** (always strict, even ``--smoke``): the artifact must
  carry a QC doc and a non-empty accuracy table; SSCS output must be
  non-empty; and per-base error may not INVERT — SSCS and DCS error
  rates must stay at or below raw (a consensus that makes reads worse
  than the input is broken no matter what the baseline says).  This is
  the check the seeded-corruption positive control trips first.
- **spectrum drift** (tolerance-gated): total-variation distance between
  the fresh and baseline family-size spectra <= --spectrum_tol.
- **rate drift** (tolerance-gated): yield/rescue/dropout/disagreement
  rates may not move more than --rate_tol absolute from baseline.
- **accuracy drift** (tolerance-gated, per policy): per-base error may
  not exceed ``baseline * (1 + --err_tol) + --err_floor``; variant
  recall may not fall more than --recall_tol; FP-per-megabase may not
  rise more than --fp_tol_mb.

``--smoke`` widens the tolerance-gated checks for shared boxes but keeps
every structural check strict.  The verdict is one machine-readable JSON
doc on stdout (same shape as ``utils/perf_gate.py``'s) and the exit code
is 0 iff every check passed (2 on usage errors).

  python -m consensuscruncher_tpu_torch.utils.qc_gate --fresh A.json --smoke
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# rates compared for absolute drift: obs.qc's rate keys plus the plane's
# disagreement rate, without importing the package (the gate must run
# standalone against two JSON files).
RATE_KEYS = ("sscs_yield", "singleton_rate", "rescue_rate",
             "dropout_rate", "duplex_rate", "dcs_yield")


def find_baseline(repo: str = _REPO) -> str | None:
    """Newest committed ``BENCH_QC_r*.json`` by revision number."""
    best, best_rev = None, -1
    for path in sorted(glob.glob(os.path.join(repo, "BENCH_QC_r*.json"))):
        m = re.search(r"BENCH_QC_r(\d+)\.json$", path)
        if m and int(m.group(1)) > best_rev:
            best, best_rev = path, int(m.group(1))
    return best


def _check(checks: list, name: str, ok: bool, got, want, detail: str = ""):
    entry = {"name": name, "ok": bool(ok), "got": got, "want": want}
    if detail:
        entry["detail"] = detail
    checks.append(entry)


def spectrum_tv(a: dict, b: dict) -> float:
    """Total-variation distance between two family-size spectra in
    [0, 1]; inline twin of obs.qc.spectrum_distance (standalone gate)."""
    ta = sum(a.values()) or 1
    tb = sum(b.values()) or 1
    keys = sorted(set(a) | set(b))
    return 0.5 * sum(abs(a.get(k, 0) / ta - b.get(k, 0) / tb)
                     for k in keys)


def check_structural(checks: list, fresh: dict) -> None:
    qc = fresh.get("qc")
    _check(checks, "qc_doc_present", isinstance(qc, dict),
           type(qc).__name__, "dict",
           "the artifact must embed the run's qc.json")
    policies = ((fresh.get("accuracy") or {}).get("policies")) or {}
    _check(checks, "accuracy_table_present", bool(policies),
           sorted(policies), "at least one policy row")
    if isinstance(qc, dict):
        sscs = int(((qc.get("yields")) or {}).get("sscs_written", 0))
        _check(checks, "sscs_written", sscs > 0, sscs, "> 0",
               "an empty consensus output cannot be judged, only failed")
    for policy, row in sorted(policies.items()):
        err = row.get("per_base_error") or {}
        raw = err.get("raw")
        for level in ("sscs", "dcs"):
            got = err.get(level)
            if raw is None or got is None:
                continue
            _check(checks, f"{policy}:error_ordering:{level}",
                   got <= raw, round(got, 6), f"<= raw ({round(raw, 6)})",
                   "consensus must improve on raw reads — an inversion "
                   "means the caller is corrupting data, not denoising it")


def check_spectrum(checks: list, fresh: dict, base: dict,
                   tol: float) -> None:
    fs = ((fresh.get("qc")) or {}).get("spectrum") or {}
    bs = ((base.get("qc")) or {}).get("spectrum") or {}
    if not fs or not bs:
        return
    tv = spectrum_tv(fs, bs)
    _check(checks, "spectrum_tv", tv <= tol, round(tv, 4), f"<= {tol}",
           "family-size spectrum drift vs baseline (total variation)")


def check_rates(checks: list, fresh: dict, base: dict, tol: float) -> None:
    fq, bq = (fresh.get("qc") or {}), (base.get("qc") or {})
    fr, br = (fq.get("rates") or {}), (bq.get("rates") or {})
    pairs = [(k, fr.get(k), br.get(k)) for k in RATE_KEYS]
    fp = (fq.get("plane") or {}).get("disagree_rate")
    bp = (bq.get("plane") or {}).get("disagree_rate")
    pairs.append(("disagree_rate", fp, bp))
    for key, got, want in pairs:
        if got is None or want is None:
            continue
        _check(checks, f"rate:{key}", abs(got - want) <= tol,
               round(got, 4), f"{round(want, 4)} +/- {tol}")


def check_accuracy(checks: list, fresh: dict, base: dict, *,
                   err_tol: float, err_floor: float, recall_tol: float,
                   fp_tol_mb: float) -> None:
    fpol = ((fresh.get("accuracy") or {}).get("policies")) or {}
    bpol = ((base.get("accuracy") or {}).get("policies")) or {}
    for policy in sorted(set(fpol) & set(bpol)):
        fe = fpol[policy].get("per_base_error") or {}
        be = bpol[policy].get("per_base_error") or {}
        for level in ("sscs", "dcs"):
            got, want = fe.get(level), be.get(level)
            if got is None or want is None:
                continue
            ceil = want * (1.0 + err_tol) + err_floor
            _check(checks, f"{policy}:per_base_error:{level}",
                   got <= ceil, round(got, 6),
                   f"<= {round(ceil, 6)} (baseline {round(want, 6)})")
        fv = fpol[policy].get("variants") or {}
        bv = bpol[policy].get("variants") or {}
        for level in ("sscs", "dcs"):
            fr = (fv.get(level) or {})
            br = (bv.get(level) or {})
            got, want = fr.get("recall"), br.get("recall")
            if got is not None and want is not None:
                _check(checks, f"{policy}:variant_recall:{level}",
                       got >= want - recall_tol, round(got, 4),
                       f">= {round(want - recall_tol, 4)}")
            got, want = fr.get("fp_per_mb"), br.get("fp_per_mb")
            if got is not None and want is not None:
                _check(checks, f"{policy}:variant_fp_per_mb:{level}",
                       got <= want + fp_tol_mb, round(got, 1),
                       f"<= {round(want + fp_tol_mb, 1)}")


def gate(fresh: dict, base: dict, *, spectrum_tol: float, rate_tol: float,
         err_tol: float, err_floor: float, recall_tol: float,
         fp_tol_mb: float) -> list[dict]:
    checks: list[dict] = []
    check_structural(checks, fresh)
    check_spectrum(checks, fresh, base, spectrum_tol)
    check_rates(checks, fresh, base, rate_tol)
    check_accuracy(checks, fresh, base, err_tol=err_tol,
                   err_floor=err_floor, recall_tol=recall_tol,
                   fp_tol_mb=fp_tol_mb)
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fresh", required=True,
                    help="the just-produced accuracy_harness artifact")
    ap.add_argument("--baseline", default="",
                    help="committed artifact to compare against (default: "
                         "newest BENCH_QC_r*.json in the repo root)")
    ap.add_argument("--spectrum_tol", type=float, default=0.10,
                    help="allowed total-variation drift of the family-"
                         "size spectrum vs baseline")
    ap.add_argument("--rate_tol", type=float, default=0.05,
                    help="allowed absolute drift per QC rate vs baseline")
    ap.add_argument("--err_tol", type=float, default=0.5,
                    help="allowed fractional rise in per-base error vs "
                         "baseline (plus --err_floor absolute)")
    ap.add_argument("--err_floor", type=float, default=2e-4,
                    help="absolute error-rate headroom (a near-zero "
                         "baseline must not make any nonzero rate fail)")
    ap.add_argument("--recall_tol", type=float, default=0.05,
                    help="allowed absolute drop in variant recall")
    ap.add_argument("--fp_tol_mb", type=float, default=200.0,
                    help="allowed absolute rise in variant FP per Mb")
    ap.add_argument("--smoke", action="store_true",
                    help="shared-CI-box mode: widen tolerance-gated "
                         "checks (spectrum 0.25, rate 0.15, err_tol 2.0, "
                         "err_floor 1e-3, recall 0.10, fp 1000/Mb); "
                         "structural checks stay strict")
    ap.add_argument("--out", default="",
                    help="also write the JSON verdict to this path")
    args = ap.parse_args(argv)

    if args.smoke:
        args.spectrum_tol = max(args.spectrum_tol, 0.25)
        args.rate_tol = max(args.rate_tol, 0.15)
        args.err_tol = max(args.err_tol, 2.0)
        args.err_floor = max(args.err_floor, 1e-3)
        args.recall_tol = max(args.recall_tol, 0.10)
        args.fp_tol_mb = max(args.fp_tol_mb, 1000.0)

    baseline = args.baseline or find_baseline()
    if not baseline:
        print("qc_gate: no BENCH_QC_r*.json baseline found "
              "(pass --baseline)", file=sys.stderr)
        return 2
    try:
        with open(args.fresh) as fh:
            fresh_doc = json.load(fh)
        with open(baseline) as fh:
            base_doc = json.load(fh)
    except (OSError, ValueError) as e:
        print(f"qc_gate: cannot load artifacts: {e}", file=sys.stderr)
        return 2

    checks = gate(fresh_doc, base_doc,
                  spectrum_tol=args.spectrum_tol, rate_tol=args.rate_tol,
                  err_tol=args.err_tol, err_floor=args.err_floor,
                  recall_tol=args.recall_tol, fp_tol_mb=args.fp_tol_mb)
    verdict = {
        "ok": all(c["ok"] for c in checks),
        "baseline": os.path.basename(baseline),
        "fresh": os.path.basename(args.fresh),
        "smoke": bool(args.smoke),
        "tolerances": {"spectrum": args.spectrum_tol,
                       "rate": args.rate_tol, "err": args.err_tol,
                       "err_floor": args.err_floor,
                       "recall": args.recall_tol,
                       "fp_per_mb": args.fp_tol_mb},
        "checks": checks,
    }
    text = json.dumps(verdict, indent=1, sort_keys=True)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    if not verdict["ok"]:
        bad = [c["name"] for c in checks if not c["ok"]]
        print(f"qc_gate: FAIL ({', '.join(bad)})", file=sys.stderr)
        return 1
    print(f"qc_gate: ok ({len(checks)} check(s) vs "
          f"{os.path.basename(baseline)})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
