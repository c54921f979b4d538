"""Truth-set accuracy harness: simulate a duplex dataset with known
molecule sequences, run the real consensus pipeline over it, and score
what came out against the ground truth.

Port of the JAX package's ``tools/accuracy_harness.py``: the same flags,
defaults, artifact schema and messages, over the port's pipeline
(``cli.main(["consensus", ...])`` in-process) and its
``utils.simulate.simulate_bam``.  ``--backend`` keeps the JAX default
``tpu`` and reads as the port's CLI reads it (``tpu`` the card,
``xla_cpu`` the CPU, ``cpu``/``reference`` the host backends); ``--device
cuda|cpu`` wins over it and is forwarded as ``--device``.  The card is
the default: without CUDA the harness raises before it writes anything.
The artifact's ``config`` carries ``backend`` and the ``device`` the runs
voted on (null for a host backend).

``utils.simulate.simulate_bam`` fabricates reads FROM a truth molecule
per fragment, so every emitted base has a known right answer.  The
harness runs the staged pipeline twice (CCT_QC=0 then CCT_QC=1 — the
wall-clock delta is the measured QC overhead, printed as
``qc_overhead_pct``), then scores three levels:

- **per-base error rate** raw -> SSCS -> DCS: mismatches vs the truth
  molecule at each read's coordinates (consensus must improve on raw —
  that ordering is a structural check in ``utils/qc_gate.py``).
- **variant FP/FN**: a seeded set of truth sites; a site is recovered
  (TP) when some consensus read covering it reports the molecule's
  base, FN when covered-wrong or dropped; FP is any non-site consensus
  mismatch (the errors a caller would mistake for variants), reported
  per megabase.

Results are keyed by consensus policy: ``--policies
majority,delegation,distilled`` sweeps every named policy over the SAME
simulated truth BAM (one accuracy row each; ``utils/qc_gate.py``
compares per-policy), while ``--policy`` keeps the single-row behavior.
A ``--degraded_rate`` fraction of reads can be pushed into a low-quality
regime (qual 3-15, ``--degraded_error`` per-base errors) — the regime
where delegation/distilled voting must beat plain majority, visible in
the ``recovered`` rate (an emitted N counts as a miss there).  The
emitted artifact embeds the run's ``qc.json`` doc, so one file carries
both the QC spectrum and the accuracy table — this is the
``BENCH_QC_r*.json`` format ``utils/qc_gate.py`` gates against.

``--corrupt RATE`` is the positive control: consensus bases are flipped
at RATE (seeded, scoring-time only — the pipeline is untouched) so the
artifact LOOKS like a broken consensus.  qc_gate MUST fail on it.

  python -m consensuscruncher_tpu_torch.utils.accuracy_harness --repeats 1 \\
      --policies majority,delegation,distilled --degraded_rate 0.5 --out A.json
  python -m consensuscruncher_tpu_torch.utils.accuracy_harness --device cpu ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BASES = "ACGT"
ARTIFACT_VERSION = 1


def _score_reads(reads, truth, by_pos, corrupt_rng=None, corrupt_rate=0.0):
    """Mismatch/base totals + per-fragment coverage for one BAM level.

    ``reads``: (qname, pos, seq) triples; ``by_pos``: pos -> [frag]
    candidates (consensus qnames do not carry the fragment id, so reads
    map back through their coordinate; a rare position collision is
    resolved by scoring against every candidate and keeping the best —
    the true fragment wins unless error rates are absurd).
    Returns (mismatches, bases, recovered, truth_bases, coverage):
    ``bases`` counts positions where BOTH sides are called (the per-base
    error denominator — an N is neither right nor wrong there), while
    ``recovered``/``truth_bases`` count an emitted N as a MISS: of every
    truth base a read covers, how many did the consensus actually call
    correctly?  A policy that abstains its way to a low error rate
    cannot hide from the recovered rate — the axis delegation/distilled
    exist to win on degraded families.  ``coverage`` maps frag ->
    [(start_offset, seq), ...] for variant-site lookup.
    """
    mism = 0
    bases = 0
    recovered = 0
    truth_bases = 0
    coverage: dict[int, list[tuple[int, str]]] = {}
    for _qname, pos, seq in reads:
        if corrupt_rng is not None and corrupt_rate > 0:
            chars = list(seq)
            for i in (corrupt_rng.random(len(chars)) < corrupt_rate).nonzero()[0]:
                if chars[i] in BASES:
                    chars[i] = BASES[(BASES.index(chars[i])
                                      + 1 + int(corrupt_rng.integers(0, 3))) % 4]
            seq = "".join(chars)
        best = None
        for frag in by_pos.get(pos, ()):
            lo, mol = truth.molecules[frag]
            off = pos - lo
            expect = mol[off:off + len(seq)]
            m = sum(1 for a, b in zip(seq, expect)
                    if a != b and a in BASES and b in BASES)
            n = sum(1 for a, b in zip(seq, expect)
                    if a in BASES and b in BASES)
            rec = sum(1 for a, b in zip(seq, expect) if a == b and b in BASES)
            tb = sum(1 for b in expect if b in BASES)
            if best is None or m < best[0]:
                best = (m, n, rec, tb, frag, off, seq)
        if best is None:
            continue
        m, n, rec, tb, frag, off, seq = best
        mism += m
        bases += n
        recovered += rec
        truth_bases += tb
        coverage.setdefault(frag, []).append((off, seq))
    return mism, bases, recovered, truth_bases, coverage


def _read_level(path):
    from consensuscruncher_tpu_torch.io.bam import BamReader

    out = []
    with BamReader(path) as rd:
        for r in rd:
            out.append((r.qname, r.pos, r.seq))
    return out


def _variant_sites(truth, n_sites, seed, read_len):
    """Seeded (frag, offset) truth sites; the variant allele is the
    molecule's own base there (the consensus should recover it).  Sites
    land only inside the two sequenced windows (R1 at the molecule
    start, R2 at its end) — the unsequenced middle would score library
    design, not consensus quality."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frags = sorted(truth.molecules)
    sites = []
    for _ in range(n_sites):
        frag = frags[int(rng.integers(0, len(frags)))]
        lo, mol = truth.molecules[frag]
        off = int(rng.integers(0, 2 * read_len))
        if off >= read_len:  # second window: R2 covers the molecule tail
            off = len(mol) - 2 * read_len + off
        sites.append((frag, off, mol[off]))
    return sites


def _score_variants(sites, coverage):
    tp = fn_wrong = fn_dropped = 0
    for frag, off, allele in sites:
        hit = False
        covered = False
        for start, seq in coverage.get(frag, ()):
            if start <= off < start + len(seq):
                covered = True
                if seq[off - start] == allele:
                    hit = True
                    break
        if hit:
            tp += 1
        elif covered:
            fn_wrong += 1
        else:
            fn_dropped += 1
    return tp, fn_wrong, fn_dropped


def _target(args) -> tuple[list[str], str | None]:
    """The ``consensus`` flags that pick where the runs vote, and the
    device they name (None for a host backend).  ``--device`` wins; else
    ``--backend`` reads as the port's CLI reads it.  The card is resolved
    here, before anything is written: without CUDA this raises."""
    from consensuscruncher_tpu_torch.utils.backend_probe import device_of_backend

    device, host = ((args.device, None) if args.device
                    else device_of_backend(args.backend, flag="--backend"))
    if host is not None:
        return ["--backend", host], None
    from consensuscruncher_tpu_torch.device import resolve_device

    return ["--device", device], resolve_device(device).type


def _run_pipeline(bam, out, name, target, qc_on, policy="majority"):
    """One staged consensus run (``target``: :func:`_target`'s flags);
    returns wall seconds.  A failed run raises."""
    from consensuscruncher_tpu_torch.cli import main as cli_main

    os.environ["CCT_QC"] = "1" if qc_on else "0"
    argv = ["consensus", "-i", bam, "-o", out, "-n", name, *target]
    if policy != "majority":
        # absent == majority everywhere; only non-default runs name it
        argv += ["--policy", policy]
    t0 = time.monotonic()
    cli_main(argv)
    return time.monotonic() - t0


def _score_policy_run(base, name, bam, truth, by_pos, args, corrupt_rng):
    """Score one pipeline output tree (raw + sscs + dcs) against truth.

    Returns the accuracy row for ``accuracy.policies.<name>``.
    """
    levels = {}
    coverage_by_level = {}
    for level, path in (
        ("raw", bam),
        ("sscs", os.path.join(base, "sscs", f"{name}.sscs.sorted.bam")),
        ("dcs", os.path.join(base, "dcs", f"{name}.dcs.sorted.bam")),
    ):
        reads = _read_level(path)
        # corruption is the consensus-gone-wrong control: raw stays honest
        mism, total, rec, tb, cov = _score_reads(
            reads, truth, by_pos,
            corrupt_rng=None if level == "raw" else corrupt_rng,
            corrupt_rate=0.0 if level == "raw" else args.corrupt)
        levels[level] = {"mismatches": mism, "bases": total,
                         "error_rate": (mism / total) if total else None,
                         "recovered_rate": (rec / tb) if tb else None,
                         "reads": len(reads)}
        coverage_by_level[level] = cov

    sites = _variant_sites(truth, args.variants, args.seed + 1,
                           args.read_len)
    variants = {}
    for level in ("sscs", "dcs"):
        tp, fn_wrong, fn_dropped = _score_variants(
            sites, coverage_by_level[level])
        err = levels[level]
        fp = err["mismatches"]  # non-site consensus errors == would-be calls
        variants[level] = {
            "sites": len(sites), "tp": tp, "fn_wrong": fn_wrong,
            "fn_dropped": fn_dropped,
            "recall": (tp / len(sites)) if sites else None,
            "fp": fp,
            "fp_per_mb": (1e6 * fp / err["bases"]) if err["bases"] else None,
        }

    return {
        "per_base_error": {lv: levels[lv]["error_rate"] for lv in levels},
        "recovered": {lv: levels[lv]["recovered_rate"] for lv in levels},
        "bases": {lv: levels[lv]["bases"] for lv in levels},
        "reads": {lv: levels[lv]["reads"] for lv in levels},
        "variants": variants,
    }


def run(args) -> dict:
    import numpy as np

    from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_bam

    target, device = _target(args)
    if not args.workdir:
        import tempfile

        args.workdir = tempfile.mkdtemp(prefix="cct_acc_")
    work = args.workdir
    os.makedirs(work, exist_ok=True)
    cfg = SimConfig(n_fragments=args.fragments, read_len=args.read_len,
                    mean_family_size=args.mean_family,
                    duplex_fraction=args.duplex_fraction,
                    error_rate=args.error_rate, seed=args.seed,
                    degraded_read_rate=args.degraded_rate,
                    degraded_error_rate=args.degraded_error)
    bam = os.path.join(work, "truth.bam")
    truth = simulate_bam(bam, cfg)

    policies = ([p.strip() for p in args.policies.split(",") if p.strip()]
                if args.policies else [args.policy])

    name = "acc"
    # QC-overhead timing runs only for the FIRST policy: warmup pass per
    # QC variant (compile caches are keyed on the with_qc flag, so each
    # variant pays its own first-run jit cost), then min-of-N timed runs
    # per variant — shared CI boxes jitter 10-15% run to run, and min is
    # the standard de-noiser.  Extra policies are scored for accuracy
    # only (one qc_on run each) so a three-policy sweep doesn't triple
    # the harness wall-clock.
    first = policies[0]
    _run_pipeline(bam, os.path.join(work, "warm_off"), name,
                  target, qc_on=False, policy=first)
    _run_pipeline(bam, os.path.join(work, "warm_on"), name,
                  target, qc_on=True, policy=first)
    wall_off = min(_run_pipeline(bam, os.path.join(work, f"off{i}"), name,
                                 target, qc_on=False, policy=first)
                   for i in range(args.repeats))
    wall_on = min(_run_pipeline(bam, os.path.join(work, "on")
                                if i == 0 else
                                os.path.join(work, f"on{i}"), name,
                                target, qc_on=True, policy=first)
                  for i in range(args.repeats))
    overhead_pct = (100.0 * (wall_on - wall_off) / wall_off
                    if wall_off > 0 else 0.0)
    print(f"accuracy_harness: stage wall qc_off={wall_off:.3f}s "
          f"qc_on={wall_on:.3f}s qc_overhead_pct={overhead_pct:.2f}",
          file=sys.stderr, flush=True)

    run_base = {first: os.path.join(work, "on", name)}
    for policy in policies[1:]:
        out = os.path.join(work, f"on_{policy}")
        _run_pipeline(bam, out, name, target, qc_on=True,
                      policy=policy)
        run_base[policy] = os.path.join(out, name)

    by_pos: dict[int, list[int]] = {}
    for frag, (lo, mol) in truth.molecules.items():
        hi = lo + len(mol) - cfg.read_len
        by_pos.setdefault(lo, []).append(frag)
        by_pos.setdefault(hi, []).append(frag)

    corrupt_rng = (np.random.default_rng(args.seed + 777)
                   if args.corrupt > 0 else None)
    policy_rows = {}
    for policy in policies:
        policy_rows[policy] = _score_policy_run(
            run_base[policy], name, bam, truth, by_pos, args, corrupt_rng)

    qc_doc = None
    try:
        with open(os.path.join(run_base[first], "qc.json")) as fh:
            qc_doc = json.load(fh)
    except (OSError, ValueError):
        pass

    return {
        "version": ARTIFACT_VERSION,
        "kind": "qc_accuracy",
        "config": {"fragments": args.fragments, "read_len": args.read_len,
                   "mean_family": args.mean_family,
                   "duplex_fraction": args.duplex_fraction,
                   "error_rate": args.error_rate, "seed": args.seed,
                   "degraded_rate": args.degraded_rate,
                   "degraded_error": args.degraded_error,
                   "variants": args.variants, "backend": args.backend,
                   "device": device},
        "corrupt": args.corrupt,
        "qc_overhead_pct": round(overhead_pct, 3),
        "stage_wall_s": {"qc_off": round(wall_off, 4),
                         "qc_on": round(wall_on, 4)},
        "qc": qc_doc,
        "accuracy": {"policies": policy_rows},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="",
                    help="write the artifact JSON here (stdout always)")
    ap.add_argument("--workdir", default="",
                    help="scratch dir for the simulated BAM + runs "
                         "(default: a fresh temp dir)")
    ap.add_argument("--policy", default="majority",
                    help="consensus policy to run and score (one row in "
                         "the accuracy table)")
    ap.add_argument("--policies", default="",
                    help="comma-separated policy sweep over the SAME "
                         "simulated truth BAM — one accuracy row per "
                         "policy (overrides --policy; timing is measured "
                         "on the first entry only)")
    ap.add_argument("--backend", default="tpu",
                    help="consensus backend to exercise, read as the CLI "
                         "reads it (default tpu: the card; xla_cpu the CPU; "
                         "cpu and reference the host backends)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the runs vote; wins over --backend and is "
                         "forwarded as consensus --device (default: "
                         "--backend's device, the card)")
    ap.add_argument("--fragments", type=int, default=400)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed pipeline runs per QC variant; min wall "
                         "is reported (de-noises shared CI boxes)")
    ap.add_argument("--read_len", type=int, default=100)
    ap.add_argument("--mean_family", type=float, default=3.0)
    ap.add_argument("--duplex_fraction", type=float, default=0.8)
    ap.add_argument("--error_rate", type=float, default=0.005)
    ap.add_argument("--degraded_rate", type=float, default=0.0,
                    help="fraction of reads degraded to the low-quality "
                         "regime (qual 3-15, elevated errors) — the "
                         "regime delegation/distilled exist to win on")
    ap.add_argument("--degraded_error", type=float, default=0.08,
                    help="per-base error rate inside degraded reads")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--variants", type=int, default=40,
                    help="seeded truth sites scored for FP/FN")
    ap.add_argument("--corrupt", type=float, default=0.0,
                    help="positive control: flip consensus bases at this "
                         "rate before scoring (pipeline untouched); "
                         "qc_gate must catch the resulting artifact")
    args = ap.parse_args(argv)

    doc = run(args)
    text = json.dumps(doc, indent=1, sort_keys=True)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
