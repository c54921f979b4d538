"""Command line of the PyTorch/CUDA port.

    python -m consensuscruncher_tpu_torch.cli fastq2bam -f1 R1.fastq.gz \\
        -f2 R2.fastq.gz -o OUT -r ref.fa [--bwa bwa|builtin] [--bpattern P] \\
        [--blist L] [--cleanup True] [--resume True] [--compress_level 0-9] \\
        [--host_workers N] [-c config.ini]

``fastq2bam`` is the reference's first command: extract the inline UMIs
into the read names (``<OUT>/fastq_tag/``), align the tag FASTQs with an
external ``bwa`` or the in-process ``builtin`` aligner (its chunks forked
over ``--host_workers`` processes) into ``<OUT>/bamfiles/<name>.sorted.bam``
and its BAI, byte for byte the JAX package's outputs.  It is host code and
opens no CUDA context.

    python -m consensuscruncher_tpu_torch.cli consensus -i X.bam[,Y.bam...] \\
        -o OUT [-c config.ini] [--scorrect True] [--device cuda|cpu] \\
        [--residency True|False] [--resume True] [--intermediate_level 0-9] \\
        [--pipeline staged|streaming] [--intermediate_taps True] \\
        [--max_mismatch N] [--wire stream|dense] \\
        [--policy majority|delegation|distilled] [--host_workers N] \\
        [--devices N] [--profile DIR] [--backend cpu|reference] ...

Port of ``consensuscruncher_tpu/cli.py``'s ``consensus``: SSCS -> singleton
rescue -> rescued merge -> DCS -> all-unique merges -> BAI indexes ->
plots, under ``<output>/<name>/{sscs,singleton,dcs,all_unique,plots}``,
plus the run's ``qc.json`` (``CCT_QC``, on by default), ``manifest.json``
(what ``--resume`` skips by), ``run.metrics.json`` and each stage's
``*.metrics.json``.  The device votes run on the CUDA card unless
``--device cpu`` is given; on the stream wire the SSCS planes stay on the
device for rescue and DCS unless ``--residency False`` is given.
``--policy`` picks the SSCS family vote (``policies/``).

Flags take precedence over the ``[consensus]`` section of ``-c
config.ini``, which takes precedence over the built-in defaults; the
``[obs]``, ``[qc]`` and ``[io]`` sections fold into their environment
variables (a variable already set wins).  A comma-separated ``--input``
runs a sample batch, each sample under its own ``<output>/<stem>/``, the
next sample's decode prestaged while the current one runs.
``--host_workers N`` runs N worker processes over BAI coordinate ranges of
the input (sharing the visible CUDA cards) and merges their outputs.
``--devices N`` family-shards the SSCS votes and pair-shards the DCS votes
over N shards laid over the visible cards (``parallel.mesh``); with
``--device cpu``, N CPU shards.
``--profile DIR`` writes a ``torch.profiler`` Chrome trace of the run.
``--result_cache P`` lets the ``--host_workers`` planner materialize a
range the cache plane knows to be empty instead of running its worker.

    python -m consensuscruncher_tpu_torch.cli serve --socket S [--journal J] \\
        [--gang_size 4] [--warmup_shapes BxFxL,...] [--device cuda|cpu] \\
        [--result_cache P] [--warm_from VIEW] ...
    python -m consensuscruncher_tpu_torch.cli submit --socket S -i X.bam -o OUT
    python -m consensuscruncher_tpu_torch.cli route --spawn N | --members M \\
        [--ring_view VIEW] [--result_cache P] [--device cuda|cpu] ...
    python -m consensuscruncher_tpu_torch.cli cache scrub --result_cache P

``serve`` runs the persistent daemon of ``serve/`` on the card (unless
``--device cpu``): it gangs the SSCS of several queued jobs into one dense
device stream and finishes each job through ``consensus --resume``;
``submit`` hands it one job and waits for the result.  With
``--result_cache`` the daemon answers a job whose content digest is in the
cache plane by copying the committed bytes; ``--warm_from`` joins a fleet
hot from its ring view (the shared kernel build directory and cache
plane).  ``CCT_CANARY=1`` (or ``canary = 1`` in ``[obs]``) starts the
golden canary prober.  ``route`` is the fleet's front door
(``serve/router.py``): it consistent-hashes submits onto N daemons, fails
over, steals, fences and adopts; it opens no CUDA context, and a spawned
fleet (``--spawn N``) builds the kernel library once, in the parent, into
the build directory every worker shares.  ``cache scrub`` re-hashes every
committed cache entry and quarantines the corrupt ones (exit 1).

    python -m consensuscruncher_tpu_torch.cli trace export|fleet [--dir D] [--out F] \
        [--socket S | --host H --port P]
    python -m consensuscruncher_tpu_torch.cli critpath report|job [KEY] [--dir D] \
        [--json F|-] [--socket S | --host H --port P]
    python -m consensuscruncher_tpu_torch.cli prof report|flame [--dir D] [--out F] \
        [--json F] [--top N] [--socket S | --host H --port P]
    python -m consensuscruncher_tpu_torch.cli history query|trend [--dir D] \
        [--metric M] [--node N] [--last N] [--socket S | --host H --port P]
    python -m consensuscruncher_tpu_torch.cli qc report|diff PATH... [--json F]
    python -m consensuscruncher_tpu_torch.cli top [--once True] \
        [--socket S | --host H --port P] [--interval_s 2.0]

The observability readers, the JAX package's commands flag for flag: they
read what a fleet writes (``CCT_TRACE``, ``CCT_PROF``, ``CCT_HISTORY_DIR``
and the Prometheus exposition) over the router's or a daemon's wire ops,
and merge the shards on disk under ``--dir`` (when the wire cannot be
reached they warn and read the shards alone).  ``qc`` reads ``qc.json``
docs.  They are host code: none takes ``--device`` or opens a CUDA
context.  ``consensus --backend tpu|xla_cpu`` is the JAX package's flag
read as the device (``cuda``, ``cpu``); ``consensus --backend
cpu|reference`` runs the JAX package's host backends (the numpy twin, and
the object path that the README's speed claims are timed against): host
only, no kernel library, no CUDA context.  ``--device``, or a ``device``
config key, wins over ``--backend`` and a ``backend`` key.
"""

from __future__ import annotations

import argparse
import configparser
import copy
import glob
import json
import os
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

from consensuscruncher_tpu_torch import __version__
from consensuscruncher_tpu_torch.core.consensus_cpu import DEFAULT_QUAL_CAP
from consensuscruncher_tpu_torch.core.tags import DEFAULT_BDELIM
from consensuscruncher_tpu_torch.device import device_name, resolve_device
from consensuscruncher_tpu_torch.io import bgzf
from consensuscruncher_tpu_torch.io.bai import index_bam
from consensuscruncher_tpu_torch.io import sam as sam_mod
from consensuscruncher_tpu_torch.io.bam import BamReader, merge_bams
from consensuscruncher_tpu_torch.io.columnar import (
    SortingBamWriter,
    single_writer_sort_buffer_bytes,
)
from consensuscruncher_tpu_torch.obs import qc as obs_qc
from consensuscruncher_tpu_torch.ops.packing import resident_planes
from consensuscruncher_tpu_torch.policies import DEFAULT_POLICY, get_policy
from consensuscruncher_tpu_torch.parallel import hostshard
from consensuscruncher_tpu_torch.stages import dcs_maker, singleton_correction, sscs_maker
from consensuscruncher_tpu_torch.stages import extract_barcodes as extract_mod
from consensuscruncher_tpu_torch.stages.align import BuiltinAligner, align_fastqs_columnar
from consensuscruncher_tpu_torch.stages.dcs_maker import DcsResult, run_dcs
from consensuscruncher_tpu_torch.stages.generate_plots import (
    plot_family_size,
    plot_read_recovery,
    plot_stage_times,
)
from consensuscruncher_tpu_torch.stages.singleton_correction import (
    SingletonResult,
    run_singleton_correction,
)
from consensuscruncher_tpu_torch.stages.sscs_maker import SscsResult, run_sscs
from consensuscruncher_tpu_torch.utils.backend_probe import device_of_backend
from consensuscruncher_tpu_torch.utils.faults import FaultError, retrying
from consensuscruncher_tpu_torch.utils.manifest import RunManifest
from consensuscruncher_tpu_torch.utils.profiling import counter_marks, maybe_profile
from consensuscruncher_tpu_torch.utils.stats import TimeTracker


def _config_defaults(path: str | None, section: str) -> dict:
    if not path:
        return {}
    parser = configparser.ConfigParser()
    if not parser.read(path):
        raise SystemExit(f"config file not found: {path}")
    if section not in parser:
        return {}
    return dict(parser[section])


def _bool(v) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


# config.ini [obs] key -> the environment variable its reader consumes
# (obs/trace, obs/flight, obs/prof, obs/history, utils/sanitize's ledger)
_OBS_ENV = {
    "trace": "CCT_TRACE",
    "trace_dir": "CCT_TRACE_DIR",
    "trace_ring": "CCT_TRACE_RING",
    "flight_ring": "CCT_FLIGHT_RING",
    "prof": "CCT_PROF",
    "prof_hz": "CCT_PROF_HZ",
    "prof_dir": "CCT_PROF_DIR",
    "history_dir": "CCT_HISTORY_DIR",
    "history_interval_s": "CCT_HISTORY_INTERVAL_S",
    "history_max_bytes": "CCT_HISTORY_MAX_BYTES",
    "lock_ledger": "CCT_LOCK_LEDGER",
    "canary": "CCT_CANARY",
    "canary_interval_s": "CCT_CANARY_INTERVAL_S",
    "canary_latency_s": "CCT_CANARY_LATENCY_S",
    "canary_golden": "CCT_CANARY_GOLDEN",
    "canary_dir": "CCT_CANARY_DIR",
}


def _apply_obs_config(path: str | None) -> None:
    """Fold the ``[obs]`` config section into the observability env vars,
    as the JAX package's ``_apply_obs_config`` does.  ``setdefault`` so a
    real environment variable always wins over config.ini; unknown keys
    are ignored, as in the reference."""
    for key, value in _config_defaults(path, "obs").items():
        env = _OBS_ENV.get(key)
        if env and str(value) != "":
            os.environ.setdefault(env, str(value))


def _apply_qc_config(path: str | None) -> None:
    """Fold the ``[qc]`` config section into the QC env flag:
    ``enabled`` maps onto ``CCT_QC`` (setdefault — a real environment
    variable wins)."""
    enabled = _config_defaults(path, "qc").get("enabled")
    if enabled not in (None, ""):
        os.environ.setdefault("CCT_QC", "1" if _bool(enabled) else "0")


def _apply_io_config(path: str | None) -> None:
    """Fold the ``[io]`` config section into the BGZF codec knobs.

    ``bgzf_threads`` sizes the parallel deflate pool (0 = serial);
    ``async_writer`` toggles the writer's background deflate thread.
    ``bgzf.configure`` sits below the environment check, so
    CCT_BGZF_THREADS / CCT_ASYNC_WRITER still win, as over ``[qc]``.
    """
    io_cfg = _config_defaults(path, "io")
    if not io_cfg:
        return
    threads = io_cfg.get("bgzf_threads")
    async_write = io_cfg.get("async_writer")
    bgzf.configure(
        threads=int(threads) if threads not in (None, "") else None,
        async_write=_bool(async_write) if async_write not in (None, "") else None,
    )


@dataclass
class _Run:
    """One consensus run: its arguments and where its outputs go."""

    args: argparse.Namespace
    device: object        # torch.device, or None under a host backend
    name: str
    base: str
    dirs: dict
    manifest: RunManifest
    ilevel: int           # deflate level of the per-stage BAMs
    t0: float             # perf_counter at the start of the run
    marks: dict           # counter_marks() at the start of the run
    deflate_before: int   # bgzf.caller_wall_us() of the run's thread at its start


class _Walls:
    """Wall seconds of each step of a run, in order."""

    def __init__(self):
        self.walls: dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, step: str) -> None:
        now = time.perf_counter()
        self.walls[step] = now - self._t
        self._t = now


def make_checkpointed(manifest: RunManifest, resume: bool, label: str):
    """The checkpoint/resume protocol (the JAX package's, stage for stage):
    skip a stage when --resume can prove its recorded inputs/outputs/params
    are fingerprint-intact, else run and record."""

    def checkpointed(stage, inputs, outputs, params, run, rebuild):
        if resume and manifest.can_skip(stage, inputs, params):
            print(f"{label}: resume — skipping {stage} (outputs intact)")
            return rebuild()
        result = run()
        manifest.record(stage, inputs, outputs, params)
        return result

    return checkpointed


# ------------------------------------------------------------------ fastq2bam

def fastq2bam(args) -> dict:
    """Extract the inline UMIs of a FASTQ pair into the read names, align
    the tag FASTQs (``--bwa`` names an external aligner, or ``builtin``)
    into a coordinate-sorted BAM and index it, as the JAX package's
    ``fastq2bam`` does, byte for byte.  Host code only: the command opens
    no CUDA context, so the ``--host_workers`` align pool forks clean."""
    os.makedirs(args.output, exist_ok=True)
    tag_dir = os.path.join(args.output, "fastq_tag")
    bam_dir = os.path.join(args.output, "bamfiles")
    os.makedirs(tag_dir, exist_ok=True)
    os.makedirs(bam_dir, exist_ok=True)
    name = args.name or os.path.basename(args.fastq1).split(".")[0]

    # Tag FASTQs are intermediates; under --cleanup they are deleted right
    # after alignment, so they are written stored (level 0) then.  The
    # bad-read FASTQs are kept outputs and always get the requested level.
    level = int(args.compress_level)
    cleanup = _bool(getattr(args, "cleanup", False))
    tag_level = 0 if cleanup else level

    # The consensus command's checkpoint/resume model: content-bearing
    # input files (the FASTQs, --blist, --ref) are fingerprinted inputs,
    # never params, so editing one in place invalidates the skip; ``name``
    # is a param so a rerun under another -n cannot match stale records.
    manifest = RunManifest(os.path.join(args.output, "manifest.json"))
    resume = _bool(getattr(args, "resume", False))
    checkpointed = make_checkpointed(manifest, resume, "fastq2bam")
    prefix = os.path.join(tag_dir, name)
    tag_paths = extract_mod.output_paths(prefix)
    extract_inputs = [args.fastq1, args.fastq2]
    if args.blist:
        extract_inputs.append(args.blist)
    extract = checkpointed(
        "extract", extract_inputs, list(tag_paths.values()),
        {"name": name, "bpattern": args.bpattern, "bdelim": args.bdelim,
         "level": tag_level},
        run=lambda: extract_mod.run_extract(
            args.fastq1, args.fastq2, prefix, bpattern=args.bpattern,
            blist=args.blist, bdelim=args.bdelim, level=tag_level,
            bad_level=level),
        rebuild=lambda: extract_mod.ExtractResult(tag_paths["r1"], tag_paths["r2"], None),
    )

    out_bam = os.path.join(bam_dir, f"{name}.sorted.bam")
    # host_workers is left out of the align params on purpose: the worker
    # fan-out is byte-invariant, so a resume under another N still matches
    checkpointed(
        "align", [extract.r1_out, extract.r2_out, args.ref],
        [out_bam, out_bam + ".bai"],
        {"name": name, "bwa": args.bwa, "level": level},
        run=lambda: align_and_sort(
            args.bwa, args.ref, extract.r1_out, extract.r2_out, out_bam,
            host_workers=int(getattr(args, "host_workers", 1) or 1), level=level),
        rebuild=lambda: None,
    )
    # the reference indexes after every sort; usually a no-op here, since
    # the columnar sort writes its .bai inline
    index_bam(out_bam, skip_if_fresh=True)
    if cleanup:
        # the tag FASTQs are intermediates once the BAM exists; the barcode
        # stats and distribution stay (they feed QC)
        for path in (extract.r1_out, extract.r2_out):
            if os.path.exists(path):
                os.unlink(path)
    print(f"fastq2bam: wrote {out_bam}")
    return {"bam": out_bam, "extract": extract}


def align_and_sort(bwa: str, ref: str, r1: str, r2: str, out_bam: str,
                   host_workers: int = 1, level: int = 6) -> None:
    """Run the aligner and sort its output into ``out_bam`` (with its BAI).

    ``bwa == "builtin"`` runs ``stages/align.py`` in process, its per-chunk
    compute forked over ``host_workers`` processes (byte-identical output).
    Otherwise ``<bwa> mem <ref> <r1> <r2>`` runs as a subprocess and its
    SAM stdout is parsed (``io/sam``) into the sorting writer; it ignores
    ``host_workers`` (pass ``--bwa 'bwa -t N'``).  An aligner failure
    (nonzero exit, garbled SAM) is retried with exponential backoff,
    ``CCT_SUBPROC_RETRIES`` attempts (default 3) under the
    ``subprocess.bwa`` fault site; each attempt is all-or-nothing (the
    writer is aborted between attempts), so ``out_bam`` is only ever one
    attempt's whole product.
    """
    if bwa == "builtin":
        _align_builtin(ref, r1, r2, out_bam, host_workers=host_workers, level=level)
        return
    cmd = shlex.split(bwa) + ["mem", ref, r1, r2]
    sort_budget = single_writer_sort_buffer_bytes()

    def _attempt():
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
        except FileNotFoundError:
            # not transient: no retry will install bwa
            raise SystemExit(
                f"aligner not found: {cmd[0]!r} — install bwa or point --bwa "
                "at an executable that speaks `<bwa> mem <ref> <r1> <r2>` "
                "and emits SAM"
            )
        writer = None
        try:
            header, records = sam_mod.read_sam(proc.stdout)
            writer = SortingBamWriter(out_bam, header, level=level,
                                      max_raw_bytes=sort_budget)
            for read in records:
                writer.write(read)
        except Exception as exc:
            # a truncated or garbled SAM stream usually means the aligner
            # died mid-run: report its status, not the parse error
            proc.kill()
            status = proc.wait()
            if writer is not None:
                writer.abort()
            raise _AlignerFailure(
                f"aligner output unreadable ({exc}); aligner exit status {status}"
            ) from exc
        if proc.wait() != 0:
            writer.abort()
            raise _AlignerFailure(f"aligner exited with status {proc.returncode}")
        writer.close()

    attempts = int(os.environ.get("CCT_SUBPROC_RETRIES", "3"))
    try:
        retrying(_attempt, site="subprocess.bwa", attempts=attempts,
                 retriable=(_AlignerFailure,), describe=f"aligner {cmd[0]!r}")
    except (_AlignerFailure, FaultError) as exc:
        raise SystemExit(str(exc)) from exc


class _AlignerFailure(RuntimeError):
    """External aligner attempt failed (retriable, unlike a missing binary)."""


def _align_builtin(ref: str, r1: str, r2: str, out_bam: str,
                   host_workers: int = 1, level: int = 6) -> None:
    """``--bwa builtin``: the in-process k-mer aligner (``stages/align.py``,
    substitutions only, no indels), columnar: batched seed and extend and a
    vectorized record encode."""
    aligner = BuiltinAligner(ref)
    n_total, n_unmapped = align_fastqs_columnar(aligner, r1, r2, out_bam,
                                                level=level, workers=host_workers)
    # A high unaligned share is the fingerprint of reads the builtin
    # aligner cannot place (indels, clipped ends): never let it pass quietly.
    if n_total and n_unmapped / n_total > 0.10:
        print(
            f"WARNING: --bwa builtin left {n_unmapped}/{n_total} reads "
            f"unaligned ({100 * n_unmapped / n_total:.0f}%). The builtin "
            "aligner handles substitutions only — reads with indels or "
            "clipped ends cannot align. For real sequencing data use a "
            "gapped aligner: --bwa /path/to/bwa",
            file=sys.stderr,
            flush=True,
        )


def consensus(args) -> dict:
    """Run the consensus pipeline on one input, or on each input of a
    comma-separated batch (``{input: result}``).  A run's result holds its
    output paths, the directory map, the wall seconds of each step and the
    pipeline that ran.  ``--profile DIR`` traces the whole command."""
    inputs = [p.strip() for p in str(args.input).split(",") if p.strip()]
    # only a process that drives the card traces it: a host-sharded parent
    # opens no CUDA context (a host backend names no device at all)
    on_card = args.device == "cuda" and args.host_workers <= 1
    with maybe_profile(args.profile, cuda=on_card):
        if len(inputs) <= 1:
            return _run_one(args)
        if args.name:
            raise SystemExit(
                "--name cannot combine with a multi-sample --input batch "
                "(every sample names its own output tree by file stem)")
        return _consensus_batch(args, inputs)


def _run_one(args) -> dict:
    if args.host_workers > 1:
        return _consensus_host_sharded(args)
    return _consensus_one(args)


def _consensus_batch(args, inputs: list[str]) -> dict:
    """The sample batch: every input through the pipeline in this process,
    each under its own ``<output>/<stem>/`` tree.  While sample N runs,
    sample N+1's columnar decode and grouping run on a producer thread
    (``sscs_maker.prestage_blocks``); host-sharded samples run their own
    worker processes instead.  A prestage that fails is reported and the
    sample decodes on its own turn (where a real fault raises); every
    prestage is closed whatever happens.  A host backend prestages
    nothing."""
    # the host backends decode their own way, as in the JAX package
    overlap = args.host_workers <= 1 and not args.host_backend
    results = {}
    prestaged = None
    for idx, inp in enumerate(inputs):
        sub = copy.copy(args)
        sub.input = inp
        sub.name = None  # per-sample stem
        sub._prestaged = prestaged
        nxt = inputs[idx + 1] if idx + 1 < len(inputs) else None
        next_stage = None
        try:
            if nxt is not None and overlap:
                try:
                    next_stage = sscs_maker.prestage_blocks(nxt, bdelim=args.bdelim)
                except Exception as e:
                    # a bad NEXT input must not kill the CURRENT sample; the
                    # real error surfaces on that sample's own turn
                    print(f"consensus: prestage of {nxt} failed ({e}); "
                          "continuing without overlap", file=sys.stderr)
            print(f"consensus: batch sample {inp}"
                  + (" (next sample prestaging)" if next_stage else ""))
            results[inp] = _run_one(sub)
        except BaseException:
            if next_stage is not None:
                next_stage.close()
            raise
        finally:
            if prestaged is not None:
                prestaged.close()  # idempotent; covers a stage --resume skipped
        prestaged = next_stage
    return results


def _consensus_host_sharded(args) -> dict:
    """``--host_workers N``: coordinate-range data parallelism over worker
    processes (see ``parallel.hostshard``), the JAX package's
    ``_consensus_host_sharded``.  The whole consensus flow is
    position-local, so N workers each run the standard pipeline on a
    disjoint BAI range of the shared input and this parent merges every
    output class, sums the stats and histograms, merges the workers'
    ``qc.json`` and draws the plots.

    On the card the parent opens no CUDA context: it builds the kernel
    library once (``nvcc`` needs no card) so N workers do not compile it N
    times, and worker *i* opens its own context on visible card *i mod
    count*.

    With ``--result_cache`` a range whose exact worker sub-spec is cached
    ``negative: true`` (it provably produces zero consensus families) is
    materialized from the cache plane instead of run.  Positive entries
    are not taken here (workers have their own ``--resume``)."""
    n = int(args.host_workers)
    resume = args.resume
    # checks for a card and opens no context; a host backend names no device
    device = None if args.host_backend else resolve_device(args.device)
    name = args.name or os.path.basename(args.input).split(".")[0]
    base = os.path.join(args.output, name)
    dirs = _make_dirs(base)
    ranges_dir = os.path.join(base, ".ranges")
    os.makedirs(ranges_dir, exist_ok=True)
    tracker = TimeTracker()

    # Workers read BAI coordinate ranges straight out of the shared input.
    # The plan is deterministic for (input, n); under --resume the recorded
    # plan must match, else worker outputs would pair with stale ranges.
    plan_path = os.path.join(ranges_dir, "ranges.json")
    input_sig = {"path": os.path.abspath(args.input),
                 "size": os.path.getsize(args.input),
                 "mtime": int(os.path.getmtime(args.input)), "n": n}
    ranges = hostshard.plan_bai_ranges(args.input, n)
    plan = {"sig": input_sig, "ranges": [hostshard.range_argv(r) for r in ranges]}
    if resume and os.path.exists(plan_path):
        with open(plan_path) as f:
            prev = json.load(f)
        if prev.get("sig") != input_sig or prev.get("ranges") != plan["ranges"]:
            raise SystemExit(
                "--resume: the input, --host_workers, or the computed range "
                f"plan changed since the interrupted run (recorded "
                f"{prev.get('sig')}, now {input_sig}); stale worker outputs "
                "cannot pair with new ranges — rerun without --resume")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    tracker.mark("split")

    n_cards = 0
    if device is not None and device.type == "cuda":
        import torch

        from consensuscruncher_tpu_torch.ops import cuda_lib

        cuda_lib.build("consensus_vote")
        n_cards = torch.cuda.device_count()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base_env = dict(os.environ)
    # -m resolves via the child's sys.path; splice the repo root in so the
    # workers import this checkout regardless of their cwd
    base_env["PYTHONPATH"] = repo_root + os.pathsep + base_env.get("PYTHONPATH", "")
    skipped_neg = _materialize_negative_ranges(args, ranges, ranges_dir)
    workers = []
    for i, rng in enumerate(ranges):
        if i in skipped_neg:
            continue
        spec = hostshard.range_argv(rng)
        argv = hostshard.worker_argv(args.input, ranges_dir, f"r{i}", args,
                                     range_spec=spec, resume=resume)
        # retries always resume: a relaunched worker reuses the stages it
        # committed before dying
        retry_argv = hostshard.worker_argv(args.input, ranges_dir, f"r{i}", args,
                                           range_spec=spec, resume=True)
        # worker stderr goes to a file: a PIPE drained only after earlier
        # workers finish could fill and block a chatty later worker
        workers.append({
            "name": f"r{i}",
            "cmd": [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", *argv],
            "retry_cmd": [sys.executable, "-m", "consensuscruncher_tpu_torch.cli",
                          *retry_argv],
            "env": hostshard.worker_env(base_env, i, device.type if device else "cpu",
                                        n_cards, args.devices or 1),
            "err_path": os.path.join(ranges_dir, f"r{i}.stderr"),
        })
    hostshard.run_workers(workers, retries=int(os.environ.get("CCT_WORKER_RETRIES", "1")))
    tracker.mark("workers")

    def rpaths(rel_fmt: str) -> list[str]:
        return [os.path.join(ranges_dir, f"r{i}", rel_fmt.format(n=f"r{i}")) for i in range(n)]

    level = args.compress_level
    ilevel = level if args.intermediate_level is None else args.intermediate_level
    # BAM classes: disjoint sorted ranges -> the merge is an ordered
    # concatenation with a fresh inline index
    bam_classes = [
        ("sscs/{n}.sscs.sorted.bam", "sscs", "sscs.sorted.bam", ilevel),
        ("sscs/{n}.singleton.sorted.bam", "sscs", "singleton.sorted.bam", ilevel),
        ("dcs/{n}.dcs.sorted.bam", "dcs", "dcs.sorted.bam", ilevel),
        ("dcs/{n}.sscs.singleton.sorted.bam", "dcs", "sscs.singleton.sorted.bam", ilevel),
        ("all_unique/{n}.all.unique.sscs.bam", "all_unique", "all.unique.sscs.bam", level),
        ("all_unique/{n}.all.unique.dcs.bam", "all_unique", "all.unique.dcs.bam", level),
    ]
    if args.scorrect:
        bam_classes += [
            ("singleton/{n}.sscs.rescue.sorted.bam", "singleton", "sscs.rescue.sorted.bam",
             ilevel),
            ("singleton/{n}.singleton.rescue.sorted.bam", "singleton",
             "singleton.rescue.sorted.bam", ilevel),
            ("singleton/{n}.remaining.singleton.sorted.bam", "singleton",
             "remaining.singleton.sorted.bam", ilevel),
        ]
    if args.scorrect and not args.cleanup:
        # the rescued-merge DCS input survives a non-cleanup one-process
        # run; keep the sharded tree's shape the same
        bam_classes.append(("dcs/{n}.sscs.rescued.bam", "dcs", "sscs.rescued.bam",
                            min(1, ilevel)))
    for rel, sub, suffix, lvl in bam_classes:
        parts = [p for p in rpaths(rel) if os.path.exists(p)]
        merge_bams(parts, os.path.join(dirs[sub], f"{name}.{suffix}"), level=lvl)
    # badReads: unsorted diagnostic stream — ordered concatenation (skipped
    # under --cleanup, which deletes it at the end of a one-process run)
    if not args.cleanup:
        with BamReader(args.input) as reader:
            in_header = reader.header
        hostshard.concat_bams(
            [p for p in rpaths("sscs/{n}.badReads.bam") if os.path.exists(p)],
            os.path.join(dirs["sscs"], f"{name}.badReads.bam"), in_header, level=ilevel)

    hostshard.aggregate_stats(rpaths("sscs/{n}.sscs_stats.json"), "SSCS",
                              os.path.join(dirs["sscs"], f"{name}.sscs_stats.txt"))
    if args.scorrect:
        hostshard.aggregate_stats(
            rpaths("singleton/{n}.singleton_stats.json"), "singleton_correction",
            os.path.join(dirs["singleton"], f"{name}.singleton_stats.txt"))
    hostshard.aggregate_stats(rpaths("dcs/{n}.dcs_stats.json"), "DCS",
                              os.path.join(dirs["dcs"], f"{name}.dcs_stats.txt"))
    hostshard.aggregate_histograms(rpaths("sscs/{n}.read_families.txt"),
                                   os.path.join(dirs["sscs"], f"{name}.read_families.txt"))
    tracker.mark("merge")
    tracker.write(os.path.join(dirs["sscs"], f"{name}.time_tracker.txt"))

    # the workers' per-range qc.json shards merge into the run's (before
    # .ranges goes): spectra and yields sum over disjoint ranges, vote
    # planes pad-add.  No best-effort catch, as in the port's one-process
    # runs.
    if obs_qc.enabled():
        docs = [obs_qc.read_qc(p) for p in rpaths("qc.json") if os.path.exists(p)]
        if docs:
            doc = obs_qc.merge_docs(docs)
            doc["run"] = name
            doc["pipeline"] = f"host_sharded[{n}]"
            if skipped_neg:
                doc["ranges_skipped_negative"] = len(skipped_neg)
            obs_qc.write_qc(os.path.join(base, "qc.json"), doc)
    _draw_plots(dirs, name, args.scorrect, rpaths("sscs/{n}.metrics.json"))

    # A resumed run keeps the worker checkpoint tree (unless --cleanup):
    # it is the evidence of what was skipped and what recomputed, and a
    # further resume after a later failure reuses it.  Plain runs drop it.
    if args.cleanup or not resume:
        shutil.rmtree(ranges_dir, ignore_errors=True)
    print(f"consensus: outputs under {base} ({n} host workers, "
          f"{device.type if device else args.host_backend})")
    return {"all_sscs": os.path.join(dirs["all_unique"], f"{name}.all.unique.sscs.bam"),
            "all_dcs": os.path.join(dirs["all_unique"], f"{name}.all.unique.dcs.bam"),
            "dirs": dirs, "walls": tracker.as_phases(), "pipeline": f"host_sharded[{n}]"}


def _materialize_negative_ranges(args, ranges, ranges_dir: str) -> set[int]:
    """The indexes of the ranges answered from the result cache: each
    range whose worker sub-spec (input, ``r<i>``, the vote parameters, its
    ``--input_range``) has a committed ``negative`` entry in the plane at
    ``--result_cache`` is copied into ``<ranges_dir>/r<i>``, where its
    worker would have written.  A range whose copy fails runs its worker."""
    root = str(args.result_cache or "")
    if not root or not os.path.isdir(root):
        return set()
    from consensuscruncher_tpu_torch.serve import result_cache as rc_mod

    cache = rc_mod.ResultCache(root)
    skipped = set()
    for i, rng in enumerate(ranges):
        spec = {"input": args.input, "name": f"r{i}", "cutoff": args.cutoff,
                "qualscore": args.qualscore, "scorrect": args.scorrect,
                "max_mismatch": args.max_mismatch, "bdelim": args.bdelim,
                "compress_level": args.compress_level,
                "input_range": hostshard.range_argv(rng)}
        digest = rc_mod.content_digest(spec)
        entry = cache.lookup(digest) if digest else None
        if entry is None or not entry.get("negative"):
            continue
        try:
            cache.materialize(entry, os.path.join(ranges_dir, f"r{i}"))
        except OSError as e:
            print(f"WARNING: cached-negative range r{i} failed to materialize ({e}); "
                  "running the worker instead", file=sys.stderr, flush=True)
            continue
        skipped.add(i)
    if skipped:
        print(f"consensus: {len(skipped)}/{len(ranges)} ranges known-empty in the result "
              f"cache; workers skipped ({sorted(skipped)})", file=sys.stderr, flush=True)
    return skipped


def _consensus_one(args) -> dict:
    """One sample, one process: the staged or the streaming pipeline."""
    t0 = time.perf_counter()
    marks, deflate_before = counter_marks(), bgzf.caller_wall_us()
    # a host backend (--backend cpu|reference) names no device and opens none
    device = None if args.host_backend else resolve_device(args.device)
    # the vote policy (and the distilled checkpoint) is resolved before any
    # output exists: an unknown name or a bad checkpoint writes nothing
    get_policy(args.policy).prepare()
    name = args.name or os.path.basename(args.input).split(".")[0]
    base = os.path.join(args.output, name)
    dirs = _make_dirs(base)
    manifest = RunManifest(os.path.join(base, "manifest.json"))
    # Per-output-class deflate: the per-stage BAMs may take
    # --intermediate_level while the finals keep --compress_level (default:
    # follow --compress_level).
    ilevel = args.compress_level if args.intermediate_level is None else args.intermediate_level
    run = _Run(args, device, name, base, dirs, manifest, ilevel, t0, marks, deflate_before)

    # Device-resident SSCS planes (on by default on the single-device
    # stream wire, as in the JAX package): rescue and DCS vote by gather on
    # the device instead of uploading the SSCS planes again.  Outputs are
    # byte-identical either way, so it is no manifest param; a resume that
    # skips SSCS leaves the store empty and rescue and DCS vote by upload.
    # A --devices N > 1 run keeps no store: its rows come back from the
    # shards in per-device blocks; nor does a host backend.
    def store():
        if (device is not None and args.wire == "stream" and _bool(args.residency)
                and (args.devices is None or args.devices <= 1)):
            return resident_planes(device, DEFAULT_QUAL_CAP)
        return None

    # The object-walk rescue (--max_mismatch > 0) re-reads its inputs as
    # files, and a host worker's range is no whole input, so such runs take
    # the staged pipeline, as in the JAX package.
    if (args.pipeline == "streaming" and not args.resume and not args.input_range
            and (not args.scorrect or int(args.max_mismatch) == 0)):
        from consensuscruncher_tpu_torch.core.streamgraph import StreamFallback

        try:
            return _consensus_streaming(run, store())
        except StreamFallback as e:
            # The JAX package re-runs the staged pipeline after any
            # exception; the port only after the host-side conditions that
            # streaming cannot get past (a spilled sort buffer, a failed
            # background write, a consensus record whose tags do not lead
            # with XT/XF, which the rescue and DCS walks must re-read from
            # files), so a device fault always raises.
            print(f"consensus: streaming pipeline cannot finish in memory ({e}); "
                  "falling back to the staged pipeline", file=sys.stderr, flush=True)
            # the streaming SSCS stage consumed (and closed) a batch's
            # prestage: the staged run decodes the input anew.  The JAX
            # package hands the closed prestage on and its staged SSCS
            # reads nothing (ROADMAP Queue C)
            args._prestaged = None
    return _consensus_staged(run, store())


def _consensus_staged(run: _Run, residency) -> dict:
    args, device, name, dirs = run.args, run.device, run.name, run.dirs
    ilevel, level = run.ilevel, args.compress_level
    checkpointed = make_checkpointed(run.manifest, args.resume, "consensus")
    walls = _Walls()
    # QC rider: the SSCS vote folds per-position vote/disagree sums into
    # this accumulator; spectrum and yields come from the stats sidecars,
    # so a --resume that skips SSCS still writes qc.json (``plane: null``).
    qc_acc = obs_qc.QcAccumulator() if obs_qc.enabled() else None

    sscs_prefix = os.path.join(dirs["sscs"], name)
    # --input_range (a host worker's share) reads one BAI coordinate range
    # of the shared input
    input_range = hostshard.parse_range_argv(args.input_range) if args.input_range else None
    sscs = checkpointed(
        "sscs", *sscs_maker.manifest_entry(args.input, sscs_prefix, args.cutoff,
                                           args.qualscore, args.bdelim, args.input_range,
                                           args.policy),
        run=lambda: run_sscs(args.input, sscs_prefix, device, cutoff=args.cutoff,
                             qual_threshold=args.qualscore, bdelim=args.bdelim, level=ilevel,
                             residency=residency, qc=qc_acc, wire=args.wire,
                             policy=args.policy, input_range=input_range,
                             prestaged=getattr(args, "_prestaged", None),
                             devices=args.devices, backend=args.host_backend),
        rebuild=lambda: SscsResult.from_prefix(sscs_prefix))
    walls.mark("sscs")
    sscs_parts = [sscs.sscs_bam]
    dcs_input = sscs.sscs_bam
    if args.scorrect:
        corr_prefix = os.path.join(dirs["singleton"], name)
        corr = checkpointed(
            "singleton_correction", [sscs.singleton_bam, sscs.sscs_bam],
            list(singleton_correction.output_paths(corr_prefix).values()),
            {"max_mismatch": args.max_mismatch},
            run=lambda: run_singleton_correction(sscs.singleton_bam, sscs.sscs_bam,
                                                 corr_prefix, device,
                                                 max_mismatch=args.max_mismatch,
                                                 level=ilevel, residency=residency,
                                                 backend=args.host_backend),
            rebuild=lambda: SingletonResult.from_prefix(corr_prefix))
        walls.mark("singleton_correction")
        sscs_parts += [corr.sscs_rescue_bam, corr.singleton_rescue_bam, corr.remaining_bam]
        # DCS pairs SSCSes plus rescued singletons: a corrected singleton can
        # now form a duplex with its partner.  The merge feeds DCS only, so
        # it is stored raw under --cleanup (deleted at the end anyway).
        dcs_input = os.path.join(dirs["dcs"], f"{name}.sscs.rescued.bam")
        merge_in = [sscs.sscs_bam, corr.sscs_rescue_bam, corr.singleton_rescue_bam]
        checkpointed(
            "merge_rescued", merge_in, [dcs_input], {},
            run=lambda: merge_bams(merge_in, dcs_input,
                                   level=0 if args.cleanup else min(1, ilevel),
                                   index=not args.cleanup),
            rebuild=lambda: None)
        walls.mark("merge_rescued")
    else:
        sscs_parts.append(sscs.singleton_bam)
    dcs_prefix = os.path.join(dirs["dcs"], name)
    dcs = checkpointed(
        "dcs", [dcs_input], list(dcs_maker.output_paths(dcs_prefix).values()), {},
        run=lambda: run_dcs(dcs_input, dcs_prefix, device, level=ilevel, residency=residency,
                            devices=args.devices, backend=args.host_backend),
        rebuild=lambda: DcsResult.from_prefix(dcs_prefix))
    walls.mark("dcs")

    # all-unique merges: SSCS path = every molecule's best single-strand
    # evidence; DCS path = duplex reads plus SSCSes that found no partner
    all_sscs = os.path.join(dirs["all_unique"], f"{name}.all.unique.sscs.bam")
    all_dcs = os.path.join(dirs["all_unique"], f"{name}.all.unique.dcs.bam")
    sscs_merge_in = [p for p in sscs_parts if os.path.exists(p)]
    checkpointed("merge_all_sscs", sscs_merge_in, [all_sscs], {},
                 run=lambda: merge_bams(sscs_merge_in, all_sscs, level=level),
                 rebuild=lambda: None)
    dcs_merge_in = [p for p in (dcs.dcs_bam, dcs.sscs_singleton_bam) if os.path.exists(p)]
    checkpointed("merge_all_dcs", dcs_merge_in, [all_dcs], {},
                 run=lambda: merge_bams(dcs_merge_in, all_dcs, level=level),
                 rebuild=lambda: None)
    walls.mark("merge_all_unique")

    index_parts = [all_sscs, all_dcs, dcs.dcs_bam, dcs.sscs_singleton_bam,
                   sscs.sscs_bam, sscs.singleton_bam]
    if args.scorrect:
        index_parts += [corr.sscs_rescue_bam, corr.singleton_rescue_bam, corr.remaining_bam]
        if not args.cleanup:
            index_parts.append(dcs_input)
    doomed = [sscs.bad_bam] + ([dcs_input, dcs_input + ".bai"] if args.scorrect else [])
    _finish(run, "staged", index_parts, doomed, qc_acc)
    walls.mark("index")
    return {"all_sscs": all_sscs, "all_dcs": all_dcs, "dirs": dirs, "walls": walls.walls,
            "pipeline": "staged"}


def _consensus_streaming(run: _Run, residency) -> dict:
    """``--pipeline streaming``: the consensus chain as a dataflow graph
    (port of the JAX package's ``_consensus_streaming``).

    Stage hand-offs move sorted record batches through bounded in-memory
    channels (``core.streamgraph``) instead of BGZF-deflating, re-reading
    and re-sorting an intermediate BAM at every boundary.  The finals stay
    byte-identical to the staged pipeline's — the merges run the same
    sort/write construction over the same records — while the
    stage-to-stage BAMs are skipped unless ``--intermediate_taps`` asks
    for them.  Files are written on a write-behind pool, overlapping
    deflate with the next stage.  One whole-flow manifest entry is
    recorded: the hand-offs were never files, so a later --resume takes
    the staged path and re-runs every stage.

    A serve job continuing from its gang's SSCS (``args._sscs_handoff``,
    see :func:`main`) starts from the hand-off's in-memory SSCS and
    singleton records instead of running the stage.
    """
    from consensuscruncher_tpu_torch.core.streamgraph import BatchStream, StreamOut
    from consensuscruncher_tpu_torch.io.bam import merge_memory_bams

    args, device, name, dirs = run.args, run.device, run.name, run.dirs
    ilevel, level, taps = run.ilevel, args.compress_level, args.intermediate_taps
    walls = _Walls()
    qc_acc = obs_qc.QcAccumulator() if obs_qc.enabled() else None
    stream = StreamOut(taps=taps)
    dcs_input = os.path.join(dirs["dcs"], f"{name}.sscs.rescued.bam")
    all_sscs = os.path.join(dirs["all_unique"], f"{name}.all.unique.sscs.bam")
    all_dcs = os.path.join(dirs["all_unique"], f"{name}.all.unique.dcs.bam")
    try:
        handoff = getattr(args, "_sscs_handoff", None)
        if handoff is not None:
            # serve gang continuation: the daemon already ran this job's
            # share of the gang SSCS and holds its sorted outputs in memory
            # (the files, stats and manifest entry are on disk already)
            sscs = SscsResult.from_prefix(os.path.join(dirs["sscs"], name))
            stream.memory["sscs"] = handoff["sscs"]
            stream.memory["singleton"] = handoff["singleton"]
        else:
            sscs = run_sscs(args.input, os.path.join(dirs["sscs"], name), device,
                            cutoff=args.cutoff, qual_threshold=args.qualscore,
                            bdelim=args.bdelim, level=ilevel, residency=residency,
                            qc=qc_acc, stream_out=stream, wire=args.wire,
                            policy=args.policy,
                            prestaged=getattr(args, "_prestaged", None),
                            devices=args.devices, backend=args.host_backend)
        walls.mark("sscs")
        sscs_mem, singleton_mem = stream.memory["sscs"], stream.memory["singleton"]
        sscs_mem_parts = [sscs_mem]
        if args.scorrect:
            corr = run_singleton_correction(
                BatchStream(singleton_mem), BatchStream(sscs_mem),
                os.path.join(dirs["singleton"], name), device, level=ilevel,
                residency=residency, stream_out=stream, backend=args.host_backend)
            walls.mark("singleton_correction")
            rescue_mems = [stream.memory["sscs_rescue"], stream.memory["singleton_rescue"]]
            sscs_mem_parts += rescue_mems + [stream.memory["remaining"]]
            # the DCS input merge stays in memory; as a tap it keeps the
            # staged path's cheap-deflate policy
            dcs_in_mem = merge_memory_bams([sscs_mem] + rescue_mems)
            if taps:
                stream.submit(dcs_in_mem.write, dcs_input,
                              level=0 if args.cleanup else min(1, ilevel),
                              index=not args.cleanup)
            walls.mark("merge_rescued")
        else:
            sscs_mem_parts.append(singleton_mem)
            dcs_in_mem = sscs_mem
        # the biggest final's merge + deflate runs on the write-behind pool,
        # overlapping the DCS stage's votes
        stream.submit(merge_memory_bams, sscs_mem_parts, all_sscs, level=level)
        dcs = run_dcs(BatchStream(dcs_in_mem), os.path.join(dirs["dcs"], name), device,
                      level=ilevel, residency=residency, stream_out=stream,
                      devices=args.devices, backend=args.host_backend)
        walls.mark("dcs")
        merge_memory_bams([stream.memory["dcs"], stream.memory["unpaired"]], all_dcs,
                          level=level)
        stream.drain()  # raises StreamFallback from the first background failure
        walls.mark("merge_all_unique")
    except BaseException:
        stream.abort()
        raise

    run.manifest.record(
        "consensus_stream", [args.input], [all_sscs, all_dcs],
        {"cutoff": args.cutoff, "qualscore": args.qualscore, "bdelim": args.bdelim,
         "scorrect": args.scorrect, "max_mismatch": args.max_mismatch,
         "pipeline": "streaming"})
    # Same indexing policy as staged: every surviving coordinate-sorted BAM.
    # Files the stream wrote carry a fresh inline .bai (a stat() here); taps
    # that were never written fail the exists() check.
    index_parts = [all_sscs, all_dcs, dcs.dcs_bam, dcs.sscs_singleton_bam,
                   sscs.sscs_bam, sscs.singleton_bam]
    if args.scorrect:
        index_parts += [corr.sscs_rescue_bam, corr.singleton_rescue_bam, corr.remaining_bam]
        if taps and not args.cleanup:
            index_parts.append(dcs_input)
    doomed = [sscs.bad_bam] + ([dcs_input, dcs_input + ".bai"] if args.scorrect and taps
                               else [])
    _finish(run, "streaming", index_parts, doomed, qc_acc)
    walls.mark("index")
    return {"all_sscs": all_sscs, "all_dcs": all_dcs, "dirs": dirs, "walls": walls.walls,
            "pipeline": "streaming"}


def _finish(run: _Run, pipeline: str, index_parts, doomed, qc_acc) -> None:
    """The end of a run, either pipeline: index every surviving BAM, draw
    the plots, delete the intermediates under --cleanup, write
    run.metrics.json and qc.json."""
    args, base, name = run.args, run.base, run.name
    for path in index_parts:
        if os.path.exists(path):
            index_bam(path, skip_if_fresh=True)
    _draw_plots(run.dirs, name, args.scorrect,
                [os.path.join(run.dirs["sscs"], f"{name}.metrics.json")])
    if args.cleanup:
        for path in doomed:
            if os.path.exists(path):
                os.unlink(path)
    _write_run_metrics(run, pipeline)
    # Unlike the JAX package, no best-effort catch around the QC doc: the
    # accumulator copies the card's sums here, and a device fault must raise.
    if qc_acc is not None:
        obs_qc.write_qc(os.path.join(base, "qc.json"),
                        obs_qc.collect_run(base, name, pipeline=pipeline, acc=qc_acc,
                                           policy=args.policy))
    print(f"consensus: outputs under {base} ({pipeline} pipeline, "
          f"{device_name(run.device) if run.device else args.host_backend})")


def _make_dirs(base: str) -> dict:
    """The output tree of a run under ``base``, made."""
    dirs = {k: os.path.join(base, k)
            for k in ("sscs", "singleton", "dcs", "all_unique", "plots")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs


def _draw_plots(dirs: dict, name: str, scorrect: bool, metrics_jsons: list[str]) -> None:
    """``plots/``: the family-size spectrum, the read-recovery funnel over
    the stage stats, and the stage walls of ``metrics_jsons``."""
    stats_jsons = [os.path.join(dirs["sscs"], f"{name}.sscs_stats.json")]
    if scorrect:
        stats_jsons.append(os.path.join(dirs["singleton"], f"{name}.singleton_stats.json"))
    stats_jsons.append(os.path.join(dirs["dcs"], f"{name}.dcs_stats.json"))
    plot_family_size(os.path.join(dirs["sscs"], f"{name}.read_families.txt"),
                     os.path.join(dirs["plots"], f"{name}.family_size.png"))
    plot_read_recovery(stats_jsons, os.path.join(dirs["plots"], f"{name}.read_recovery.png"))
    plot_stage_times(metrics_jsons, os.path.join(dirs["plots"], f"{name}.stage_times.png"))


_last_run_metrics: dict | None = None


def last_run_metrics() -> dict | None:
    """The document of the last ``run.metrics.json`` this process wrote
    (None before the first), for in-process callers."""
    return None if _last_run_metrics is None else dict(_last_run_metrics)


def _write_run_metrics(run: _Run, pipeline: str) -> None:
    """``<base>/run.metrics.json``: the end-to-end numbers of a run — total
    wall, deflate wall (the run's own thread's time in ``io.deflate``
    spans), how many of the BGZF bytes written were stage-to-stage
    intermediates (0 in streaming mode with taps off), and the run's change
    of every ``utils.profiling.counter_marks`` counter (BGZF bytes written,
    bytes to and from the card, kernel builds, the SSCS vote calls'
    member-positions and output positions, the writers' summed deflate
    time).  The same
    document stays in memory for :func:`last_run_metrics`."""
    global _last_run_metrics
    now = counter_marks()
    base, name, dirs = run.base, run.name, run.dirs
    intermediates = [
        os.path.join(dirs["sscs"], f"{name}.singleton.sorted.bam"),
        os.path.join(dirs["singleton"], f"{name}.sscs.rescue.sorted.bam"),
        os.path.join(dirs["singleton"], f"{name}.singleton.rescue.sorted.bam"),
        os.path.join(dirs["dcs"], f"{name}.sscs.rescued.bam"),
    ]
    payload = {key: now[key] - run.marks[key] for key in now}
    payload.update({
        "pipeline": pipeline,
        "wall_s": round(time.perf_counter() - run.t0, 6),
        "deflate_wall_s": round((bgzf.caller_wall_us() - run.deflate_before) / 1e6, 6),
        "intermediate_bam_bytes": sum(
            os.path.getsize(p) for p in intermediates if os.path.exists(p)),
    })
    with open(os.path.join(base, "run.metrics.json"), "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    _last_run_metrics = payload


# ---------------------------------------------------------------------- serve

def _serve_child_argv(args) -> list[str]:
    """Rebuild the serve subcommand argv for the supervised daemon child —
    the resolved values (flag > config > builtin), minus --supervise."""
    argv = ["serve"]
    for flag in ("socket", "host", "warmup_shapes", "compile_cache",
                 "journal", "device", "node", "result_cache", "warm_from", "policy"):
        value = getattr(args, flag, None)
        if value:
            argv += [f"--{flag}", str(value)]
    for flag in ("port", "queue_bound", "gang_size", "max_batch"):
        argv += [f"--{flag}", str(int(getattr(args, flag)))]
    for flag in ("drain_s", "result_ttl_s", "warmup_budget_s",
                 "class_weights", "slo_targets",
                 "tenant_queue_cap", "tenant_inflight_cap"):
        value = getattr(args, flag, None)
        if value not in (None, ""):
            argv += [f"--{flag}", str(value)]
    return argv


def _parse_class_map(text, what: str) -> dict:
    """Parse ``'interactive=8,batch=3'`` style per-qos-class maps (the
    --class_weights / --slo_targets wire format) into ``{class: float}``;
    empty/None parses to ``{}`` (scheduler defaults apply)."""
    out: dict = {}
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SystemExit(f"{what}: expected 'class=value' pairs, got {part!r}")
        k, v = part.split("=", 1)
        try:
            out[k.strip()] = float(v)
        except ValueError:
            raise SystemExit(f"{what}: {v!r} is not a number") from None
    return out


def serve_cmd(args) -> None:
    """Run the persistent consensus daemon (``serve/``): probe the card,
    build the kernel library and warm the configured buckets once, then
    accept jobs over a unix socket or localhost TCP.  With --journal every
    accepted job is write-ahead journaled and a restart replays unfinished
    work; with --supervise this process runs the restart loop and the
    daemon runs as a child.  The device is the card unless --device cpu
    is given; without a card the command exits before it binds its
    socket.  --result_cache answers jobs already in the cache plane;
    --warm_from joins a fleet hot from its ring view; CCT_CANARY=1 starts
    the golden canary prober."""
    if _bool(args.supervise):
        from consensuscruncher_tpu_torch.serve.supervisor import child_command, run_supervised

        rc = run_supervised(child_command(_serve_child_argv(args)),
                            max_restarts=int(args.max_restarts))
        if rc:
            raise SystemExit(rc)
        return

    from consensuscruncher_tpu_torch.obs import flight as obs_flight
    from consensuscruncher_tpu_torch.obs import history as obs_history
    from consensuscruncher_tpu_torch.obs import trace as obs_trace
    from consensuscruncher_tpu_torch.serve import canary as serve_canary
    from consensuscruncher_tpu_torch.serve import warmup
    from consensuscruncher_tpu_torch.serve.scheduler import Scheduler
    from consensuscruncher_tpu_torch.serve.server import ServeServer, install_signal_handlers
    from consensuscruncher_tpu_torch.utils.backend_probe import ensure_backend

    # the JAX package's [autotune] section picks a kernel per bucket and
    # learns a bucket table to warm; the port has one kernel per bucket and
    # compiles nothing per shape
    autotune = _config_defaults(args.config, "autotune")
    if str(autotune.get("backend") or "").strip():
        raise SystemExit(
            "config [autotune] backend: the port runs every dense bucket on B1's hand "
            "kernel (csrc/consensus_vote.cu); a second backend to choose comes with the "
            "autotuner's measuring half (ROADMAP A11)")
    ignored = sorted(k for k, v in autotune.items() if str(v).strip())
    if ignored:
        print(f"config [autotune] {', '.join(ignored)}: ignored (the port keeps no bucket "
              "table: nothing compiles per shape)", file=sys.stderr)
    device = ensure_backend(args.device)
    # warm join: a late member reads the fleet's warm state off the ring
    # view and builds into (so finds the library in) the fleet's build dir
    warm = warmup.warm_join(args.warm_from) if args.warm_from else {}
    if not args.compile_cache and warm.get("compile_cache"):
        args.compile_cache = str(warm["compile_cache"])
    if args.compile_cache and warmup.setup_compilation_cache(args.compile_cache):
        print(f"serve: kernel build directory at {args.compile_cache}")
    budget = float(args.warmup_budget_s) if args.warmup_budget_s not in (None, "") else None
    # every job votes under its own spec policy (passed to the gang
    # explicitly); --policy only decides which policy is prepared (its
    # checkpoint loaded) before the socket binds: an unknown name fails here
    warm_policy = str(args.policy or DEFAULT_POLICY)
    get_policy(warm_policy).prepare()
    # at least one warm launch: the kernel library is built and loaded
    # before the first request
    shapes = warmup.parse_shapes(args.warmup_shapes) or [warmup.LIBRARY_WARM_SHAPE]
    n = warmup.warm_shapes(shapes, budget_s=budget, device=device)
    print(f"serve: warmed {n}/{len(shapes)} bucket shapes on {device_name(device)}")

    journal = None
    if args.journal:
        from consensuscruncher_tpu_torch.serve.journal import Journal

        journal = Journal(args.journal, max_bytes=int(os.environ.get(
            "CCT_SERVE_JOURNAL_MAX_BYTES", str(1 << 20))))
    drain_s = args.drain_s
    if drain_s in (None, ""):
        drain_s = os.environ.get("CCT_SERVE_DRAIN_S", "30")
    drain_s = float(drain_s)
    result_ttl_s = float(args.result_ttl_s) if args.result_ttl_s not in (None, "") else None

    # flight recorder: dumps land next to the journal (or CCT_TRACE_DIR);
    # installed BEFORE the Scheduler so journal-replay anomalies in its
    # _recover can already dump.  SIGQUIT = post-mortem on demand.
    dump_dir = os.environ.get("CCT_TRACE_DIR") or (
        os.path.dirname(os.path.abspath(journal.path)) if journal else None)
    if dump_dir:
        obs_flight.set_dump_dir(dump_dir)
    obs_flight.install_sigquit()
    if args.node:
        obs_trace.set_identity(args.node)
        obs_flight.set_identity(node=args.node)

    def _cap(name):
        value = getattr(args, name, None)
        return int(value) if value not in (None, "") else None

    scheduler = Scheduler(
        queue_bound=int(args.queue_bound), gang_size=int(args.gang_size),
        device=device.type, max_batch=int(args.max_batch),
        journal=journal, result_ttl_s=result_ttl_s,
        class_weights=_parse_class_map(args.class_weights, "--class_weights"),
        slo_targets=_parse_class_map(args.slo_targets, "--slo_targets"),
        tenant_queue_cap=_cap("tenant_queue_cap"),
        tenant_inflight_cap=_cap("tenant_inflight_cap"),
        node=args.node or None,
        result_cache=args.result_cache or warm.get("result_cache") or None,
    )
    server = ServeServer(scheduler, host=args.host, port=int(args.port),
                         socket_path=args.socket or None)
    install_signal_handlers(server, scheduler, journal)
    # env-armed sidecars: the durable telemetry-history recorder
    # (CCT_HISTORY_DIR) and the golden canary prober (CCT_CANARY=1); neither
    # touches a tenant's outputs
    obs_history.maybe_start(scheduler.history_doc)
    canary_dir = os.environ.get("CCT_CANARY_DIR") or os.path.join(
        dump_dir or tempfile.gettempdir(), f"cct-canary-{os.getpid()}")
    prober = serve_canary.maybe_start(scheduler, canary_dir)
    print(f"serve: listening on {server.describe()} "
          f"(queue_bound={scheduler.queue_bound}, gang_size={scheduler.gang_size}, "
          f"device={device_name(device)}"
          + (f", journal={journal.path}" if journal else "") + ")", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass  # pre-handler window only; handlers replace SIGINT
    # SIGTERM/SIGINT landed (or the listener died): bounded graceful drain
    print(f"serve: draining (up to {drain_s:g}s)", flush=True)
    try:
        scheduler.drain(timeout=drain_s)
    except TimeoutError:
        pending = scheduler.healthz()
        print(f"WARNING: drain timed out after {drain_s:g}s "
              f"({pending['queued']} queued, {pending['running']} running); "
              + ("unfinished jobs stay journaled and replay on restart"
                 if journal else "unfinished jobs are LOST (no --journal)"),
              file=sys.stderr, flush=True)
    server.close()
    if prober is not None:
        prober.stop()
    obs_history.stop()  # final interval stamp lands before shutdown
    scheduler.shutdown()
    if journal is not None:
        journal.close()
    print("serve: shutdown complete", flush=True)


def submit_cmd(args) -> None:
    """Submit one consensus job to a running daemon and (by default) block
    for its result — the thin client leg of ``serve/``.  A quarantined
    verdict (the key exhausted its retry budget) exits non-zero with the
    reason; it is an operator decision, not a retry candidate."""
    from consensuscruncher_tpu_torch.serve.client import JobQuarantined, ServeClient

    address = args.socket or (args.host, int(args.port))
    client = ServeClient(address)
    spec = {
        "input": os.path.abspath(args.input),
        "output": os.path.abspath(args.output),
        "name": args.name,
        "cutoff": args.cutoff,
        "qualscore": args.qualscore,
        "scorrect": args.scorrect,
        "max_mismatch": args.max_mismatch,
        "bdelim": args.bdelim,
        "compress_level": args.compress_level,
    }
    if args.deadline_s not in (None, ""):
        spec["deadline_s"] = float(args.deadline_s)
    # tenant/qos enter the spec only when set: a default submit keeps the
    # exact pre-tenancy spec (and idempotency key)
    if args.tenant not in (None, ""):
        spec["tenant"] = str(args.tenant)
    if args.qos not in (None, ""):
        spec["qos"] = str(args.qos)
    # policy enters the spec only when set AND non-default (absent ==
    # majority everywhere on the serve plane)
    if args.policy not in (None, "", "majority"):
        spec["policy"] = str(args.policy)
    try:
        sub = client.submit_full(spec)
    except JobQuarantined as e:
        raise SystemExit(f"submit: quarantined ({e.reason}); key {e.key or '<key>'}")
    job_id = sub["job_id"]
    print(f"submit: job {job_id} queued on {address} (key {sub['key']}"
          + (", duplicate of an existing job" if sub.get("duplicate") else "")
          + ")", flush=True)
    if not _bool(args.wait):
        return
    # poll by idempotency key: survives a daemon restart mid-wait
    try:
        job = client.result(key=sub["key"])
    except JobQuarantined as e:
        raise SystemExit(f"submit: job {job_id} quarantined ({e.reason}); key {sub['key']}")
    if job["state"] != "done":
        raise SystemExit(f"submit: job {job_id} {job['state']}: {job.get('error')}")
    base = (job.get("outputs") or {}).get("base")
    print(f"submit: job {job_id} done in {job['wall_s']}s"
          + (f" — outputs under {base}" if base else ""), flush=True)


def _spawn_fleet(args, children: dict, build_dir: str) -> list:
    """``route --spawn N``: launch N worker daemons under ``--workdir``
    (per-worker socket and journal), each kept alive by the
    :mod:`serve.supervisor` restart policy in its own thread.  Every
    worker builds into (so finds the library in) ``build_dir``, which the
    caller has built once; on the card worker *i* sees card *i mod count*.
    ``children`` collects the live Popen per member name so the router's
    shutdown can SIGTERM them into a clean drain (rc 0 stops the
    supervisor loop too).  Returns ``[(name, socket_path), ...]``."""
    import threading

    from consensuscruncher_tpu_torch.serve.supervisor import child_command, run_supervised

    n = int(args.spawn)
    workdir = os.path.abspath(args.workdir or "fleet")
    os.makedirs(workdir, exist_ok=True)
    n_cards = 0
    if args.device == "cuda":
        import torch

        n_cards = torch.cuda.device_count()  # opens no context
    members = []
    for i in range(n):
        name = f"w{i}"
        sock = os.path.join(workdir, f"{name}.sock")
        if os.path.exists(sock):
            os.unlink(sock)  # stale socket from a previous fleet
        serve_argv = [
            "serve", "--socket", sock, "--node", name,
            "--journal", os.path.join(workdir, f"{name}.journal"),
            "--compile_cache", build_dir,
            "--gang_size", str(int(args.gang_size)),
            "--queue_bound", str(int(args.queue_bound)),
            "--max_batch", str(int(args.max_batch)),
            "--device", args.device,
        ]
        for flag in ("warmup_shapes", "class_weights", "slo_targets",
                     "drain_s", "result_cache"):
            value = getattr(args, flag, None)
            if value not in (None, ""):
                serve_argv += [f"--{flag}", str(value)]
        cmd = child_command(serve_argv)
        env = hostshard.worker_env(dict(os.environ), i, args.device, n_cards)

        def _spawn(argv, _name=name, _env=env):
            child = subprocess.Popen(argv, env=_env)
            children[_name] = child
            return child

        threading.Thread(
            target=run_supervised, args=(cmd,),
            kwargs={"spawn": _spawn, "max_restarts": int(args.max_restarts)},
            name=f"fleet-{name}", daemon=True).start()
        members.append((name, sock))
    # ready gate: a worker's socket appears only once it is accepting
    deadline = time.monotonic() + float(os.environ.get("CCT_ROUTE_SPAWN_WAIT_S", "180"))
    for name, sock in members:
        while not os.path.exists(sock):
            if time.monotonic() > deadline:
                raise SystemExit(f"route: worker {name} never came up ({sock} missing)")
            time.sleep(0.2)
        print(f"route: member {name} up at {sock}", flush=True)
    return members


def _parse_journals(text: str) -> dict:
    """``'w0=/path/w0.journal,w1=/path/w1.journal'`` -> ``{name: path}``
    for the router's journal-adoption map."""
    out: dict = {}
    for part in str(text or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SystemExit(f"route: --journals entry {part!r} is not 'name=path'")
        name, path = part.split("=", 1)
        out[name.strip()] = os.path.abspath(path.strip())
    return out


def _route_adopt(args) -> None:
    """``route --adopt NODE``: client mode — ask the running router (at
    --socket / --host:--port) to adopt a dead member's journal now,
    instead of waiting out ``adopt_after_s``."""
    from consensuscruncher_tpu_torch.serve.client import ServeClient

    address = args.socket or (args.host, int(args.port))
    reply = ServeClient(address).request(
        {"op": "adopt", "node": str(args.adopt), "force": _bool(args.adopt_force)},
        timeout=600.0)
    print(f"route: adopted {reply.get('node')} — "
          f"{reply.get('jobs_adopted', 0)} jobs resubmitted "
          f"({', '.join(reply.get('keys') or []) or 'none pending'})")


def _route_release(args) -> None:
    """``route --release KEY``: client mode — lift a poison-job quarantine.
    The router resets the key's fleet attempt lineage and fans the release
    out to every up member (the quarantine marker may live on any node the
    job was failed over to); the journaled ``released`` marker makes the
    lift durable across worker restarts."""
    from consensuscruncher_tpu_torch.serve.client import ServeClient

    address = args.socket or (args.host, int(args.port))
    reply = ServeClient(address).request(
        {"op": "release", "key": str(args.release)}, timeout=60.0)
    if reply.get("released"):
        print(f"route: released {reply.get('key')} on {reply.get('node')} — "
              "next submit retries with a fresh fleet attempt budget")
    else:
        raise SystemExit(f"route: key {args.release} is not quarantined on any up member")


def route_cmd(args) -> None:
    """Run the fleet router (``serve/router.py``): a stateless front door
    consistent-hashing submits by idempotency key onto N worker daemons,
    with replay-aware failover and bounded cross-node work stealing.
    ``--members`` points at externally managed daemons; ``--spawn N``
    brings up a local fleet under the supervisor restart policy, the
    workers on the card unless --device cpu (without a card the command
    exits before it spawns).

    The router itself opens no CUDA context.  A spawned fleet shares one
    kernel build directory (``--compile_cache``, else ``<workdir>/build``):
    on the card this process builds the library there once, with ``nvcc``
    and no context, before any worker starts, and publishes the directory
    as the warm-join ``compile_cache``.

    HA: ``--ring_view PATH`` (shared, fsync'd epoch document) plus a
    second ``route --standby True`` process against the same path gives
    an active/standby pair — the standby health-probes the active and
    takes over by bumping the epoch; workers fence the stale router.
    ``--adopt_after_s`` arms journal adoption of permanently lost
    members; ``--adopt NODE`` triggers it by hand."""
    from consensuscruncher_tpu_torch.obs import flight as obs_flight
    from consensuscruncher_tpu_torch.obs import history as obs_history
    from consensuscruncher_tpu_torch.obs import trace as obs_trace
    from consensuscruncher_tpu_torch.serve.router import Router, RouterServer, parse_members
    from consensuscruncher_tpu_torch.serve.server import install_signal_handlers

    if args.adopt:
        _route_adopt(args)
        return
    if args.release:
        _route_release(args)
        return

    children: dict = {}
    journals = _parse_journals(args.journals)
    build_dir = os.path.abspath(args.compile_cache) if args.compile_cache else None
    if int(args.spawn or 0) > 0:
        workdir = os.path.abspath(args.workdir or "fleet")
        build_dir = build_dir or os.path.join(workdir, "build")
        if resolve_device(args.device).type == "cuda":  # checks; opens no context
            from consensuscruncher_tpu_torch.ops import cuda_lib

            cuda_lib.set_build_dir(build_dir)
            print(f"route: kernel library at {cuda_lib.build('consensus_vote')}", flush=True)
        members = _spawn_fleet(args, children, build_dir)
        # spawned workers journal under --workdir by construction: the
        # adoption map needs no extra flags for the common case
        for name, _ in members:
            journals.setdefault(name, os.path.join(workdir, f"{name}.journal"))
    elif args.members:
        members = parse_members(args.members)
    else:
        raise SystemExit("route: pass --members 'n0=sock,...' for an existing fleet, "
                         "or --spawn N to launch one")
    adopt_after_s = None if args.adopt_after_s in (None, "") else float(args.adopt_after_s)
    # content-addressed cache plane + the warm-join state published in
    # every ring-view epoch record (what `serve --warm_from` reads)
    result_cache = os.path.abspath(args.result_cache) if args.result_cache else None
    cache_journal = args.cache_journal or None
    if not cache_journal and result_cache:
        cache_journal = os.path.join(result_cache, "cache_answers.journal")
    router = Router(
        members,
        vnodes=int(args.vnodes),
        steal_threshold=int(args.steal_threshold),
        steal_margin=int(args.steal_margin),
        health_interval_s=float(args.health_interval_s),
        down_after=int(args.down_after),
        router_id=str(args.router_id or "r0"),
        ring_view=args.ring_view or None,
        standby=_bool(args.standby),
        takeover_after=int(args.takeover_after or 3),
        adopt_after_s=adopt_after_s,
        journals=journals or None,
        result_cache=result_cache,
        cache_journal=cache_journal,
        warm_state={"compile_cache": build_dir, "result_cache": result_cache},
        start_monitor=False,  # started below, once the advertise
    )                         # address is known
    obs_trace.set_identity(router.router_id)
    obs_flight.set_identity(node=router.router_id, epoch=router.epoch)
    if os.environ.get("CCT_TRACE_DIR"):
        obs_flight.set_dump_dir(os.environ["CCT_TRACE_DIR"])
    server = RouterServer(router, host=args.host, port=int(args.port),
                          socket_path=args.socket or None)
    advertise = args.advertise or None
    if advertise and ":" in advertise and os.sep not in advertise:
        host, port = advertise.rsplit(":", 1)
        advertise = (host, int(port))
    router.start(advertise=advertise or server.address)
    install_signal_handlers(server, router, None)

    # router-side telemetry history: the recorder the worker daemons run,
    # stamping the router's own cumulative counters plus a fleet-up gauge
    def _router_history_doc():
        health = router.healthz()
        return {"cum": router.counters.snapshot(),
                "gauges": {"fleet_up": (health.get("fleet") or {}).get("up", 0)}}

    obs_history.maybe_start(_router_history_doc)
    print(f"route: fleet front door on {server.describe()} over {len(members)} members "
          f"({', '.join(name for name, _ in members)}); "
          f"steal_threshold={router.steal_threshold}, steal_margin={router.steal_margin}"
          + (f"; ha={'standby' if router.standby else 'active'} "
             f"epoch={router.epoch} ring_view={args.ring_view}"
             if router.ring_view is not None else ""), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    drain_s = args.drain_s
    if drain_s in (None, ""):
        drain_s = os.environ.get("CCT_SERVE_DRAIN_S", "30")
    drain_s = float(drain_s)
    if children:
        # our own fleet: SIGTERM each worker into its bounded drain (the
        # supervisor sees rc 0 and stops restarting); external members
        # (--members) are left serving — drain them via the drain op.
        print(f"route: draining {len(children)} spawned workers (up to {drain_s:g}s)",
              flush=True)
        for child in children.values():
            if child.poll() is None:
                try:
                    child.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + drain_s + 10.0
        for name, child in children.items():
            while child.poll() is None and time.monotonic() < deadline:
                time.sleep(0.2)
            if child.poll() is None:
                print(f"WARNING: route: worker {name} ignored SIGTERM; killing (its "
                      "journal replays on next start)", file=sys.stderr, flush=True)
                child.kill()
    server.close()
    obs_history.stop()  # final interval stamp lands before shutdown
    router.close()
    print("route: shutdown complete", flush=True)


def cache_cmd(args) -> None:
    """``cache scrub``: offline integrity sweep of the result-cache plane.
    Every committed entry's payload is re-hashed against the sha256
    pinned in its ``entry.json`` at insert; a mismatch means the bytes on
    disk are no longer the bytes the job produced — the entry is
    quarantined (moved out of the shard tree, never served again) and
    reported.  Exits 1 when any corruption was found so cron/CI wiring
    notices."""
    from consensuscruncher_tpu_torch.serve.result_cache import ResultCache

    root = str(args.result_cache or "")
    if not root or not os.path.isdir(root):
        raise SystemExit(f"cache: result-cache root {root!r} is not a directory "
                         "(pass --result_cache)")
    report = ResultCache(root).scrub()
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
    print(f"cache scrub: {report['entries']} entries — {report['intact']} intact, "
          f"{report['legacy']} legacy (no pinned digest), {report['corrupt']} corrupt")
    for q in report["quarantined"]:
        where = f" -> {q['moved_to']}" if q.get("moved_to") else ""
        print(f"  quarantined {q['shard']}/{q['digest']}: {q['error']}{where}")
    raise SystemExit(1 if report["corrupt"] else 0)


def _fleet_replies(args, op: str, label: str, verb: str = "merging") -> list:
    """The ``op`` wire op's per-process docs, pulled fleet-wide through the
    router (or a lone daemon) at ``--socket`` or ``--host``/``--port``.  If
    the wire cannot be reached: a warning, and none (the shards on disk
    remain)."""
    from consensuscruncher_tpu_torch.serve.client import ServeClient

    address = args.socket or (args.host, int(args.port))
    try:
        reply = ServeClient(address).request({"op": op, "fleet": True}, timeout=60.0)[op]
    except Exception as e:
        print(f"WARNING: {label}: wire collection failed ({e}); {verb} on-disk shards only",
              file=sys.stderr, flush=True)
        return []
    if isinstance(reply, dict):  # a lone daemon answered directly
        return [reply]
    return reply or []


def _trace_shards(args) -> list:
    """The event list of each ``trace-*.ndjson`` shard under ``--dir`` (else
    ``$CCT_TRACE_DIR``)."""
    from consensuscruncher_tpu_torch.obs import trace as obs_trace

    trace_dir = args.trace_dir or os.environ.get("CCT_TRACE_DIR")
    if not (trace_dir and os.path.isdir(trace_dir)):
        return []
    return [obs_trace._read_shard(shard)
            for shard in sorted(glob.glob(os.path.join(trace_dir, "trace-*.ndjson")))]


def trace_cmd(args) -> None:
    """``trace export``: merge the per-process ``trace-*.ndjson`` shards a
    CCT_TRACE=1 run left under --dir into one Chrome-trace JSON (open it in
    Perfetto / chrome://tracing).

    ``trace fleet``: pull every live process's span buffer through the
    router's ``trace`` wire op (router + each up member), union it with
    any on-disk shards under --dir (dead processes' flushed spans), and
    merge the lot into ONE Chrome-trace timeline — per-node process
    lanes, ``follows_from`` flow arrows across the kill/steal/adoption
    hops."""
    from consensuscruncher_tpu_torch.obs import trace as obs_trace

    if args.action == "export":
        trace_dir = args.trace_dir or os.environ.get("CCT_TRACE_DIR")
        if not trace_dir:
            raise SystemExit(
                "trace export: no trace directory — pass --dir or set "
                "CCT_TRACE_DIR to where the traced run wrote its shards")
        n = obs_trace.export_chrome_trace(trace_dir, args.out)
        print(f"trace: exported {n} events from {trace_dir} -> {args.out}")
        return
    groups: list[list[dict]] = []
    for buf in _fleet_replies(args, "trace", "trace fleet"):
        events = (buf or {}).get("events") or []
        node = (buf or {}).get("node")
        if node:
            for ev in events:
                ev.setdefault("node", node)
        groups.append(events)
    groups += _trace_shards(args)
    if not any(groups):
        raise SystemExit(
            "trace fleet: nothing collected — is the router up "
            "(--socket/--host/--port) or --dir pointing at a "
            "CCT_TRACE_DIR with shards?")
    n = obs_trace.merge_fleet_trace(groups, args.out)
    print(f"trace: merged {n} fleet events ({len(groups)} buffer(s)) -> {args.out}")


def top_cmd(args) -> None:
    """``top``: live terminal observatory over a router (or lone
    daemon) — per-node queue depth, QoS latency percentiles and burn
    rates, steal/resubmit/adoption/fence counters, router epoch."""
    from consensuscruncher_tpu_torch.obs import top as obs_top

    address = args.socket or (args.host, int(args.port))
    raise SystemExit(obs_top.run_top(address, interval_s=float(args.interval_s),
                                     once=_bool(args.once)))


def _qc_docs_from_paths(paths) -> list:
    """Resolve ``qc`` path operands into ``(label, doc)`` pairs.
    A file operand is a qc.json; a directory is scanned recursively for
    ``qc.json`` docs (a run tree, a fleet output root, a host-shard
    ``.ranges`` tree)."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            found = sorted(glob.glob(os.path.join(p, "**", "qc.json"), recursive=True))
            if not found:
                print(f"WARNING: qc: no qc.json under {p}", file=sys.stderr, flush=True)
            for f in found:
                doc = obs_qc.read_qc(f)
                out.append((doc.get("run") or os.path.basename(os.path.dirname(f)) or f, doc))
        elif os.path.exists(p):
            doc = obs_qc.read_qc(p)
            out.append((doc.get("run") or p, doc))
        else:
            print(f"WARNING: qc: {p} does not exist; skipped", file=sys.stderr, flush=True)
    return out


def qc_cmd(args) -> None:
    """``qc report``: per-run consensus-quality tables (+ a merged ALL
    row and family-size spectrum) over one or many qc.json docs — run
    trees, fleet shards, host-shard ranges.  ``qc diff``: rate deltas
    and spectrum drift between two runs (each side may itself be a
    directory of shards, merged first)."""
    if args.action == "report":
        docs = _qc_docs_from_paths(args.paths)
        if not docs:
            raise SystemExit("qc report: no qc.json docs found")
        print(obs_qc.render_report(docs))
        if args.json:
            obs_qc.write_qc(args.json, obs_qc.merge_docs([d for _l, d in docs]))
        return
    # diff: exactly two sides, each merged from whatever it resolves to
    if len(args.paths) != 2:
        raise SystemExit("qc diff: need exactly two paths (run dirs or qc.json files)")
    sides = []
    for p in args.paths:
        docs = _qc_docs_from_paths([p])
        if not docs:
            raise SystemExit(f"qc diff: no qc.json docs under {p}")
        sides.append(obs_qc.merge_docs([d for _l, d in docs]))
    label_a = sides[0].get("run") or "A"
    label_b = sides[1].get("run") or "B"
    print(obs_qc.render_diff(sides[0], sides[1], label_a=label_a[:12], label_b=label_b[:12]))
    if args.json:
        obs_qc.write_qc(args.json, {
            "a": sides[0], "b": sides[1],
            "spectrum_tv": obs_qc.spectrum_distance(sides[0].get("spectrum") or {},
                                                    sides[1].get("spectrum") or {})})


def prof_cmd(args) -> None:
    """``prof report``: merge every live process's profile (router's
    ``prof`` wire op, fleet-wide) with any on-disk ``prof-*.ndjson``
    shards under --dir (dead processes' flushed samples) into per-node
    hottest-function tables and the wall-attribution report splitting
    each node's wall into {queue, routing, host compute, device
    dispatch, deflate, io}.

    ``prof flame``: same merge, written as standard collapsed-stack
    lines (``frame;frame count``) for any flamegraph renderer."""
    from consensuscruncher_tpu_torch.obs import prof as obs_prof

    docs = [d for d in _fleet_replies(args, "prof", "prof") if isinstance(d, dict)]
    prof_dir = args.prof_dir or os.environ.get("CCT_PROF_DIR")
    if prof_dir and os.path.isdir(prof_dir):
        for shard in sorted(glob.glob(os.path.join(prof_dir, "prof-*.ndjson"))):
            docs.append({"lines": obs_prof.read_shard(shard)})
    merged = obs_prof.merge_profiles(docs)
    if not merged["samples"] and not merged["by_node"]:
        raise SystemExit(
            "prof: nothing collected — is the router up "
            "(--socket/--host/--port) or --dir pointing at a "
            "CCT_PROF_DIR with prof-*.ndjson shards?")
    if args.action == "flame":
        out = args.out or "prof.collapsed"
        with open(out, "w", encoding="utf-8") as fh:
            fh.write("\n".join(obs_prof.collapsed_lines(merged["samples"])) + "\n")
        print(f"prof: wrote {len(merged['samples'])} collapsed stacks "
              f"({sum(merged['samples'].values())} samples) -> {out}")
        return
    sys.stdout.write(obs_prof.render_report(merged, top_n=int(args.top)))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(obs_prof.attribution_doc(merged), fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"prof: attribution -> {args.json}")


def critpath_cmd(args) -> None:
    """``critpath report``: decompose every finished job's wall into its
    ordered causal segment chain (admit -> journal-ack -> queue ->
    gang-form -> handoff -> run) from the fleet's ``serve.critpath``
    trace events — live buffers through the router's ``trace`` wire op,
    unioned with on-disk ``trace-*.ndjson`` shards — and render the
    fleet-level "where does p99 queue time actually go" table plus the
    queue-antagonist attribution (which lock / dispatcher-busy window /
    admission idle made jobs wait).

    ``critpath job KEY``: one job's chain (key or numeric id)."""
    from consensuscruncher_tpu_torch.obs import critpath as obs_critpath

    events: list[dict] = []
    for buf in _fleet_replies(args, "trace", "critpath", verb="reading"):
        node = (buf or {}).get("node")
        for ev in (buf or {}).get("events") or []:
            if node and isinstance(ev, dict):
                ev.setdefault("node", node)
            events.append(ev)
    for shard in _trace_shards(args):
        events.extend(shard)
    doc = obs_critpath.report_doc(events)
    if not doc["jobs"]:
        raise SystemExit(
            "critpath: no serve.critpath events collected — is the "
            "fleet up with CCT_TRACE=1 (or --dir pointing at its "
            "CCT_TRACE_DIR shards)?")
    if args.action == "job":
        key = str(args.key or "")
        if not key:
            raise SystemExit("critpath job: pass the job KEY (or id)")
        hits = [j for j in doc["jobs"] if str(j.get("key")) == key or str(j.get("job_id")) == key]
        if not hits:
            raise SystemExit(f"critpath: no finished job with key/id {key!r}")
        for job in hits:
            sys.stdout.write(obs_critpath.render_job(job))
        return
    if args.json:
        payload = obs_critpath.to_json(doc)
        if args.json == "-":
            sys.stdout.write(payload)
            return
        with open(args.json, "w", encoding="utf-8") as fh:
            fh.write(payload)
        print(f"critpath: report doc -> {args.json}")
    sys.stdout.write(obs_critpath.render_report(doc))


def history_cmd(args) -> None:
    """``history query``: merged durable telemetry-history lines (live
    processes through the router's ``history`` wire op, unioned with
    on-disk ``history-*.ndjson`` shards, deduped by (pid, seq)) printed
    as NDJSON, optionally filtered by --metric/--node/--last.

    ``history trend``: per-interval delta + rate table for one metric."""
    from consensuscruncher_tpu_torch.obs import history as obs_history

    docs = [d for d in _fleet_replies(args, "history", "history") if isinstance(d, dict)]
    hist_dir = args.history_dir or os.environ.get("CCT_HISTORY_DIR")
    if hist_dir and os.path.isdir(hist_dir):
        docs.append({"lines": obs_history.read_dir(hist_dir)})
    lines = obs_history.merge_history(docs)
    if not lines:
        raise SystemExit(
            "history: nothing collected — is the fleet up with "
            "CCT_HISTORY_DIR set (or --dir pointing at its "
            "history-*.ndjson shards)?")
    metric = args.metric or None
    if args.action == "trend":
        if not metric:
            raise SystemExit("history trend: pass --metric NAME")
        sys.stdout.write(obs_history.render_trend(obs_history.trend(lines, metric), metric))
        return
    last = int(args.last) if args.last not in (None, "") else None
    for ln in obs_history.query(lines, metric=metric, node=args.node or None, last=last):
        sys.stdout.write(json.dumps(ln, sort_keys=True) + "\n")


def build_parser() -> argparse.ArgumentParser:
    # Every value-bearing flag defaults to None so the precedence is the
    # JAX package's: CLI flag > config.ini value > built-in default
    # (applied in parse_args; argparse defaults would mask the config).
    p = argparse.ArgumentParser(prog="consensuscruncher_tpu_torch",
                                description="PyTorch/CUDA port of ConsensusCruncher")
    p.add_argument("--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="command", required=True)
    f = sub.add_parser("fastq2bam", help="extract UMIs and align FASTQ pairs")
    f.add_argument("-c", "--config", default=None,
                   help="config.ini whose [fastq2bam] section gives defaults (flags win)")
    f.add_argument("--fastq1", "-f1")
    f.add_argument("--fastq2", "-f2")
    f.add_argument("--output", "-o")
    f.add_argument("--name", "-n")
    f.add_argument("--bwa", "-b", help="aligner executable (invoked as '<bwa> mem ref r1 r2'), "
                                       "or 'builtin' for the in-process aligner")
    f.add_argument("--ref", "-r", help="reference genome fasta (passed to the aligner)")
    f.add_argument("--bpattern", "-p")
    f.add_argument("--blist", "-l")
    f.add_argument("--bdelim")
    f.add_argument("--cleanup", help="remove intermediate tag FASTQs after alignment")
    f.add_argument("--resume", help="skip stages whose manifest-recorded "
                                    "outputs are intact")
    f.add_argument("--compress_level", type=int, choices=range(0, 10),
                   metavar="0-9",
                   help="BGZF deflate level for outputs (default 6); tag "
                        "FASTQs are written stored (level 0) under "
                        "--cleanup since they are deleted after alignment")
    f.add_argument("--host_workers", type=int, metavar="N",
                   help="fan the builtin aligner's per-chunk compute over N "
                        "forked worker processes (byte-identical output; 0 = "
                        "all cores; ignored for an external --bwa — use its "
                        "own -t)")
    f.set_defaults(func=fastq2bam, config_section="fastq2bam",
                   required_args=("fastq1", "fastq2", "output", "ref"),
                   builtin_defaults={"bwa": "bwa", "bdelim": DEFAULT_BDELIM,
                                     "cleanup": "False", "host_workers": 1,
                                     "compress_level": 6, "resume": "False"})
    c = sub.add_parser("consensus", help="collapse UMI families into SSCS/DCS")
    c.add_argument("-c", "--config", default=None,
                   help="config.ini whose [consensus] section gives defaults "
                        "(flags win) and whose [obs]/[qc]/[io] sections fold into "
                        "their environment variables (a variable already set wins)")
    c.add_argument("--input", "-i",
                   help="coordinate-sorted barcoded BAM; comma-separate several "
                        "to run a sample batch (each sample under its own "
                        "<output>/<stem>/ tree)")
    c.add_argument("--output", "-o")
    c.add_argument("--name", "-n")
    c.add_argument("--cutoff", type=float)
    c.add_argument("--qualscore", "-q", type=int)
    c.add_argument("--scorrect", help="singleton correction on/off")
    c.add_argument("--max_mismatch", type=int,
                   help="barcode Hamming tolerance for singleton rescue (default "
                        "0: exact complementary match; > 0 runs the object walk "
                        "with the Hamming matcher, on the staged pipeline)")
    c.add_argument("--bdelim")
    c.add_argument("--cleanup", help="remove intermediate BAMs")
    c.add_argument("--resume",
                   help="skip stages whose manifest-recorded inputs, outputs and "
                        "params are intact (default False)")
    c.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run into DIR "
                        "(consensus.<pid>.trace.json; the card's kernels and "
                        "copies too when the run drives it)")
    c.add_argument("--devices", type=int, default=None, metavar="N",
                   help="shard the device votes across N shards (family-data-"
                        "parallel mesh over the packed stream wire; DCS pair "
                        "axis sharded too), laid over the visible cards in "
                        "turn; with --device cpu, N CPU shards. Default: 1")
    c.add_argument("--compress_level", type=int, choices=range(0, 10),
                   metavar="0-9", help="BGZF deflate level of output BAMs (default 6)")
    c.add_argument("--host_workers", type=int, metavar="N",
                   help="coordinate-range data parallelism (0 = all cores): N "
                        "worker processes each run the full pipeline on a "
                        "disjoint BAI range of the input, on the card sharing "
                        "the visible CUDA cards; outputs merge by "
                        "concatenation. Default 1")
    c.add_argument("--intermediate_level", type=int, choices=range(0, 10), default=None,
                   metavar="0-9",
                   help="BGZF deflate level of the per-stage BAMs (sscs/singleton, "
                        "rescue BAMs, dcs parts, badReads); default: follow "
                        "--compress_level")
    c.add_argument("--input_range", default=None, help=argparse.SUPPRESS)
    c.add_argument("--pipeline", choices=("staged", "streaming"),
                   help="'staged' (default): each stage writes its BAM, the next "
                        "re-reads it. 'streaming': stages hand sorted record batches "
                        "over in memory, intermediate BAMs are skipped (see "
                        "--intermediate_taps), finals are byte-identical; --resume "
                        "and host-worker runs take the staged path, and a run whose "
                        "sort buffer spills or whose background write fails re-runs "
                        "staged")
    c.add_argument("--intermediate_taps",
                   help="with --pipeline streaming: also write the stage-to-stage "
                        "BAMs, reproducing the staged output tree (default False)")
    c.add_argument("--device", choices=("cuda", "cpu"),
                   help="where the votes run (default cuda; cpu runs the "
                        "kernels' plain PyTorch versions); wins over --backend "
                        "and a config.ini 'backend' key")
    c.add_argument("--backend", choices=("cpu", "tpu", "xla_cpu", "reference"),
                   help="the JAX package's flag: tpu and xla_cpu read as the device "
                        "(cuda, cpu); cpu (the numpy twin) and reference (the "
                        "object path: per-read decode, dict grouping, the Counter "
                        "vote) run on the host alone and touch no device. --device, "
                        "or a config.ini 'device' key, wins")
    c.add_argument("--wire", choices=("stream", "dense"), default="stream",
                   help="SSCS vote layout: 'stream' (packed member stream, the "
                        "default) or 'dense' (padded (B, F, L) family batches). "
                        "Byte-identical outputs; residency needs 'stream'")
    c.add_argument("--policy",
                   help="consensus vote policy of the SSCS family vote: 'majority' "
                        "(the reference rational-cutoff vote, the default), "
                        "'delegation' (members below Phred 20 hand their vote "
                        "weight to the family's high-quality members) or "
                        "'distilled' (the small frozen MLP head of "
                        "policies/checkpoints/distilled_v1.json). Host workers "
                        "vote majority, as in the JAX package")
    c.add_argument("--residency",
                   help="keep SSCS consensus planes on the device so rescue and "
                        "DCS vote by gather instead of uploading them again "
                        "(default True). Byte-identical outputs; 'False' "
                        "uploads every duplex vote")
    c.add_argument("--result_cache",
                   help="content-addressed result cache root (the serve plane's "
                        "--result_cache dir). With --host_workers, the range planner "
                        "consults it before launching workers: a range whose exact "
                        "sub-spec is cached negative (known-empty) is materialized "
                        "from the cache instead of decoded")
    c.set_defaults(func=consensus, config_section="consensus",
                   required_args=("input", "output"),
                   builtin_defaults={
                       "cutoff": 0.7, "qualscore": 0, "scorrect": "True",
                       "max_mismatch": 0, "device": "cuda", "bdelim": DEFAULT_BDELIM,
                       "cleanup": "False", "resume": "False", "compress_level": 6,
                       "host_workers": 1, "residency": "True", "pipeline": "staged",
                       "intermediate_taps": "False", "policy": DEFAULT_POLICY,
                       "result_cache": "",
                   })

    s = sub.add_parser(
        "serve",
        help="run the persistent consensus daemon (warm kernels, cross-request "
             "continuous batching)")
    s.add_argument("-c", "--config", default=None)
    s.add_argument("--socket", help="unix socket path (overrides host/port)")
    s.add_argument("--host", help="TCP bind host (default 127.0.0.1)")
    s.add_argument("--port", type=int, help="TCP port (default 7733; 0 = any free)")
    s.add_argument("--queue_bound", type=int,
                   help="max queued jobs before submit is refused (default 16)")
    s.add_argument("--gang_size", type=int,
                   help="max compatible jobs batched into one device dispatch "
                        "round (default 4)")
    s.add_argument("--max_batch", type=int,
                   help="families per device bucket dispatch (default 1024)")
    s.add_argument("--device", choices=("cuda", "cpu"),
                   help="where served jobs vote (default cuda: the card; without "
                        "one the daemon exits before it binds its socket). cpu "
                        "runs the kernels' plain PyTorch versions")
    s.add_argument("--backend",
                   help="the JAX package's flag, read as the device: tpu -> cuda, "
                        "xla_cpu -> cpu (cpu and reference exit naming --device)")
    s.add_argument("--warmup_shapes",
                   help="comma-separated BxFxL vote buckets to launch once at "
                        "startup (e.g. '64x4x128,64x8x128'; the first builds the "
                        "kernel library); empty = one launch at a small shape")
    s.add_argument("--compile_cache",
                   help="kernel build directory (the port's persistent compile "
                        "cache; survives daemon restarts and checkouts); empty = "
                        "the package's _build/")
    s.add_argument("--journal",
                   help="write-ahead job journal path: accepted jobs are fsync'd "
                        "before the submit reply and replayed on restart "
                        "(crash-safe, exactly-once outputs); empty = in-memory only")
    s.add_argument("--drain_s",
                   help="bounded graceful-shutdown window on SIGTERM/SIGINT "
                        "(default $CCT_SERVE_DRAIN_S or 30); unfinished jobs stay "
                        "journaled for replay")
    s.add_argument("--result_ttl_s",
                   help="evict done/failed job records from memory after this many "
                        "seconds (default $CCT_SERVE_RESULT_TTL_S or 600); outputs "
                        "stay on disk")
    s.add_argument("--warmup_budget_s",
                   help="cap the total warmup wall so a supervised restart serves "
                        "again quickly; empty = no cap")
    s.add_argument("--supervise",
                   help="run the daemon as a supervised child restarted with capped "
                        "backoff on crash (default False)")
    s.add_argument("--max_restarts", type=int,
                   help="supervised-restart budget before giving up (default 10)")
    s.add_argument("--class_weights",
                   help="weighted-fair dispatch shares per qos class as "
                        "'class=weight' pairs (e.g. 'interactive=8,batch=3,"
                        "scavenger=1' — the default)")
    s.add_argument("--slo_targets",
                   help="per-class latency SLO targets in seconds as "
                        "'class=seconds' pairs (e.g. 'interactive=30'); jobs "
                        "without --deadline_s inherit their class target for "
                        "shedding; empty = no targets")
    s.add_argument("--tenant_queue_cap", type=int,
                   help="max queue slots one tenant may hold; empty = unlimited")
    s.add_argument("--tenant_inflight_cap", type=int,
                   help="max queued+running jobs one tenant may hold; empty = "
                        "unlimited")
    s.add_argument("--node",
                   help="fleet member name this daemon serves as (surfaced in "
                        "healthz/metrics); empty = standalone")
    s.add_argument("--result_cache",
                   help="root of the fleet content-addressed result-cache plane: "
                        "finished jobs are committed by content digest and identical "
                        "jobs (any tenant) are answered byte-identically without "
                        "recomputing; empty = caching off")
    s.add_argument("--warm_from",
                   help="ring-view document path to warm-join from: adopt the "
                        "fleet's kernel build directory and result-cache plane "
                        "published in the epoch record, so this member joins hot "
                        "(no kernel build); empty = cold")
    s.add_argument("--policy",
                   help="consensus vote policy prepared at startup (default "
                        "'majority'; an unknown name fails before the socket "
                        "binds). Jobs always vote under their own spec policy")
    s.set_defaults(func=serve_cmd, config_section="serve", required_args=(),
                   builtin_defaults={
                       "socket": "", "host": "127.0.0.1", "port": 7733,
                       "queue_bound": 16, "gang_size": 4, "max_batch": 1024,
                       "device": "cuda", "warmup_shapes": "", "compile_cache": "",
                       "journal": "", "drain_s": "", "result_ttl_s": "",
                       "warmup_budget_s": "", "supervise": "False", "max_restarts": 10,
                       "class_weights": "", "slo_targets": "",
                       "tenant_queue_cap": "", "tenant_inflight_cap": "", "node": "",
                       "result_cache": "", "warm_from": "", "policy": DEFAULT_POLICY,
                   })

    r = sub.add_parser(
        "route",
        help="run the fleet router: consistent-hash submits onto N worker daemons "
             "with replay-aware failover + work stealing")
    r.add_argument("-c", "--config", default=None)
    r.add_argument("--members",
                   help="comma-separated fleet members as 'name=address' (unix socket "
                        "path or host:port), e.g. 'w0=/run/cct/w0.sock,w1=10.0.0.2:7733'; "
                        "bare addresses are auto-named n0..; mutually exclusive with "
                        "--spawn")
    r.add_argument("--spawn", type=int,
                   help="launch this many local worker daemons under --workdir "
                        "(per-worker journal; one shared kernel build directory), "
                        "each supervised with crash-restart backoff (default 0 = "
                        "route to --members)")
    r.add_argument("--workdir",
                   help="directory for spawned workers' sockets, journals and the "
                        "fleet's kernel build directory (default ./fleet)")
    r.add_argument("--socket", help="router unix socket path (overrides host/port)")
    r.add_argument("--host", help="router TCP bind host (default 127.0.0.1)")
    r.add_argument("--port", type=int, help="router TCP port (default 7780; 0 = any free)")
    r.add_argument("--vnodes", type=int,
                   help="virtual ring points per member (default 64); more = smoother "
                        "key spread, same stability")
    r.add_argument("--steal_threshold", type=int,
                   help="a batch/scavenger submit may leave its ring-home node once "
                        "that node's queue is this deep (default 4); interactive jobs "
                        "never move")
    r.add_argument("--steal_margin", type=int,
                   help="the thief must be at least this many queued jobs shallower "
                        "than the home node (default 2)")
    r.add_argument("--health_interval_s", type=float,
                   help="seconds between fleet health sweeps (default 2)")
    r.add_argument("--down_after", type=int,
                   help="consecutive failed probes before a member is marked down "
                        "(default 3); a failed forward marks it down immediately")
    r.add_argument("--gang_size", type=int, help="spawned workers' --gang_size (default 4)")
    r.add_argument("--queue_bound", type=int,
                   help="spawned workers' --queue_bound (default 16)")
    r.add_argument("--max_batch", type=int,
                   help="spawned workers' --max_batch (default 1024)")
    r.add_argument("--device", choices=("cuda", "cpu"),
                   help="where spawned workers vote (default cuda: the card; without "
                        "one the command exits before it spawns). The router itself "
                        "opens no CUDA context")
    r.add_argument("--backend",
                   help="the JAX package's flag, read as the device: tpu -> cuda, "
                        "xla_cpu -> cpu (cpu and reference exit naming --device)")
    r.add_argument("--compile_cache",
                   help="kernel build directory the spawned workers share (default "
                        "<workdir>/build); published as the warm-join compile_cache")
    r.add_argument("--warmup_shapes", help="spawned workers' --warmup_shapes")
    r.add_argument("--class_weights", help="spawned workers' --class_weights")
    r.add_argument("--slo_targets", help="spawned workers' --slo_targets")
    r.add_argument("--max_restarts", type=int,
                   help="per-worker supervised-restart budget (default 10)")
    r.add_argument("--drain_s",
                   help="bounded drain window for spawned workers on router shutdown "
                        "(default $CCT_SERVE_DRAIN_S or 30)")
    r.add_argument("--router_id",
                   help="this router's identity in the ring-view document (default "
                        "r0); give the standby a distinct id")
    r.add_argument("--ring_view",
                   help="path to the shared epoch-numbered ring-view document; set on "
                        "BOTH routers of an HA pair (default: unset = single-router "
                        "mode)")
    r.add_argument("--standby",
                   help="start as the standby of an HA pair: health-probe the active "
                        "router and take over by bumping the ring-view epoch when it "
                        "stops answering (default False)")
    r.add_argument("--takeover_after", type=int,
                   help="consecutive failed probes of the active router before the "
                        "standby takes over (default 3)")
    r.add_argument("--adopt_after_s",
                   help="adopt a dead member's journal (resubmit its non-terminal "
                        "jobs to the ring successor, then tombstone) once it has been "
                        "down this many seconds (default: unset = manual --adopt only)")
    r.add_argument("--journals",
                   help="journal paths for adoption as 'name=path,...'; auto-derived "
                        "for --spawn fleets")
    r.add_argument("--advertise",
                   help="address other routers should probe this one at ('host:port' "
                        "or a unix socket path; default: the bound server address)")
    r.add_argument("--adopt", metavar="NODE",
                   help="client mode: ask the running router (--socket / "
                        "--host:--port) to adopt NODE's journal now, then exit")
    r.add_argument("--adopt_force",
                   help="with --adopt: adopt even if the member still answers health "
                        "probes (default False)")
    r.add_argument("--release", metavar="KEY",
                   help="client mode: lift the quarantine on KEY via the running "
                        "router (resets the fleet retry budget and requeues the parked "
                        "job), then exit")
    r.add_argument("--result_cache",
                   help="root of the fleet content-addressed result-cache plane: the "
                        "router consults it BEFORE dispatch (a committed entry answers "
                        "the submit without touching a worker), spawned workers insert "
                        "into it, and its path is published as warm-join state in the "
                        "ring view; empty = caching off")
    r.add_argument("--cache_journal",
                   help="path of the router's cache-answer journal (fsync'd before "
                        "each cached reply so keyed polls survive a router kill -9; "
                        "default: cache_answers.journal under --result_cache)")
    r.set_defaults(func=route_cmd, config_section="route", required_args=(),
                   builtin_defaults={
                       "members": "", "spawn": 0, "workdir": "",
                       "socket": "", "host": "127.0.0.1", "port": 7780,
                       "vnodes": 64, "steal_threshold": 4,
                       "steal_margin": 2, "health_interval_s": 2.0,
                       "down_after": 3, "gang_size": 4, "queue_bound": 16,
                       "max_batch": 1024, "device": "cuda",
                       "compile_cache": "", "warmup_shapes": "",
                       "class_weights": "", "slo_targets": "",
                       "max_restarts": 10, "drain_s": "",
                       "router_id": "r0", "ring_view": "",
                       "standby": "False", "takeover_after": 3,
                       "adopt_after_s": "", "journals": "",
                       "advertise": "", "adopt": "",
                       "adopt_force": "False", "release": "",
                       "result_cache": "", "cache_journal": "",
                   })

    t = sub.add_parser(
        "trace", help="work with CCT_TRACE observability traces")
    t.add_argument("action", choices=("export", "fleet"),
                   help="export: merge trace-*.ndjson shards into one "
                        "Chrome-trace JSON for Perfetto/chrome://tracing; "
                        "fleet: pull live span buffers through the "
                        "router's trace op, union with --dir shards, and "
                        "merge into one cross-node timeline")
    t.add_argument("-c", "--config", default=None)
    t.add_argument("--dir", dest="trace_dir",
                   help="trace shard directory (default $CCT_TRACE_DIR)")
    t.add_argument("--out", help="output path (default trace.json)")
    t.add_argument("--socket", help="router/daemon unix socket (fleet)")
    t.add_argument("--host", help="router TCP host (default 127.0.0.1)")
    t.add_argument("--port", type=int, help="router TCP port (default 7733)")
    t.set_defaults(func=trace_cmd, config_section="obs", required_args=(),
                   builtin_defaults={"trace_dir": "", "out": "trace.json",
                                     "socket": "", "host": "127.0.0.1",
                                     "port": 7733})

    pr = sub.add_parser(
        "prof", help="work with CCT_PROF sampling-profiler data")
    pr.add_argument("action", choices=("report", "flame"),
                    help="report: per-node hottest-function tables + the "
                         "wall-attribution report (queue/routing/host/"
                         "device/deflate/io); flame: export merged "
                         "collapsed-stack lines for a flamegraph "
                         "renderer")
    pr.add_argument("-c", "--config", default=None)
    pr.add_argument("--dir", dest="prof_dir",
                    help="profile shard directory (default $CCT_PROF_DIR)")
    pr.add_argument("--out", help="flame output path "
                                  "(default prof.collapsed)")
    pr.add_argument("--json", help="also write the attribution doc as "
                                   "JSON to this path (report only)")
    pr.add_argument("--top", type=int, help="rows per node in the "
                                            "report tables (default 15)")
    pr.add_argument("--socket", help="router/daemon unix socket (fleet)")
    pr.add_argument("--host", help="router TCP host (default 127.0.0.1)")
    pr.add_argument("--port", type=int, help="router TCP port "
                                             "(default 7733)")
    pr.set_defaults(func=prof_cmd, config_section="obs", required_args=(),
                    builtin_defaults={"prof_dir": "", "out": "",
                                      "json": "", "top": 15,
                                      "socket": "", "host": "127.0.0.1",
                                      "port": 7733})

    cp = sub.add_parser(
        "critpath", help="per-job dispatch critical-path decomposition")
    cp.add_argument("action", choices=("report", "job"),
                    help="report: fleet-level segment table (where p99 "
                         "queue time goes) + queue-antagonist "
                         "attribution; job: one job's ordered causal "
                         "segment chain by KEY/id")
    cp.add_argument("key", nargs="?",
                    help="job key or numeric id (job action)")
    cp.add_argument("-c", "--config", default=None)
    cp.add_argument("--dir", dest="trace_dir",
                    help="trace shard directory (default $CCT_TRACE_DIR)")
    cp.add_argument("--json",
                    help="write the full report doc as JSON here "
                         "('-' prints to stdout instead of the table)")
    cp.add_argument("--socket", help="router/daemon unix socket")
    cp.add_argument("--host", help="router TCP host (default 127.0.0.1)")
    cp.add_argument("--port", type=int,
                    help="router TCP port (default 7733)")
    cp.set_defaults(func=critpath_cmd, config_section="obs",
                    required_args=(),
                    builtin_defaults={"key": "", "trace_dir": "",
                                      "json": "", "socket": "",
                                      "host": "127.0.0.1", "port": 7733})

    hp = sub.add_parser(
        "history", help="query durable telemetry-history shards")
    hp.add_argument("action", choices=("query", "trend"),
                    help="query: merged history lines as NDJSON "
                         "(--metric/--node/--last filters); trend: "
                         "per-interval delta + rate table for one "
                         "metric")
    hp.add_argument("-c", "--config", default=None)
    hp.add_argument("--dir", dest="history_dir",
                    help="history shard directory "
                         "(default $CCT_HISTORY_DIR)")
    hp.add_argument("--metric",
                    help="counter/gauge name to project (required for "
                         "trend)")
    hp.add_argument("--node", help="filter to one node's lines (query)")
    hp.add_argument("--last", type=int,
                    help="keep only the most recent N lines (query)")
    hp.add_argument("--socket", help="router/daemon unix socket")
    hp.add_argument("--host", help="router TCP host (default 127.0.0.1)")
    hp.add_argument("--port", type=int,
                    help="router TCP port (default 7733)")
    hp.set_defaults(func=history_cmd, config_section="obs",
                    required_args=(),
                    builtin_defaults={"history_dir": "", "metric": "",
                                      "node": "", "last": "",
                                      "socket": "", "host": "127.0.0.1",
                                      "port": 7733})

    qp = sub.add_parser(
        "qc", help="consensus-quality reports over per-run qc.json docs")
    qp.add_argument("action", choices=("report", "diff"),
                    help="report: per-run quality tables + merged spectrum "
                         "over every doc found; diff: rate deltas and "
                         "spectrum drift (total-variation) between two "
                         "runs/shard sets")
    qp.add_argument("paths", nargs="+",
                    help="qc.json files or directories scanned recursively "
                         "(run trees, fleet output roots)")
    qp.add_argument("-c", "--config", default=None)
    qp.add_argument("--json", help="also write the merged doc (report) / "
                                   "the A-B comparison doc (diff) here")
    qp.set_defaults(func=qc_cmd, config_section="qc", required_args=(),
                    builtin_defaults={"json": ""})

    w = sub.add_parser(
        "top", help="live terminal observatory over a router or daemon")
    w.add_argument("-c", "--config", default=None)
    w.add_argument("--socket", help="router/daemon unix socket path")
    w.add_argument("--host", help="router TCP host (default 127.0.0.1)")
    w.add_argument("--port", type=int, help="router TCP port (default 7733)")
    w.add_argument("--interval_s", type=float,
                   help="poll interval in seconds (default 2.0)")
    w.add_argument("--once", help="render one frame and exit (no tty "
                                  "needed; for scripts and tests)")
    w.set_defaults(func=top_cmd, config_section="serve", required_args=(),
                   builtin_defaults={"socket": "", "host": "127.0.0.1",
                                     "port": 7733, "interval_s": 2.0,
                                     "once": "False"})

    ca = sub.add_parser("cache", help="operate on the fleet result-cache plane")
    ca.add_argument("action", choices=("scrub",),
                    help="scrub: offline integrity sweep — re-hash every committed "
                         "entry's payload against the sha256 pinned at insert; corrupt "
                         "entries are quarantined and the command exits 1")
    ca.add_argument("-c", "--config", default=None)
    ca.add_argument("--result_cache",
                    help="cache-plane root directory (the [serve]/[route] result_cache "
                         "knob)")
    ca.add_argument("--json", help="also write the scrub report as JSON to this path")
    ca.set_defaults(func=cache_cmd, config_section="serve",
                    required_args=("result_cache",), builtin_defaults={"json": ""})

    u = sub.add_parser("submit", help="submit a consensus job to a running serve daemon")
    u.add_argument("-c", "--config", default=None)
    u.add_argument("--socket", help="daemon unix socket path")
    u.add_argument("--host", help="daemon TCP host (default 127.0.0.1)")
    u.add_argument("--port", type=int, help="daemon TCP port (default 7733)")
    u.add_argument("--input", "-i", help="coordinate-sorted barcoded BAM")
    u.add_argument("--output", "-o")
    u.add_argument("--name", "-n")
    u.add_argument("--cutoff", type=float)
    u.add_argument("--qualscore", "-q", type=int)
    u.add_argument("--scorrect", help="singleton correction on/off")
    u.add_argument("--max_mismatch", type=int)
    u.add_argument("--bdelim")
    u.add_argument("--compress_level", type=int, choices=range(0, 10), metavar="0-9")
    u.add_argument("--wait", help="block until the job finishes (default True)")
    u.add_argument("--deadline_s", type=float,
                   help="shed the job at admission (or dispatch) if it cannot "
                        "finish within this many seconds at the daemon's observed "
                        "service rate; unset = no deadline")
    u.add_argument("--tenant",
                   help="tenant id for quota and per-tenant metrics (default "
                        "'default')")
    u.add_argument("--qos", choices=("interactive", "batch", "scavenger"),
                   help="qos class for weighted-fair dispatch and SLO accounting "
                        "(default 'interactive')")
    u.add_argument("--policy",
                   help="consensus vote policy of this job (default 'majority'); "
                        "unknown names are refused at admission")
    u.set_defaults(func=submit_cmd, config_section="serve",
                   required_args=("input", "output"),
                   builtin_defaults={
                       "socket": "", "host": "127.0.0.1", "port": 7733,
                       "cutoff": 0.7, "qualscore": 0, "scorrect": "True",
                       "max_mismatch": 0, "bdelim": DEFAULT_BDELIM,
                       "compress_level": 6, "wait": "True",
                       "tenant": "", "qos": "", "policy": "",
                   })
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The command's arguments resolved as the JAX package's ``main``
    resolves them: a flag, else the config.ini value, else the built-in
    default; then typed.  Where neither ``--device`` nor a ``device`` key
    is given, a ``--backend`` flag, else a config ``backend`` key, reads
    through :func:`device_of_backend`: ``tpu``/``xla_cpu`` as the device,
    and under ``consensus`` ``cpu``/``reference`` as its host backend
    (``args.host_backend``, with ``args.device`` None; other commands
    exit on them).  ``--host_workers 0`` means every core this process may
    run on."""
    parser = build_parser()
    args = parser.parse_args(argv)
    config_values = _config_defaults(args.config, args.config_section)
    for key, value in config_values.items():
        if hasattr(args, key) and getattr(args, key) is None:
            setattr(args, key, value)
    args.host_backend = None
    if hasattr(args, "device") and args.device is None:
        if getattr(args, "backend", None):
            args.device, host = device_of_backend(args.backend, flag="--backend")
        else:
            args.device, host = device_of_backend(config_values.get("backend"))
        if host is not None and args.command != "consensus":
            raise SystemExit(
                f"{args.command} --backend {host}: the host backends run under consensus "
                "alone; this command's workers vote on a device (--device cuda|cpu)")
        args.host_backend = host
    for key, value in args.builtin_defaults.items():
        if getattr(args, key) is None and not (key == "device" and args.host_backend):
            setattr(args, key, value)
    missing = [a for a in args.required_args if getattr(args, a, None) in (None, "")]
    if missing:
        parser.error("missing required arguments (flag or config.ini): "
                     + ", ".join("--" + m for m in missing))
    if args.command == "fastq2bam":
        args.cleanup, args.resume = _bool(args.cleanup), _bool(args.resume)
        args.compress_level = int(args.compress_level)
        args.host_workers = _host_workers(parser, args.host_workers)
        return args
    if args.command != "consensus":
        if hasattr(args, "scorrect"):  # submit
            args.scorrect = _bool(args.scorrect)
            args.cutoff, args.qualscore = float(args.cutoff), int(args.qualscore)
            args.max_mismatch = int(args.max_mismatch)
            args.compress_level = int(args.compress_level)
        return args
    for key in ("scorrect", "cleanup", "resume", "residency", "intermediate_taps"):
        setattr(args, key, _bool(getattr(args, key)))
    args.cutoff, args.qualscore = float(args.cutoff), int(args.qualscore)
    args.max_mismatch, args.compress_level = int(args.max_mismatch), int(args.compress_level)
    if args.intermediate_level is not None:
        args.intermediate_level = int(args.intermediate_level)
    if args.devices is not None:
        args.devices = int(args.devices)
    args.host_workers = _host_workers(parser, args.host_workers)
    return args


def _host_workers(parser, value) -> int:
    """``--host_workers`` typed; 0 means every core this process may run
    on (affinity-aware, since a cgroup- or taskset-limited host's
    cpu_count() reports the machine, not the schedulable set)."""
    n = int(value)
    if n < 0:
        parser.error(f"--host_workers must be >= 0, got {n}")
    if n == 0:
        try:
            cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            cores = os.cpu_count() or 1
        n = max(1, cores)
    return n


def main(argv=None, _sscs_handoff=None):
    """Run one command; returns what the command returns (``consensus``:
    its result dict).  ``_sscs_handoff`` is serve-internal: a gang-
    dispatched job continuing into the streaming pipeline hands its
    in-memory SSCS outputs through here."""
    args = parse_args(argv)
    args._sscs_handoff = _sscs_handoff
    _apply_obs_config(args.config)
    _apply_io_config(args.config)
    _apply_qc_config(args.config)
    from consensuscruncher_tpu_torch.obs import prof as obs_prof
    from consensuscruncher_tpu_torch.obs import trace as obs_trace

    # the sampling profiler (CCT_PROF) covers every subcommand; the root
    # span mints the run's trace id (serve jobs re-entering main()
    # in-process inherit their job span's id), and the explicit flush
    # leaves complete trace shards without relying on atexit ordering
    obs_prof.maybe_start()
    try:
        with obs_trace.span(f"cli.{args.command}"):
            return args.func(args)
    finally:
        obs_trace.flush()
        obs_prof.flush()


if __name__ == "__main__":
    main(sys.argv[1:])
