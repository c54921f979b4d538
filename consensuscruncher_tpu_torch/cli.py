"""Command line of the PyTorch/CUDA port.

    python -m consensuscruncher_tpu_torch.cli consensus -i X.bam[,Y.bam...] \\
        -o OUT [-c config.ini] [--scorrect True] [--device cuda|cpu] \\
        [--residency True|False] [--resume True] [--intermediate_level 0-9] \\
        [--pipeline staged|streaming] [--intermediate_taps True] \\
        [--max_mismatch N] [--wire stream|dense] \\
        [--policy majority|delegation|distilled] [--host_workers N] \\
        [--devices N] [--profile DIR] ...

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

    python -m consensuscruncher_tpu_torch.cli serve --socket S [--journal J] \\
        [--gang_size 4] [--warmup_shapes BxFxL,...] [--device cuda|cpu] ...
    python -m consensuscruncher_tpu_torch.cli submit --socket S -i X.bam -o OUT

``serve`` runs the persistent daemon of ``serve/`` on the card (unless
``--device cpu``): it gangs the SSCS of several queued jobs into one dense
device stream and finishes each job through ``consensus --resume``;
``submit`` hands it one job and waits for the result.  The JAX package's
``--warm_from`` and ``--result_cache`` belong to its fleet and are not
ported yet.
"""

from __future__ import annotations

import argparse
import configparser
import copy
import json
import os
import shutil
import sys
import time
from dataclasses import dataclass

from consensuscruncher_tpu_torch.core.consensus_cpu import DEFAULT_QUAL_CAP
from consensuscruncher_tpu_torch.core.tags import DEFAULT_BDELIM
from consensuscruncher_tpu_torch.device import device_name, resolve_device
from consensuscruncher_tpu_torch.io import bgzf
from consensuscruncher_tpu_torch.io.bai import index_bam
from consensuscruncher_tpu_torch.io.bam import BamReader, merge_bams
from consensuscruncher_tpu_torch.obs import qc as obs_qc
from consensuscruncher_tpu_torch.ops.packing import resident_planes
from consensuscruncher_tpu_torch.policies import DEFAULT_POLICY, get_policy
from consensuscruncher_tpu_torch.parallel import hostshard
from consensuscruncher_tpu_torch.stages import dcs_maker, singleton_correction, sscs_maker
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
from consensuscruncher_tpu_torch.utils.manifest import RunManifest
from consensuscruncher_tpu_torch.utils.profiling import maybe_profile
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
}
# the JAX package's canary prober keys: its reader comes with the fleet
# (router, result cache, canary), so a key set here is named as ignored
_OBS_LATER = ("canary", "canary_interval_s", "canary_latency_s", "canary_golden",
              "canary_dir")


def _apply_obs_config(path: str | None) -> None:
    """Fold the ``[obs]`` config section into the observability env vars,
    as the JAX package's ``_apply_obs_config`` does.  ``setdefault`` so a
    real environment variable always wins over config.ini.  A canary key
    set there is named on stderr as ignored (the port has no canary yet);
    other unknown keys are ignored silently, as in the reference."""
    later = []
    for key, value in _config_defaults(path, "obs").items():
        if str(value) == "":
            continue
        env = _OBS_ENV.get(key)
        if env:
            os.environ.setdefault(env, str(value))
        elif key in _OBS_LATER:
            later.append(key)
    if later:
        print(f"config [obs] {', '.join(sorted(later))}: ignored (the serve canary is "
              "not ported yet)", file=sys.stderr)


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


# The JAX package's [consensus] ``backend`` key, read as the port's device.
_BACKEND_DEVICE = {"tpu": "cuda", "xla_cpu": "cpu"}


def device_of_backend(backend: str | None) -> str | None:
    """The port's device for a config.ini ``backend`` value (None when
    unset): ``tpu`` (the device kernels) is the card, ``xla_cpu`` (the same
    kernels on the CPU) the CPU.  ``cpu`` and ``reference`` name the JAX
    package's numpy twin and object path, which the port has not: they
    exit, naming ``--device``."""
    if backend in (None, ""):
        return None
    if backend in _BACKEND_DEVICE:
        return _BACKEND_DEVICE[backend]
    if backend in ("cpu", "reference"):
        raise SystemExit(
            f"config backend = {backend}: this port has no numpy or object-path "
            "backend; set device = cpu in [consensus] (or pass --device cpu) to run "
            "its CPU path, or device = cuda for the card")
    raise SystemExit(f"config backend = {backend!r}: expected tpu, xla_cpu, cpu or "
                     "reference (or set device = cuda|cpu)")


@dataclass
class _Run:
    """One consensus run: its arguments and where its outputs go."""

    args: argparse.Namespace
    device: object
    name: str
    base: str
    dirs: dict
    manifest: RunManifest
    ilevel: int           # deflate level of the per-stage BAMs
    t0: float             # perf_counter at the start of the run
    io_before: dict       # bgzf.write_stats() at the start of the run


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


def consensus(args) -> dict:
    """Run the consensus pipeline on one input, or on each input of a
    comma-separated batch (``{input: result}``).  A run's result holds its
    output paths, the directory map, the wall seconds of each step and the
    pipeline that ran.  ``--profile DIR`` traces the whole command."""
    inputs = [p.strip() for p in str(args.input).split(",") if p.strip()]
    # only a process that drives the card traces it: a host-sharded parent
    # opens no CUDA context
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
    prestage is closed whatever happens."""
    overlap = args.host_workers <= 1
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
    count*."""
    n = int(args.host_workers)
    resume = args.resume
    device = resolve_device(args.device)  # checks for a card; opens no context
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
    if device.type == "cuda":
        import torch

        from consensuscruncher_tpu_torch.ops import cuda_lib

        cuda_lib.build("consensus_vote")
        n_cards = torch.cuda.device_count()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base_env = dict(os.environ)
    # -m resolves via the child's sys.path; splice the repo root in so the
    # workers import this checkout regardless of their cwd
    base_env["PYTHONPATH"] = repo_root + os.pathsep + base_env.get("PYTHONPATH", "")
    workers = []
    for i, rng in enumerate(ranges):
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
            "env": hostshard.worker_env(base_env, i, device.type, n_cards,
                                        args.devices or 1),
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
            obs_qc.write_qc(os.path.join(base, "qc.json"), doc)
    _draw_plots(dirs, name, args.scorrect, rpaths("sscs/{n}.metrics.json"))

    # A resumed run keeps the worker checkpoint tree (unless --cleanup):
    # it is the evidence of what was skipped and what recomputed, and a
    # further resume after a later failure reuses it.  Plain runs drop it.
    if args.cleanup or not resume:
        shutil.rmtree(ranges_dir, ignore_errors=True)
    print(f"consensus: outputs under {base} ({n} host workers, {device.type})")
    return {"all_sscs": os.path.join(dirs["all_unique"], f"{name}.all.unique.sscs.bam"),
            "all_dcs": os.path.join(dirs["all_unique"], f"{name}.all.unique.dcs.bam"),
            "dirs": dirs, "walls": tracker.as_phases(), "pipeline": f"host_sharded[{n}]"}


def _consensus_one(args) -> dict:
    """One sample, one process: the staged or the streaming pipeline."""
    t0 = time.perf_counter()
    io_before = bgzf.write_stats()
    device = resolve_device(args.device)
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
    run = _Run(args, device, name, base, dirs, manifest, ilevel, t0, io_before)

    # Device-resident SSCS planes (on by default on the single-device
    # stream wire, as in the JAX package): rescue and DCS vote by gather on
    # the device instead of uploading the SSCS planes again.  Outputs are
    # byte-identical either way, so it is no manifest param; a resume that
    # skips SSCS leaves the store empty and rescue and DCS vote by upload.
    # A --devices N > 1 run keeps no store: its rows come back from the
    # shards in per-device blocks.
    def store():
        if (args.wire == "stream" and _bool(args.residency)
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
                             devices=args.devices),
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
                                                 level=ilevel, residency=residency),
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
                            devices=args.devices),
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
                            devices=args.devices)
        walls.mark("sscs")
        sscs_mem, singleton_mem = stream.memory["sscs"], stream.memory["singleton"]
        sscs_mem_parts = [sscs_mem]
        if args.scorrect:
            corr = run_singleton_correction(
                BatchStream(singleton_mem), BatchStream(sscs_mem),
                os.path.join(dirs["singleton"], name), device, level=ilevel,
                residency=residency, stream_out=stream)
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
                      devices=args.devices)
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
    _write_run_metrics(base, name, run.dirs, pipeline, run.t0, run.io_before)
    # Unlike the JAX package, no best-effort catch around the QC doc: the
    # accumulator copies the card's sums here, and a device fault must raise.
    if qc_acc is not None:
        obs_qc.write_qc(os.path.join(base, "qc.json"),
                        obs_qc.collect_run(base, name, pipeline=pipeline, acc=qc_acc,
                                           policy=args.policy))
    print(f"consensus: outputs under {base} ({pipeline} pipeline, "
          f"{device_name(run.device)})")


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


def _write_run_metrics(base, name, dirs, pipeline, t0, io_before) -> None:
    """``<base>/run.metrics.json``: the end-to-end numbers of a run — total
    wall, deflate wall, BGZF bytes written, and how many of those bytes
    were stage-to-stage intermediates (0 in streaming mode with taps off)."""
    now = bgzf.write_stats()
    intermediates = [
        os.path.join(dirs["sscs"], f"{name}.singleton.sorted.bam"),
        os.path.join(dirs["singleton"], f"{name}.sscs.rescue.sorted.bam"),
        os.path.join(dirs["singleton"], f"{name}.singleton.rescue.sorted.bam"),
        os.path.join(dirs["dcs"], f"{name}.sscs.rescued.bam"),
    ]
    payload = {
        "pipeline": pipeline,
        "wall_s": round(time.perf_counter() - t0, 6),
        "deflate_wall_s": round((now["deflate_wall_us"] - io_before["deflate_wall_us"]) / 1e6, 6),
        "bytes_bam_written": now["bytes_written"] - io_before["bytes_written"],
        "intermediate_bam_bytes": sum(
            os.path.getsize(p) for p in intermediates if os.path.exists(p)),
    }
    with open(os.path.join(base, "run.metrics.json"), "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


# ---------------------------------------------------------------------- serve

def _serve_child_argv(args) -> list[str]:
    """Rebuild the serve subcommand argv for the supervised daemon child —
    the resolved values (flag > config > builtin), minus --supervise."""
    argv = ["serve"]
    for flag in ("socket", "host", "warmup_shapes", "compile_cache",
                 "journal", "device", "node", "policy"):
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
    socket."""
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
    )
    server = ServeServer(scheduler, host=args.host, port=int(args.port),
                         socket_path=args.socket or None)
    install_signal_handlers(server, scheduler, journal)
    # the durable telemetry-history recorder (CCT_HISTORY_DIR): touches no
    # pipeline output
    obs_history.maybe_start(scheduler.history_doc)
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


def build_parser() -> argparse.ArgumentParser:
    # Every value-bearing flag defaults to None so the precedence is the
    # JAX package's: CLI flag > config.ini value > built-in default
    # (applied in parse_args; argparse defaults would mask the config).
    p = argparse.ArgumentParser(prog="consensuscruncher_tpu_torch",
                                description="PyTorch/CUDA port of ConsensusCruncher")
    sub = p.add_subparsers(dest="command", required=True)
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
                        "kernels' plain PyTorch versions). A config.ini "
                        "'backend' key reads as tpu -> cuda, xla_cpu -> cpu")
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
    c.set_defaults(func=consensus, config_section="consensus",
                   required_args=("input", "output"),
                   builtin_defaults={
                       "cutoff": 0.7, "qualscore": 0, "scorrect": "True",
                       "max_mismatch": 0, "device": "cuda", "bdelim": DEFAULT_BDELIM,
                       "cleanup": "False", "resume": "False", "compress_level": 6,
                       "host_workers": 1, "residency": "True", "pipeline": "staged",
                       "intermediate_taps": "False", "policy": DEFAULT_POLICY,
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
                       "policy": DEFAULT_POLICY,
                   })

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
    default; then typed.  A config ``backend`` key reads as the device
    (:func:`device_of_backend`) where neither ``--device`` nor a ``device``
    key is given.  ``--host_workers 0`` means every core this process may
    run on."""
    parser = build_parser()
    args = parser.parse_args(argv)
    config_values = _config_defaults(args.config, args.config_section)
    for key, value in config_values.items():
        if hasattr(args, key) and getattr(args, key) is None:
            setattr(args, key, value)
    if hasattr(args, "device") and args.device is None:
        args.device = device_of_backend(getattr(args, "backend", None)
                                        or config_values.get("backend"))
    for key, value in args.builtin_defaults.items():
        if getattr(args, key) is None:
            setattr(args, key, value)
    missing = [a for a in args.required_args if getattr(args, a, None) in (None, "")]
    if missing:
        parser.error("missing required arguments (flag or config.ini): "
                     + ", ".join("--" + m for m in missing))
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
    args.host_workers = int(args.host_workers)
    if args.host_workers < 0:
        parser.error(f"--host_workers must be >= 0, got {args.host_workers}")
    if args.host_workers == 0:
        # 0 = all cores: affinity-aware, since a cgroup- or taskset-limited
        # host's cpu_count() reports the machine, not the schedulable set
        try:
            cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            cores = os.cpu_count() or 1
        args.host_workers = max(1, cores)
    return args


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
