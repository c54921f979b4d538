"""Command line of the PyTorch/CUDA port.

    python -m consensuscruncher_tpu_torch.cli consensus -i X.bam -o OUT \\
        [--scorrect True] [--device cuda|cpu] [--residency True|False] \\
        [--resume True] [--intermediate_level 0-9] \\
        [--pipeline staged|streaming] [--intermediate_taps True] \\
        [--max_mismatch N] [--wire stream|dense] \\
        [--policy majority|delegation|distilled] ...

Port of ``consensuscruncher_tpu/cli.py``'s ``_consensus_impl`` (the staged
pipeline) and ``_consensus_streaming``: SSCS -> singleton rescue -> rescued
merge -> DCS -> all-unique merges -> BAI indexes, under
``<output>/<name>/{sscs,singleton,dcs,all_unique}``, plus the run's
``qc.json`` (``CCT_QC``, on by default), ``manifest.json`` (what
``--resume`` skips by) and ``run.metrics.json``.  The device votes run on
the CUDA card unless ``--device cpu`` is given; on the stream wire the SSCS
planes stay on the device for rescue and DCS unless ``--residency False``
is given.  ``--policy`` picks the SSCS family vote (``policies/``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass

from consensuscruncher_tpu_torch.core.consensus_cpu import DEFAULT_QUAL_CAP
from consensuscruncher_tpu_torch.core.tags import DEFAULT_BDELIM
from consensuscruncher_tpu_torch.device import device_name, resolve_device
from consensuscruncher_tpu_torch.io import bgzf
from consensuscruncher_tpu_torch.io.bai import index_bam
from consensuscruncher_tpu_torch.io.bam import merge_bams
from consensuscruncher_tpu_torch.obs import qc as obs_qc
from consensuscruncher_tpu_torch.ops.packing import resident_planes
from consensuscruncher_tpu_torch.policies import DEFAULT_POLICY, get_policy
from consensuscruncher_tpu_torch.stages import dcs_maker, singleton_correction, sscs_maker
from consensuscruncher_tpu_torch.stages.dcs_maker import DcsResult, run_dcs
from consensuscruncher_tpu_torch.stages.singleton_correction import (
    SingletonResult,
    run_singleton_correction,
)
from consensuscruncher_tpu_torch.stages.sscs_maker import SscsResult, run_sscs
from consensuscruncher_tpu_torch.utils.manifest import RunManifest


def _bool(v) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


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
    """Run the consensus pipeline; returns the output paths, the directory
    map, the wall seconds of each step and the pipeline that ran."""
    t0 = time.perf_counter()
    io_before = bgzf.write_stats()
    device = resolve_device(args.device)
    # the vote policy (and the distilled checkpoint) is resolved before any
    # output exists: an unknown name or a bad checkpoint writes nothing
    get_policy(args.policy).prepare()
    args.scorrect, args.cleanup = _bool(args.scorrect), _bool(args.cleanup)
    args.resume, args.intermediate_taps = _bool(args.resume), _bool(args.intermediate_taps)
    name = args.name or os.path.basename(args.input).split(".")[0]
    base = os.path.join(args.output, name)
    dirs = {k: os.path.join(base, k) for k in ("sscs", "singleton", "dcs", "all_unique")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    manifest = RunManifest(os.path.join(base, "manifest.json"))
    # Per-output-class deflate: the per-stage BAMs may take
    # --intermediate_level while the finals keep --compress_level (default:
    # follow --compress_level).
    ilevel = args.compress_level if args.intermediate_level is None else args.intermediate_level
    run = _Run(args, device, name, base, dirs, manifest, ilevel, t0, io_before)

    # Device-resident SSCS planes (on by default on the stream wire, as in
    # the JAX package): rescue and DCS vote by gather on the device instead
    # of uploading the SSCS planes again.  Outputs are byte-identical
    # either way, so it is no manifest param; a resume that skips SSCS
    # leaves the store empty and rescue and DCS vote by upload.
    def store():
        if args.wire == "stream" and _bool(args.residency):
            return resident_planes(device, DEFAULT_QUAL_CAP)
        return None

    # The object-walk rescue (--max_mismatch > 0) re-reads its inputs as
    # files, so such a run takes the staged pipeline, as in the JAX package.
    if (args.pipeline == "streaming" and not args.resume
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
    sscs_paths = sscs_maker.output_paths(sscs_prefix)
    # badReads.bam is no manifest output (--cleanup deletes it and nothing
    # downstream reads it), nor is time_tracker (it changes every run).
    # "input_range" keeps the params the JAX package records (the port
    # reads whole inputs only), so either package resumes the other's run.
    sscs = checkpointed(
        "sscs", [args.input],
        [sscs_paths[k] for k in ("sscs", "singleton", "stats_txt", "stats_json", "families")],
        # "policy" joins the params only when it is not the default, so a
        # pre-policy manifest still satisfies a default --resume
        {"cutoff": args.cutoff, "qualscore": args.qualscore, "bdelim": args.bdelim,
         "input_range": None,
         **({"policy": args.policy} if args.policy != DEFAULT_POLICY else {})},
        run=lambda: run_sscs(args.input, sscs_prefix, device, cutoff=args.cutoff,
                             qual_threshold=args.qualscore, bdelim=args.bdelim, level=ilevel,
                             residency=residency, qc=qc_acc, wire=args.wire,
                             policy=args.policy),
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
        run=lambda: run_dcs(dcs_input, dcs_prefix, device, level=ilevel, residency=residency),
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
        sscs = run_sscs(args.input, os.path.join(dirs["sscs"], name), device,
                        cutoff=args.cutoff, qual_threshold=args.qualscore,
                        bdelim=args.bdelim, level=ilevel, residency=residency,
                        qc=qc_acc, stream_out=stream, wire=args.wire,
                        policy=args.policy)
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
                      level=ilevel, residency=residency, stream_out=stream)
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
    """The end of a run, either pipeline: index every surviving BAM, delete
    the intermediates under --cleanup, write run.metrics.json and
    qc.json."""
    args, base, name = run.args, run.base, run.name
    for path in index_parts:
        if os.path.exists(path):
            index_bam(path, skip_if_fresh=True)
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="consensuscruncher_tpu_torch",
                                description="PyTorch/CUDA port of ConsensusCruncher")
    sub = p.add_subparsers(dest="command", required=True)
    c = sub.add_parser("consensus", help="collapse UMI families into SSCS/DCS")
    c.add_argument("--input", "-i", required=True, help="coordinate-sorted barcoded BAM")
    c.add_argument("--output", "-o", required=True)
    c.add_argument("--name", "-n")
    c.add_argument("--cutoff", type=float, default=0.7)
    c.add_argument("--qualscore", "-q", type=int, default=0)
    c.add_argument("--scorrect", default="True", help="singleton correction on/off")
    c.add_argument("--max_mismatch", type=int, default=0,
                   help="barcode Hamming tolerance for singleton rescue (default "
                        "0: exact complementary match; > 0 runs the object walk "
                        "with the Hamming matcher, on the staged pipeline)")
    c.add_argument("--bdelim", default=DEFAULT_BDELIM)
    c.add_argument("--cleanup", default="False", help="remove intermediate BAMs")
    c.add_argument("--resume", default="False",
                   help="skip stages whose manifest-recorded inputs, outputs and "
                        "params are intact (default False)")
    c.add_argument("--compress_level", type=int, choices=range(0, 10), default=6,
                   metavar="0-9", help="BGZF deflate level of output BAMs")
    c.add_argument("--intermediate_level", type=int, choices=range(0, 10), default=None,
                   metavar="0-9",
                   help="BGZF deflate level of the per-stage BAMs (sscs/singleton, "
                        "rescue BAMs, dcs parts, badReads); default: follow "
                        "--compress_level")
    c.add_argument("--pipeline", choices=("staged", "streaming"), default="staged",
                   help="'staged' (default): each stage writes its BAM, the next "
                        "re-reads it. 'streaming': stages hand sorted record batches "
                        "over in memory, intermediate BAMs are skipped (see "
                        "--intermediate_taps), finals are byte-identical; --resume "
                        "runs take the staged path, and a run whose sort buffer "
                        "spills or whose background write fails re-runs staged")
    c.add_argument("--intermediate_taps", default="False",
                   help="with --pipeline streaming: also write the stage-to-stage "
                        "BAMs, reproducing the staged output tree (default False)")
    c.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the votes run (default cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
    c.add_argument("--wire", choices=("stream", "dense"), default="stream",
                   help="SSCS vote layout: 'stream' (packed member stream, the "
                        "default) or 'dense' (padded (B, F, L) family batches). "
                        "Byte-identical outputs; residency needs 'stream'")
    c.add_argument("--policy", default=DEFAULT_POLICY,
                   help="consensus vote policy of the SSCS family vote: 'majority' "
                        "(the reference rational-cutoff vote, the default), "
                        "'delegation' (members below Phred 20 hand their vote "
                        "weight to the family's high-quality members) or "
                        "'distilled' (the small frozen MLP head of "
                        "policies/checkpoints/distilled_v1.json)")
    c.add_argument("--residency", default="True",
                   help="keep SSCS consensus planes on the device so rescue and "
                        "DCS vote by gather instead of uploading them again "
                        "(default True). Byte-identical outputs; 'False' "
                        "uploads every duplex vote")
    c.set_defaults(func=consensus)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main(sys.argv[1:])
