"""Command line of the PyTorch/CUDA port.

    python -m consensuscruncher_tpu_torch.cli consensus -i X.bam -o OUT \\
        [--scorrect True] [--device cuda|cpu] [--residency True|False] ...

Port of the staged path of ``consensuscruncher_tpu/cli.py:_consensus_impl``:
SSCS -> singleton rescue -> rescued merge -> DCS -> all-unique merges ->
BAI indexes, under ``<output>/<name>/{sscs,singleton,dcs,all_unique}``.
The device votes run on the CUDA card unless ``--device cpu`` is given;
the SSCS planes stay on the device for rescue and DCS unless
``--residency False`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from consensuscruncher_tpu_torch.core.consensus_cpu import DEFAULT_QUAL_CAP
from consensuscruncher_tpu_torch.core.tags import DEFAULT_BDELIM
from consensuscruncher_tpu_torch.device import device_name, resolve_device
from consensuscruncher_tpu_torch.io.bai import index_bam
from consensuscruncher_tpu_torch.io.bam import merge_bams
from consensuscruncher_tpu_torch.ops.packing import resident_planes
from consensuscruncher_tpu_torch.stages.dcs_maker import run_dcs
from consensuscruncher_tpu_torch.stages.singleton_correction import run_singleton_correction
from consensuscruncher_tpu_torch.stages.sscs_maker import run_sscs


def _bool(v) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def consensus(args) -> dict:
    """Run the consensus pipeline; returns the output paths, the directory
    map and the wall seconds of each step."""
    if int(args.max_mismatch) != 0:
        raise SystemExit("--max_mismatch > 0 is not supported by the torch port yet")
    device = resolve_device(args.device)
    scorrect, cleanup = _bool(args.scorrect), _bool(args.cleanup)
    level = args.compress_level
    name = args.name or os.path.basename(args.input).split(".")[0]
    base = os.path.join(args.output, name)
    dirs = {k: os.path.join(base, k) for k in ("sscs", "singleton", "dcs", "all_unique")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    walls: dict[str, float] = {}
    t = time.perf_counter()

    def mark(step: str) -> None:
        nonlocal t
        now = time.perf_counter()
        walls[step] = now - t
        t = now

    # Device-resident SSCS planes (on by default, as in the JAX package):
    # rescue and DCS vote by gather on the device instead of uploading the
    # SSCS planes again.  Outputs are byte-identical either way.
    residency = resident_planes(device, DEFAULT_QUAL_CAP) if _bool(args.residency) else None
    sscs = run_sscs(args.input, os.path.join(dirs["sscs"], name), device,
                    cutoff=args.cutoff, qual_threshold=args.qualscore,
                    bdelim=args.bdelim, level=level, residency=residency)
    mark("sscs")
    sscs_parts = [sscs.sscs_bam]
    dcs_input = sscs.sscs_bam
    if scorrect:
        corr = run_singleton_correction(sscs.singleton_bam, sscs.sscs_bam,
                                        os.path.join(dirs["singleton"], name),
                                        device, level=level, residency=residency)
        mark("singleton_correction")
        sscs_parts += [corr.sscs_rescue_bam, corr.singleton_rescue_bam, corr.remaining_bam]
        # DCS pairs SSCSes plus rescued singletons: a corrected singleton can
        # now form a duplex with its partner.  The merge feeds DCS only, so
        # it is stored raw under --cleanup (deleted at the end anyway).
        dcs_input = os.path.join(dirs["dcs"], f"{name}.sscs.rescued.bam")
        merge_bams([sscs.sscs_bam, corr.sscs_rescue_bam, corr.singleton_rescue_bam],
                   dcs_input, level=0 if cleanup else min(1, level),
                   index=not cleanup)
        mark("merge_rescued")
    else:
        sscs_parts.append(sscs.singleton_bam)
    dcs = run_dcs(dcs_input, os.path.join(dirs["dcs"], name), device, level=level,
                  residency=residency)
    mark("dcs")

    # all-unique merges: SSCS path = every molecule's best single-strand
    # evidence; DCS path = duplex reads plus SSCSes that found no partner
    all_sscs = os.path.join(dirs["all_unique"], f"{name}.all.unique.sscs.bam")
    all_dcs = os.path.join(dirs["all_unique"], f"{name}.all.unique.dcs.bam")
    merge_bams([p for p in sscs_parts if os.path.exists(p)], all_sscs, level=level)
    merge_bams([p for p in (dcs.dcs_bam, dcs.sscs_singleton_bam) if os.path.exists(p)],
               all_dcs, level=level)
    mark("merge_all_unique")

    index_parts = [all_sscs, all_dcs, dcs.dcs_bam, dcs.sscs_singleton_bam,
                   sscs.sscs_bam, sscs.singleton_bam]
    if scorrect:
        index_parts += [corr.sscs_rescue_bam, corr.singleton_rescue_bam, corr.remaining_bam]
        if not cleanup:
            index_parts.append(dcs_input)
    for path in index_parts:
        if os.path.exists(path):
            index_bam(path, skip_if_fresh=True)
    if cleanup:
        doomed = [sscs.bad_bam] + ([dcs_input, dcs_input + ".bai"] if scorrect else [])
        for path in doomed:
            if os.path.exists(path):
                os.unlink(path)
    mark("index")
    print(f"consensus: outputs under {base} ({device_name(device)})")
    return {"all_sscs": all_sscs, "all_dcs": all_dcs, "dirs": dirs, "walls": walls}


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
                   help="barcode Hamming tolerance for singleton rescue (only 0)")
    c.add_argument("--bdelim", default=DEFAULT_BDELIM)
    c.add_argument("--cleanup", default="False", help="remove intermediate BAMs")
    c.add_argument("--compress_level", type=int, choices=range(0, 10), default=6,
                   metavar="0-9", help="BGZF deflate level of output BAMs")
    c.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the votes run (default cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
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
