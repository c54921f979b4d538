"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--fragments N]

Drives ``consensuscruncher_tpu_torch`` on the card and exits non-zero on any
failure; no phase's failure is caught.  Phases:

1. the card's name and power limit, its SM count and top SM clock
   (``nvidia-smi``), from which the INT32 rate of the bounds follows;
2. build ``csrc/consensus_vote.cu`` (one kernel template: the SSCS vote,
   the SSCS vote with the QC rider and the fused duplex vote, each on the
   raw, pack8, pack6 and pack4 wires), timed, with each instantiation's
   registers, spills and shared memory;
3. each kernel against its plain PyTorch version on the card (the torch
   wire decode, then the plain vote), exactly (``torch.equal``), one launch
   per wrapper call, the path its tiles took (staged, direct, mixed):
   - the SSCS vote (B1): random dense and stream batches, edge shapes, a
     family of more than 1000 members, 70,000 families; on every wire, a
     family straddling the planner's byte budget, size-0 families at tile
     starts and ends, a family count that is not a multiple of the tile,
     70,000 families, a 1,500-member family (the direct path) and rows of
     L 100, rows of L 640 (the QC rider's global-atomic form), three
     configs, each also with the QC rider over per-family true lengths
     that differ inside the batch (planes and rider sums exact); then its
     time at the main path's shape (the largest early batch of the phase-5
     input, its live families only) on the wire the main path ships: the
     kernel alone (profiler), with the QC rider and without, in turns, the
     call as the main path pays it (checks, tile plan, one upload, the
     launch), the same kernel on the torch-unpacked raw planes, and the
     yardstick of the earlier design's path (torch ``unpack_wire`` + the
     kernel);
   - the fused duplex vote (B2): dense batches with PAD tails, size-0
     slots on strand A, on B and on both, F = 1, 7 and 8 of 10 at cutoff
     0.7, a first-seen tie with a demoted member, a stream batch with a
     1,500-member family, more than 65,535 pairs, three configs; on every
     wire, stream batches with a 1,500-member family and with 70,000 pairs,
     planes, ``packed_out`` planes and stats; then its time at the JAX
     package's shapes: dense ``B8192_F16_L100`` and ``B65536_F8_L100``
     (``tools/tpu_device_bench.py`` inputs) and the stage loop of
     ``tools/tpu_stage_row.py`` (eight batches of 8,192 pairs, L 128,
     pack4), prestaged on the card: the bare launch, the step
     (``segment_duplex_step``, ``loop_ms``), the unfused chain (torch
     unpack4, B1 per strand, ``duplex_vote``) and the plain version, in
     turns over the same eight batches; every stage step's output and stats
     are held against the plain version and a numpy count;
4. ``consensus --scorrect True`` on the committed ``test/data`` BAMs with
   residency on (the default), every digest of ``test/golden.json``
   checked, each run's ``qc.json`` equal, whole, to the port's own
   ``--device cpu`` run's; ``sample.bam`` also with ``--residency False``,
   whose BAMs must be byte-identical to the resident run's, and with
   ``--pipeline streaming --intermediate_taps True``, whose whole tree
   (BAMs and indexes) must be the staged run's; then the object paths:
   ``--max_mismatch 1`` on ``sample_bcerr.bam`` (the ``consensus_mm1``
   goldens, the Hamming matcher on the card), ``--wire dense`` on the
   three BAMs (every launch B1's dense form with the dense rider) and on
   ``sample.bam`` under streaming, each staged card run's records and
   ``qc.json`` equal to the port's ``--device cpu`` run's; and a tagged
   ``sample.bam`` (``NM:i:0`` on every read, as an aligner writes): card
   records equal to the CPU run's, streaming re-running staged;
5. the same command on a simulated BAM (``--fragments`` duplex fragments,
   seed 42, ``ref_len = 40 * fragments``), residency on: wall time,
   families/s, reads/s, the SSCS kernel's launches (> 0, every one with the
   QC rider), the resident duplex votes (pairs and rescues, each > 0) and
   a ``qc.json`` with its vote plane; then ``--resume True`` on the same
   output (every stage skipped, no launch, every BAM's sha256 kept); then
   three more runs of it with their step walls: staged with
   ``--residency`` off, streaming, staged (taps off: the finals
   byte-identical to the main run's, no intermediate written);
6. the object paths at full width (read length 100, UMI 6, mean family
   3): (a) phase 5's settings at ``OBJECT_FRAGMENTS`` fragments, untagged
   and with ``NM:i:0`` on every read: the tagged run's rescue and DCS
   take the window walks on the card, and each of the two stages again
   with ``device="cpu"`` writes the same records; (b) ``--wire dense`` on
   (a)'s untagged sample, every BAM byte-identical to (a)'s stream run's,
   every SSCS launch B1's dense form with the dense rider, which is then
   held to its plain version at the run's largest bucket (qualscore 0 and
   30) and timed with its bound; (c) ``--max_mismatch 1`` on the same
   settings with barcode errors (another seed): the Hamming matcher's
   calls and seconds, and the rescue stage on the CPU writes the same
   records;
7. the vote policies (``--policy delegation|distilled``, torch ops on the
   card): each policy's stream vote at the main path's batch, with and
   without the rider, its dense vote at (b)'s largest bucket and the fused
   API's policy branch (B15) at ``B8192_F16_L100`` against the same
   functions on the CPU, exactly, timed beside B1 (and B2), their kernels
   per call counted by the profiler; ``consensus --policy P`` on
   ``sample.bam`` and on a degraded sample (``simulate_bam``,
   ``DEGRADED_FRAGMENTS``, half the reads degraded): card records and
   ``qc.json`` equal to the ``--device cpu`` run's, the ``qc.json`` plane
   the majority run's, delegation's SSCS BAM other than majority's on the
   degraded sample, and on ``sample.bam`` ``--wire dense``, streaming and
   ``--residency False`` writing the same records; then phase 5's sample
   under each policy, staged (walls; delegation's SSCS BAM majority's,
   byte for byte);
8. the fused path: ``run_duplex_pipelined`` over the stage-loop batches,
   its kernel launches counted (> 0) and its outputs equal to the
   prestaged loop's.

The line before the ``kernels`` line is the ``policies`` JSON; the line
before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from consensuscruncher_tpu_torch.cli import main as cli_main  # noqa: E402
from consensuscruncher_tpu_torch.io.columnar import open_batch_source  # noqa: E402
from consensuscruncher_tpu_torch.ops import (  # noqa: E402
    consensus_dense,
    consensus_segment,
    consensus_vote,
    cuda_lib,
    residency,
)
from consensuscruncher_tpu_torch.ops import singleton as hamming  # noqa: E402
from consensuscruncher_tpu_torch.ops.duplex import duplex_vote  # noqa: E402
from consensuscruncher_tpu_torch.ops.packing import (  # noqa: E402
    WIRES,
    build_codebook4,
    encode_wire,
    pack4,
    unpack4_device,
    unpack_wire,
)
from consensuscruncher_tpu_torch.parallel.batching import MAX_BATCH, bucket_member_blocks  # noqa: E402
from consensuscruncher_tpu_torch.io.bam import BamWriter  # noqa: E402
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader  # noqa: E402
from consensuscruncher_tpu_torch.stages import dcs_maker, singleton_correction  # noqa: E402
from consensuscruncher_tpu_torch.utils.ragged import scatter_runs  # noqa: E402
from consensuscruncher_tpu_torch.stages.grouping import stream_family_blocks  # noqa: E402
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches  # noqa: E402
from consensuscruncher_tpu_torch.utils.phred import N, NUM_BASES, PAD  # noqa: E402
from consensuscruncher_tpu_torch.utils.simulate import (  # noqa: E402
    SimConfig,
    simulate_bam,
    simulate_bam_fast,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak (NVIDIA data sheet)
INT32_LANES_PER_SM = 64  # Hopper runs int32 adds, compares and selects on 64 lanes per SM

# The vote's integer work, in int32 operations: per member-position folded
# (qual test, select, count, first-seen, agree test, qual add), per output
# position finalized (max, argmin over first-seen, cutoff, cap), and per
# pair-position combined into the DCS (agree tests, select, add, min).  The
# QC rider's per live position (below its family's length): the five lane
# counts summed (4 adds), the disagreement (1 subtract; the top count is the
# finalize's maximum), the length test (1 compare) and the two sums it adds
# into (2 adds).
FOLD_OPS, FINALIZE_OPS, COMBINE_OPS, QC_OPS = 6, 30, 6, 8

VOTE = {"name": "consensus_vote", "route": "cuda",
        "source": "consensuscruncher_tpu_torch/csrc/consensus_vote.cu",
        "replaces": "consensuscruncher_tpu/ops/consensus_pallas.py:139"}
# B1's dense form with the dense rider (the --wire dense vote)
DENSE_VOTE = {**VOTE, "name": "consensus_vote_dense"}
FUSED = {"name": "duplex_members", "route": "cuda",
         "source": "consensuscruncher_tpu_torch/csrc/consensus_vote.cu",
         "replaces": "consensuscruncher_tpu/ops/consensus_pallas.py:163"}
NO_LIBRARY = "no single PyTorch call computes this majority vote"
KERNEL = "vote_tiles_kernel"  # the profiler's name of both forms
# wire bytes the kernel reads per live member-position voted
WIRE_BYTES = {"raw": 2.0, "pack8": 1.0, "pack6": 0.75, "pack4": 0.5}

BINNED = np.array([2, 12, 23, 37], np.uint8)  # tools/tpu_stage_row.py's quals
# more families (or pairs) in one call than one grid dimension holds (65,535)
MANY = 70_000
DENSE_SHAPES = {"B8192_F16_L100": (8192, 16, 100), "B65536_F8_L100": (65536, 8, 100)}
STAGE_PAIRS, STAGE_L, STAGE_BATCHES = 8192, 128, 8


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, name: str, reps: int = 50) -> float | None:
    """Device time per launch of the CUDA kernel ``name`` as the profiler
    reports it, or None when the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if name in e.key]
    total_us = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
                   for e in rows)
    count = sum(e.count for e in rows)
    return total_us / count / 1e3 if count and total_us > 0 else None


def kernel_ms(fn, name: str, reps: int) -> dict:
    """The kernel's time per launch: the profiler's device time when the
    profiler sees the card, else CUDA events over back-to-back launches
    (which can measure the host's launch rate instead); both reported."""
    events_ms = cuda_ms(fn, reps)
    profiler_ms = kernel_device_ms(fn, name)
    return {"ms": profiler_ms if profiler_ms is not None else events_ms,
            "profiler_ms": profiler_ms, "events_ms": events_ms}


def bound(bytes_moved: int, ops: int, rates: dict) -> dict:
    """The least time the card could take: bytes over the memory rate
    against int32 operations over the INT32 rate, the larger of the two."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rates["int32_ops_per_s"] * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_moved, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {"card": smi, "sms": sms, "max_sm_mhz": float(clock),
             "int32_ops_per_s": INT32_LANES_PER_SM * sms * float(clock) * 1e6,
             "hbm_bytes_per_s": HBM_BYTES_PER_S}
    emit("card", **rates)
    return rates


def phase_build() -> None:
    """Build the kernels; report each instantiation of the template
    (``<wire>/sscs``, ``<wire>/sscs_qc`` and ``<wire>/duplex``): registers,
    spills, static and dynamic shared memory per block."""
    t = time.perf_counter()
    so = cuda_lib.build("consensus_vote")
    build_s = time.perf_counter() - t
    with open(so + ".log") as fh:
        log = fh.read()
    consensus_vote._library()  # loads the kernel's layouts
    kernels: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        if "entry function" in line or "Function properties" in line:
            # a noinline device function reports its own properties
            entry = re.search(KERNEL + r"ILi(\d)ELb(\d)ELb(\d)E", line)
            if not entry:
                current = None
                continue
            duplex = entry.group(2) == "1"
            form = "duplex" if duplex else ("sscs_qc" if entry.group(3) == "1" else "sscs")
            current = f"{WIRES[int(entry.group(1))]}/{form}"
            kernels.setdefault(current, {})["dynamic_smem_bytes"] = \
                consensus_vote._layouts[duplex].smem_bytes
        elif current and "registers" in line:
            kernels[current]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            kernels[current]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
        elif current and "spill" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            kernels[current].update(spill_stores=int(stores), spill_loads=int(loads))
    want = {f"{w}/{form}" for w in WIRES for form in ("sscs", "sscs_qc", "duplex")}
    if set(kernels) != want or any("registers" not in k for k in kernels.values()):
        raise AssertionError(f"ptxas report lacks a kernel: {kernels}\n{log}")
    emit("build", source=VOTE["source"], seconds=build_s, ptxas=kernels)


def _check_equal(name, got: torch.Tensor, want: torch.Tensor, errs: list,
                 detail=None) -> None:
    """``got`` equal to ``want`` (on one device), exactly; a mismatch fails
    with its first positions and, through ``detail(row, column)``, what
    decided them."""
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max()) if got.numel() else 0
    errs.append(err)
    if not torch.equal(got, want):
        where = torch.nonzero(got != want)[:5].tolist()
        info = [{"at": w, "got": int(got[tuple(w)]), "want": int(want[tuple(w)]),
                 **(detail(w[-2], w[-1]) if detail is not None else {})} for w in where]
        raise AssertionError(f"{name}: disagrees with its reference (max abs err {err}): "
                             f"{info}")


CONFIGS = [consensus_vote.ConsensusConfig(),
           consensus_vote.ConsensusConfig(cutoff=0.5, qual_threshold=20),
           consensus_vote.ConsensusConfig(cutoff=0.9, qual_threshold=30, qual_cap=45)]


# ---------------------------------------------------------------- SSCS vote


def _stream_case(rng, nf, max_size, length, dev, zero_frac=0.1):
    sizes = rng.integers(1, max_size + 1, nf).astype(np.int32)
    sizes[rng.random(nf) < zero_frac] = 0
    m = int(sizes.sum()) + 7  # trailing dead rows, as the member batches carry
    bases = torch.from_numpy(rng.choice(6, (m, length), p=[.3, .2, .2, .2, .06, .04])
                             .astype(np.uint8)).to(dev)
    quals = torch.from_numpy(rng.integers(0, 42, (m, length), dtype=np.uint8)).to(dev)
    return bases, quals, torch.from_numpy(sizes)


def main_path_batch(bam: str):
    """The first full member batch the SSCS stage would vote on this BAM."""
    reader = open_batch_source(bam)

    def items():
        for kind, block, _reason in stream_family_blocks(reader, reader.header, "|"):
            if kind == "block":
                multi = np.nonzero(block.sizes >= 2)[0]
                if len(multi):
                    yield block, multi, [(block, int(j)) for j in multi]

    try:
        best = None
        for batch in bucket_member_blocks(items()):
            if best is None or batch.n_members > best.n_members:
                best = batch
            if batch.n_real >= MAX_BATCH:
                break
        return best
    finally:
        reader.close()


def phase_vote_kernel(dev, sim_bam: str, rates: dict) -> dict:
    rng = np.random.default_rng(7)
    errs: list[int] = []
    # random stream batches, a >1000-member family, more families than one
    # grid dimension (65535) holds, single-member families
    cases = {
        "stream_random": _stream_case(rng, 4096, 8, 128, dev),
        "stream_family_1500": _stream_case(rng, 5, 1500, 96, dev, zero_frac=0),
        "stream_70000_families": _stream_case(rng, MANY, 3, 40, dev),
        "stream_F1": _stream_case(rng, 512, 1, 64, dev, zero_frac=0),
    }
    for name, (bases, quals, sizes) in cases.items():
        for cfg in CONFIGS:
            for length in (bases.shape[1], bases.shape[1] - 5):
                before = consensus_vote.launches
                got = consensus_vote.vote_members(bases, quals, sizes, cfg, length=length)
                assert consensus_vote.launches == before + 1  # one launch per call
                want = consensus_vote.vote_members_plain(bases, quals, sizes, cfg, length=length)
                _check_equal(f"{name}/{cfg}/L={length}", got, want, errs)
    # dense form and its edge shapes: PAD slots, an all-PAD bucket, 7 of 10
    # at cutoff 0.7, a first-seen tie with a demoted low-qual member
    b, f, length = 512, 16, 128
    dense_b = rng.integers(0, 5, (b, f, length)).astype(np.uint8)
    dense_q = rng.integers(2, 41, (b, f, length)).astype(np.uint8)
    dense_s = rng.integers(0, f + 1, b).astype(np.int32)
    for i in range(b):
        dense_b[i, dense_s[i]:] = PAD
        dense_q[i, dense_s[i]:] = 0
    dense_b[0, :10], dense_q[0, :10], dense_s[0] = 1, 30, 10
    dense_b[0, :7] = 0
    dense_b[1, :3, 0], dense_q[1, :3, 0], dense_s[1] = [2, 3, 1], [30, 30, 10], 3
    dense_b[2:10], dense_q[2:10], dense_s[2:10] = PAD, 0, 0
    for cfg in CONFIGS:
        got = consensus_vote.consensus_batch(torch.from_numpy(dense_b).to(dev),
                                             torch.from_numpy(dense_q).to(dev), dense_s, cfg)
        flat = (torch.from_numpy(dense_b).reshape(b * f, length).to(dev),
                torch.from_numpy(dense_q).reshape(b * f, length).to(dev))
        want = consensus_vote.vote_members_plain(
            *flat, torch.from_numpy(dense_s), cfg,
            starts=torch.arange(b, dtype=torch.int64) * f)
        _check_equal(f"dense/{cfg}", torch.stack(got), want, errs)
        if cfg == CONFIGS[0]:  # 7 of 10 passes at 0.7; empty slots are all N
            assert int(got[0][0].max()) == 0 and int(got[0][2:10].min()) == N

    wire_errs, wire_paths = phase_wire_cases(dev)
    errs += wire_errs

    # the main path's shape: a full batch of the simulated input on the wire
    # the SSCS stage ships, voted over its live families as the stage does
    batch = main_path_batch(sim_bam)
    wire, a, w = consensus_segment.encode_member_batch(batch)
    a_d = torch.from_numpy(a).to(dev)
    book = torch.from_numpy(w)                 # a codebook rides in the launch
    book_d = book.to(dev)                      # the torch decode's lookup table
    b_arg = book_d if wire == "raw" else book  # raw: the quals plane
    sizes = torch.from_numpy(batch.sizes[:batch.n_real])
    out_len = consensus_segment._out_len(batch)
    cfg = consensus_vote.ConsensusConfig()
    got = consensus_vote.vote_wire(wire, a_d, b_arg, sizes, cfg, length=out_len)
    want = consensus_vote.vote_wire_plain(wire, a_d, book_d, sizes, cfg, length=out_len)
    _check_equal("main_path_batch", got, want, errs)
    job = consensus_vote.prepare_wire(wire, a_d, b_arg, sizes, cfg, length=out_len)
    bases, quals = (x.contiguous() for x in unpack_wire(wire, a_d, book_d))
    raw_job = consensus_vote.prepare_wire("raw", bases, quals, sizes, cfg, length=out_len)
    _check_equal("main_path_batch/raw_planes", raw_job()[0], want, errs)
    # the same launch with the QC rider, as the main path makes it (the
    # batch's true lengths); its sums are those of its first call (every
    # call adds into them)
    lengths = torch.from_numpy(batch.lengths[:batch.n_real])
    qc_job = consensus_vote.prepare_wire(wire, a_d, b_arg, sizes, cfg, length=out_len,
                                         qc_lengths=lengths)
    qc_planes = qc_job()[0]
    got_qc = qc_job.qc.clone()
    want_planes, want_qc = consensus_vote.vote_wire_plain(wire, a_d, book_d, sizes, cfg,
                                                          length=out_len, qc_lengths=lengths)
    _check_equal("main_path_batch/qc_planes", qc_planes, want_planes, errs)
    _check_equal("main_path_batch/qc", got_qc, want_qc, errs)

    def kernel():  # the bare launch, its records and tiles already on the card
        job()

    def call():  # as the main path pays it: checks, tile plan, one upload, launch
        consensus_segment.stream_vote(wire, a_d, b_arg, sizes, cfg, out_len)

    def unfused():  # the earlier design's path: torch decode, then the kernel on raw planes
        unpack_wire(wire, a_d, book_d)
        raw_job()

    def unfused_call():
        consensus_vote.vote_members(*unpack_wire(wire, a_d, book_d), sizes, cfg,
                                    length=out_len)

    def plain():
        consensus_vote.vote_wire_plain(wire, a_d, book_d, sizes, cfg, length=out_len)

    def qc_plain():
        consensus_vote.vote_wire_plain(wire, a_d, book_d, sizes, cfg, length=out_len,
                                       qc_lengths=lengths)

    # the launch's fixed cost: the same kernel on the batch's first tile only
    one_tile = consensus_vote.prepare_wire(wire, a_d, b_arg, sizes[:job.plan.fams], cfg,
                                           length=out_len)

    # in turns within this one call
    first = kernel_ms(kernel, KERNEL, 500)
    qc_runs = [kernel_ms(qc_job, KERNEL, 500)]
    one_tile_ms = kernel_ms(one_tile, KERNEL, 500)
    raw_ms = kernel_ms(raw_job, KERNEL, 500)
    unfused_runs = [cuda_ms(unfused, 200)]
    plain_runs = [cuda_ms(plain, 20), cuda_ms(plain, 20)]
    qc_plain_ms = min(cuda_ms(qc_plain, 20), cuda_ms(qc_plain, 20))
    unfused_runs.append(cuda_ms(unfused, 200))
    qc_runs.append(kernel_ms(qc_job, KERNEL, 500))
    again = kernel_ms(kernel, KERNEL, 500)
    call_runs = [cuda_ms(call, 200), cuda_ms(unfused_call, 200)]
    call_runs += [cuda_ms(unfused_call, 200), cuda_ms(call, 200)]
    nf, m = int(sizes.shape[0]), int(batch.n_members)
    # least work: the wire bytes of each live member-position voted read
    # once, each live family's output (base + qual) written once; with the
    # rider also each family's length read and the (2, out_len) int32 sums
    # written once, and the rider's operations at each family's positions
    # below its length
    live = int(torch.clamp(lengths, max=out_len).sum())
    qc_bound = bound(int(WIRE_BYTES[wire] * m * out_len) + 2 * nf * out_len + 4 * nf
                     + 8 * out_len,
                     FOLD_OPS * m * out_len + FINALIZE_OPS * nf * out_len + QC_OPS * live,
                     rates)
    rider_bound = bound(4 * nf + 8 * out_len, QC_OPS * live, rates)
    qc_row = {"ms": min(r["ms"] for r in qc_runs), "runs": qc_runs,
              "plain_ms": qc_plain_ms, "bound_ms": qc_bound["bound_ms"],
              "bound_by": qc_bound["bound_by"], "bound": qc_bound,
              "rider_bound_ms": rider_bound["bound_ms"], "rider_bound": rider_bound}
    row = {
        "ms": min(first["ms"], again["ms"]), "runs": [first, again], "qc": qc_row,
        "raw_planes_ms": raw_ms["ms"], "one_tile_ms": one_tile_ms["ms"],
        "unfused_ms": min(unfused_runs),
        "unfused_runs": unfused_runs, "call_ms": min(call_runs[0], call_runs[3]),
        "unfused_call_ms": min(call_runs[1], call_runs[2]), "call_runs": call_runs,
        "plain_ms": min(plain_runs), "plain_runs": plain_runs,
        **bound(int(WIRE_BYTES[wire] * m * out_len) + 2 * nf * out_len,
                FOLD_OPS * m * out_len + FINALIZE_OPS * nf * out_len, rates),
        "max_abs_err": max(errs), "comparisons": len(errs),
        "path": job.plan.summary(), "wire_case_paths": wire_paths,
        "shape": {"wire": wire, "families": nf, "members": m, "L": int(bases.shape[1]),
                  "out_len": out_len, "qc_live_positions": live},
    }
    emit("kernels", kernel=VOTE["name"], **row)
    return row


def _wire_planes(rng, wire, sizes, length, pad_rows=9):
    """A member stream for ``sizes`` that ``wire`` can carry (ACGT on the
    2-bit wires, A C G T N PAD on raw and pack8; quals from a codebook the
    wire holds), encoded on the host."""
    m = int(sizes.sum()) + pad_rows
    top = 4 if wire in ("pack4", "pack6") else 6
    bases = rng.integers(0, top, (m, length), dtype=np.uint8)
    levels = {"raw": np.arange(42, dtype=np.uint8),
              "pack8": np.arange(5, 41, 3, dtype=np.uint8),
              "pack6": np.arange(8, 40, 2, dtype=np.uint8), "pack4": BINNED}[wire]
    return encode_wire(wire, bases, rng.choice(levels, (m, length)).astype(np.uint8))


def _wire_args(dev, wire, a, b):
    """The kernel's arguments (a codebook stays on the host) and the plain
    version's (everything on the card)."""
    a_d, b_d = torch.from_numpy(np.ascontiguousarray(a)).to(dev), torch.from_numpy(b).to(dev)
    return (a_d, b_d if wire == "raw" else torch.from_numpy(b)), (a_d, b_d)


def _wire_edge_sizes(rng, case):
    """``(sizes, length)`` of one tile-edge case."""
    if case == "straddling_budget":  # families around half a stage's bytes
        sizes = rng.integers(1, 6, 3000)
        sizes[[10, 11, 500, 1500, 2999]] = [20, 30, 48, 64, 70]
        return sizes, 128
    if case == "zeros_at_tile_edges":
        sizes = rng.integers(0, 4, 5000)
        sizes[::37] = 0
        sizes[:50] = 0
        sizes[-50:] = 0
        return sizes, 128
    if case == "not_a_tile_multiple":  # a prime count of families
        return rng.integers(1, 9, 4099), 128
    if case == "families_70000":
        return rng.integers(0, 4, MANY), 40
    if case == "family_1500":  # over the packed tally: the direct path
        sizes = rng.integers(0, 5, 400)
        sizes[[0, 200]] = [1500, 257]
        return sizes, 96
    if case == "rows_L100":  # rows not a multiple of 16 bytes
        return rng.integers(0, 7, 3000), 100
    if case == "rows_L640":  # past the QC rider's shared-memory sums
        return rng.integers(0, 6, 800), 640
    raise KeyError(case)


WIRE_CASES = ("straddling_budget", "zeros_at_tile_edges", "not_a_tile_multiple",
              "families_70000", "family_1500", "rows_L100", "rows_L640")


def phase_wire_cases(dev) -> tuple[list[int], dict]:
    """B1 on every wire at the tile edges, against the plain version on the
    card: three configs, two vote lengths, one launch per call; each call
    again with the QC rider over per-family true lengths that differ inside
    the batch (a tenth of them 0), planes and rider sums exact."""
    errs: list[int] = []
    qc_errs: list[int] = []
    paths: dict[str, dict] = {}
    for wire in WIRES:
        for case in WIRE_CASES:
            rng = np.random.default_rng(WIRES.index(wire) * 100 + WIRE_CASES.index(case))
            sizes, length = _wire_edge_sizes(rng, case)
            sizes = torch.from_numpy(sizes.astype(np.int64))
            kargs, pargs = _wire_args(dev, wire, *_wire_planes(rng, wire, sizes.numpy(), length))
            lengths = rng.integers(length // 3, length + 1, sizes.shape[0])
            lengths[rng.random(sizes.shape[0]) < 0.1] = 0
            for cfg in CONFIGS:
                for out_len in (length, length - 5):
                    before = consensus_vote.launches
                    got = consensus_vote.vote_wire(wire, *kargs, sizes, cfg, out_len)
                    assert consensus_vote.launches == before + 1  # one launch per call
                    want = consensus_vote.vote_wire_plain(wire, *pargs, sizes, cfg, out_len)
                    _check_equal(f"{wire}/{case}/{cfg}/L={out_len}", got, want, errs)
                    live = torch.from_numpy(np.minimum(lengths, out_len))
                    before = consensus_vote.qc_launches
                    got, got_qc = consensus_vote.vote_wire(wire, *kargs, sizes, cfg, out_len,
                                                           qc_lengths=live)
                    assert consensus_vote.qc_launches == before + 1
                    _, want_qc = consensus_vote.vote_wire_plain(wire, *pargs, sizes, cfg, out_len,
                                                                qc_lengths=live)
                    _check_equal(f"{wire}/{case}/{cfg}/L={out_len}/qc_planes", got, want, errs)
                    _check_equal(f"{wire}/{case}/{cfg}/L={out_len}/qc", got_qc, want_qc, qc_errs)
                    if not int(want_qc[1].sum()):
                        raise AssertionError(f"{wire}/{case}: the rider saw no disagreement")
            paths[f"{wire}/{case}"] = consensus_vote.last_plan.summary()
    if paths["pack6/family_1500"]["direct"] < 2:
        raise AssertionError(f"the 1,500-member family did not take the direct path: "
                             f"{paths['pack6/family_1500']}")
    emit("wire_cases", comparisons=len(errs), max_abs_err=max(errs), paths=paths,
         qc_comparisons=len(qc_errs), qc_max_abs_err=max(qc_errs))
    return errs + qc_errs, paths


# --------------------------------------------------------- fused duplex vote


def _dense_strand(rng, b, f, length, empty=()):
    bases = rng.integers(0, 4, (b, f, length)).astype(np.uint8)
    quals = rng.integers(2, 41, (b, f, length)).astype(np.uint8)
    sizes = rng.integers(1, f + 1, b).astype(np.int32)
    sizes[list(empty)] = 0
    for i in range(b):
        bases[i, sizes[i]:] = PAD
        quals[i, sizes[i]:] = 0
    return bases, quals, sizes


def _fused_dense_cases(rng):
    """The dense edge cases of tests/test_pallas.py, at card-sized batches."""
    cases = {}
    for b, f, length in ((512, 16, 100), (1000, 4, 33), (3, 2, 64)):
        cases[f"dense_{b}x{f}x{length}"] = (*_dense_strand(rng, b, f, length),
                                            *_dense_strand(rng, b, f, length))
    for name, ea, eb in (("size0_a", range(0, 256, 2), ()), ("size0_b", (), range(0, 256, 3)),
                         ("size0_both", range(0, 256, 2), range(0, 256, 2))):
        cases[name] = (*_dense_strand(rng, 256, 8, 100, ea), *_dense_strand(rng, 256, 8, 100, eb))
    ones = np.ones(256, np.int32)
    cases["F1"] = (rng.integers(0, 4, (256, 1, 100)).astype(np.uint8),
                   rng.integers(2, 41, (256, 1, 100)).astype(np.uint8), ones,
                   rng.integers(0, 4, (256, 1, 100)).astype(np.uint8),
                   rng.integers(2, 41, (256, 1, 100)).astype(np.uint8), ones.copy())
    for winners in (7, 8):  # 7 and 8 of 10 at cutoff 0.7
        ba = np.zeros((16, 10, 64), np.uint8)
        ba[:, winners:] = 2
        qa = np.full((16, 10, 64), 30, np.uint8)
        tens = np.full(16, 10, np.int32)
        cases[f"cutoff_{winners}_of_10"] = (ba, qa, tens, ba.copy(), qa.copy(), tens.copy())
    tie_b = np.array([[[2, 0], [3, 0], [1, 0], [PAD, PAD]]] * 64, np.uint8)
    tie_q = np.array([[[30, 30], [30, 30], [10, 30], [0, 0]]] * 64, np.uint8)
    threes = np.full(64, 3, np.int32)
    cases["tie_demoted"] = (tie_b, tie_q, threes, tie_b[:, [1, 0, 2, 3]].copy(), tie_q,
                            threes.copy())
    return cases


def _fused_check(name, got, want, errs):
    _check_equal(name, torch.stack(list(got)) if isinstance(got, tuple) else got, want, errs)


def phase_fused_cases(dev) -> list[int]:
    rng = np.random.default_rng(17)
    errs: list[int] = []
    t = torch.from_numpy
    for name, (ba, qa, sa, bb, qb, sb) in _fused_dense_cases(rng).items():
        b, f, length = ba.shape
        starts = torch.arange(b, dtype=torch.int64) * f
        for cfg in CONFIGS:
            before = consensus_vote.fused_launches
            got = consensus_vote.duplex_batch(t(ba).to(dev), t(qa).to(dev), sa,
                                              t(bb).to(dev), t(qb).to(dev), sb, cfg)
            assert consensus_vote.fused_launches == before + 1  # one launch per call
            want = consensus_vote.duplex_members_plain(
                t(ba).reshape(b * f, length).to(dev), t(qa).reshape(b * f, length).to(dev),
                t(sa), t(bb).reshape(b * f, length).to(dev),
                t(qb).reshape(b * f, length).to(dev), t(sb), cfg,
                starts_a=starts, starts_b=starts)
            _fused_check(f"{name}/{cfg}", got, want, errs)
            if name == "cutoff_7_of_10" and cfg == CONFIGS[0]:
                assert int(got[4].max()) == 0  # 7 of 10 passes on both strands
            if name.startswith("size0") and name != "size0_b":
                assert bool((got[4][::2] == N).all())  # a missing strand: DCS N
    # stream form: one member stream, strand A families then strand B's, with
    # a 1,500-member family, and more pairs than one grid dimension holds
    for name, n_pairs, max_size, length in (("stream_family_1500", 5, 8, 96),
                                            ("stream_70000_pairs", MANY, 3, 40)):
        sizes = rng.integers(0, max_size + 1, 2 * n_pairs).astype(np.int32)
        if name == "stream_family_1500":
            sizes[[0, n_pairs + 1]] = [1500, 1200]
        m = int(sizes.sum()) + 7
        bases = t(rng.choice(6, (m, length), p=[.3, .2, .2, .2, .06, .04]).astype(np.uint8)).to(dev)
        quals = t(rng.integers(0, 42, (m, length), dtype=np.uint8)).to(dev)
        starts = torch.cumsum(t(sizes).long(), 0) - t(sizes).long()
        args = (bases, quals, t(sizes[:n_pairs]), bases, quals, t(sizes[n_pairs:]))
        for cfg in CONFIGS:
            for vote_len in (length, length - 5):
                before = consensus_vote.fused_launches
                got = consensus_vote.duplex_members(*args, cfg, vote_len,
                                                    starts[:n_pairs], starts[n_pairs:])
                assert consensus_vote.fused_launches == before + 1
                want = consensus_vote.duplex_members_plain(*args, cfg, vote_len,
                                                           starts[:n_pairs], starts[n_pairs:])
                _fused_check(f"{name}/{cfg}/L={vote_len}", got, want, errs)
    # every wire: planes, packed_out planes and stats against the plain
    # version on the card (torch decode, plain votes, duplex_stats)
    paths = {}
    for wire in WIRES:
        for name, n_pairs, length in (("family_1500", 3000, 128), ("pairs_70000", MANY, 40)):
            sizes = np.concatenate([rng.integers(0, 8 if n_pairs < 10000 else 4, n_pairs),
                                    rng.integers(0, 8 if n_pairs < 10000 else 4, n_pairs)])
            sizes[n_pairs + 3::16] = 0
            if name == "family_1500":
                sizes[[0, n_pairs + 7]] = [1500, 300]
            sizes = t(sizes.astype(np.int64))
            kargs, pargs = _wire_args(dev, wire, *_wire_planes(rng, wire, sizes.numpy(), length))
            for cfg in CONFIGS:
                for packed_out in (False, True):
                    before = consensus_vote.fused_launches
                    got, stats = consensus_vote.duplex_wire(wire, *kargs, sizes, cfg, length - 3,
                                                            packed_out=packed_out)
                    assert consensus_vote.fused_launches == before + 1
                    want, want_stats = consensus_vote.duplex_wire_plain(
                        wire, *pargs, sizes, cfg, length - 3, packed_out=packed_out)
                    label = f"{wire}/{name}/{cfg}/packed_out={packed_out}"
                    _check_equal(label, got, want, errs)
                    _check_equal(f"{label}/stats", stats, want_stats, errs)
            paths[f"{wire}/{name}"] = consensus_vote.last_plan.summary()
    emit("fused_cases", comparisons=len(errs), max_abs_err=max(errs), paths=paths)
    return errs


class _Strands:
    """Two raw strands on the card as the bare launches take them: the fused
    kernel's launch and, for the unfused chain, one SSCS launch per strand,
    each planned and uploaded once at the default config."""

    def __init__(self, ba, qa, sa, bb, qb, sb, starts_a, starts_b, length):
        cfg = consensus_vote.ConsensusConfig()
        self.length = length
        self.host = [(ba, qa, torch.as_tensor(sa), torch.as_tensor(starts_a)),
                     (bb, qb, torch.as_tensor(sb), torch.as_tensor(starts_b))]
        (ba, qa, sa, st_a), (bb, qb, sb, st_b) = self.host
        self.job = consensus_vote.prepare_duplex_members(ba, qa, sa, bb, qb, sb, cfg, length,
                                                         st_a, st_b)
        self.sscs = [consensus_vote.prepare_wire("raw", b, q, sz, cfg, length, st)
                     for b, q, sz, st in self.host]

    def kernel(self):
        return self.job()[0]

    def plain(self):
        (ba, qa, sa, st_a), (bb, qb, sb, st_b) = self.host
        return consensus_vote.duplex_members_plain(ba, qa, sa, bb, qb, sb,
                                                   consensus_vote.ConsensusConfig(),
                                                   self.length, st_a, st_b)

    def chain(self):
        """The unfused chain: the SSCS kernel per strand, then the duplex
        combine (the port's counterpart of the JAX bench's resident_chain)."""
        va, vb = (job()[0] for job in self.sscs)
        return (va, vb, *duplex_vote(va[0], va[1], vb[0], vb[1],
                                     qual_cap=int(consensus_vote.ConsensusConfig().qual_cap)))


def _fused_timing(strands: _Strands, length, live_members, pairs, rates, errs, label,
                  plain_reps=5):
    """Time the bare fused launch against its plain version and the chain,
    in turns (kernel, plain, chain, chain, plain, kernel), and bound it."""
    got = strands.kernel()
    _check_equal(label, got, strands.plain(), errs)
    va, vb, dcs_b, dcs_q = strands.chain()
    _check_equal(f"{label}/chain", torch.stack([va[0], va[1], vb[0], vb[1], dcs_b, dcs_q]),
                 got, errs)
    first = kernel_ms(strands.kernel, KERNEL, 200)
    plain_ms = cuda_ms(strands.plain, plain_reps)
    chain_ms = cuda_ms(strands.chain, 50)
    chain_ms_again = cuda_ms(strands.chain, 50)
    plain_ms_again = cuda_ms(strands.plain, plain_reps)
    again = kernel_ms(strands.kernel, KERNEL, 200)
    # least work: each live member-position of both strands read once (raw
    # wire: base + qual), the six output planes written once
    return {
        "ms": min(first["ms"], again["ms"]), "runs": [first, again],
        "plain_ms": min(plain_ms, plain_ms_again), "plain_runs": [plain_ms, plain_ms_again],
        "chain_ms": min(chain_ms, chain_ms_again), "chain_runs": [chain_ms, chain_ms_again],
        "library_ms": None, "library_note": NO_LIBRARY, "path": strands.job.plan.summary(),
        **bound(int(WIRE_BYTES["raw"] * live_members * length) + 6 * pairs * length,
                FOLD_OPS * live_members * length
                + (2 * FINALIZE_OPS + COMBINE_OPS) * pairs * length, rates),
    }


def phase_fused_dense(dev, tag, rates, errs) -> dict:
    """The JAX device bench's fused_pallas / resident_chain rows at one
    shape: its inputs (seed 7), strand B from seed 11."""
    b, f, length = DENSE_SHAPES[tag]
    rng = np.random.default_rng(7)
    ba = rng.integers(0, 4, (b, f, length)).astype(np.uint8)
    qa = rng.integers(20, 41, (b, f, length)).astype(np.uint8)
    sa = rng.integers(1, f + 1, (b,)).astype(np.int32)
    rng = np.random.default_rng(11)
    bb = rng.integers(0, 4, (b, f, length)).astype(np.uint8)
    qb = rng.integers(20, 41, (b, f, length)).astype(np.uint8)
    sb = rng.integers(1, f + 1, (b,)).astype(np.int32)
    planes = [torch.from_numpy(x).reshape(b * f, length).to(dev) for x in (ba, qa, bb, qb)]
    starts = torch.arange(b, dtype=torch.int64) * f
    strands = _Strands(planes[0], planes[1], sa, planes[2], planes[3], sb, starts, starts,
                       length)
    row = _fused_timing(strands, length, int(sa.sum() + sb.sum()), b, rates, errs,
                        f"dense/{tag}")
    row["shape"] = {"B": b, "F": f, "L": length, "wire": "raw",
                    "device_bytes": 4 * b * f * length}
    emit("fused_timing", kernel=FUSED["name"], tag=tag, **row)
    return row


def stage_loop_batches():
    """tools/tpu_stage_row.py's workload: eight batches of 8,192 duplex
    pairs, geometric mean-4 family sizes clipped at 16, every 16th strand-B
    slot empty, L 128, quals from four bins (seed 23)."""
    rng = np.random.default_rng(23)
    batches = []
    for _ in range(STAGE_BATCHES):
        sizes_a = np.minimum(1 + rng.geometric(1.0 / 4.0, STAGE_PAIRS), 16).astype(np.int32)
        sizes_b = np.minimum(1 + rng.geometric(1.0 / 4.0, STAGE_PAIRS), 16).astype(np.int32)
        sizes_b[::16] = 0
        seg = np.concatenate([sizes_a, sizes_b])
        m = int(seg.sum())
        rows = rng.integers(0, 4, (m, STAGE_L)).astype(np.uint8)
        qrows = BINNED[rng.integers(0, 4, (m, STAGE_L))]
        batches.append((sizes_a, sizes_b, rows, qrows))
    return build_codebook4(BINNED), batches


def _check_step(i, step_out, plain, sizes_a, sizes_b, errs) -> None:
    """One ``segment_duplex_step(packed_out=True)`` output on the host
    against the plain version's six planes of the same batch: the packed
    SSCS pair and both quals exactly, the DCS derived from them equal to the
    plain DCS, and the stats equal to a numpy count of the plain planes."""
    packed, qa, qb, stats = step_out
    sscs_a, pqa, sscs_b, pqb, dcs, dq = plain
    want_packed = sscs_a | sscs_b << 3
    for name, got, want in (("packed", packed, want_packed), ("qa", qa, pqa), ("qb", qb, pqb)):
        _check_equal(f"stage/batch{i}/step_{name}", torch.from_numpy(got),
                     torch.from_numpy(want), errs)
    derived = consensus_segment.derive_host_outputs(packed, qa, qb, sizes_a, sizes_b)
    _check_equal(f"stage/batch{i}/derived", torch.from_numpy(np.stack(derived)),
                 torch.from_numpy(plain), errs)
    both = (sizes_a > 0) & (sizes_b > 0)
    want_stats = [int(((sizes_a > 0) | (sizes_b > 0)).sum()), int(both.sum()),
                  int((dcs[both] == N).sum()), int(dq[both].astype(np.int64).sum())]
    if stats.tolist() != want_stats:
        raise AssertionError(f"stage batch {i}: step stats {stats.tolist()} != "
                             f"numpy count {want_stats}")


def phase_fused_stage(dev, rates, errs, book, batches) -> tuple[dict, list]:
    """The stage loop prestaged on the card: packed batches uploaded first,
    then, in turns over the same eight batches: the bare fused launch, the
    step (``segment_duplex_step``: checks, tile plan, one upload, one launch
    that decodes pack4 and folds the stats), the unfused chain (torch
    unpack4, the SSCS kernel per strand on the raw planes, ``duplex_vote``)
    and the plain version (torch decode, plain votes, ``duplex_stats``)."""
    step = consensus_segment.segment_duplex_step(STAGE_PAIRS, STAGE_L, packed_out=True)
    book_h = torch.from_numpy(book)   # the kernel takes the codebook by value
    book_d = book_h.to(dev)           # the torch decode's lookup table
    cfg = consensus_vote.ConsensusConfig()
    staged = [(torch.from_numpy(pack4(rows, qrows, book)).to(dev),
               torch.from_numpy(np.concatenate([sa, sb])))
              for sa, sb, rows, qrows in batches]
    torch.cuda.synchronize()
    outs = [step(p, s, book_h) for p, s in staged]
    torch.cuda.synchronize()
    reference = [[x.cpu().numpy() for x in o] for o in outs]

    # each step's output (the packed SSCS pair, the quals, the stats) is
    # held against the plain version of the same batch and a numpy count;
    # the bare launch and the chain against the step
    jobs, chains, live = [], [], 0
    for i, ((sa, sb, _rows, _qrows), (packed, sizes)) in enumerate(zip(batches, staged)):
        job = consensus_vote.prepare_duplex_wire("pack4", packed, book_h, sizes, cfg, STAGE_L,
                                                 packed_out=True)
        jobs.append(job)
        live += int(sa.sum() + sb.sum())
        plain, plain_stats = consensus_vote.duplex_wire_plain("pack4", packed, book_d, sizes,
                                                              cfg, STAGE_L)
        _check_step(i, reference[i], plain.cpu().numpy(), sa, sb, errs)
        _check_equal(f"stage/batch{i}/plain_stats", torch.from_numpy(reference[i][3]),
                     plain_stats.cpu(), errs)
        got, got_stats = job()
        for k in range(3):
            _check_equal(f"stage/batch{i}/bare{k}", got[k], outs[i][k], errs)
        _check_equal(f"stage/batch{i}/bare_stats", got_stats, outs[i][3], errs)
        bases, quals = unpack4_device(packed, book_d, STAGE_L)
        starts = torch.cumsum(sizes.long(), 0) - sizes.long()
        chain = _Strands(bases, quals, sa, bases, quals, sb, starts[:STAGE_PAIRS],
                         starts[STAGE_PAIRS:], STAGE_L)
        chains.append((packed, chain))
        va, vb, dcs_b, dcs_q = chain.chain()
        _check_equal(f"stage/batch{i}/chain", torch.stack([va[0], va[1], vb[0], vb[1], dcs_b,
                                                           dcs_q]), plain, errs)
    path = jobs[0].plan.summary()

    def bare():
        return [job() for job in jobs]

    def loop():
        return [step(p, s, book_h) for p, s in staged]

    def chain():
        out = []
        for packed, c in chains:
            unpack4_device(packed, book_d, STAGE_L)
            out.append(c.chain())
        return out

    def plain():
        return [consensus_vote.duplex_wire_plain("pack4", p, book_d, s, cfg, STAGE_L,
                                                 packed_out=True) for p, s in staged]

    def bare_ms():
        events = cuda_ms(bare, 20) / STAGE_BATCHES
        profiler = kernel_device_ms(bare, KERNEL, 20)
        return {"ms": profiler if profiler is not None else events,
                "profiler_ms": profiler, "events_ms": events}

    # in turns: bare, step, chain, plain, plain, chain, step, bare (per batch)
    first = bare_ms()
    loop_runs = [cuda_ms(loop, 10) / STAGE_BATCHES]
    chain_runs = [cuda_ms(chain, 10) / STAGE_BATCHES]
    plain_runs = [cuda_ms(plain, 2) / STAGE_BATCHES, cuda_ms(plain, 2) / STAGE_BATCHES]
    chain_runs.append(cuda_ms(chain, 10) / STAGE_BATCHES)
    loop_runs.append(cuda_ms(loop, 10) / STAGE_BATCHES)
    again = bare_ms()
    pairs, per_batch = STAGE_PAIRS, live / STAGE_BATCHES
    # least work per batch: the pack4 wire of each live member-position read
    # once, the three packed_out planes written once
    row = {"ms": min(first["ms"], again["ms"]), "runs": [first, again],
           "loop_ms": min(loop_runs), "loop_runs": loop_runs,
           "chain_ms": min(chain_runs), "chain_runs": chain_runs,
           "plain_ms": min(plain_runs), "plain_runs": plain_runs,
           "library_ms": None, "library_note": NO_LIBRARY, "path": path,
           **bound(int(WIRE_BYTES["pack4"] * per_batch * STAGE_L) + 3 * pairs * STAGE_L,
                   int(FOLD_OPS * per_batch * STAGE_L)
                   + (2 * FINALIZE_OPS + COMBINE_OPS) * pairs * STAGE_L, rates)}
    families = sum(int((sa > 0).sum() + (sb > 0).sum()) for sa, sb, _r, _q in batches)
    row.update(families=families, reads=live,
               families_per_s_loop=families / (row["loop_ms"] * STAGE_BATCHES / 1e3),
               shape={"batches": STAGE_BATCHES, "pairs": STAGE_PAIRS, "L": STAGE_L,
                      "wire": "pack4", "packed_out": True})
    emit("fused_timing", kernel=FUSED["name"], tag="stage_loop", **row)
    return row, reference


def phase_fused_path(dev, book, batches, reference) -> dict:
    """The fused path as a user drives it: ``run_duplex_pipelined`` over
    the stage-loop batches (chunks of 8,192 pairs, host pack4, pinned
    uploads and downloads), counts set to 0 just before and read just after;
    its outputs must equal the prestaged loop's."""
    rows = np.concatenate([r[:int(sa.sum())] for sa, _sb, r, _q in batches]
                          + [r[int(sa.sum()):] for sa, _sb, r, _q in batches])
    qrows = np.concatenate([q[:int(sa.sum())] for sa, _sb, _r, q in batches]
                           + [q[int(sa.sum()):] for sa, _sb, _r, q in batches])
    sizes_a = np.concatenate([sa for sa, _sb, _r, _q in batches])
    sizes_b = np.concatenate([sb for _sa, sb, _r, _q in batches])
    torch.cuda.synchronize()
    consensus_vote.launches = consensus_vote.fused_launches = 0
    t = time.perf_counter()
    out = consensus_segment.run_duplex_pipelined(rows, qrows, sizes_a, sizes_b, book,
                                                 chunk_pairs=STAGE_PAIRS, device=dev)
    wall = time.perf_counter() - t
    launches = consensus_vote.fused_launches
    if launches == 0:
        raise AssertionError("the fused path never launched the fused kernel")
    stats = np.zeros(4, np.int64)
    for i, (pk, qa, qb, st) in enumerate(reference):
        sl = slice(i * STAGE_PAIRS, (i + 1) * STAGE_PAIRS)
        derived = consensus_segment.derive_host_outputs(pk, qa, qb, sizes_a[sl], sizes_b[sl])
        for got, want in zip(out[:6], derived):
            if not np.array_equal(got[sl], want):
                raise AssertionError(f"pipelined run differs from the prestaged loop, batch {i}")
        stats += st
    if not np.array_equal(out[6], stats):
        raise AssertionError(f"pipelined stats {out[6]} != prestaged {stats}")
    row = {"wall_s": wall, "fused_launches": launches, "sscs_launches": consensus_vote.launches,
           "pairs": int(sizes_a.shape[0]), "stats": out[6].tolist(),
           "pairs_per_s": sizes_a.shape[0] / wall}
    emit("fused_path", **row)
    return row


# ---------------------------------------------------------------- main path


def _bam_sha256(base: str, exts=(".bam",)) -> dict:
    out = {}
    for root, _dirs, files in os.walk(base):
        for f in files:
            if f.endswith(exts):
                with open(os.path.join(root, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(root, f), base)] = \
                        hashlib.sha256(fh.read()).hexdigest()
    return out


def _qc_doc(base: str) -> dict:
    with open(os.path.join(base, "qc.json")) as fh:
        return json.load(fh)


def phase_goldens(dev) -> dict:
    """The committed BAMs: goldens, each card run's qc.json against the
    port's own CPU run's, residency on against off, and streaming with taps
    against staged (the whole tree, indexes included)."""
    golden = json.load(open(os.path.join(REPO, "test", "golden.json")))
    out = {}
    consensus_vote.launches = consensus_vote.qc_launches = 0
    residency.pair_votes = residency.against_votes = 0
    runs = (("sample.bam", "consensus", "golden", "True", "staged"),
            ("sample.bam", "consensus", "golden", "False", "staged"),
            ("sample.bam", "consensus", "golden", "True", "streaming"),
            ("sample_adversarial.bam", "consensus_adversarial", "golden_adv", "True", "staged"),
            ("sample_bcerr.bam", "consensus_bcerr_exact", "golden_bcerr", "True", "staged"))
    trees = {}
    for bam, section, name, resident, pipeline in runs:
        work = tempfile.mkdtemp(dir=os.path.join(REPO, ".scratch"))
        argv = ["consensus", "-i", os.path.join(REPO, "test", "data", bam), "-o", work,
                "-n", name, "--scorrect", "True", "--residency", resident,
                "--pipeline", pipeline, "--intermediate_taps", "True"]
        t = time.perf_counter()
        res = cli_main(argv + ["--device", dev.type])
        wall = time.perf_counter() - t
        if res["pipeline"] != pipeline:
            raise AssertionError(f"{bam}: asked for {pipeline}, ran {res['pipeline']}")
        base = os.path.join(work, name)
        bad = golden_mismatches(base, golden[section])
        trees[(bam, resident, pipeline)] = _bam_sha256(base, (".bam", ".bai"))
        card_qc = _qc_doc(base)
        qc_equal = None
        if resident == "True" and pipeline == "staged":
            # the reference of the card's qc.json: the port's plain versions
            cli_main(argv + ["--device", "cpu", "-o", os.path.join(work, "cpu")])
            qc_equal = card_qc == _qc_doc(os.path.join(work, "cpu", name))
        shutil.rmtree(work)
        if bad:
            raise AssertionError(f"{bam} (residency {resident}, {pipeline}): outputs diverge "
                                 f"from {section} goldens: {bad}")
        if qc_equal is False:
            raise AssertionError(f"{bam}: the card's qc.json differs from the CPU run's")
        if not card_qc["plane"] or not card_qc["plane"]["total_votes"]:
            raise AssertionError(f"{bam}: qc.json has no vote plane")
        out[f"{bam}/residency={resident}/{pipeline}"] = wall
        emit("goldens", input=bam, residency=resident, pipeline=pipeline,
             digests=len(golden[section]), wall_s=wall, qc_equal_to_cpu=qc_equal,
             qc_total_votes=card_qc["plane"]["total_votes"],
             qc_positions=card_qc["plane"]["positions"])
    staged = trees[("sample.bam", "True", "staged")]
    if {k: v for k, v in staged.items() if k.endswith(".bam")} != \
            {k: v for k, v in trees[("sample.bam", "False", "staged")].items()
             if k.endswith(".bam")}:
        raise AssertionError("sample.bam: --residency True and False wrote different BAMs")
    if trees[("sample.bam", "True", "streaming")] != staged:
        raise AssertionError("sample.bam: streaming with taps wrote another tree than staged")
    if consensus_vote.launches == 0 or consensus_vote.qc_launches != consensus_vote.launches:
        raise AssertionError(f"the golden runs launched the vote kernel {consensus_vote.launches} "
                             f"times, {consensus_vote.qc_launches} with the QC rider")
    if residency.pair_votes == 0 or residency.against_votes == 0:
        raise AssertionError("the golden runs never voted from the resident store")
    emit("residency_parity", input="sample.bam", bams=len(staged), identical=True)
    emit("streaming_parity", input="sample.bam", files=len(staged), identical=True)
    return out


def _synced_timer(owner, attr: str, acc: dict, key: str, calls: dict | None = None):
    """Wrap ``owner.attr`` so each call is bracketed by synchronises and
    its wall added to ``acc[key]`` (and, given ``calls``, counted in
    ``calls[key]``); returns the restore function."""
    fn = getattr(owner, attr)
    acc[key] = 0.0
    if calls is not None:
        calls[key] = 0

    def timed(*args, **kwargs):
        if calls is not None:
            calls[key] += 1
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        acc[key] += time.perf_counter() - t
        return out

    setattr(owner, attr, timed)
    return lambda: setattr(owner, attr, fn)


def phase_scale(dev, sim_bam: str, truth, work: str, card: str) -> dict:
    # device-side walls: the SSCS unpack + vote calls, the duplex votes of
    # rescue and DCS by upload, and the resident ones by gather (transfers
    # included)
    device_s: dict[str, float] = {}
    restores = [
        _synced_timer(consensus_segment, "stream_vote", device_s, "vote_s"),
        _synced_timer(dcs_maker, "duplex_batch_host", device_s, "duplex_upload_s"),
        _synced_timer(residency.ResidentPlanes, "duplex_pairs", device_s, "resident_pairs_s"),
        _synced_timer(residency.ResidentPlanes, "duplex_against", device_s,
                      "resident_against_s"),
    ]
    argv = ["consensus", "-i", sim_bam, "-o", work, "-n", "sim", "--scorrect", "True",
            "--device", dev.type]
    consensus_vote.launches = consensus_vote.qc_launches = consensus_vote.fused_launches = 0
    residency.pair_votes = residency.against_votes = 0
    t = time.perf_counter()
    res = cli_main(argv)
    wall = time.perf_counter() - t
    launches, qc_launches = consensus_vote.launches, consensus_vote.qc_launches
    pair_votes, against_votes = residency.pair_votes, residency.against_votes
    for restore in restores:
        restore()
    if launches == 0:
        raise AssertionError("the main path never launched the vote kernel")
    if qc_launches != launches:
        raise AssertionError(f"{launches - qc_launches} of the main path's {launches} SSCS "
                             "launches ran without the QC rider")
    if pair_votes == 0 or against_votes == 0:
        raise AssertionError(f"the main path voted too little from the resident store "
                             f"(pairs {pair_votes}, rescues {against_votes})")
    stats = json.load(open(os.path.join(work, "sim", "sscs", "sim.sscs_stats.json")))
    dcs = json.load(open(os.path.join(work, "sim", "dcs", "sim.dcs_stats.json")))
    if stats["total_reads"] != truth.n_reads or stats.get("bad_reads", 0):
        raise AssertionError(f"SSCS saw {stats['total_reads']} reads, simulated {truth.n_reads}")
    if not stats["sscs_written"] or not dcs.get("dcs_written"):
        raise AssertionError("the simulated run wrote no SSCS or no DCS")
    for key in ("all_sscs", "all_dcs"):
        if not os.path.exists(res[key] + ".bai"):
            raise AssertionError(f"{key} has no index")
    base = os.path.join(work, "sim")
    qc_doc = _qc_doc(base)
    if not qc_doc["plane"] or not qc_doc["plane"]["total_votes"]:
        raise AssertionError("the main path's qc.json has no vote plane")
    with open(os.path.join(base, "run.metrics.json")) as fh:
        run_metrics = json.load(fh)

    # --resume on the same output: every stage skipped, nothing launched,
    # every BAM as it was
    shas = _bam_sha256(base)
    consensus_vote.launches = 0
    log = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(log):
        cli_main(argv + ["--resume", "True"])
    resume_wall = time.perf_counter() - t
    skipped = [stage for stage in MANIFEST_STAGES if f"skipping {stage} " in log.getvalue()]
    if skipped != list(MANIFEST_STAGES) or consensus_vote.launches:
        raise AssertionError(f"--resume skipped {skipped}, launched {consensus_vote.launches}")
    if _bam_sha256(base) != shas:
        raise AssertionError("--resume changed a BAM")
    emit("resume", stages_skipped=skipped, wall_s=resume_wall, bams=len(shas))
    row = {"card": card, "wall_s": wall, "reads": stats["total_reads"],
           "families": stats["families"],
           "families_per_s": stats["families"] / wall, "reads_per_s": stats["total_reads"] / wall,
           "sscs_written": stats["sscs_written"], "dcs_written": dcs["dcs_written"],
           "dcs_pairs": dcs.get("pairs"), "vote_kernel_launches": launches,
           "qc_launches": qc_launches, "qc_positions": qc_doc["plane"]["positions"],
           "qc_disagree_rate": qc_doc["plane"]["disagree_rate"], "run_metrics": run_metrics,
           "resume_wall_s": resume_wall,
           "resident_pair_votes": pair_votes, "resident_against_votes": against_votes,
           **device_s, "device_calls_share": sum(device_s.values()) / wall,
           "steps_s": res["walls"]}
    emit("scale", **row)
    # the main run's vote plane (the resume run rewrote its qc.json without one)
    return {**row, "qc_plane": qc_doc["plane"]}


MANIFEST_STAGES = ("sscs", "singleton_correction", "merge_rescued", "dcs", "merge_all_sscs",
                   "merge_all_dcs")
# (pipeline, residency) per turn: residency off, streaming, staged (the main
# run is a staged-on run too)
WALL_TURNS = (("staged", "False"), ("streaming", "True"), ("staged", "True"))
# the object-path samples (tagged input, --max_mismatch 1): phase 5's
# settings at a quarter of its fragments (the walks decode every record in
# Python, and each stage runs again on the CPU for its reference)
OBJECT_FRAGMENTS = 50_000
BARCODE_ERROR_RATE = 0.15  # test/make_test_data.py's sample_bcerr.bam rate
# the stage-to-stage BAMs streaming writes only as taps
INTERMEDIATES = ("sscs/sim.singleton.sorted.bam", "singleton/sim.sscs.rescue.sorted.bam",
                 "singleton/sim.singleton.rescue.sorted.bam", "dcs/sim.sscs.rescued.bam")


def phase_walls(dev, sim_bam: str, work: str, card: str) -> dict:
    """The phase-5 command again, uninstrumented, in turns (``WALL_TURNS``):
    step walls and ``run.metrics.json`` per run.  A staged run's BAMs must
    be the main run's; a streaming run (taps off) must write the main
    run's finals byte for byte and no intermediate.  Each turn's launch
    counts are set to 0 just before it and read just after: every turn
    must launch the SSCS kernel, each launch with the QC rider."""
    want = _bam_sha256(os.path.join(work, "sim"))
    finals = {k: v for k, v in want.items() if k not in INTERMEDIATES}
    runs = []
    for turn, (pipeline, resident) in enumerate(WALL_TURNS):
        out = os.path.join(work, f"turn{turn}")
        consensus_vote.launches = consensus_vote.qc_launches = 0
        t = time.perf_counter()
        res = cli_main(["consensus", "-i", sim_bam, "-o", out, "-n", "sim",
                        "--scorrect", "True", "--device", dev.type, "--residency", resident,
                        "--pipeline", pipeline])
        wall = time.perf_counter() - t
        launches, qc_launches = consensus_vote.launches, consensus_vote.qc_launches
        if launches == 0 or qc_launches != launches:
            raise AssertionError(f"turn {turn} ({pipeline}) launched the SSCS kernel {launches} "
                                 f"times, {qc_launches} with the QC rider")
        got = _bam_sha256(os.path.join(out, "sim"))
        if res["pipeline"] != pipeline:
            raise AssertionError(f"turn {turn}: asked for {pipeline}, ran {res['pipeline']}")
        if got != (want if pipeline == "staged" else finals):
            raise AssertionError(f"turn {turn} ({pipeline}, residency {resident}) wrote other "
                                 "BAMs than the main run")
        with open(os.path.join(out, "sim", "run.metrics.json")) as fh:
            metrics = json.load(fh)
        shutil.rmtree(out)
        runs.append({"pipeline": pipeline, "residency": resident, "wall_s": wall,
                     "steps_s": res["walls"], "run_metrics": metrics, "launches": launches})
        emit("wall_turn", turn=turn, **runs[-1])

    def walls(pipeline, resident):
        return [r["wall_s"] for r in runs
                if (r["pipeline"], r["residency"]) == (pipeline, resident)]

    staged, streaming = walls("staged", "True"), walls("streaming", "True")
    row = {"card": card, "turns": [list(t) for t in WALL_TURNS], "bams": len(want),
           "staged_walls_s": staged, "streaming_walls_s": streaming,
           "staged_spread_s": max(staged) - min(staged),
           "streaming_spread_s": max(streaming) - min(streaming),
           "streaming_minus_staged_least_s": min(streaming) - min(staged),
           "residency_off_wall_s": walls("staged", "False")[0],
           "residency_on_minus_off_least_s": min(staged) - walls("staged", "False")[0]}
    emit("walls", **row)
    return row


# ------------------------------------------------------------- object paths


def _records(path: str) -> list:
    """A BAM's header text and raw record bytes, in file order."""
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _same_records(base: str, other: str, rels) -> None:
    for rel in rels:
        if _records(os.path.join(base, rel)) != _records(os.path.join(other, rel)):
            raise AssertionError(f"{rel}: the card's records differ from the CPU run's")


def _tag_every_read(src: str, dst: str) -> None:
    """``src`` with ``NM:i:0`` appended to every record's tags (an aligned
    sample's reads carry such tags), by raw-record surgery in numpy."""
    tag = np.frombuffer(b"NMi\x00\x00\x00\x00", np.uint8)
    with ColumnarReader(src) as reader, BamWriter(dst, reader.header) as writer:
        for batch in reader.batches():
            n, off = batch.n, batch.rec_off
            lens = np.diff(off)
            new_off = np.zeros(n + 1, np.int64)
            np.cumsum(lens + tag.size, out=new_off[1:])
            out = np.empty(int(new_off[-1]), np.uint8)
            scatter_runs(out, new_off[:-1], batch.buf, lens, src_starts=off[:-1])
            scatter_runs(out, new_off[:-1] + lens, np.tile(tag, n),
                         np.full(n, tag.size, np.int64))
            block_size = (lens + tag.size - 4).astype("<u4").view(np.uint8).reshape(n, 4)
            out[new_off[:-1, None] + np.arange(4)] = block_size
            writer.write_encoded(out)


def phase_object_goldens(dev) -> dict:
    """The object paths on the committed BAMs: ``--max_mismatch 1`` on
    ``sample_bcerr.bam`` (the ``consensus_mm1`` goldens, every BAM's
    records equal to the port's CPU run's), ``--wire dense`` on the three
    (their goldens, each card ``qc.json`` equal to the CPU dense run's,
    every launch with the dense rider), ``--wire dense --pipeline
    streaming`` on ``sample.bam``, and a tagged ``sample.bam`` (every
    read with ``NM:i:0``): card records equal to the CPU run's, and under
    streaming a staged re-run that writes the same tree."""
    golden = json.load(open(os.path.join(REPO, "test", "golden.json")))
    runs = (("sample_bcerr.bam", "consensus_mm1", "golden_mm1", ["--max_mismatch", "1"],
             "staged"),
            ("sample.bam", "consensus", "golden", ["--wire", "dense"], "staged"),
            ("sample_adversarial.bam", "consensus_adversarial", "golden_adv",
             ["--wire", "dense"], "staged"),
            ("sample_bcerr.bam", "consensus_bcerr_exact", "golden_bcerr", ["--wire", "dense"],
             "staged"),
            ("sample.bam", "consensus", "golden", ["--wire", "dense"], "streaming"))
    out = {}
    for bam, section, name, extra, pipeline in runs:
        work = tempfile.mkdtemp(dir=os.path.join(REPO, ".scratch"))
        argv = ["consensus", "-i", os.path.join(REPO, "test", "data", bam), "-o", work,
                "-n", name, "--scorrect", "True", "--pipeline", pipeline,
                "--intermediate_taps", "True", *extra]
        consensus_vote.launches = consensus_vote.qc_launches = hamming.launches = 0
        t = time.perf_counter()
        res = cli_main(argv + ["--device", dev.type])
        wall = time.perf_counter() - t
        launches, qc_launches, ham = (consensus_vote.launches, consensus_vote.qc_launches,
                                      hamming.launches)
        if res["pipeline"] != pipeline:
            raise AssertionError(f"{bam} {extra}: asked for {pipeline}, ran {res['pipeline']}")
        base = os.path.join(work, name)
        bad = golden_mismatches(base, golden[section])
        if bad:
            raise AssertionError(f"{bam} {extra} ({pipeline}): outputs diverge from "
                                 f"{section} goldens: {bad}")
        if launches == 0 or qc_launches != launches:
            raise AssertionError(f"{bam} {extra}: {launches} vote launches, {qc_launches} "
                                 "with the QC rider")
        if "--max_mismatch" in extra and ham == 0:
            raise AssertionError(f"{bam}: the Hamming matcher never ran on the card")
        qc_equal = None
        if pipeline == "staged":
            cpu = os.path.join(work, "cpu")
            cli_main(argv + ["--device", "cpu", "-o", cpu])
            _same_records(base, os.path.join(cpu, name), _bam_sha256(base))
            qc_equal = _qc_doc(base) == _qc_doc(os.path.join(cpu, name))
            if not qc_equal:
                raise AssertionError(f"{bam} {extra}: the card's qc.json differs from the "
                                     "CPU run's")
        shutil.rmtree(work)
        out[f"{bam}/{' '.join(extra)}/{pipeline}"] = wall
        emit("object_goldens", input=bam, flags=extra, pipeline=pipeline,
             digests=len(golden[section]), wall_s=wall, launches=launches,
             qc_launches=qc_launches, hamming_launches=ham, qc_equal_to_cpu=qc_equal)

    work = tempfile.mkdtemp(dir=os.path.join(REPO, ".scratch"))
    tagged = os.path.join(work, "tagged.bam")
    _tag_every_read(os.path.join(REPO, "test", "data", "sample.bam"), tagged)
    argv = ["consensus", "-i", tagged, "-n", "t", "--scorrect", "True"]
    trees = {}
    for pipeline in ("staged", "streaming"):
        res = cli_main(argv + ["-o", os.path.join(work, pipeline), "--device", dev.type,
                               "--pipeline", pipeline])
        if res["pipeline"] != "staged":
            raise AssertionError(f"tagged sample.bam ({pipeline}) ran {res['pipeline']}")
        trees[pipeline] = _bam_sha256(os.path.join(work, pipeline, "t"))
    if trees["streaming"] != trees["staged"]:
        raise AssertionError("tagged sample.bam: streaming's staged re-run wrote another tree")
    cli_main(argv + ["-o", os.path.join(work, "cpu"), "--device", "cpu"])
    _same_records(os.path.join(work, "staged", "t"), os.path.join(work, "cpu", "t"),
                  trees["staged"])
    shutil.rmtree(work)
    emit("object_goldens", input="sample.bam tagged NM:i:0", bams=len(trees["staged"]),
         equal_to_cpu=True, streaming_ran="staged")
    return out


def phase_dense(dev, obj_bam: str, work: str, rates: dict) -> tuple[dict, object]:
    """(b) ``--wire dense`` on (a)'s untagged sample (phase 5's settings at
    ``OBJECT_FRAGMENTS``): counts set to 0 just before and read just after
    (every SSCS launch is B1's dense form with the dense rider), every BAM
    byte-identical to (a)'s stream run's; then B1's dense form with the
    rider at the run's largest bucket against its plain version, timed
    with its bound.  Returns the row and that bucket."""
    largest = {}
    dense_batch = consensus_dense.consensus_batch

    def keep_largest(batch, *args, **kwargs):
        cells = int(batch.fam_sizes[:batch.n_real].sum()) * batch.bases.shape[2]
        if cells > largest.get("cells", -1):
            largest.update(cells=cells, batch=batch)
        return dense_batch(batch, *args, **kwargs)

    consensus_dense.consensus_batch = keep_largest
    out = os.path.join(work, "dense")
    try:
        consensus_vote.launches = consensus_vote.qc_launches = 0
        t = time.perf_counter()
        res = cli_main(["consensus", "-i", obj_bam, "-o", out, "-n", "obj", "--scorrect", "True",
                        "--device", dev.type, "--wire", "dense"])
        wall = time.perf_counter() - t
        launches, qc_launches = consensus_vote.launches, consensus_vote.qc_launches
    finally:
        consensus_dense.consensus_batch = dense_batch
    if launches == 0 or qc_launches != launches:
        raise AssertionError(f"the dense run launched B1 {launches} times, {qc_launches} with "
                             "the dense rider")
    if _bam_sha256(os.path.join(out, "obj")) != _bam_sha256(os.path.join(work, "untagged",
                                                                          "obj")):
        raise AssertionError("--wire dense wrote other BAMs than the stream wire")
    qc_plane = _qc_doc(os.path.join(out, "obj"))["plane"]
    shutil.rmtree(out)

    batch = largest["batch"]
    n = batch.n_real
    _b, f, length = batch.bases.shape
    bases = torch.from_numpy(batch.bases[:n]).to(dev).reshape(n * f, length)
    quals = torch.from_numpy(batch.quals[:n]).to(dev).reshape(n * f, length)
    sizes = torch.from_numpy(batch.fam_sizes[:n])
    starts = torch.arange(n, dtype=torch.int64) * f
    lengths = torch.full((n,), length, dtype=torch.int32)
    cfg = consensus_vote.ConsensusConfig()
    errs: list[int] = []
    job = consensus_vote.prepare_wire("raw", bases, quals, sizes, cfg, starts=starts,
                                      qc_lengths=lengths)
    planes = job()[0]
    got_qc = job.qc.clone()
    want, want_qc = consensus_vote.vote_members_plain(bases, quals, sizes, cfg, starts=starts,
                                                      qc_lengths=lengths)
    _check_equal("dense/largest_bucket", planes, want, errs)
    _check_equal("dense/largest_bucket/qc", got_qc, want_qc, errs)
    for qt in (0, 30):  # the dense rider at both qualscores, PAD tails included
        cfg_q = consensus_vote.ConsensusConfig(qual_threshold=qt)
        got = consensus_dense.consensus_batch(batch, cfg_q, dev, qc=True)
        plain = consensus_vote.vote_members_plain(bases, quals, sizes, cfg_q, starts=starts,
                                                  qc_lengths=lengths)
        _check_equal(f"dense/q{qt}/planes", got[0], plain[0], errs)
        _check_equal(f"dense/q{qt}/qc", got[1], plain[1], errs)

    def plain_call():
        consensus_vote.vote_members_plain(bases, quals, sizes, cfg, starts=starts,
                                          qc_lengths=lengths)

    runs = [kernel_ms(job, KERNEL, 300)]
    plain_ms = cuda_ms(plain_call, 10)
    runs.append(kernel_ms(job, KERNEL, 300))
    live_members = int(sizes.sum())
    # least work: each live member-position's base and qual read once, each
    # family's size read once, its output planes written once, the (2, L)
    # int32 sums written once; the vote's operations at each live member-
    # position and output position, the rider's at every position
    b = bound(2 * live_members * length + 4 * n + 2 * n * length + 8 * length,
              FOLD_OPS * live_members * length + FINALIZE_OPS * n * length
              + QC_OPS * n * length, rates)
    row = {"card": rates["card"], "fragments": OBJECT_FRAGMENTS, "wall_s": wall,
           "steps_s": res["walls"], "launches": launches,
           "qc_launches": qc_launches, "qc_positions": qc_plane["positions"],
           "ms": min(r["ms"] for r in runs), "runs": runs, "plain_ms": plain_ms, **b,
           "max_abs_err": max(errs), "comparisons": len(errs), "path": job.plan.summary(),
           "shape": {"families": n, "F": f, "L": length, "live_members": live_members}}
    emit("dense", **row)
    return row, batch


def phase_tagged(dev, work: str, card: str) -> dict:
    """(a) Phase 5's settings at ``OBJECT_FRAGMENTS`` fragments, untagged
    and with ``NM:i:0`` on every read, staged: the tagged run's rescue and
    DCS steps take the window walks on the card; each of those two stages
    again with ``device="cpu"`` on the same inputs writes the same
    records; step walls of both runs."""
    plain_bam = os.path.join(work, "obj.bam")
    tagged_bam = os.path.join(work, "obj_tagged.bam")
    cfg = SimConfig(n_fragments=OBJECT_FRAGMENTS, ref_len=40 * OBJECT_FRAGMENTS, seed=42)
    simulate_bam_fast(plain_bam, cfg)
    t = time.perf_counter()
    _tag_every_read(plain_bam, tagged_bam)
    tag_s = time.perf_counter() - t
    rows = {}
    for label, bam in (("untagged", plain_bam), ("tagged", tagged_bam)):
        # the window walks, counted and timed (synchronised)
        acc: dict[str, float] = {}
        calls: dict[str, int] = {}
        restores = [
            _synced_timer(singleton_correction, "_run_rescue_walk", acc, "rescue_walk_s", calls),
            _synced_timer(dcs_maker, "_run_dcs_windows", acc, "dcs_walk_s", calls)]
        consensus_vote.launches = 0
        try:
            t = time.perf_counter()
            res = cli_main(["consensus", "-i", bam, "-o", os.path.join(work, label), "-n", "obj",
                            "--scorrect", "True", "--device", dev.type])
            wall = time.perf_counter() - t
        finally:
            for restore in restores:
                restore()
        walks = 1 if label == "tagged" else 0
        if calls != {"rescue_walk_s": walks, "dcs_walk_s": walks}:
            raise AssertionError(f"{label}: walks taken {calls}")
        if consensus_vote.launches == 0:
            raise AssertionError(f"{label}: the SSCS vote never launched")
        rows[label] = {"wall_s": wall, "steps_s": res["walls"], **acc,
                       "sscs_launches": consensus_vote.launches}
    base = os.path.join(work, "tagged", "obj")
    cpu = torch.device("cpu")
    t = time.perf_counter()
    rescue = singleton_correction.run_singleton_correction(
        os.path.join(base, "sscs", "obj.singleton.sorted.bam"),
        os.path.join(base, "sscs", "obj.sscs.sorted.bam"), os.path.join(work, "cpu_rescue"), cpu)
    dcs = dcs_maker.run_dcs(os.path.join(base, "dcs", "obj.sscs.rescued.bam"),
                            os.path.join(work, "cpu_dcs"), cpu)
    cpu_s = time.perf_counter() - t
    for got, want in ((rescue.sscs_rescue_bam, "singleton/obj.sscs.rescue.sorted.bam"),
                      (rescue.singleton_rescue_bam, "singleton/obj.singleton.rescue.sorted.bam"),
                      (rescue.remaining_bam, "singleton/obj.remaining.singleton.sorted.bam"),
                      (dcs.dcs_bam, "dcs/obj.dcs.sorted.bam"),
                      (dcs.sscs_singleton_bam, "dcs/obj.sscs.singleton.sorted.bam")):
        if _records(got) != _records(os.path.join(base, want)):
            raise AssertionError(f"tagged {want}: the card's records differ from the CPU's")
    stats = json.load(open(os.path.join(base, "singleton", "obj.singleton_stats.json")))
    row = {"card": card, "fragments": OBJECT_FRAGMENTS, "tag_s": tag_s, **rows,
           "cpu_rerun_s": cpu_s, "rescued_by_sscs": stats.get("rescued_by_sscs"),
           "rescued_by_singleton": stats.get("rescued_by_singleton"),
           "dcs_pairs": dcs.stats.get("pairs")}
    emit("tagged", **row)
    return row


def phase_mm1(dev, work: str, card: str) -> dict:
    """(c) ``--max_mismatch 1`` on phase 5's settings at ``OBJECT_FRAGMENTS``
    fragments with barcode errors (another seed): Hamming launches and
    their synchronised seconds; the rescue stage again with
    ``device="cpu"`` writes the same records."""
    bam = os.path.join(work, "mm1.bam")
    cfg = SimConfig(n_fragments=OBJECT_FRAGMENTS, ref_len=40 * OBJECT_FRAGMENTS,
                    barcode_error_rate=BARCODE_ERROR_RATE, seed=43)
    simulate_bam_fast(bam, cfg)
    hamming.launches, hamming.hamming_s = 0, 0.0
    consensus_vote.launches = 0
    t = time.perf_counter()
    res = cli_main(["consensus", "-i", bam, "-o", os.path.join(work, "mm1"), "-n", "mm1",
                    "--scorrect", "True", "--device", dev.type, "--max_mismatch", "1"])
    wall = time.perf_counter() - t
    launches, ham_s, sscs_launches = hamming.launches, hamming.hamming_s, consensus_vote.launches
    if launches == 0 or sscs_launches == 0:
        raise AssertionError(f"--max_mismatch 1: {launches} Hamming calls, {sscs_launches} "
                             "SSCS launches")
    base = os.path.join(work, "mm1", "mm1")
    t = time.perf_counter()
    rescue = singleton_correction.run_singleton_correction(
        os.path.join(base, "sscs", "mm1.singleton.sorted.bam"),
        os.path.join(base, "sscs", "mm1.sscs.sorted.bam"), os.path.join(work, "cpu_mm1"),
        torch.device("cpu"), max_mismatch=1)
    cpu_s = time.perf_counter() - t
    for got, want in ((rescue.sscs_rescue_bam, "singleton/mm1.sscs.rescue.sorted.bam"),
                      (rescue.singleton_rescue_bam, "singleton/mm1.singleton.rescue.sorted.bam"),
                      (rescue.remaining_bam, "singleton/mm1.remaining.singleton.sorted.bam")):
        if _records(got) != _records(os.path.join(base, want)):
            raise AssertionError(f"mm1 {want}: the card's records differ from the CPU's")
    stats = json.load(open(os.path.join(base, "singleton", "mm1.singleton_stats.json")))
    row = {"card": card, "fragments": OBJECT_FRAGMENTS, "barcode_error_rate": BARCODE_ERROR_RATE,
           "wall_s": wall, "steps_s": res["walls"], "hamming_launches": launches,
           "hamming_s": ham_s, "cpu_rescue_s": cpu_s,
           "singletons": stats.get("singletons_total"),
           "rescued_by_sscs": stats.get("rescued_by_sscs"),
           "rescued_by_singleton": stats.get("rescued_by_singleton")}
    emit("mm1", **row)
    return row


# ------------------------------------------------------------ vote policies

POLICIES = ("delegation", "distilled")
# the policies' rows (torch ops on the card; XLA programs in the reference)
POLICY_ROWS = {
    "delegation": {"name": "delegation_vote", "route": "torch",
                   "source": "consensuscruncher_tpu_torch/policies/delegation.py",
                   "replaces": "consensuscruncher_tpu/policies/delegation.py:82"},
    "distilled": {"name": "distilled_vote", "route": "torch",
                  "source": "consensuscruncher_tpu_torch/policies/distilled.py",
                  "replaces": "consensuscruncher_tpu/policies/distilled.py:146"},
    "duplex_batch": {"name": "duplex_batch_policy", "route": "torch",
                     "source": "consensuscruncher_tpu_torch/ops/consensus_vote.py",
                     "replaces": "consensuscruncher_tpu/ops/consensus_pallas.py:404"},
}
# the degraded sample: the port's simulate_bam at phase 5's widths with
# half the reads degraded (quals 3-15, 8% extra errors)
DEGRADED_FRAGMENTS = 20_000
DEGRADED_RATE = 0.5


def torch_launches(fn) -> dict:
    """The CUDA kernels (and copies) one call of ``fn`` runs, as the
    profiler sees them (None when it sees no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(n.startswith(("Memcpy", "Memset")) for n in names)
    if not names:
        return {"launches": None, "copies": None}
    return {"launches": len(names) - copies, "copies": copies}


def _distilled_detail(wire, a, book, sizes, cfg, out_len, fam, pos) -> dict:
    """The distilled head's inputs and confidence at one (family,
    position) of a stream batch, recomputed on the host."""
    from consensuscruncher_tpu_torch.policies import distilled

    bases, quals = unpack_wire(wire, a.cpu(), torch.as_tensor(book).cpu())
    start = int(sizes[:fam].sum())
    rows = slice(start, start + int(sizes[fam]))
    b, q = bases[rows, pos], quals[rows, pos]
    eff = torch.where(q >= cfg.qual_threshold, b, N)
    counts = torch.stack([(eff == k).sum() for k in range(NUM_BASES)]).to(torch.int32)
    qsums = torch.stack([torch.where(eff == k, q.to(torch.int32), 0).sum()
                         for k in range(NUM_BASES)]).to(torch.int32)
    feats = distilled.features(counts[None], qsums[None], int(sizes[fam]),
                               qual_cap=cfg.qual_cap)
    logits = distilled.DistilledPolicy().head(torch.device("cpu"))(feats)
    return {"family": fam, "position": pos, "counts": counts.tolist(),
            "qsums": qsums.tolist(), "confidence": float(distilled.confidence(logits)[0]),
            "logits": logits[0].tolist()}


def phase_policy_batches(dev, sim_bam: str, dense_batch, rates: dict) -> dict:
    """(1) Each policy's stream vote at the main path's batch, with and
    without the rider, and its dense vote at the dense run's largest
    bucket, on the card against the same function on the CPU (exact),
    timed with CUDA events beside B1's call on the same inputs, its
    kernels per call counted by the profiler; B15 (``duplex_batch`` under
    a policy) likewise at ``B8192_F16_L100`` with degraded members."""
    batch = main_path_batch(sim_bam)
    n = batch.n_real
    wire, a, w = consensus_segment.encode_member_batch(batch)
    a_h, book = torch.from_numpy(a), torch.from_numpy(w)
    a_d = a_h.to(dev)
    b_d = book.to(dev) if wire == "raw" else book
    b_h = book
    sizes = torch.from_numpy(batch.sizes[:n])
    lengths = torch.from_numpy(batch.lengths[:n])
    out_len = consensus_segment._out_len(batch)
    cfg = consensus_vote.ConsensusConfig()

    def b1_call():
        consensus_segment.stream_vote(wire, a_d, b_d, sizes, cfg, out_len, lengths)

    rows: dict[str, dict] = {}
    b1_ms = [cuda_ms(b1_call, 200)]
    for policy in POLICIES:
        errs: list[int] = []
        detail = None
        if policy == "distilled":
            def detail(fam, pos):
                return _distilled_detail(wire, a_h, b_h, sizes, cfg, out_len, fam, pos)
        before = consensus_vote.launches
        for lens in (None, lengths):
            got = consensus_segment.stream_vote(wire, a_d, b_d, sizes, cfg, out_len, lens,
                                                policy=policy)
            want = consensus_segment.stream_vote(wire, a_h, b_h, sizes, cfg, out_len, lens,
                                                 policy=policy)
            if lens is None:
                _check_equal(f"{policy}/main_path_batch", got.cpu(), want, errs, detail)
            else:
                _check_equal(f"{policy}/main_path_batch/qc_planes", got[0].cpu(), want[0], errs,
                             detail)
                _check_equal(f"{policy}/main_path_batch/qc", got[1].cpu(), want[1], errs)
        if consensus_vote.launches != before:
            raise AssertionError(f"{policy}: the policy vote launched B1")

        def call(policy=policy):
            consensus_segment.stream_vote(wire, a_d, b_d, sizes, cfg, out_len, policy=policy)

        def qc_call(policy=policy):
            consensus_segment.stream_vote(wire, a_d, b_d, sizes, cfg, out_len, lengths,
                                          policy=policy)

        t = time.perf_counter()
        consensus_segment.stream_vote(wire, a_h, b_h, sizes, cfg, out_len, policy=policy)
        cpu_s = time.perf_counter() - t
        runs = [cuda_ms(call, 20), cuda_ms(qc_call, 20), cuda_ms(qc_call, 20), cuda_ms(call, 20)]
        rows[policy] = {"ms": min(runs[0], runs[3]), "qc_ms": min(runs[1], runs[2]),
                        "runs": runs, "cpu_s": cpu_s, **torch_launches(call),
                        "qc_launches_per_call": torch_launches(qc_call)["launches"],
                        "errs": errs}
    b1_ms.append(cuda_ms(b1_call, 200))
    shape = {"wire": wire, "families": n, "members": int(batch.n_members),
             "cap": consensus_segment.pick_member_cap(batch.sizes[:n]), "out_len": out_len}
    emit("policy_batch", card=rates["card"], shape=shape, b1_call_ms=min(b1_ms),
         b1_call_runs=b1_ms, **{p: {k: v for k, v in r.items() if k != "errs"}
                                for p, r in rows.items()})

    # the dense run's largest bucket
    n_d = dense_batch.n_real
    host = [torch.from_numpy(x[:n_d]) for x in (dense_batch.bases, dense_batch.quals)]
    card_planes = [x.to(dev) for x in host]
    d_sizes = torch.from_numpy(dense_batch.fam_sizes[:n_d])

    def b1_dense():
        consensus_vote.consensus_batch(*card_planes, d_sizes, cfg, qc=True)

    dense = {"b1_ms": cuda_ms(b1_dense, 100)}
    for policy in POLICIES:
        errs = rows[policy]["errs"]
        got = consensus_vote.consensus_batch(*card_planes, d_sizes, cfg, qc=True, policy=policy)
        want = consensus_vote.consensus_batch(*host, d_sizes, cfg, qc=True, policy=policy)
        for i, (g, w_) in enumerate(zip(got, want)):
            _check_equal(f"{policy}/dense_largest_bucket/{i}", g.cpu(), w_, errs)

        def dense_call(policy=policy):
            consensus_vote.consensus_batch(*card_planes, d_sizes, cfg, qc=True, policy=policy)

        dense[policy] = {"ms": min(cuda_ms(dense_call, 20), cuda_ms(dense_call, 20)),
                         **torch_launches(dense_call)}
    dense["shape"] = {"families": n_d, "F": int(dense_batch.bases.shape[1]),
                      "L": int(dense_batch.bases.shape[2])}
    emit("policy_dense_bucket", card=rates["card"], **dense)

    # B15: the fused API's policy branch, at B8192_F16_L100, degraded members
    rng = np.random.default_rng(61)
    strands = []
    for _ in range(2):
        b_, q_, s_ = _dense_strand(rng, 8192, 16, 100)
        # members mostly agree with their first; every other one degraded
        b_ = np.where((rng.random(b_.shape) < 0.75) & (b_ != PAD), b_[:, :1], b_)
        q_[:, ::2] = np.minimum(q_[:, ::2], 15)
        strands.append((torch.from_numpy(b_), torch.from_numpy(q_), s_))
    card_strands = [(x.to(dev), y.to(dev), s_) for x, y, s_ in strands]
    b15: dict[str, object] = {"errs": []}
    before = consensus_vote.fused_launches
    for policy in POLICIES:
        got = consensus_vote.duplex_batch(*card_strands[0], *card_strands[1], policy=policy)
        want = consensus_vote.duplex_batch(*strands[0], *strands[1], policy=policy)
        for i, (g, w_) in enumerate(zip(got, want)):
            _check_equal(f"duplex_batch/{policy}/{i}", g.cpu(), w_, b15["errs"])

        def fused_call(policy=policy):
            consensus_vote.duplex_batch(*card_strands[0], *card_strands[1], policy=policy)

        b15[policy] = {"ms": min(cuda_ms(fused_call, 10), cuda_ms(fused_call, 10)),
                       **torch_launches(fused_call)}
    if consensus_vote.fused_launches != before:
        raise AssertionError("duplex_batch under a policy launched B2")

    def b2_call():
        consensus_vote.duplex_batch(*card_strands[0], *card_strands[1])

    b15["b2_ms"] = cuda_ms(b2_call, 50)
    emit("policy_b15", card=rates["card"], shape="B8192_F16_L100",
         **{k: v for k, v in b15.items() if k != "errs"})
    return {"batch": rows, "shape": shape, "b1_call_ms": min(b1_ms), "dense": dense,
            "b15": b15}


def _policy_run(bam, out, name, policy, device, *extra) -> dict:
    """One ``consensus`` run under ``policy``: its policy stream votes
    counted and timed (synchronised), and its B1 launches (each count set
    to 0 just before, read just after)."""
    calls: dict[str, int] = {}
    acc: dict[str, float] = {}
    restore = _synced_timer(consensus_segment, "policy_stream_vote", acc, "stream", calls)
    consensus_vote.launches = 0
    try:
        t = time.perf_counter()
        res = cli_main(["consensus", "-i", bam, "-o", out, "-n", name, "--scorrect", "True",
                        "--policy", policy, "--device", device, *extra])
        wall = time.perf_counter() - t
    finally:
        restore()
    return {"wall_s": wall, "steps_s": res["walls"], "pipeline": res["pipeline"],
            "policy_stream_calls": calls["stream"], "policy_stream_s": acc["stream"],
            "b1_launches": consensus_vote.launches}


def phase_policy_runs(dev, work: str, card: str) -> dict:
    """(2) ``sample.bam`` and a degraded sample (``DEGRADED_FRAGMENTS``)
    under each policy: the card run's records and ``qc.json`` equal to the
    ``--device cpu`` run's; the ``qc.json`` plane the majority run's; on
    the degraded sample delegation's BAMs differ from majority's; on
    ``sample.bam`` ``--wire dense``, streaming (taps) and ``--residency
    False`` write the staged stream run's records."""
    degraded = os.path.join(work, "degraded.bam")
    t = time.perf_counter()
    simulate_bam(degraded, SimConfig(n_fragments=DEGRADED_FRAGMENTS, seed=7,
                                     degraded_read_rate=DEGRADED_RATE,
                                     ref_len=40 * DEGRADED_FRAGMENTS))
    sim_s = time.perf_counter() - t
    sample = os.path.join(REPO, "test", "data", "sample.bam")
    out: dict[str, dict] = {"simulate_s": sim_s}
    for label, bam in (("sample", sample), ("degraded", degraded)):
        root = os.path.join(work, f"policy_{label}")
        majority = _policy_run(bam, os.path.join(root, "majority"), "p", "majority", dev.type)
        base_m = os.path.join(root, "majority", "p")
        plane = _qc_doc(base_m)["plane"]
        shas_m = _bam_sha256(base_m)
        for policy in POLICIES:
            base = os.path.join(root, policy, "p")
            run = _policy_run(bam, os.path.join(root, policy), "p", policy, dev.type)
            if run["policy_stream_calls"] == 0 or run["b1_launches"]:
                raise AssertionError(f"{label}/{policy}: {run['policy_stream_calls']} policy "
                                     f"votes, {run['b1_launches']} B1 launches")
            cpu = _policy_run(bam, os.path.join(root, f"{policy}_cpu"), "p", policy, "cpu")
            shas = _bam_sha256(base)
            _same_records(base, os.path.join(root, f"{policy}_cpu", "p"), shas)
            qc = _qc_doc(base)
            if qc != _qc_doc(os.path.join(root, f"{policy}_cpu", "p")):
                raise AssertionError(f"{label}/{policy}: the card's qc.json differs from the CPU's")
            if qc["plane"] != plane or qc["policy"] != policy:
                raise AssertionError(f"{label}/{policy}: qc.json's plane is not majority's")
            differs = shas["sscs/p.sscs.sorted.bam"] != shas_m["sscs/p.sscs.sorted.bam"]
            if label == "degraded" and policy == "delegation" and not differs:
                raise AssertionError("degraded: delegation wrote majority's SSCS BAM")
            turns = {}
            if label == "sample":
                for turn, extra in (("dense", ["--wire", "dense"]),
                                    ("streaming", ["--pipeline", "streaming",
                                                   "--intermediate_taps", "True"]),
                                    ("residency_off", ["--residency", "False"])):
                    other = os.path.join(root, f"{policy}_{turn}")
                    turns[turn] = _policy_run(bam, other, "p", policy, dev.type, *extra)
                    _same_records(os.path.join(other, "p"), base, shas)
            out[f"{label}/{policy}"] = {"card": run, "cpu": cpu, "sscs_differs_from_majority":
                                        differs, "turns": turns}
            emit("policy_run", input=label, policy=policy, card_run=run, cpu_wall_s=cpu["wall_s"],
                 records_equal_to_cpu=True, qc_equal_to_cpu=True, plane_is_majority=True,
                 sscs_differs_from_majority=differs,
                 turns={k: v["wall_s"] for k, v in turns.items()})
        out[f"{label}/majority"] = majority
        shutil.rmtree(root)
    return out


def phase_policy_scale(dev, sim_bam: str, work: str, plane: dict, card: str) -> dict:
    """(3) Phase 5's sample, staged, under each policy: walls and the SSCS
    step beside the majority run of this call (phase 5's counted run);
    delegation's SSCS BAM equals majority's byte for byte (every read has
    quals 25-40, so every member is high), the ``qc.json`` plane is
    majority's (``plane``, the majority run's: its ``qc.json`` now holds
    the resume run's); the policy votes per run counted, no B1 launch."""
    shas_m = _bam_sha256(os.path.join(work, "sim"))
    rows = {}
    for policy in POLICIES:
        out = os.path.join(work, f"scale_{policy}")
        run = _policy_run(sim_bam, out, "sim", policy, dev.type)
        shas = _bam_sha256(os.path.join(out, "sim"))
        same = shas["sscs/sim.sscs.sorted.bam"] == shas_m["sscs/sim.sscs.sorted.bam"]
        if policy == "delegation" and not same:
            raise AssertionError("delegation's SSCS BAM differs from majority's on the "
                                 "phase-5 sample, whose quals are all >= 25")
        if _qc_doc(os.path.join(out, "sim"))["plane"] != plane:
            raise AssertionError(f"{policy}: the phase-5 qc.json plane is not majority's")
        if run["policy_stream_calls"] == 0 or run["b1_launches"]:
            raise AssertionError(f"{policy}: {run['policy_stream_calls']} policy votes, "
                                 f"{run['b1_launches']} B1 launches")
        shutil.rmtree(out)
        rows[policy] = {**run, "sscs_equal_to_majority": same}
        emit("policy_scale", card=card, policy=policy, **rows[policy])
    return rows


def policies_line(policies: dict, policy_scale: dict, policy_runs: dict, scale: dict,
                  card: str) -> dict:
    """The ``{"policies": [...]}`` line: per policy (and B15), its route,
    source, the JAX function it replaces, time and torch launches per call,
    calls per phase-5-size run and ``max_abs_err`` card against CPU."""
    b15 = policies["b15"]
    rows = [
        {**POLICY_ROWS[p], "ms": policies["batch"][p]["ms"],
         "qc_ms": policies["batch"][p]["qc_ms"],
         "b1_call_ms": policies["b1_call_ms"], "shape": policies["shape"],
         "calls_per_run": policy_scale[p]["policy_stream_calls"],
         "launches_per_call": policies["batch"][p]["launches"],
         "qc_launches_per_call": policies["batch"][p]["qc_launches_per_call"],
         "copies_per_call": policies["batch"][p]["copies"],
         "max_abs_err": max(policies["batch"][p]["errs"]),
         "dense_ms": policies["dense"][p]["ms"],
         "dense_launches_per_call": policies["dense"][p]["launches"],
         "dense_b1_ms": policies["dense"]["b1_ms"],
         "run_wall_s": policy_scale[p]["wall_s"],
         "run_policy_vote_s": policy_scale[p]["policy_stream_s"],
         "run_sscs_s": policy_scale[p]["steps_s"]["sscs"],
         "majority_wall_s": scale["wall_s"], "majority_sscs_s": scale["steps_s"]["sscs"]}
        for p in POLICIES]
    rows.append(
        {**POLICY_ROWS["duplex_batch"], "ms": {p: b15[p]["ms"] for p in POLICIES},
         "b2_ms": b15["b2_ms"], "shape": "B8192_F16_L100", "calls_per_run": 0,
         "calls_note": "the fused API; the consensus command does not call it",
         "launches_per_call": {p: b15[p]["launches"] for p in POLICIES},
         "max_abs_err": max(b15["errs"])})
    degraded = {k: v["card"]["wall_s"] for k, v in policy_runs.items()
                if isinstance(v, dict) and "card" in v}
    return {"policies": rows, "card": card, "degraded_runs": degraded}



def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fragments", type=int, default=200_000,
                   help="simulated duplex fragments for phase 5 (default 200000)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    rates = phase_card()
    phase_build()

    os.makedirs(os.path.join(REPO, ".scratch"), exist_ok=True)
    work = tempfile.mkdtemp(dir=os.path.join(REPO, ".scratch"))
    try:
        sim_bam = os.path.join(work, "sim.bam")
        t = time.perf_counter()
        cfg = SimConfig(n_fragments=args.fragments, ref_len=40 * args.fragments, seed=42)
        truth = simulate_bam_fast(sim_bam, cfg)
        emit("simulate", fragments=args.fragments, reads=truth.n_reads,
             seconds=time.perf_counter() - t)
        vote = phase_vote_kernel(dev, sim_bam, rates)
        fused_errs = phase_fused_cases(dev)
        shapes = {tag: phase_fused_dense(dev, tag, rates, fused_errs) for tag in DENSE_SHAPES}
        book, batches = stage_loop_batches()
        stage, reference = phase_fused_stage(dev, rates, fused_errs, book, batches)
        phase_goldens(dev)
        phase_object_goldens(dev)
        scale = phase_scale(dev, sim_bam, truth, work, rates["card"])
        phase_walls(dev, sim_bam, work, rates["card"])
        phase_tagged(dev, work, rates["card"])
        dense, dense_batch = phase_dense(dev, os.path.join(work, "obj.bam"), work, rates)
        phase_mm1(dev, work, rates["card"])
        policies = phase_policy_batches(dev, sim_bam, dense_batch, rates)
        policy_runs = phase_policy_runs(dev, work, rates["card"])
        policy_scale = phase_policy_scale(dev, sim_bam, work, scale["qc_plane"],
                                          rates["card"])
        path = phase_fused_path(dev, book, batches, reference)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    shapes["stage_loop"] = stage
    kernels = [
        {**VOTE, "launches": scale["vote_kernel_launches"], "max_abs_err": vote["max_abs_err"],
         "ms": vote["ms"], "plain_ms": vote["plain_ms"], "bound_ms": vote["bound_ms"],
         "bound_by": vote["bound_by"], "library_ms": None, "library_note": NO_LIBRARY,
         "unfused_ms": vote["unfused_ms"], "raw_planes_ms": vote["raw_planes_ms"],
         "call_ms": vote["call_ms"], "unfused_call_ms": vote["unfused_call_ms"],
         "path": vote["path"], "shape": vote["shape"],
         "qc_launches": scale["qc_launches"], "qc_ms": vote["qc"]["ms"],
         "qc_plain_ms": vote["qc"]["plain_ms"], "qc_bound_ms": vote["qc"]["bound_ms"],
         "qc_bound_by": vote["qc"]["bound_by"],
         "rider_bound_ms": vote["qc"]["rider_bound_ms"]},
        {**DENSE_VOTE, "launches": dense["launches"], "max_abs_err": dense["max_abs_err"],
         "ms": dense["ms"], "plain_ms": dense["plain_ms"], "bound_ms": dense["bound_ms"],
         "bound_by": dense["bound_by"], "library_ms": None, "library_note": NO_LIBRARY,
         "qc_launches": dense["qc_launches"], "path": dense["path"], "shape": dense["shape"]},
        {**FUSED, "launches": path["fused_launches"], "max_abs_err": max(fused_errs),
         "ms": stage["ms"], "plain_ms": stage["plain_ms"], "bound_ms": stage["bound_ms"],
         "bound_by": stage["bound_by"], "library_ms": None, "library_note": NO_LIBRARY,
         "chain_ms": stage["chain_ms"], "loop_ms": stage["loop_ms"], "path": stage["path"],
         "shapes": {tag: {k: row[k] for k in ("ms", "plain_ms", "chain_ms", "bound_ms",
                                              "bound_by", "path")}
                    for tag, row in shapes.items()}},
    ]
    print(json.dumps(policies_line(policies, policy_scale, policy_runs, scale,
                                   rates["card"])), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
