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
   the command again, uninstrumented, staged (every BAM byte-identical to
   the main run's: the N = 1 wall of phase 9) and streaming (taps off: the
   finals byte-identical to the main run's, no intermediate written), the
   step walls of each beside the main run's;
6. the object paths at full width (read length 100, UMI 6, mean family
   3): (a) phase 5's settings at ``OBJECT_FRAGMENTS`` fragments, untagged
   and with ``NM:i:0`` on every read: the tagged run's rescue and DCS
   take the window walks on the card, and each of the two stages again
   with ``device="cpu"`` writes the same records; (b) ``--wire dense`` on
   (a)'s untagged sample, every BAM byte-identical to (a)'s stream run's,
   every SSCS launch B1's dense form with the dense rider, which is then
   held to its plain version at the run's largest bucket (qualscore 0 and
   30) and timed with its bound; (c) ``--max_mismatch 1`` on the same
   settings at ``MM1_FRAGMENTS`` with barcode errors (another seed): the
   Hamming matcher's calls and seconds, and the rescue stage on the CPU writes the same
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
   under each policy of ``SCALE_POLICIES``, staged (walls; delegation's
   SSCS BAM majority's, byte for byte);
8. the fused path: ``run_duplex_pipelined`` over the stage-loop batches,
   its kernel launches counted (> 0) and its outputs equal to the
   prestaged loop's;
9. the whole command: (i) ``--host_workers 2`` and ``4`` on phase 5's
   sample, each parent a process of its own that opens no CUDA context,
   its workers sharing the card: every merged BAM record by record and
   the stats to phase 5's counted run, each worker's SSCS sidecar on the
   card with bytes uploaded, the walls beside phase 5's uninstrumented
   staged turn (N = 1) and the host's cores; (ii) a two-sample batch of phase 6 (a)'s untagged sample
   and phase 7's degraded sample (majority): each tree, records, stats
   and ``qc.json``, equal to that sample's own run, the second sample
   prestaged, the batch's wall beside the sum of the two; (iii) ``-c
   config.ini`` (``backend = tpu``: the card) on ``sample.bam``: the
   goldens; then ``-c config.ini --profile DIR`` on phase 6 (a)'s
   untagged sample, in a process of its own: its records equal to that
   sample's run, and the Chrome trace names ``vote_tiles_kernel``, with
   the device's busy share of the traced window (a whole run at real
   size); (iv) in every tree, the three PNGs decode and the stage
   sidecars carry their ``cumulative`` block;
10. multi-device (``--devices N``; with one card, the shards take turns on
    it), each run held to its one-device counterpart in this call: (i)
    ``--devices 2`` staged on phase 5's sample (records, stats and
    ``qc.json``, which has no vote plane on a mesh; one B1 launch per
    shard; ``vote_s`` and the wall beside phase 5's), (ii) the same under
    ``--pipeline streaming`` (the finals), (iii) ``--devices 4 --wire
    dense`` on phase 7's degraded sample, (iv) ``--host_workers 2
    --devices 2`` on phase 6 (a)'s untagged sample (each worker's sidecar on
    the card), (v) the ``parallel.mesh`` library steps at
    ``B8192_F16_L100`` over 1, 2 and 4 shards, each equal to the unsharded
    B1 or B2 and to its plain version, stats equal, ms per step, (vi) the
    two-process ``parallel.distributed`` dryrun (gloo) on the card;
11. the serve daemon (``serve`` in a process of its own, on the card, a
    journal, tracing on, the gang's buckets warmed): (i) a warm first job
    through ``submit``, then four jobs ganged behind a blocker job — phase
    6 (a)'s untagged sample, phase 7's degraded sample, ``sample.bam`` and
    (a)'s settings at seed 43 — each tree equal to its one-shot run of
    this call (records, stats less backend lines, the manifest's stages,
    ``qc.json`` less its vote plane, which a ganged job has not, as in the
    JAX package), ``sample.bam``'s the goldens; a ``device.batch`` trace
    event naming two or more jobs; the gang's B1 dense launches (one per
    batch) beside the batches each job would fill alone, each job's
    latency, the Prometheus text; (ii) a ``pipeline: streaming`` job in a
    gang of two finishes from the gang's in-memory hand-off, its finals
    equal to its one-shot streaming run; (iii) ``CCT_FAULTS=serve.worker=
    kill:SIGKILL`` (once, across restarts) kills the daemon with its job
    dispatched; restarted on the same journal it replays the job through
    ``--resume`` to its one-shot tree and reports the replay; (iv)
    ``CCT_SANITIZE=1 consensus`` on ``sample.bam`` keeps the goldens and
    a planted ``.item()`` in a guarded stage raises ``StageTransferError``;
12. the fleet, held to phase 11's one-shot trees: (i) ``route --spawn 2
    --ring_view V --result_cache P`` in a process of its own (it opens no
    CUDA context; its workers share the library phase 2 built, through
    ``--compile_cache``) serves the four 600-fragment jobs, ``sample.bam``
    (the goldens) and phase 6 (a)'s untagged sample, each tree equal to
    its one-shot run (records, stats less backend lines, manifest stages,
    ``qc.json`` less its plane when ganged); each job's node and the
    router's overhead on it, each worker's B1 launches, the gangs' B1
    dense launches (one per batch) and the ``cct_fleet_*`` lines; the
    router and its workers also run the sampling profiler and the history
    recorder (``CCT_PROF=1``, ``CCT_HISTORY_DIR``), and while the fleet is
    up one reader process (no CUDA context) runs ``trace fleet`` (a lane
    per process, the workers' ``device.dispatch`` spans, one
    ``serve.critpath`` event per job), ``critpath report|job`` (each job's
    segments summing to its wall), ``prof report|flame`` (per-node wall
    attribution; the flame's samples the merge's), ``history query|trend``
    (every node's lines; the router's ``jobs_routed``) and ``top --once``
    (a row per worker); after the router stops, ``trace export`` of its
    shard directory holds at least the workers' spans; (ii) two
    ``serve`` daemons started by hand behind ``route --members ...
    --journals ...``: the ring owner of phase 7's degraded job kills itself
    with the job dispatched (``serve.worker=kill:SIGKILL``), the router
    resubmits it by key to the other daemon, whose tree equals the
    one-shot run (the seconds from the kill to the result); (iii) (i)'s
    ``OBJECT_FRAGMENTS``-fragment spec again under another tenant and
    output: answered ``cached`` by the router, no worker launching, every file the first
    tree's bytes (hit latency beside the miss's); (iv) a third daemon
    ``serve --warm_from V`` joins with ``member_add``: no kernel build
    (``cct_recompiles_total`` 0) and the job routed to it equals its
    one-shot run; (v) ``CCT_CANARY=1``: on that daemon the self-minted
    golden equals ``output_digest`` of a ``--device cpu`` run of the probe
    made here and ``cct_canary_ok`` reads 1; on (ii)'s surviving daemon a
    wrong ``CCT_CANARY_GOLDEN`` flips it to 0;
13. the reference's flow from FASTQ: (i) ``run_extract`` on the committed
    FASTQ pair (``--bpattern NNNNNNT``): the 6 ``extract`` digests of
    ``test/golden.json``; (ii) ``simulate_fastq_pairs`` at phase 5's
    widths (``FASTQ_FRAGMENTS``, read length 100, UMI 6, mean family 3,
    duplex fraction 0.8, seed 42, ``ref_len`` 40 x fragments), then
    ``fastq2bam --bwa builtin --host_workers 4`` in a process of its own
    (host only: no CUDA context, the align pool forked, no indel
    warning): the extract and align walls, reads/s beside the host's
    cores, the unmapped share; (iii) the same settings at
    ``FASTQ_PARITY_FRAGMENTS`` with seed 43 through ``--host_workers`` 1
    and 4 (every output file byte-equal), then ``consensus --scorrect
    True`` on that BAM on the card and with ``--device cpu``: the aligner
    writes ``NM`` on every read, so rescue and DCS take the window walks;
    the trees equal (records with tags, stats less backend lines, the
    manifest's stages, ``qc.json``; ``qc report`` of each and ``qc diff``
    between them: every rate delta zero, ``spectrum_tv`` 0.0), the card
    run's step walls and B1 launches beside phase 6's tagged wall per
    fragment; (iv) the
    standalone stage entries on ``sample.bam`` (``sscs_maker``, then
    ``singleton_correction``, then ``dcs_maker`` on the SSCS BAM, then
    ``generate_plots``), each on the card in a process of its own, against
    the same entry with ``--device cpu``: every BAM record by record, the
    stats less backend lines, the SSCS and rescue outputs the
    ``consensus`` goldens;
14. the library's member-stream entries and the host backends: (i)
    ``consensus_families_stream`` (ragged families of a
    ``LIBRARY_FRAGMENTS``-fragment sample at phase 5's widths) and
    ``consensus_blocks_stream`` (that sample's family blocks) on the card,
    each batch one B1 launch (counted from 0 per entry), family by family
    equal to the ``device="cpu"`` run, the card's wall beside the plain
    version's; (ii) ``consensus --backend reference`` and ``--backend
    cpu`` on ``sample.bam``, ``sample_adversarial.bam`` and a
    ``HOST_FRAGMENTS``-fragment sample, in a process of its own that opens
    no CUDA context and builds no kernel: every tree equal to the card's
    ``--device cuda`` run of the same input (records, stats less backend
    lines), each wall beside the card run's; (iii)
    ``IndexedBamReader.fetch`` on the card run's SSCS BAM of (ii)'s sample
    over seeded random regions, equal to a linear scan;
15. training and the last public names: (i) the distilled head's trainer
    (``python -m consensuscruncher_tpu_torch.policies.distill_train``) at
    its defaults on the card, within the stated tolerances of the
    committed checkpoint (every weight within 1e-4, every held-out
    accuracy within 0.001, every ``n`` exact, distilled above majority on
    mixed and degraded, the rest equal but ``meta.tool``), and at
    ``TRAIN_CUT`` on the card and with ``--device cpu``, the card's within
    the same tolerances of the CPU's; each run's seconds, the card's
    steps/s and CUDA launches per step; (ii) the card-trained file
    as ``DistilledPolicy(checkpoint=...)`` voting phase 7's stream batch
    on the card, equal to its plain version; (iii)
    ``policies.majority_family_vote`` on phase 6 (b)'s largest bucket, one
    family per call, with and without the rider: one B1 dense launch per
    call (counted from 0, the B1 dense row's
    ``majority_family_vote_launches``), each output equal to the plain
    version's;
16. the quality and capacity yardsticks (``tools/ci_check.sh:184-298`` on
    the card): (i) ``utils.accuracy_harness`` at ``BENCH_QC_r17.json``'s
    config (400 fragments, seed 7, half the reads degraded, the three
    policies) on the card with ``--repeats 2`` and with ``--device cpu
    --repeats 1``: both artifacts' ``accuracy`` and ``qc`` equal each other
    and that file's; each pipeline run's B1 launches counted from 0 (every
    majority run launches B1, with the QC rider on every launch of a qc-on
    run and on none of a qc-off run; a delegation or distilled run votes
    with torch ops and launches none); ``utils.qc_gate --smoke`` passes the
    card's artifact against the newest committed ``BENCH_QC_r*.json`` and
    fails the ``--corrupt 0.02`` control and a ``--policy distilled`` run
    under a rigged checkpoint (``b2`` calling C at full confidence); (ii)
    two ``utils.loadgen`` passes, each against its own spawned ``serve``
    on the card (the tool's input sizes, ``LOADGEN_CUT``, the kernel
    library of phase 2 as ``--compile_cache``), the second under the
    sampling profiler: no lost job at any level, a knee throughput above 0,
    the SLO classes, the daemon's gangs' B1 dense launches (one per batch,
    from its ``serve.gang_batches`` trace events) above 0, and
    ``utils.perf_gate --smoke`` passing pass 2 against pass 1;
17. the soaks, the fleet's HA paths on the card ((i) right after phase
    12; (ii) and (iii) in a process of their own started after phase 11,
    beside phases 12-15, and joined before phase 16, whose latencies they
    would disturb): (i)
    ``utils.trace_check``'s schema check and fleet check (journal
    agreement, one component per trace, anchors, terminals) over phase 12
    (i)'s ``trace fleet`` output and that fleet's worker journals as they
    stood then: no problem, the ``fleet_summary`` printed; (ii)
    ``utils.serve_soak --jobs 3 --seed 7 --kill-after 0.2`` on the card
    (the supervised daemon traced; the tool run as it stands): exit 0,
    the kill -9 landing while jobs are in flight (at least one job
    replayed from the journal, a ``journal-replay`` flight dump), every
    job's tree on the goldens; each job's wall, the restart's seconds and
    the daemon's B1 launches before the kill and after the restart, read
    over its socket as the soak signals it (``--gang_size 1``: each job
    runs solo, B1 on the stream wire; the B1 row's ``soak_launches``);
    (iii) the ``utils.chaos_conductor`` ``--smoke`` leg on the card at 4
    random events, not 8 (the time limit; seed 7, 3 workers, every
    structural event: standby takeover by epoch bump, journal adoption
    and its tombstone, the zombie dropping adopted jobs,
    ``member_add``/``member_remove``, the poison key quarantined under the
    fleet retry budget, the ENOSPC brownout), the kernel library of phase
    2 shared by every worker spawn: exit 0 (every invariant after every
    event, every acknowledged job byte-identical to the goldens), or exit
    1 on the one violation that the reference's lost poison verdict makes
    where the schedule kills the quarantine's holder for good (ROADMAP,
    "Faults found in the reference"; judged by
    ``chaos_conductor.reference_poison_fault``, as the CPU tests judge
    it, and the branch taken printed as ``outcome``); at least one
    takeover, adoption, quarantine and brownout, no orphaned span; the
    spawns, the kills, each event's wall, each worker's B1 launches read
    before it dies (where it lives long enough to be read; the B1 row's
    ``chaos_launches``), and at each such read the workers alive (each
    holds a CUDA context) and the compute apps ``nvidia-smi
    --query-compute-apps`` lists on the card.

Phase 17 (ii)-(iii) runs in a process of its own beside phases 12-15: run
after phase 16 the smoke outgrows its time limit (PERF.md section 7).  The
lines those phases emit meanwhile carry ``"beside": "soaks"``: their walls
carry the soaks' load and are not compared with runs without it.  Every
JSON line carries ``t_s``, the seconds since the script started (the
background phases' own lines: since their process started;
``soaks_process`` gives its seconds and how long the script waited for
it).

The ``policies`` JSON comes next, then the ``fleet_obs`` JSON (the obs
readers' exit codes and seconds, phase 12 (i)'s critical-path p50/p99 per
segment, each node's profiler wall attribution, phase 13 (iii)'s ``qc
diff``, the smoke's seconds); the line before the last is the ``kernels``
JSON; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import glob
import hashlib
import importlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from consensuscruncher_tpu_torch import cli as port_cli  # noqa: E402
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
    build_codebook,
    build_codebook4,
    encode_wire,
    pack,
    pack4,
    unpack4_device,
    unpack_wire,
)
from consensuscruncher_tpu_torch.parallel import distributed  # noqa: E402
from consensuscruncher_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from consensuscruncher_tpu_torch.parallel.batching import MAX_BATCH, bucket_member_blocks  # noqa: E402
from consensuscruncher_tpu_torch.policies import distill_train, distilled  # noqa: E402
from consensuscruncher_tpu_torch.policies import majority_family_vote  # noqa: E402
from consensuscruncher_tpu_torch.serve.canary import (  # noqa: E402
    CANARY_FRAGMENTS,
    CANARY_SEED,
    output_digest,
)
from consensuscruncher_tpu_torch.serve.client import ServeClient  # noqa: E402
from consensuscruncher_tpu_torch.serve.journal import idempotency_key, replay  # noqa: E402
from consensuscruncher_tpu_torch.serve.router import HashRing  # noqa: E402
from consensuscruncher_tpu_torch.io.bai import IndexedBamReader  # noqa: E402
from consensuscruncher_tpu_torch.io.bam import BamReader, BamWriter  # noqa: E402
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader  # noqa: E402
from consensuscruncher_tpu_torch.stages import dcs_maker, singleton_correction  # noqa: E402
from consensuscruncher_tpu_torch.stages.extract_barcodes import run_extract  # noqa: E402
from consensuscruncher_tpu_torch.utils.ragged import scatter_runs  # noqa: E402
from consensuscruncher_tpu_torch.stages.generate_plots import decode_png  # noqa: E402
from consensuscruncher_tpu_torch.stages.grouping import (  # noqa: E402
    stream_families_columnar,
    stream_family_blocks,
)
from consensuscruncher_tpu_torch.utils import (  # noqa: E402
    accuracy_harness,
    chaos_conductor,
    loadgen,
    perf_gate,
    qc_gate,
    serve_soak,
    trace_check,
)
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches, text_digest  # noqa: E402
from consensuscruncher_tpu_torch.utils.phred import N, NUM_BASES, PAD  # noqa: E402
from consensuscruncher_tpu_torch.utils.profiling import trace_summary  # noqa: E402
from consensuscruncher_tpu_torch.utils.simulate import (  # noqa: E402
    SimConfig,
    simulate_bam,
    simulate_bam_fast,
    simulate_fastq_pairs,
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


_T0 = time.perf_counter()
# set while phase 17 (ii)-(iii) runs in its own process: every line emitted
# meanwhile says so, its walls taken beside the soaks' fleets
BESIDE: dict = {}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - _T0, **BESIDE, **fields}),
          flush=True)


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
# (pipeline, residency) per turn, uninstrumented: staged (phase 9's N = 1
# wall) and streaming (the residency-off turn was cut to make room for
# phase 9; PERF.md section 4 lists the cuts).
WALL_TURNS = (("staged", "True"), ("streaming", "True"))
# the object-path samples (tagged input, --max_mismatch 1): phase 5's
# settings at 30,000 fragments (the walks decode every record in Python,
# and each stage runs again on the CPU for its reference; with phase 17 the
# smoke fits its time limit on slower card hosts only at this depth,
# PERF.md section 4)
OBJECT_FRAGMENTS = 30_000
# the --max_mismatch 1 cell's sample, cut from OBJECT_FRAGMENTS to make
# room for phase 9 (its rescue walk is host-bound, ~0.45 ms a fragment)
MM1_FRAGMENTS = 20_000
BARCODE_ERROR_RATE = 0.15  # test/make_test_data.py's sample_bcerr.bam rate
# the stage-to-stage BAMs streaming writes only as taps
INTERMEDIATES = ("sscs/sim.singleton.sorted.bam", "singleton/sim.sscs.rescue.sorted.bam",
                 "singleton/sim.singleton.rescue.sorted.bam", "dcs/sim.sscs.rescued.bam")


def phase_walls(dev, sim_bam: str, work: str, card: str, main_wall: float) -> dict:
    """The phase-5 command again, uninstrumented, in turns (``WALL_TURNS``):
    step walls and ``run.metrics.json`` per run, beside ``main_wall``, phase
    5's counted (staged) run's, whose device calls were synchronised for
    their timers.  A staged run's BAMs must
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

    staged, streaming = [main_wall] + walls("staged", "True"), walls("streaming", "True")
    row = {"card": card, "turns": [list(t) for t in WALL_TURNS], "bams": len(want),
           "staged_walls_s": staged, "streaming_walls_s": streaming,
           "staged_uninstrumented_wall_s": walls("staged", "True")[0],
           "streaming_minus_staged_least_s": min(streaming) - min(staged)}
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
    """(c) ``--max_mismatch 1`` on phase 5's settings at ``MM1_FRAGMENTS``
    fragments with barcode errors (another seed): Hamming launches and
    their synchronised seconds; the rescue stage again with
    ``device="cpu"`` writes the same records."""
    bam = os.path.join(work, "mm1.bam")
    cfg = SimConfig(n_fragments=MM1_FRAGMENTS, ref_len=40 * MM1_FRAGMENTS,
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
    row = {"card": card, "fragments": MM1_FRAGMENTS, "barcode_error_rate": BARCODE_ERROR_RATE,
           "wall_s": wall, "steps_s": res["walls"], "hamming_launches": launches,
           "hamming_s": ham_s, "cpu_rescue_s": cpu_s,
           "singletons": stats.get("singletons_total"),
           "rescued_by_sscs": stats.get("rescued_by_sscs"),
           "rescued_by_singleton": stats.get("rescued_by_singleton")}
    emit("mm1", **row)
    return row


# ------------------------------------------------------------ vote policies

POLICIES = ("delegation", "distilled")
# the policies run at phase 5's scale: distilled's run there was cut to
# make room for phase 9 (PERF.md section 6 keeps its earlier numbers)
SCALE_POLICIES = ("delegation",)
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
        if label == "degraded":  # phase 9's batch holds its tree to this run
            os.replace(os.path.join(root, "majority"), os.path.join(work, "degraded_majority"))
        shutil.rmtree(root)
    return out


def phase_policy_scale(dev, sim_bam: str, work: str, plane: dict, card: str) -> dict:
    """(3) Phase 5's sample, staged, under each of ``SCALE_POLICIES``: walls
    and the SSCS step beside the majority run of this call (phase 5's
    counted run);
    delegation's SSCS BAM equals majority's byte for byte (every read has
    quals 25-40, so every member is high), the ``qc.json`` plane is
    majority's (``plane``, the majority run's: its ``qc.json`` now holds
    the resume run's); the policy votes per run counted, no B1 launch."""
    shas_m = _bam_sha256(os.path.join(work, "sim"))
    rows = {}
    for policy in SCALE_POLICIES:
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

    def at_scale(p, key, sub=None):
        run = policy_scale.get(p)  # None: not run at phase 5's scale (SCALE_POLICIES)
        return None if run is None else (run[key][sub] if sub else run[key])

    rows = [
        {**POLICY_ROWS[p], "ms": policies["batch"][p]["ms"],
         "qc_ms": policies["batch"][p]["qc_ms"],
         "b1_call_ms": policies["b1_call_ms"], "shape": policies["shape"],
         "calls_per_run": at_scale(p, "policy_stream_calls"),
         "launches_per_call": policies["batch"][p]["launches"],
         "qc_launches_per_call": policies["batch"][p]["qc_launches_per_call"],
         "copies_per_call": policies["batch"][p]["copies"],
         "max_abs_err": max(policies["batch"][p]["errs"]),
         "dense_ms": policies["dense"][p]["ms"],
         "dense_launches_per_call": policies["dense"][p]["launches"],
         "dense_b1_ms": policies["dense"]["b1_ms"],
         "run_wall_s": at_scale(p, "wall_s"),
         "run_policy_vote_s": at_scale(p, "policy_stream_s"),
         "run_sscs_s": at_scale(p, "steps_s", "sscs"),
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


# ----------------------------------------------------- phase 9: the whole command

HOST_WORKERS = (2, 4)
# A host-sharded parent in a process of its own: it opens no CUDA context
# (the smoke's own process holds one), so it reports whether torch did.
_PARENT = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from consensuscruncher_tpu_torch.cli import main
t = time.perf_counter()
res = main(sys.argv[2:])
print(json.dumps({"wall_s": time.perf_counter() - t, "steps_s": res["walls"],
                  "pipeline": res["pipeline"],
                  "parent_cuda_initialized": torch.cuda.is_initialized()}))
"""
SIDECARS = ("sscs/{n}.metrics.json", "singleton/{n}.singleton.metrics.json",
            "dcs/{n}.dcs.metrics.json")
PLOTS = ("family_size", "read_recovery", "stage_times")


@functools.lru_cache(maxsize=None)
def _reference_digest(path: str) -> str:
    """:func:`_record_digest` of a run's BAM that several trees are held
    to (phase 5's, read once)."""
    return _record_digest(path)


def _record_digest(path: str) -> str:
    """sha256 of a BAM's header text and its records' bytes, in file order
    (records are length-prefixed, so equal digests mean equal records,
    tags included), whatever the BGZF blocking."""
    h = hashlib.sha256()
    with ColumnarReader(path) as reader:
        h.update(reader.header.text.encode())
        for batch in reader.batches():
            h.update(batch.buf[:int(batch.rec_off[-1])].tobytes())
    return h.hexdigest()


def _no_backend(path: str) -> list:
    with open(path) as fh:
        return [ln for ln in fh if "backend" not in ln]


def _bam_rels(base: str, name: str) -> list:
    """The BAMs of run ``name`` under ``base`` (not a worker's), as
    ``dir/{n}.suffix`` patterns."""
    return sorted(os.path.join(os.path.relpath(root, base), "{n}" + f[len(name):])
                  for root, _dirs, files in os.walk(base) if ".ranges" not in root
                  for f in files if f.endswith(".bam") and f.startswith(name + "."))


def _same_tree(base: str, name: str, other: str, other_name: str) -> int:
    """``base`` (run ``name``) against ``other`` (run ``other_name``):
    every BAM record by record, the stats and ``read_families.txt`` less
    their backend lines.  Returns the number of BAMs held."""
    rels = _bam_rels(base, name)
    if rels != _bam_rels(other, other_name) or len(rels) != 11:
        raise AssertionError(f"{base}: BAMs {rels}, against {_bam_rels(other, other_name)}")
    for rel in rels:
        mine = os.path.join(base, rel.format(n=name))
        if _record_digest(mine) != _reference_digest(
                os.path.join(other, rel.format(n=other_name))):
            raise AssertionError(f"{mine}: records differ from {other}'s")
    for rel in ("sscs/{n}.sscs_stats.txt", "singleton/{n}.singleton_stats.txt",
                "dcs/{n}.dcs_stats.txt", "sscs/{n}.read_families.txt"):
        if _no_backend(os.path.join(base, rel.format(n=name))) != \
                _no_backend(os.path.join(other, rel.format(n=other_name))):
            raise AssertionError(f"{base}: {rel.format(n=name)} differs from {other}'s")
    return len(rels)


def _outputs_whole(base: str, name: str, sidecar_bases) -> None:
    """(iv) the three PNGs decode and every run's three stage sidecars
    exist with a ``cumulative`` block (for a host-sharded tree, each
    worker's under ``.ranges``)."""
    for plot in PLOTS:
        with open(os.path.join(base, "plots", f"{name}.{plot}.png"), "rb") as fh:
            decode_png(fh.read())
    for run_base, run_name in sidecar_bases:
        for rel in SIDECARS:
            with open(os.path.join(run_base, rel.format(n=run_name))) as fh:
                if "cumulative" not in json.load(fh):
                    raise AssertionError(f"{run_base}: {rel} has no cumulative block")


def phase_host_workers(dev, sim_bam: str, work: str, scale: dict, n1_wall: float,
                       card: str) -> dict:
    """(i) ``--host_workers 2`` and ``4`` on phase 5's sample, each parent
    in a process of its own, on the card: every merged tree record by
    record and its stats to phase 5's counted run; the walls beside
    ``n1_wall``, the uninstrumented staged turn's (the N = 1 wall); each
    worker's SSCS sidecar on the card with bytes uploaded; the parent
    opened no CUDA context.  ``--resume True`` on a fresh output keeps the
    worker trees (``.ranges``) for those checks; nothing is skipped."""
    rows = {"card": card, "cores": len(os.sched_getaffinity(0)), "n1_wall_s": n1_wall,
            "n1_counted_wall_s": scale["wall_s"]}
    for n in HOST_WORKERS:
        out = os.path.join(work, f"hw{n}")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _PARENT, REPO, "consensus", "-i", sim_bam, "-o", out,
             "-n", "sim", "--scorrect", "True", "--device", dev.type, "--host_workers", str(n),
             "--resume", "True"],
            capture_output=True, text=True, timeout=900)
        command_s = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"--host_workers {n} failed:\n{proc.stderr[-4000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        if run["parent_cuda_initialized"] or run["pipeline"] != f"host_sharded[{n}]":
            raise AssertionError(f"--host_workers {n}: {run}")
        base = os.path.join(out, "sim")
        bams = _same_tree(base, "sim", os.path.join(work, "sim"), "sim")
        workers = [(os.path.join(base, ".ranges", f"r{i}"), f"r{i}") for i in range(n)]
        _outputs_whole(base, "sim", workers)
        uploads = []
        for wbase, wname in workers:
            with open(os.path.join(wbase, "sscs", f"{wname}.metrics.json")) as fh:
                doc = json.load(fh)
            if doc["backend"] != dev.type or (dev.type == "cuda"
                                              and doc["cumulative"]["bytes_h2d"] <= 0):
                raise AssertionError(f"worker {wname}: {doc['backend']}, "
                                     f"{doc['cumulative']['bytes_h2d']} bytes uploaded")
            uploads.append(doc["cumulative"]["bytes_h2d"])
        shutil.rmtree(out)
        rows[f"n{n}"] = {"wall_s": run["wall_s"], "command_s": command_s,
                         "steps_s": run["steps_s"], "bams_equal": bams,
                         "worker_bytes_h2d": uploads, "parent_cuda_initialized": False}
        emit("host_workers", card=card, workers=n, cores=rows["cores"], **rows[f"n{n}"],
             n1_wall_s=n1_wall, n1_counted_wall_s=scale["wall_s"])
    return rows


def phase_batch(dev, work: str, single_walls: dict, card: str) -> dict:
    """(ii) a two-sample batch, majority: phase 6 (a)'s untagged sample and
    phase 7's degraded sample, in one process, each tree equal record by
    record, stats and ``qc.json`` (less its run name) to that sample's own
    run in this call; the second sample's decode prestaged."""
    bams = {"obj": os.path.join(work, "obj.bam"), "degraded": os.path.join(work, "degraded.bam")}
    singles = {"obj": (os.path.join(work, "untagged", "obj"), "obj"),
               "degraded": (os.path.join(work, "degraded_majority", "p"), "p")}
    prestaged = []
    run_sscs = port_cli.run_sscs

    def spy(*args, **kwargs):
        prestaged.append(kwargs.get("prestaged") is not None)
        return run_sscs(*args, **kwargs)

    out = os.path.join(work, "batch")
    port_cli.run_sscs = spy
    consensus_vote.launches = 0
    try:
        t = time.perf_counter()
        cli_main(["consensus", "-i", ",".join(bams.values()), "-o", out, "--scorrect", "True",
                  "--device", dev.type])
        wall = time.perf_counter() - t
    finally:
        port_cli.run_sscs = run_sscs
    launches = consensus_vote.launches
    if launches == 0 or prestaged != [False, True]:
        raise AssertionError(f"the batch launched B1 {launches} times, prestaged {prestaged}")
    held = {}
    for name, (single, single_name) in singles.items():
        base = os.path.join(out, name)
        held[name] = _same_tree(base, name, single, single_name)
        mine, theirs = _qc_doc(base), _qc_doc(single)
        mine.pop("run"), theirs.pop("run")
        if mine != theirs:
            raise AssertionError(f"batch {name}: qc.json differs from its single run's")
        _outputs_whole(base, name, [(base, name)])
    shutil.rmtree(out)
    row = {"card": card, "wall_s": wall, "single_walls_s": single_walls,
           "single_sum_s": sum(single_walls.values()), "second_prestaged": prestaged[1],
           "b1_launches": launches, "bams_equal": held}
    emit("batch", **row)
    return row


def phase_config_profile(dev, work: str, card: str) -> dict:
    """(iii) ``-c config.ini`` (the committed file: ``backend = tpu``, so
    the card) on ``sample.bam``: the goldens hold.  Then ``-c config.ini
    --profile DIR`` on phase 6 (a)'s untagged sample (``OBJECT_FRAGMENTS``
    fragments), as a user runs it: ``python -m
    consensuscruncher_tpu_torch.cli`` in a process of its own (a trace
    taken late in a long process can miss kernels).  Its records equal
    that sample's run in this call; the Chrome trace names
    ``vote_tiles_kernel``; the device's busy share of the traced window
    (``utils.profiling.trace_summary``) is that of a whole run at real
    size."""
    golden = json.load(open(os.path.join(REPO, "test", "golden.json")))
    config = os.path.join(REPO, "config.ini")
    device = ["--device", "cpu"] if dev.type == "cpu" else []
    out = os.path.join(work, "config")
    consensus_vote.launches = 0
    cli_main(["consensus", "-c", config, "-i", os.path.join(REPO, "test", "data", "sample.bam"),
              "-o", out, "-n", "golden", *device])
    base = os.path.join(out, "golden")
    bad = golden_mismatches(base, golden["consensus"])
    if bad or _qc_doc(base)["plane"] is None or consensus_vote.launches == 0:
        raise AssertionError(f"-c config.ini: goldens {bad}, qc.json {_qc_doc(base)}, "
                             f"{consensus_vote.launches} launches")
    _outputs_whole(base, "golden", [(base, "golden")])
    shutil.rmtree(out)

    out, prof = os.path.join(work, "profiled"), os.path.join(work, "profile")
    t = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "consensus", "-c", config,
         "-i", os.path.join(work, "obj.bam"), "-o", out, "-n", "obj", "--profile", prof,
         *device],
        cwd=REPO, check=True, capture_output=True, timeout=600)
    wall = time.perf_counter() - t
    base = os.path.join(out, "obj")
    bams = _same_tree(base, "obj", os.path.join(work, "untagged", "obj"), "obj")
    _outputs_whole(base, "obj", [(base, "obj")])
    with open(os.path.join(base, "run.metrics.json")) as fh:
        run_wall = json.load(fh)["wall_s"]
    (trace,) = os.listdir(prof)
    summary = trace_summary(os.path.join(prof, trace))
    vote = {k: v for k, v in summary["kernels"].items() if KERNEL in k}
    if not vote:
        with open(os.path.join(prof, trace)) as fh:
            events = json.load(fh)["traceEvents"]
        cats: dict = {}
        for ev in events:
            cats[ev.get("cat")] = cats.get(ev.get("cat"), 0) + 1
        raise AssertionError(f"the trace names no {KERNEL}: categories {cats}, kernels "
                             f"{sorted(k[:80] for k in summary['kernels'])}")
    top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["us"])[:5]
    row = {"card": card, "fragments": OBJECT_FRAGMENTS, "command_s": wall,
           "run_wall_s": run_wall, "bams_equal": bams,
           "trace_bytes": os.path.getsize(os.path.join(prof, trace)),
           "window_us": summary["window_us"], "device_busy_us": summary["device_busy_us"],
           "device_busy_share": summary["device_busy_share"],
           "device_events": summary["device_events"],
           "vote_launches": sum(k["count"] for k in vote.values()),
           "vote_us": sum(k["us"] for k in vote.values()),
           "top_kernels": [{"name": k[:120], **v} for k, v in top]}
    shutil.rmtree(out)
    shutil.rmtree(prof)
    emit("config_profile", **row)
    return row


# ------------------------------------------------------------ multi-device

# phase 10 (v): the library steps' shard counts (1 = the unsharded step)
STEP_SHARDS = (1, 2, 4)
DRYRUN_DEADLINE_S = 300
# A process of the two-process distributed dryrun (gloo: NCCL refuses two
# ranks on one card), its JSON result last.
_DRYRUN = ("consensuscruncher_tpu_torch.parallel.distributed", "--dist_backend", "gloo",
           "--local-devices", "2", "--num-processes", "2")


def _mesh_run(argv, counts: dict) -> tuple[float, dict]:
    """One ``consensus --devices N`` run in this process: its wall and
    result, with the sharded votes counted and timed (synchronised) into
    ``counts`` and the B1 launches of the run (set to 0 just before, read
    just after)."""
    acc: dict[str, float] = {}
    calls: dict[str, int] = {}
    restores = [
        _synced_timer(mesh_mod, "stream_vote_sharded", acc, "stream", calls),
        _synced_timer(mesh_mod, "sharded_vote_async", acc, "dense", calls),
        _synced_timer(dcs_maker, "duplex_batch_host_sharded", acc, "duplex", calls)]
    consensus_vote.launches = consensus_vote.qc_launches = consensus_vote.fused_launches = 0
    residency.pair_votes = residency.against_votes = 0
    try:
        t = time.perf_counter()
        res = cli_main(argv)
        wall = time.perf_counter() - t
    finally:
        for restore in restores:
            restore()
    counts.update(
        b1_launches=consensus_vote.launches, qc_launches=consensus_vote.qc_launches,
        resident_votes=residency.pair_votes + residency.against_votes,
        stream_calls=calls["stream"], dense_calls=calls["dense"],
        duplex_calls=calls["duplex"], vote_s=acc["stream"] + acc["dense"],
        duplex_s=acc["duplex"])
    if counts["qc_launches"] or counts["resident_votes"]:
        raise AssertionError(f"a mesh run armed the QC rider or residency: {counts}")
    return wall, res


def _step_inputs(rng, b: int, f: int, length: int):
    """Two strand batches of ``b`` families of up to ``f`` members at
    ``length``: pure-ACGT bases and binned quals (every wire takes them),
    dead slots base 0 and qual ``BINNED[0]``, strand B missing in every
    fifth pair."""
    strands = []
    for _ in range(2):
        bases = rng.integers(0, 4, (b, f, length)).astype(np.uint8)
        quals = BINNED[rng.integers(0, 4, (b, f, length))]
        sizes = rng.integers(1, f + 1, b).astype(np.int32)
        dead = np.arange(f)[None, :] >= sizes[:, None]
        bases[dead], quals[dead] = 0, BINNED[0]
        strands.append((bases, quals, sizes))
    strands[1][2][::5] = 0
    return strands


def phase_library_steps(dev, card: str) -> dict:
    """(v) the mesh library steps at the JAX package's shape
    ``B8192_F16_L100``, over ``STEP_SHARDS`` shards of the card, inputs on
    the card: ``sharded_consensus_batch`` (B1's dense form per shard) and
    ``full_pipeline_step``, ``packed_pipeline_step`` (pack8) and
    ``packed4_pipeline_step`` (B2 per shard).  Every sharded result equals
    the unsharded kernel's (B1's or B2's dense form) and its plain version
    on the card, exactly, and its stats the unsharded step's; each step's
    launches are one per shard, and its ms per step (CUDA events) is
    printed per shard count."""
    b, f, length = DENSE_SHAPES["B8192_F16_L100"]
    rng = np.random.default_rng(81)
    (ba, qa, na), (bb, qb, nb) = _step_inputs(rng, b, f, length)
    book8 = build_codebook(BINNED)
    book4 = build_codebook4(BINNED)
    on_card = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        ba=ba, qa=qa, bb=bb, qb=qb, pa8=pack(ba, qa, book8), pb8=pack(bb, qb, book8),
        pa4=pack4(ba, qa, book4), pb4=pack4(bb, qb, book4)).items()}
    starts = torch.arange(b, dtype=torch.int64) * f
    flat = {k: on_card[k].reshape(b * f, length) for k in ("ba", "qa", "bb", "qb")}
    # the unsharded kernels and their plain versions on the same inputs
    b1 = torch.stack(consensus_vote.consensus_batch(on_card["ba"], on_card["qa"], na))
    b1_plain = consensus_vote.vote_members_plain(flat["ba"], flat["qa"], na, starts=starts)
    b2 = torch.stack(consensus_vote.duplex_batch(on_card["ba"], on_card["qa"], na,
                                                 on_card["bb"], on_card["qb"], nb))
    b2_plain = consensus_vote.duplex_members_plain(flat["ba"], flat["qa"], na, flat["bb"],
                                                   flat["qb"], nb, starts_a=starts,
                                                   starts_b=starts)
    for name, got, want in (("B1", b1, b1_plain), ("B2", b2, b2_plain)):
        if not torch.equal(got, want):
            raise AssertionError(f"{name} dense at B8192_F16_L100 differs from its plain version")
    rows: dict[str, dict] = {}
    base_stats: dict[str, list] = {}
    for shards in STEP_SHARDS:
        mesh = mesh_mod.make_mesh(devices=[dev] * shards)
        steps = {
            "sharded_consensus_batch": (
                lambda m=mesh: mesh_mod.sharded_consensus_batch_async(
                    on_card["ba"], on_card["qa"], na, m), "b1"),
            "full_pipeline_step": (
                lambda m=mesh: mesh_mod.full_pipeline_step(m)(
                    on_card["ba"], on_card["qa"], na, on_card["bb"], on_card["qb"], nb), "b2"),
            "packed_pipeline_step": (
                lambda m=mesh: mesh_mod.packed_pipeline_step(m)(
                    on_card["pa8"], na, on_card["pb8"], nb, book8), "b2"),
            "packed4_pipeline_step": (
                lambda m=mesh: mesh_mod.packed4_pipeline_step(m, length)(
                    on_card["pa4"], na, on_card["pb4"], nb, book4), "b2"),
        }
        for name, (step, kind) in steps.items():
            consensus_vote.launches = consensus_vote.fused_launches = 0
            out = step()
            launched = consensus_vote.launches if kind == "b1" else consensus_vote.fused_launches
            planes, stats = torch.stack(out[:-1]), out[-1].cpu().tolist()
            want = b1 if kind == "b1" else b2
            if launched != shards or not torch.equal(planes, want):
                raise AssertionError(f"{name} over {shards} shards: {launched} launches, "
                                     f"planes equal {torch.equal(planes, want)}")
            if base_stats.setdefault(name, stats) != stats:
                raise AssertionError(f"{name} over {shards} shards: stats {stats}, unsharded "
                                     f"{base_stats[name]}")
            rows.setdefault(name, {})[str(shards)] = {"ms": cuda_ms(step, 5),
                                                      "launches": launched}
    row = {"card": card, "shape": "B8192_F16_L100", "shards": list(STEP_SHARDS),
           "stats": base_stats, "steps": rows}
    emit("library_steps", **row)
    return row


def phase_dryrun(dev, card: str) -> dict:
    """(vi) the distributed dryrun: two processes of ``python -m
    consensuscruncher_tpu_torch.parallel.distributed`` (gloo, two shards
    each, all on this card), each with a deadline: both report the stats
    of the same global batch's ``full_pipeline_step`` over four shards in
    this process, ``stream_wire_ok``, and one fused and one SSCS launch per
    local shard."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", *_DRYRUN, "--device", dev.type,
         "--coordinator", f"127.0.0.1:{port}", "--process-id", str(i)], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    results = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=DRYRUN_DEADLINE_S)
            if proc.returncode != 0:
                raise AssertionError(f"dryrun process failed:\n{out[-2000:]}\n{err[-4000:]}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:  # never leave a rendezvous-blocked sibling behind
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t
    _rng, batch = distributed.dryrun_batch(2, 8, 4, 32, 7)
    want = mesh_mod.full_pipeline_step(mesh_mod.make_mesh(devices=[dev] * 4))(*batch)[-1]
    want = want.cpu().tolist()
    launches = 2 if dev.type == "cuda" else 0  # one of each per local shard on the card
    for r in results:
        got = [r["families"], r["duplexes"], r["n_count"], r["q_sum"]]
        if (got != want or not r["stream_wire_ok"] or r["backend"] != "gloo"
                or r["launches"] != {"sscs": launches, "fused": launches}
                or not r["device"].startswith(dev.type)):
            raise AssertionError(f"dryrun process {r['process_id']}: {r}, expected stats {want}")
    row = {"card": card, "seconds": seconds, "stats": want, "processes": results}
    emit("dryrun", **row)
    return row


def phase_devices(dev, sim_bam: str, work: str, scale: dict, walls: dict, card: str) -> dict:
    """Phase 10, multi-device (``--devices N``; on a box with one card the
    shards take turns on it), each run held to its one-device counterpart
    in this call: (i) ``--devices 2`` staged on phase 5's sample: records
    and stats (less backend lines) equal to phase 5's counted run, its
    ``qc.json`` that run's with no vote plane (a mesh arms no rider), one
    B1 launch per shard of every batch; (ii) the same under ``--pipeline
    streaming``: the finals byte for byte phase 5's; (iii) ``--devices 4
    --wire dense`` on phase 7's degraded sample: its majority run's
    records; (iv) ``--host_workers 2 --devices 2`` on phase 6 (a)'s
    untagged sample, the parent in a process of its own: (a)'s records,
    each worker's sidecar on the card; (v) the library steps; (vi) the
    distributed dryrun."""
    row: dict = {"card": card}
    main_base = os.path.join(work, "sim")
    want = _bam_sha256(main_base)
    ref_qc = _qc_doc(main_base)
    for label, extra in (("staged", []), ("streaming", ["--pipeline", "streaming"])):
        out = os.path.join(work, f"devices2_{label}")
        counts: dict = {}
        wall, res = _mesh_run(["consensus", "-i", sim_bam, "-o", out, "-n", "sim",
                               "--scorrect", "True", "--device", dev.type, "--devices", "2",
                               *extra], counts)
        base = os.path.join(out, "sim")
        # one launch per shard that holds families: both, but in a batch
        # too small to split
        if res["pipeline"] != label or counts["duplex_calls"] == 0 or not \
                counts["stream_calls"] < counts["b1_launches"] <= 2 * counts["stream_calls"]:
            raise AssertionError(f"--devices 2 {label}: {res['pipeline']}, {counts}")
        if label == "staged":
            bams = _same_tree(base, "sim", main_base, "sim")
            mine = _qc_doc(base)
            if mine["plane"] is not None or {**mine, "plane": 0} != {**ref_qc, "plane": 0}:
                raise AssertionError(f"--devices 2: qc.json {mine}")
        else:
            got = _bam_sha256(base)
            finals = {k: v for k, v in want.items() if k not in INTERMEDIATES}
            if got != finals:
                raise AssertionError("--devices 2 streaming: other finals than phase 5's")
            bams = len(got)
        shutil.rmtree(out)
        n1 = {"staged": walls["staged_uninstrumented_wall_s"],
              "streaming": min(walls["streaming_walls_s"])}[label]
        row[label] = {"wall_s": wall, "steps_s": res["walls"], "bams_equal": bams, **counts,
                      "n1_wall_s": n1, "n1_counted_wall_s": scale["wall_s"],
                      "n1_vote_s": scale["vote_s"], "n1_launches": scale["vote_kernel_launches"]}
        emit("devices", cell=f"devices2_{label}", **row[label])

    out = os.path.join(work, "devices4_dense")
    counts = {}
    wall, res = _mesh_run(["consensus", "-i", os.path.join(work, "degraded.bam"), "-o", out,
                           "-n", "p", "--scorrect", "True", "--device", dev.type, "--devices",
                           "4", "--wire", "dense"], counts)
    if counts["dense_calls"] == 0 or counts["b1_launches"] != 4 * counts["dense_calls"]:
        raise AssertionError(f"--devices 4 --wire dense: {counts}")
    bams = _same_tree(os.path.join(out, "p"), "p", os.path.join(work, "degraded_majority", "p"),
                      "p")
    shutil.rmtree(out)
    row["dense4"] = {"wall_s": wall, "steps_s": res["walls"], "bams_equal": bams, **counts,
                     "fragments": DEGRADED_FRAGMENTS}
    emit("devices", cell="devices4_dense", **row["dense4"])

    out = os.path.join(work, "hw2_devices2")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _PARENT, REPO, "consensus", "-i", os.path.join(work, "obj.bam"),
         "-o", out, "-n", "obj", "--scorrect", "True", "--device", dev.type,
         "--host_workers", "2", "--devices", "2", "--resume", "True"],
        capture_output=True, text=True, timeout=900)
    command_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"--host_workers 2 --devices 2 failed:\n{proc.stderr[-4000:]}")
    run = json.loads(proc.stdout.strip().splitlines()[-1])
    base = os.path.join(out, "obj")
    bams = _same_tree(base, "obj", os.path.join(work, "untagged", "obj"), "obj")
    for i in range(2):
        with open(os.path.join(base, ".ranges", f"r{i}", "sscs", f"r{i}.metrics.json")) as fh:
            doc = json.load(fh)
        if doc["backend"] != dev.type:
            raise AssertionError(f"worker r{i}: backend {doc['backend']}")
        with open(os.path.join(base, ".ranges", f"r{i}.stderr")) as fh:
            shards_line = "--devices 2: 2 shards over" in fh.read()
        if dev.type == "cuda" and torch.cuda.device_count() < 2 and not shards_line:
            raise AssertionError(f"worker r{i} did not name its shards over the card")
    shutil.rmtree(out)
    row["hw2_devices2"] = {"wall_s": run["wall_s"], "command_s": command_s,
                           "steps_s": run["steps_s"], "bams_equal": bams,
                           "fragments": OBJECT_FRAGMENTS}
    emit("devices", cell="host_workers2_devices2", **row["hw2_devices2"])
    row["library_steps"] = phase_library_steps(dev, card)
    row["dryrun"] = phase_dryrun(dev, card)
    return row


# ------------------------------------------------------------ phase 11: serve

# the dense buckets of the served gang's families (read length 100: L 128),
# each launched once when the daemon starts
SERVE_WARMUP = "1024x2x128,1024x4x128,1024x8x128"
SERVE_GANG = 4
# four small jobs of sample.bam's size (600 fragments, ~6,600 reads each):
# each fills its buckets far below max_batch, so a gang's jobs share them
SERVE_SMALL_SEEDS = (101, 102, 103, 104)
SERVE_SMALL_FRAGMENTS = 600
SAMPLE_BAM = os.path.join(REPO, "test", "data", "sample.bam")


class _Proc:
    """A CLI process of the smoke's (``what``: its command), its output in
    ``self.log``."""

    what = "serve"

    def tail(self) -> str:
        with open(self.log) as fh:
            return fh.read()[-3000:]

    def stop(self) -> None:
        """SIGTERM: the process drains and exits 0."""
        self.proc.send_signal(signal.SIGTERM)
        if self.proc.wait(timeout=300) != 0:
            raise AssertionError(f"{self.what} exited {self.proc.returncode}: {self.tail()}")

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


class _Daemon(_Proc):
    """``python -m consensuscruncher_tpu_torch.cli serve`` in a process of
    its own, as a user starts it: on the card (``--device cpu`` only when
    the smoke itself runs on the CPU), with a journal and tracing on.
    Started by :meth:`start`, which returns once healthz answers."""

    def __init__(self, work: str, tag: str, dev, env_extra=None, argv_extra=()):
        self.tag, self.dev, self.argv_extra = tag, dev, list(argv_extra)
        self.sock = os.path.join(work, f"{tag}.sock")
        self.journal = os.path.join(work, f"{tag}.wal")
        self.log = os.path.join(work, f"{tag}.log")
        self.env = dict(os.environ, CCT_TRACE="1",
                        CCT_TRACE_DIR=os.path.join(work, f"{tag}_trace"), **(env_extra or {}))
        self.proc = None

    def start(self) -> float:
        """Launch the daemon and wait until it serves; returns the seconds
        from launch to serving."""
        return self.launch().ready()

    def launch(self) -> "_Daemon":
        argv = [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "serve",
                "--socket", self.sock, "--journal", self.journal,
                "--gang_size", str(SERVE_GANG), "--warmup_shapes", SERVE_WARMUP,
                *self.argv_extra]
        if self.dev.type == "cpu":
            argv += ["--device", "cpu"]
        if os.path.exists(self.sock):  # a killed daemon's socket file
            os.unlink(self.sock)
        self.t_launch = time.perf_counter()
        with open(self.log, "a") as log:
            self.proc = subprocess.Popen(argv, cwd=REPO, env=self.env, stdout=log,
                                         stderr=subprocess.STDOUT)
        return self

    def ready(self) -> float:
        deadline = time.monotonic() + 600
        while not os.path.exists(self.sock):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"serve did not start: {self.tail()}")
            time.sleep(0.05)
        self.client = ServeClient(self.sock)
        if self.client.healthz()["status"] != "serving":
            raise AssertionError(f"serve is not serving: {self.tail()}")
        return time.perf_counter() - self.t_launch


def _serve_spec(inp: str, out: str, name: str, **extra) -> dict:
    return {"input": inp, "output": out, "name": name, "cutoff": 0.7, "qualscore": 0,
            "scorrect": True, "max_mismatch": 0, "bdelim": "|", "compress_level": 6,
            **extra}


def _submit_all(client, specs) -> tuple[list, list]:
    """Submit ``specs`` back to back; wait for each result on a thread of
    its own.  Returns the submit replies and ``(job, seconds from its
    submit to its result)`` per spec."""
    import threading

    subs, t_sub = [], []
    for spec in specs:
        t_sub.append(time.perf_counter())
        subs.append(client.submit_full(spec))
    done: list = [None] * len(specs)

    def wait(i):
        job = ServeClient(client.address).result(key=subs[i]["key"], timeout=900)
        done[i] = (job, time.perf_counter() - t_sub[i])

    threads = [threading.Thread(target=wait, args=(i,)) for i in range(len(specs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for job, _s in done:
        if job["state"] != "done":
            raise AssertionError(f"served job {job['job_id']} {job['state']}: {job.get('error')}")
    return subs, done


def _served_tree(base: str, one: str, name: str, ganged: bool = True) -> dict:
    """A served tree against its one-shot run: every BAM record by record,
    the stats less backend lines (``_same_tree``), the manifest's stage
    list and sscs params, and ``qc.json``: a ganged job's has no vote plane
    (the gang arms no plane sink, as the JAX package's daemon does) and
    equals the one-shot doc otherwise; a solo job's equals it whole."""
    bams = _same_tree(base, name, one, name)
    with open(os.path.join(base, "manifest.json")) as fh:
        got = json.load(fh)["stages"]
    with open(os.path.join(one, "manifest.json")) as fh:
        want = json.load(fh)["stages"]
    if sorted(got) != sorted(want) or got["sscs"]["params"] != want["sscs"]["params"]:
        raise AssertionError(f"{base}: manifest stages {sorted(got)} against {sorted(want)}")
    qc, qc_one = _qc_doc(base), _qc_doc(one)
    if ganged:
        qc_one = dict(qc_one, plane=None)
    if qc != qc_one:
        raise AssertionError(f"{base}: served qc.json differs from the one-shot run's")
    return {"bams_equal": bams, "stages": len(got)}


def _gang_event(client, done, dev) -> dict:
    """The served gang of ``done``'s jobs, from the daemon's trace: its
    ``serve.gang_batches`` event (batches, and the B1 launches the vote
    wrapper counted during the gang) and the ``device.batch`` events of
    its batches.  At least one batch must carry two or more jobs'
    families, and on the card every batch is one launch."""
    events = client.request({"op": "trace"})["trace"]["events"]
    ids = {job["trace_id"] for job, _s in done}
    batches = [e for e in events if e["name"] == "device.batch"
               and e["args"].get("trace_ids") and set(e["args"]["trace_ids"]) <= ids]
    shared = [e for e in batches if len(e["args"]["trace_ids"]) >= 2]
    gang = [e["args"] for e in events if e["name"] == "serve.gang_batches"
            and set(e["args"]["trace_ids"]) == ids]
    if not shared or len(gang) != 1 or gang[0]["batches"] != len(batches):
        raise AssertionError(f"no B1 dense launch carried two jobs' families "
                             f"({len(batches)} batches traced, {len(gang)} gangs)")
    gang = gang[0]
    # (the plain versions on the CPU launch nothing)
    if dev.type == "cuda" and gang["launches"] != gang["batches"]:
        raise AssertionError(f"{gang['launches']} B1 launches for {gang['batches']} gang batches")
    return {"launches": gang["launches"], "batches": gang["batches"],
            "families": gang["families"], "shared_batches": len(shared)}


def _one_shot(inp: str, out: str, name: str, dev, *extra) -> dict:
    """A one-shot ``consensus`` run in this process, its B1 launches counted
    from 0."""
    consensus_vote.launches = 0
    t = time.perf_counter()
    cli_main(["consensus", "-i", inp, "-o", out, "-n", name, "--scorrect", "True",
              "--device", dev.type, *extra])
    return {"wall_s": time.perf_counter() - t, "launches": consensus_vote.launches}


def phase_serve(dev, work: str, one_shot: dict, card: str) -> dict:
    """(i) a ``serve`` daemon on the card gangs four jobs — (a)'s untagged
    sample, the degraded sample, ``sample.bam`` and (a)'s settings at seed
    43 — into one SSCS dispatch stream of B1 dense launches, and then four
    small jobs of ``sample.bam``'s size, whose families share launches;
    each served tree equals its one-shot run of this call; (ii) a
    ``pipeline: streaming`` job finishes from its gang's in-memory
    hand-off and equals its one-shot streaming run; (iii) a daemon killed
    while its job is dispatched (``CCT_FAULTS=serve.worker=kill``)
    restarts on its journal, replays the job through ``--resume`` to the
    one-shot tree and reports the replay; (iv) ``CCT_SANITIZE=1
    consensus`` on ``sample.bam`` on the card keeps the goldens, a sync
    planted in the SSCS vote loop (``CCT_FAULTS=sscs.sync_probe=fail``)
    fails the run with ``StageTransferError`` on both wires, and so does a
    planted ``.item()`` inside a guarded stage.

    ``one_shot``: the one-shot runs of (a)'s untagged sample (``obj``) and
    the degraded sample (``p``) made by earlier phases of this call,
    ``{name: {"wall_s", "launches"}}``."""
    from consensuscruncher_tpu_torch.utils import sanitize

    golden = json.load(open(os.path.join(REPO, "test", "golden.json")))
    t0 = time.perf_counter()
    serve_dir = os.path.join(work, "srv")
    os.makedirs(serve_dir)
    # the fourth sample, the small samples and the one-shot runs this
    # phase holds trees to (B1 launches counted from 0 in each)
    bam43 = os.path.join(work, "obj43.bam")
    simulate_bam_fast(bam43, SimConfig(n_fragments=OBJECT_FRAGMENTS,
                                       ref_len=40 * OBJECT_FRAGMENTS, seed=43))
    small = {}
    for seed in SERVE_SMALL_SEEDS:
        small[f"s{seed}"] = os.path.join(work, f"s{seed}.bam")
        simulate_bam_fast(small[f"s{seed}"], SimConfig(
            n_fragments=SERVE_SMALL_FRAGMENTS, ref_len=40 * SERVE_SMALL_FRAGMENTS, seed=seed))
    one = os.path.join(work, "one")
    adversarial = os.path.join(REPO, "test", "data", "sample_adversarial.bam")
    for inp, name, extra in ((bam43, "obj43", ()), (SAMPLE_BAM, "golden", ()),
                             (SAMPLE_BAM, "stream", ("--pipeline", "streaming")),
                             *((p, n, ()) for n, p in small.items())):
        one_shot[name] = _one_shot(inp, one, name, dev, *extra)
    # what each small job fills alone on the gang's wire
    alone_dense = {n: _one_shot(p, os.path.join(work, "one_dense"), n, dev,
                                "--wire", "dense")["launches"] for n, p in small.items()}
    one_shot_s = time.perf_counter() - t0

    # (i) the gang
    daemon = _Daemon(serve_dir, "a", dev)
    row: dict = {"card": card}
    try:
        row["daemon_start_s"] = daemon.start()
        client = daemon.client
        # the warm first job, through the submit command a user runs
        t = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "submit", "--socket",
             daemon.sock, "-i", SAMPLE_BAM, "-o", os.path.join(serve_dir, "warm"),
             "-n", "golden"], cwd=REPO, check=True, capture_output=True, text=True,
            timeout=600).stdout
        row["warm_first_job_submit_command_s"] = time.perf_counter() - t
        warm = client.status(key=re.search(r"\(key (\w+)", out).group(1))
        row["warm_first_job_s"] = warm["queue_wait_s"] + warm["wall_s"]
        emit("serve_warm_first_job", card=card, latency_s=row["warm_first_job_s"],
             submit_command_s=row["warm_first_job_submit_command_s"],
             one_shot_wall_s=one_shot["golden"]["wall_s"])
        if golden_mismatches(os.path.join(serve_dir, "warm", "golden"), golden["consensus"]):
            raise AssertionError("the warm served job misses the goldens")
        # a blocker (run solo, on the stream wire) keeps the dispatcher
        # busy while the jobs queue, so they leave the queue as one gang
        blocker = _serve_spec(adversarial, serve_dir, "blocker")
        cells = {"large": [("obj", os.path.join(work, "obj.bam"),
                            os.path.join(work, "untagged", "obj")),
                           ("p", os.path.join(work, "degraded.bam"),
                            os.path.join(work, "degraded_majority", "p")),
                           ("golden", SAMPLE_BAM, os.path.join(one, "golden")),
                           ("obj43", bam43, os.path.join(one, "obj43"))],
                 "small": [(n, p, os.path.join(one, n)) for n, p in small.items()]}
        for cell, members in cells.items():
            out_dir = os.path.join(serve_dir, cell)
            before = client.metrics()["cumulative"]["batches_dispatched"]
            t = time.perf_counter()
            _subs, done = _submit_all(client, [dict(blocker, output=os.path.join(out_dir, "b"))]
                                      + [_serve_spec(p, out_dir, n) for n, p, _o in members])
            gang_wall = time.perf_counter() - t
            blocker_s, done = done[0][1], done[1:]
            gang_sizes = [job["gang_size"] for job, _s in done]
            if gang_sizes != [SERVE_GANG] * SERVE_GANG:
                raise AssertionError(f"the {cell} jobs did not gang: gang sizes {gang_sizes}")
            after = client.metrics()["cumulative"]["batches_dispatched"]
            gang = _gang_event(client, done, dev)
            names = [n for n, _p, _o in members]
            cell_row = {
                **gang, "first_submit_to_last_result_s": gang_wall, "blocker_s": blocker_s,
                # the daemon's counter over the cell: the gang's batches and
                # the blocker's (its stage sidecar, folded in when it ends)
                "batches_dispatched_in_cell": after - before,
                "job_latency_s": {n: s for n, (_j, s) in zip(names, done)},
                "job_wall_s": {n: job["wall_s"] for n, (job, _s) in zip(names, done)},
                "one_shot_wall_s": {n: one_shot[n]["wall_s"] for n in names},
                "one_shot_b1_launches": {n: one_shot[n]["launches"] for n in names}}
            if cell == "small":
                cell_row["alone_dense_b1_launches"] = alone_dense
            for n, _p, base_one in members:
                cell_row.setdefault("trees", {})[n] = _served_tree(
                    os.path.join(out_dir, n), base_one, n)
            if cell == "large" and golden_mismatches(os.path.join(out_dir, "golden"),
                                                     golden["consensus"]):
                raise AssertionError("the served sample.bam misses the goldens")
            row[cell] = cell_row
            emit(f"serve_gang_{cell}", card=card,
                 **{k: v for k, v in cell_row.items() if k != "trees"})
        prom = client.metrics_prometheus()
        named = {m: next((ln.split()[-1] for ln in prom.splitlines()
                          if ln.startswith(m + " ")), None)
                 for m in ("cct_batches_dispatched_total", "cct_families_out_total",
                           "cct_jobs_replayed_total", "cct_recompiles_total",
                           "cct_queue_wait_s_count", "cct_device_dispatch_s_count")}
        row.update({"prometheus_bytes": len(prom), "prometheus_counters": named})
        emit("serve_metrics", card=card, prometheus_bytes=len(prom), counters=named)

        # (ii) the streaming hand-off: a gang of two behind a blocker
        t = time.perf_counter()
        _subs, sdone = _submit_all(client, [
            dict(blocker, output=os.path.join(serve_dir, "b2")),
            _serve_spec(SAMPLE_BAM, serve_dir, "stream", pipeline="streaming"),
            _serve_spec(os.path.join(REPO, "test", "data", "sample_bcerr.bam"), serve_dir,
                        "bcerr")])
        if [j["gang_size"] for j, _s in sdone[1:]] != [2, 2]:
            raise AssertionError("the streaming pair did not gang")
        for rel in ("all_unique/stream.all.unique.sscs.bam",
                    "all_unique/stream.all.unique.dcs.bam", "dcs/stream.dcs.sorted.bam",
                    "sscs/stream.sscs.sorted.bam"):
            if _record_digest(os.path.join(serve_dir, "stream", rel)) != \
                    _record_digest(os.path.join(one, "stream", rel)):
                raise AssertionError(f"served streaming {rel} differs from the one-shot run's")
        with open(os.path.join(serve_dir, "stream", "run.metrics.json")) as fh:
            if json.load(fh)["pipeline"] != "streaming":
                raise AssertionError("the served streaming job did not stream")
        row["streaming_s"] = time.perf_counter() - t
        emit("serve_streaming", card=card, seconds=row["streaming_s"],
             latency_s=sdone[1][1], finals_equal_to_one_shot=True)
        daemon.stop()
    finally:
        daemon.kill()

    # (iii) durability: the first job's worker SIGKILLs its daemon once
    # (the fault ledger survives the restart), after the job was dispatched
    t = time.perf_counter()
    ledger = os.path.join(serve_dir, "faults")
    env = {"CCT_FAULTS": "serve.worker=kill:SIGKILL", "CCT_FAULTS_DIR": ledger}
    killed = _Daemon(serve_dir, "b", dev, env)
    try:
        killed.start()
        spec = _serve_spec(os.path.join(work, "degraded.bam"), os.path.join(serve_dir, "r"), "p")
        sub = killed.client.submit_full(spec)
        if killed.proc.wait(timeout=300) != -signal.SIGKILL:
            raise AssertionError(f"the daemon was not killed: {killed.tail()}")
        _jobs, _info = replay(killed.journal)
        state = _jobs[sub["job_id"]]["state"]
        if state != "dispatched":
            raise AssertionError(f"the killed job's journal state is {state}")
        restarted = _Daemon(serve_dir, "b", dev, env)
        try:
            restart_s = restarted.start()
            health = restarted.client.healthz()
            job = restarted.client.result(key=sub["key"], timeout=900)
            if job["state"] != "done":
                raise AssertionError(f"the replayed job {job['state']}: {job.get('error')}")
            replayed = restarted.client.metrics()["cumulative"]
            if replayed["jobs_replayed"] != 1 or replayed["suspect_blames"] != 1:
                raise AssertionError(f"replay not reported: {replayed['jobs_replayed']} "
                                     f"replayed, {replayed['suspect_blames']} blamed")
            restarted.stop()
        finally:
            restarted.kill()
    finally:
        killed.kill()
    tree = _served_tree(os.path.join(serve_dir, "r", "p"),
                        os.path.join(work, "degraded_majority", "p"), "p", ganged=False)
    row["durability"] = {"restart_s": restart_s, "seconds": time.perf_counter() - t,
                         "healthz": health, "jobs_replayed": replayed["jobs_replayed"],
                         "suspect_blames": replayed["suspect_blames"], "tree": tree}
    emit("serve_replay", card=card, **row["durability"])

    # (iv) the sanitizer on the card
    t = time.perf_counter()
    os.environ["CCT_SANITIZE"] = "1"
    try:
        cli_main(["consensus", "-i", SAMPLE_BAM, "-o", os.path.join(work, "sanitized"),
                  "-n", "golden", "--device", dev.type])
        bad = golden_mismatches(os.path.join(work, "sanitized", "golden"), golden["consensus"])
        if bad:
            raise AssertionError(f"CCT_SANITIZE=1: goldens {bad}")
        # a sync planted in the SSCS vote loop itself, once on each wire
        probe_raised = {}
        os.environ["CCT_FAULTS"] = "sscs.sync_probe=fail@2"
        try:
            for wire in ("stream", "dense"):
                try:
                    cli_main(["consensus", "-i", SAMPLE_BAM, "-n", "golden", "--wire", wire,
                              "-o", os.path.join(work, f"probed_{wire}"), "--device", dev.type])
                    probe_raised[wire] = False
                except sanitize.StageTransferError:
                    probe_raised[wire] = True
        finally:
            os.environ.pop("CCT_FAULTS", None)
        if not all(probe_raised.values()):
            raise AssertionError(f"a sync planted in the SSCS loop did not raise: {probe_raised}")
        planted = False
        try:
            with sanitize.guarded_stage("planted", dev):
                torch.zeros(1, device=dev).item()
        except sanitize.StageTransferError:
            planted = True
        if dev.type == "cuda" and not planted:
            raise AssertionError("a planted .item() inside a guarded stage did not raise")
    finally:
        os.environ.pop("CCT_SANITIZE", None)
    row["sanitize"] = {"seconds": time.perf_counter() - t, "goldens": True,
                       "sscs_sync_probe_raised": probe_raised,
                       "planted_item_raised": planted}
    emit("serve_sanitize", card=card, **row["sanitize"])
    row["one_shot_s"] = one_shot_s
    row["one_shot"] = one_shot
    row["seconds"] = time.perf_counter() - t0
    shutil.rmtree(serve_dir)
    return row


# ------------------------------------------------------------ phase 12: the fleet

FLEET_MEMBERS = ("w0", "w1")
# the canary's probe cadence on the daemons that run one (s)
FLEET_CANARY_INTERVAL_S = "1"
WRONG_GOLDEN = "0" * 64
FLEET_WAIT_S = 300


class _Router(_Proc):
    """``python -m consensuscruncher_tpu_torch.cli route`` in a process of
    its own, as a user starts it; the workers it spawns inherit its
    environment (tracing on, and ``env_extra``).  :meth:`start` returns
    once its socket answers with ``n_members`` members up; :meth:`stop`
    drains the workers it spawned."""

    what = "route"

    def __init__(self, work: str, tag: str, dev, argv, n_members: int, env_extra=None):
        self.sock = os.path.join(work, f"{tag}.sock")
        self.log = os.path.join(work, f"{tag}.log")
        self.argv = list(argv) + (["--device", "cpu"] if dev.type == "cpu" else [])
        self.n_members = n_members
        self.trace_dir = os.path.join(work, f"{tag}_trace")
        self.env = dict(os.environ, CCT_TRACE="1", CCT_TRACE_DIR=self.trace_dir,
                        **(env_extra or {}))
        self.proc = None

    def start(self) -> float:
        t = time.perf_counter()
        with open(self.log, "a") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "route",
                 "--socket", self.sock, *self.argv],
                cwd=REPO, env=self.env, stdout=log, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 600
        while not os.path.exists(self.sock):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"route did not start: {self.tail()}")
            time.sleep(0.05)
        self.client = ServeClient(self.sock)
        fleet = self.client.request({"op": "healthz"})["health"]["fleet"]
        if fleet["up"] != self.n_members:
            raise AssertionError(f"route: {fleet['up']} of {self.n_members} members up")
        return time.perf_counter() - t


def _owned_spec(members, owner: str, inp: str, out_root: str, name: str) -> dict:
    """A spec of ``inp`` run ``name`` whose ring owner among ``members``
    is ``owner``: the first output directory ``<out_root>/o<k>`` that
    hashes there (placement keys on the whole spec)."""
    ring = HashRing(list(members))
    for k in range(1000):
        spec = _serve_spec(inp, os.path.join(out_root, f"o{k}"), name)
        if ring.owner(idempotency_key(spec)) == owner:
            return spec
    raise AssertionError(f"no output directory hashes to {owner}")


def _worker_launches(socks: dict) -> dict:
    """Each daemon's B1 launches so far (the vote wrapper's count, read
    over its socket)."""
    return {n: ServeClient(sock).metrics()["kernel_launches"]["vote"]
            for n, sock in socks.items()}


def _prom_value(text: str, name: str):
    return next((ln.split()[-1] for ln in text.splitlines() if ln.startswith(name + " ")), None)


def _canary_status(client, want: str) -> dict:
    """The daemon's canary status once a probe has passed (``want`` =
    ``"pass"``) or failed (``"fail"``)."""
    deadline = time.monotonic() + FLEET_WAIT_S
    while True:
        canary = client.metrics().get("canary") or {}
        if canary.get(want, 0) >= 1:
            return canary
        if time.monotonic() > deadline:
            raise AssertionError(f"no canary {want} within {FLEET_WAIT_S} s: {canary}")
        time.sleep(0.2)


# the observability readers in a process of their own: each argv of the
# JSON list through the port's cli.main in turn, its exit code, seconds and
# stdout, and whether torch opened a CUDA context by the end
_READERS = """
import contextlib, io, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from consensuscruncher_tpu_torch import cli
rows = []
for argv in json.loads(sys.argv[2]):
    out, code, t = io.StringIO(), 0, time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            cli.main(argv)
        except SystemExit as exc:
            code = exc.code
    rows.append({"code": code, "seconds": time.perf_counter() - t, "out": out.getvalue()})
print(json.dumps({"rows": rows, "cuda_initialized": torch.cuda.is_initialized()}))
"""


def _obs_readers(argvs: list) -> dict:
    """``argvs`` run by one reader process; every command must exit 0 and
    the process must end with no CUDA context."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CCT_TRACE", "CCT_PROF", "CCT_HISTORY"))}
    proc = subprocess.run([sys.executable, "-c", _READERS, REPO, json.dumps(argvs)],
                          capture_output=True, text=True, timeout=300, env=env)
    if proc.returncode != 0:
        raise AssertionError(f"the obs readers failed:\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = [(argv[:2], row["code"]) for argv, row in zip(argvs, res["rows"]) if row["code"]]
    if bad or res["cuda_initialized"]:
        raise AssertionError(f"obs readers: exits {bad}, CUDA context "
                             f"{res['cuda_initialized']}\n{proc.stderr[-4000:]}")
    return res


def _in_process(argv: list) -> str:
    """One CLI command run in this process; its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(argv)
    return out.getvalue()


def _fleet_obs(router, dirs: dict, keys: list, obj_key: str, fdir: str) -> dict:
    """(i)'s live fleet read by the six commands' readers in one process of
    their own: the merged Chrome trace (a lane per process, the workers'
    ``device.dispatch`` spans, one ``serve.critpath`` event per job), each
    job's critical path (segments non-negative, summing to its wall), the
    per-node prof attribution and flame, the history lines of every node
    and the router's ``jobs_routed``, and a ``top`` frame with a row per
    worker.  ``keys``: (i)'s job keys, blockers included."""
    wire = ["--socket", router.sock]
    files = {k: os.path.join(fdir, f"obs_{k}") for k in ("trace", "critpath", "prof", "flame")}
    commands = {
        "trace_fleet": ["trace", "fleet", *wire, "--dir", dirs["trace"], "--out", files["trace"]],
        "critpath_report": ["critpath", "report", *wire, "--dir", dirs["trace"],
                            "--json", files["critpath"]],
        "critpath_job": ["critpath", "job", obj_key, *wire, "--dir", dirs["trace"]],
        "prof_report": ["prof", "report", *wire, "--dir", dirs["prof"], "--json", files["prof"]],
        "prof_flame": ["prof", "flame", *wire, "--dir", dirs["prof"], "--out", files["flame"]],
        "history_query": ["history", "query", *wire, "--dir", dirs["history"]],
        "history_routed": ["history", "query", *wire, "--dir", dirs["history"],
                           "--metric", "jobs_routed"],
        "history_trend": ["history", "trend", *wire, "--dir", dirs["history"],
                          "--metric", "jobs_routed"],
        "history_batches": ["history", "trend", *wire, "--dir", dirs["history"],
                            "--metric", "batches_dispatched"],
        "top": ["top", "--once", "True", *wire],
    }
    t = time.perf_counter()
    res = _obs_readers(list(commands.values()))
    out = dict(zip(commands, (row["out"] for row in res["rows"])))
    row: dict = {"commands": {name: {"code": r["code"], "seconds": r["seconds"]}
                              for name, r in zip(commands, res["rows"])},
                 "readers_process_s": time.perf_counter() - t,
                 "cuda_initialized": res["cuda_initialized"]}
    nodes = {"r0", *FLEET_MEMBERS}

    with open(files["trace"]) as fh:
        doc = json.load(fh)
    lanes = {ev["pid"]: ev["args"]["name"] for ev in doc["traceEvents"]
             if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    events = [ev for ev in doc["traceEvents"] if ev.get("ph") != "M"]
    dispatch = {lanes.get(ev.get("pid")) for ev in events if ev["name"] == "device.dispatch"}
    per_key = {k: 0 for k in keys}
    for ev in events:
        if ev["name"] == "serve.critpath" and (ev.get("args") or {}).get("key") in per_key:
            per_key[ev["args"]["key"]] += 1
    worker_spans = sum(1 for ev in events if lanes.get(ev.get("pid")) in FLEET_MEMBERS)
    # the card's busy time as the workers saw it: their device.dispatch spans
    dispatch_ms = {w: sum(ev.get("dur", 0) for ev in events if ev["name"] == "device.dispatch"
                          and lanes.get(ev.get("pid")) == w) / 1e3 for w in FLEET_MEMBERS}
    if not nodes <= set(lanes.values()) or not dispatch & set(FLEET_MEMBERS) \
            or set(per_key.values()) != {1}:
        raise AssertionError(f"trace fleet: lanes {sorted(lanes.values())}, device.dispatch "
                             f"on {dispatch}, serve.critpath per job {per_key}")
    row["trace"] = {"events": len(doc["traceEvents"]), "lanes": sorted(lanes.values()),
                    "worker_spans": worker_spans, "device_dispatch_ms": dispatch_ms,
                    "device_dispatch_spans": sum(1 for ev in events
                                                 if ev["name"] == "device.dispatch")}

    with open(files["critpath"]) as fh:
        crit = json.load(fh)
    jobs = {j["key"]: j for j in crit["jobs"]}
    for key in keys:
        job = jobs.get(key)
        segs = (job or {}).get("segments") or []
        if job is None or any(sg["ms"] < 0 for sg in segs) \
                or abs(sum(sg["ms"] for sg in segs) - job["wall_ms"]) > 1.0:
            raise AssertionError(f"critpath: job {key}: {job}")
    if not out["critpath_job"].startswith("job ") or f"key={obj_key}" not in out["critpath_job"]:
        raise AssertionError(f"critpath job {obj_key}: {out['critpath_job']!r}")
    row["critpath"] = {
        "jobs": len(keys), "coverage_min": crit["fleet"]["coverage_min"],
        "dominant_queue_antagonist": crit["fleet"]["dominant_queue_antagonist"],
        "segments": {name: {k: seg[k] for k in ("p50_ms", "p99_ms", "total_ms", "share")}
                     for name, seg in crit["fleet"]["segments"].items()},
        "obj_chain": out["critpath_job"].splitlines()}

    with open(files["prof"]) as fh:
        attribution = json.load(fh)
    with open(files["flame"]) as fh:
        flame = sum(int(ln.rsplit(" ", 1)[1]) for ln in fh if ln.strip())
    said = int(out["prof_flame"].split("(")[1].split()[0])
    if not nodes <= set(attribution["nodes"]) or flame != said \
            or not all(n in out["prof_report"] for n in nodes):
        raise AssertionError(f"prof: nodes {sorted(attribution['nodes'])}, flame {flame} "
                             f"samples against {said}")
    row["prof"] = {"flame_samples": flame, "nodes": {
        n: {k: attribution["nodes"][n][k] for k in ("shares", "buckets_ms", "wall_ms", "jobs")}
        for n in sorted(nodes)}, "fleet": attribution["fleet"]}

    lines = [json.loads(ln) for ln in out["history_query"].splitlines()]
    routed = sum(ln["cum"].get("jobs_routed", 0)
                 for ln in map(json.loads, out["history_routed"].splitlines())
                 if ln["node"] == "r0")
    trend_nodes = {ln.split()[1] for ln in out["history_batches"].splitlines()[2:]}
    if not nodes <= {ln.get("node") for ln in lines} or routed < len(keys) \
            or "jobs_routed" not in out["history_trend"] \
            or not set(FLEET_MEMBERS) <= trend_nodes:
        raise AssertionError(f"history: nodes {sorted({ln.get('node') for ln in lines})}, "
                             f"jobs_routed {routed} of {len(keys)}, batches on {trend_nodes}")
    row["history"] = {"lines": len(lines), "router_jobs_routed": routed,
                      "trend": out["history_trend"].splitlines()[0]}

    frame = out["top"].splitlines()
    if not all(any(ln.startswith(w + " ") for ln in frame) for w in FLEET_MEMBERS):
        raise AssertionError(f"top: {out['top']}")
    row["top_frame"] = frame
    return row


def _qc_readers(card_tree: str, cpu_tree: str, work: str) -> dict:
    """``qc report`` over each tree and ``qc diff`` between them: equal
    trees, so every rate delta is zero and the spectrum distance 0.0."""
    diff_doc = os.path.join(work, "qc_diff.json")
    t = time.perf_counter()
    reports = [_in_process(["qc", "report", tree]) for tree in (card_tree, cpu_tree)]
    diff = _in_process(["qc", "diff", card_tree, cpu_tree, "--json", diff_doc])
    seconds = time.perf_counter() - t
    with open(diff_doc) as fh:
        doc = json.load(fh)
    deltas = [ln.split()[-1] for ln in diff.splitlines()[1:-1]]
    if doc["spectrum_tv"] != 0.0 or doc["a"]["rates"] != doc["b"]["rates"] \
            or any(d not in ("+0.00pp", "-") for d in deltas):
        raise AssertionError(f"qc diff of the card and CPU trees:\n{diff}")
    return {"seconds": seconds, "spectrum_tv": doc["spectrum_tv"], "deltas": deltas,
            "report_lines": [len(r.splitlines()) for r in reports]}


def phase_fleet(dev, work: str, one_shot: dict, card: str) -> dict:
    """(i) ``route --spawn 2 --ring_view V --result_cache P`` (the kernel
    library shared through ``--compile_cache``) serves the four 600-fragment
    jobs, ``sample.bam`` (the goldens) and (a)'s untagged sample, each
    tree equal to its one-shot run of this call; each job's node, each
    worker's B1 launches over the cell and the fleet Prometheus printed;
    (iii) (a)'s spec again under another tenant and output: answered from
    the cache (no worker launches), its bytes the first tree's; (iv) a
    third daemon ``serve --warm_from V`` added with ``member_add``: no
    kernel build, and a job routed to it equals its one-shot run; (v) the
    golden canary on that daemon mints the golden a ``--device cpu`` run
    of the probe digests to (``cct_canary_ok`` 1); (ii) two ``serve``
    daemons started by hand behind ``route --members ... --journals ...``:
    the ring owner of the degraded sample's job kills itself with the job
    dispatched, the router resubmits it by key to the other daemon, whose
    tree equals the one-shot run, and whose canary, pinned to a wrong
    ``CCT_CANARY_GOLDEN``, flips ``cct_canary_ok`` to 0.

    ``one_shot``: phase 11's one-shot runs (their trees under
    ``<work>/one``), ``{name: {"wall_s", "launches"}}``."""
    t0 = time.perf_counter()
    golden = json.load(open(os.path.join(REPO, "test", "golden.json")))
    fdir = os.path.join(work, "fleet")
    os.makedirs(fdir)
    one = os.path.join(work, "one")
    row: dict = {"card": card}
    s105 = os.path.join(work, "s105.bam")
    simulate_bam_fast(s105, SimConfig(n_fragments=SERVE_SMALL_FRAGMENTS,
                                      ref_len=40 * SERVE_SMALL_FRAGMENTS, seed=105))
    one_shot["s105"] = _one_shot(s105, one, "s105", dev)
    probe = os.path.join(work, "canary.bam")
    simulate_bam(probe, SimConfig(n_fragments=CANARY_FRAGMENTS, seed=CANARY_SEED))
    cli_main(["consensus", "-i", probe, "-o", os.path.join(work, "canary_cpu"), "-n", "canary",
              "--device", "cpu"])
    cpu_golden = output_digest(os.path.join(work, "canary_cpu", "canary"))

    view, plane = os.path.join(fdir, "ring.view"), os.path.join(fdir, "plane")
    fleet_work = os.path.join(fdir, "fw")
    # (i)'s router and the workers it spawns also sample their stacks and
    # record their history, for the obs readers
    obs_dirs = {"prof": os.path.join(fdir, "prof"), "history": os.path.join(fdir, "history")}
    router = _Router(fdir, "route", dev, [
        "--spawn", str(len(FLEET_MEMBERS)), "--workdir", fleet_work, "--ring_view", view,
        "--result_cache", plane, "--compile_cache", cuda_lib.BUILD_DIR,
        "--gang_size", str(SERVE_GANG), "--warmup_shapes", SERVE_WARMUP], len(FLEET_MEMBERS),
        env_extra={"CCT_PROF": "1", "CCT_PROF_DIR": obs_dirs["prof"],
                   "CCT_HISTORY_DIR": obs_dirs["history"], "CCT_HISTORY_INTERVAL_S": "1"})
    obs_dirs["trace"] = router.trace_dir
    socks = {n: os.path.join(fleet_work, f"{n}.sock") for n in FLEET_MEMBERS}
    warm = None
    try:
        row["route_start_s"] = router.start()
        # (i) every job through the router; a blocker per worker first, so
        # each worker's jobs queue together and gang
        out_i = os.path.join(fdir, "i")
        jobs = {"obj": (os.path.join(work, "obj.bam"), os.path.join(work, "untagged", "obj")),
                "golden": (SAMPLE_BAM, os.path.join(one, "golden")),
                **{f"s{sd}": (os.path.join(work, f"s{sd}.bam"), os.path.join(one, f"s{sd}"))
                   for sd in SERVE_SMALL_SEEDS}}
        adversarial = os.path.join(REPO, "test", "data", "sample_adversarial.bam")
        blockers = [_owned_spec(FLEET_MEMBERS, w, adversarial, os.path.join(fdir, f"b{w}"),
                                f"blocker_{w}") for w in FLEET_MEMBERS]
        before = _worker_launches(socks)
        t = time.perf_counter()
        subs, done = _submit_all(router.client, blockers + [
            _serve_spec(inp, out_i, n) for n, (inp, _one) in jobs.items()])
        wall = time.perf_counter() - t
        after = _worker_launches(socks)
        keys = [sub["key"] for sub in subs]
        subs, done = subs[len(blockers):], done[len(blockers):]
        cell = {"first_submit_to_last_result_s": wall, "jobs": {}}
        for (n, (_inp, base_one)), sub, (job, latency) in zip(jobs.items(), subs, done):
            if sub["node"] not in FLEET_MEMBERS or sub.get("cached"):
                raise AssertionError(f"{n}: routed to {sub['node']}")
            cell["jobs"][n] = {
                "node": sub["node"], "gang_size": job["gang_size"], "latency_s": latency,
                "worker_latency_s": job["queue_wait_s"] + job["wall_s"],
                "router_overhead_s": latency - job["queue_wait_s"] - job["wall_s"],
                "tree": _served_tree(os.path.join(out_i, n), base_one, n,
                                     ganged=job["gang_size"] > 1)}
        if golden_mismatches(os.path.join(out_i, "golden"), golden["consensus"]):
            raise AssertionError("the routed sample.bam misses the goldens")
        gangs = []
        for sock in socks.values():
            events = ServeClient(sock).request({"op": "trace"})["trace"]["events"]
            gangs += [e["args"] for e in events if e["name"] == "serve.gang_batches"]
        cell["worker_b1_launches"] = {w: after[w] - before[w] for w in FLEET_MEMBERS}
        cell["gang_b1_launches"] = sum(g["launches"] for g in gangs)
        cell["gangs"] = len(gangs)
        if not gangs or (dev.type == "cuda" and (
                cell["gang_b1_launches"] == 0
                or any(g["launches"] != g["batches"] for g in gangs))):
            raise AssertionError(f"the fleet's gangs did not launch B1 dense per batch: {gangs}")
        prom = router.client.metrics_prometheus()
        cell["fleet_prometheus"] = [ln for ln in prom.splitlines()
                                    if ln.startswith("cct_fleet_")]
        if f"cct_fleet_members {len(FLEET_MEMBERS)}" not in cell["fleet_prometheus"]:
            raise AssertionError(f"fleet Prometheus: {cell['fleet_prometheus']}")
        cell["worker_recompiles"] = {w: _prom_value(ServeClient(sock).metrics_prometheus(),
                                                    "cct_recompiles_total")
                                     for w, sock in socks.items()}
        if dev.type == "cuda" and set(cell["worker_recompiles"].values()) != {"0"}:
            raise AssertionError(f"a spawned worker built the library: {cell}")
        row["route"] = cell
        emit("fleet_route", card=card, **cell)
        row["obs"] = _fleet_obs(router, obs_dirs, keys, subs[0]["key"], fdir)
        emit("fleet_obs_live", card=card, **row["obs"])
        # phase 17 (i) checks this trace against the journals as they stand now
        row["trace_snapshot"] = os.path.join(work, "fleet_trace")
        os.makedirs(row["trace_snapshot"])
        shutil.copy(os.path.join(fdir, "obs_trace"),
                    os.path.join(row["trace_snapshot"], "trace.json"))
        for name in FLEET_MEMBERS:
            shutil.copy(os.path.join(fleet_work, f"{name}.journal"), row["trace_snapshot"])

        # (iii) the same question from another tenant: the router answers
        # it from the cache plane, and no worker launches
        before = _worker_launches(socks)
        spec = _serve_spec(os.path.join(work, "obj.bam"), os.path.join(fdir, "iii"), "obj",
                           tenant="other")
        t = time.perf_counter()
        sub = router.client.submit_full(spec)
        job = router.client.result(key=sub["key"], timeout=FLEET_WAIT_S)
        hit_s = time.perf_counter() - t
        if not (sub.get("cached") and job["state"] == "done" and job.get("cached")):
            raise AssertionError(f"the resubmitted spec was not a cache hit: {sub} {job}")
        if _worker_launches(socks) != before:
            raise AssertionError("a cache hit launched a kernel on a worker")
        first, hit = os.path.join(out_i, "obj"), os.path.join(fdir, "iii", "obj")
        rels = sorted(os.path.relpath(os.path.join(r, f), first)
                      for r, _d, files in os.walk(first) for f in files)
        for rel in rels:
            with open(os.path.join(first, rel), "rb") as a, \
                    open(os.path.join(hit, rel), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"cached {rel} differs from the first tree's")
        row["cache"] = {"hit_latency_s": hit_s,
                        "miss_latency_s": cell["jobs"]["obj"]["latency_s"],
                        "files_equal": len(rels), "node": sub["node"]}
        emit("fleet_cache", card=card, **row["cache"])

        # (iv) warm join: a third daemon reads the ring view, is added to
        # the ring, and runs the job routed to it
        warm = _Daemon(fdir, "w2", dev, {"CCT_CANARY": "1",
                                         "CCT_CANARY_INTERVAL_S": FLEET_CANARY_INTERVAL_S},
                       ["--node", "w2", "--warm_from", view])
        start_s = warm.start()
        recompiles = _prom_value(warm.client.metrics_prometheus(), "cct_recompiles_total")
        if dev.type == "cuda" and recompiles != "0":
            raise AssertionError(f"the warm-joined daemon built the library ({recompiles})")
        added = router.client.request({"op": "member_add", "name": "w2",
                                       "address": warm.sock, "journal": warm.journal})
        spec = _owned_spec((*FLEET_MEMBERS, "w2"), "w2", s105, os.path.join(fdir, "iv"),
                           "s105")
        launches0 = _worker_launches({"w2": warm.sock})["w2"]
        wsubs, wdone = _submit_all(router.client, [spec])
        if wsubs[0]["node"] != "w2":
            raise AssertionError(f"the job meant for w2 went to {wsubs[0]['node']}")
        job = wdone[0][0]
        tree = _served_tree(os.path.join(spec["output"], "s105"), os.path.join(one, "s105"),
                            "s105", ganged=job["gang_size"] > 1)
        row["warm_join"] = {"start_s": start_s, "spawned_fleet_start_s": row["route_start_s"],
                            "recompiles": recompiles, "fleet_size": added["fleet_size"],
                            "latency_s": wdone[0][1], "tree": tree,
                            "b1_launches": _worker_launches({"w2": warm.sock})["w2"] - launches0}
        emit("fleet_warm_join", card=card, **row["warm_join"])

        # (v) the canary on the warm-joined daemon: the golden it mints is
        # the --device cpu run's digest
        canary = _canary_status(warm.client, "pass")
        ok = _prom_value(warm.client.metrics_prometheus(), "cct_canary_ok")
        if canary["golden"] != cpu_golden or ok != "1":
            raise AssertionError(f"canary golden {canary['golden']} against the CPU run's "
                                 f"{cpu_golden}; cct_canary_ok {ok}")
        events = warm.client.request({"op": "trace"})["trace"]["events"]
        row["canary"] = {"golden_equals_cpu_run": True, "canary_ok": ok,
                         "passes": canary["pass"],
                         "probe_latency_ms": [e["args"]["latency_ms"] for e in events
                                              if e["name"] == "serve.canary"
                                              and e["args"].get("ok")]}
        warm.stop()
        router.stop()
        # every process of (i) has flushed its shards: the export holds at
        # least the workers' spans the live merge saw
        t = time.perf_counter()
        said = _in_process(["trace", "export", "--dir", obs_dirs["trace"],
                            "--out", os.path.join(fdir, "obs_export.json")])
        exported = int(said.split("exported ")[1].split()[0])
        if exported < row["obs"]["trace"]["worker_spans"]:
            raise AssertionError(f"trace export: {exported} events, fewer than the "
                                 f"{row['obs']['trace']['worker_spans']} worker spans merged live")
        row["obs"]["export"] = {"events": exported, "seconds": time.perf_counter() - t}
    finally:
        if warm is not None:
            warm.kill()
        router.kill()

    # (ii) failover: two daemons started by hand behind a router
    t = time.perf_counter()
    hdir = os.path.join(fdir, "ha")
    os.makedirs(hdir)
    spec = _serve_spec(os.path.join(work, "degraded.bam"), os.path.join(hdir, "out"), "p")
    names = ("v0", "v1")
    owner = HashRing(list(names)).owner(idempotency_key(spec))
    daemons = {n: _Daemon(hdir, n, dev, {"CCT_FAULTS": "serve.worker=kill:SIGKILL"}
                          if n == owner else {"CCT_CANARY": "1", "CCT_CANARY_GOLDEN": WRONG_GOLDEN,
                                              "CCT_CANARY_INTERVAL_S": FLEET_CANARY_INTERVAL_S},
                          ["--node", n]) for n in names}
    ha = _Router(hdir, "route", dev, [
        "--members", ",".join(f"{n}={d.sock}" for n, d in daemons.items()),
        "--journals", ",".join(f"{n}={d.journal}" for n, d in daemons.items()),
        "--down_after", "1"], len(names))
    try:
        for d in daemons.values():
            d.launch()
        for d in daemons.values():
            d.ready()
        ha.start()
        sub = ha.client.submit_full(spec)
        if sub["node"] != owner:
            raise AssertionError(f"the job went to {sub['node']}, not its ring owner {owner}")
        if daemons[owner].proc.wait(timeout=FLEET_WAIT_S) != -signal.SIGKILL:
            raise AssertionError(f"the owner was not killed: {daemons[owner].tail()}")
        t_kill = time.perf_counter()
        job = ha.client.result(key=sub["key"], timeout=900)
        kill_to_result_s = time.perf_counter() - t_kill
        if job["state"] != "done":
            raise AssertionError(f"the failed-over job {job['state']}: {job.get('error')}")
        jobs, _info = replay(daemons[owner].journal)
        if [j["state"] for j in jobs.values()] != ["dispatched"]:
            raise AssertionError(f"the owner's journal: {jobs}")
        counters = ha.client.metrics()["cumulative"]
        if counters.get("member_down_events", 0) < 1 or counters.get("route_resubmits", 0) < 1:
            raise AssertionError(f"no failover counted: {counters}")
        tree = _served_tree(os.path.join(hdir, "out", "p"),
                            os.path.join(work, "degraded_majority", "p"), "p",
                            ganged=job["gang_size"] > 1)
        survivor = daemons[next(n for n in names if n != owner)]
        failed = _canary_status(survivor.client, "fail")
        flipped = _prom_value(survivor.client.metrics_prometheus(), "cct_canary_ok")
        if flipped != "0" or "mismatch" not in (failed.get("last_error") or ""):
            raise AssertionError(f"a wrong golden did not flip the canary: {flipped} {failed}")
        row["canary"]["wrong_golden_canary_ok"] = flipped
        row["failover"] = {"owner": owner, "kill_to_result_s": kill_to_result_s,
                           "seconds": time.perf_counter() - t, "tree": tree,
                           "member_down_events": counters["member_down_events"],
                           "route_resubmits": counters["route_resubmits"]}
        emit("fleet_failover", card=card, **row["failover"])
        emit("fleet_canary", card=card, **row["canary"])
        ha.stop()
        survivor.stop()
    finally:
        ha.kill()
        for d in daemons.values():
            d.kill()
    row["seconds"] = time.perf_counter() - t0
    shutil.rmtree(fdir)
    return row


# ------------------------------------------- phase 13: the reference's flow from FASTQ

FASTQ_FRAGMENTS = 80_000  # (ii): phase 5's widths
FASTQ_PARITY_FRAGMENTS = 20_000  # (iii)
FASTQ_WORKERS = 4
BPATTERN = "NNNNNNT"  # test/make_test_data.py's pattern: 6-base UMI + 'T' spacer
_BUILTIN = ["--bwa", "builtin", "--bpattern", BPATTERN]
# fastq2bam in a process of its own: each argv of the JSON list in turn,
# with the extract and align legs timed, the aligner's read counts, whether
# each align pool really forked, and whether torch opened a CUDA context
_FASTQ2BAM = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from consensuscruncher_tpu_torch import cli
from consensuscruncher_tpu_torch.stages import align, extract_barcodes
row = {}

def timed(name, fn):
    def run(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            row[name] = time.perf_counter() - t
    return run

def counted(*a, **k):
    row["reads"], row["unmapped"] = counts = columnar(*a, **k)
    return counts

def pool(*a):
    p = start_pool(*a)
    row.setdefault("pools_forked", []).append(p is not None)
    return p

columnar, start_pool = cli.align_fastqs_columnar, align._start_pool
extract_barcodes.run_extract = timed("extract_s", extract_barcodes.run_extract)
cli.align_and_sort = timed("align_s", cli.align_and_sort)
cli.align_fastqs_columnar, align._start_pool = counted, pool
for argv in json.loads(sys.argv[2]):
    row.clear()
    t = time.perf_counter()
    cli.main(argv)
    row["wall_s"] = time.perf_counter() - t
    print(json.dumps({**row, "cuda_initialized": torch.cuda.is_initialized()}), flush=True)
"""
# a standalone stage entry run as ``python -m``, in a process of its own,
# with the vote kernels' launch counts read after it
_ENTRY = """
import json, runpy, sys
sys.path.insert(0, sys.argv[1])
from consensuscruncher_tpu_torch.ops import consensus_vote
sys.argv = sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
print(json.dumps({"b1_launches": consensus_vote.launches,
                  "b2_launches": consensus_vote.fused_launches}))
"""


def _fastq2bam(runs: list, card: str) -> list:
    """``fastq2bam`` argvs run in turn by one process of its own: a row per
    run.  Every align pool forked (no serial fallback), no CUDA context,
    and no indel warning (simulated reads all place)."""
    proc = subprocess.run([sys.executable, "-c", _FASTQ2BAM, REPO, json.dumps(runs)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"fastq2bam failed:\n{proc.stderr[-4000:]}")
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if len(rows) != len(runs) or "falling back to serial" in proc.stderr \
            or "WARNING: --bwa builtin" in proc.stderr:
        raise AssertionError(f"fastq2bam: {rows}\n{proc.stderr[-4000:]}")
    for argv, row in zip(runs, rows):
        workers = int(argv[argv.index("--host_workers") + 1])
        if row["cuda_initialized"] or row.get("pools_forked", []) != [True] * (workers > 1):
            raise AssertionError(f"fastq2bam --host_workers {workers}: {row}")
        row.update(card=card, host_workers=workers, cores=len(os.sched_getaffinity(0)),
                   unmapped_share=row["unmapped"] / row["reads"],
                   reads_per_s=row["reads"] / row["align_s"])
    return rows


def _files(base: str) -> dict:
    """sha256 of every file under ``base`` but its manifest (which names
    the paths), by relative path."""
    return {rel: digest for rel, digest in _bam_sha256(base, ("",)).items()
            if not rel.endswith("manifest.json")}


def _simulated_pair(work: str, n: int, seed: int) -> tuple:
    t = time.perf_counter()
    paths = simulate_fastq_pairs(os.path.join(work, f"fq{seed}"), SimConfig(
        n_fragments=n, read_len=100, umi_len=6, mean_family_size=3.0, duplex_fraction=0.8,
        seed=seed, ref_len=40 * n))
    return paths, time.perf_counter() - t


def phase_fastq(dev, work: str, tagged: dict, card: str) -> dict:
    """(i) the extract goldens; (ii) ``fastq2bam`` at real size, in a
    process of its own; (iii) its byte parity over ``--host_workers`` and
    ``consensus`` on its BAM on the card against ``--device cpu``; (iv) the
    standalone stage entries on ``sample.bam``, each on the card in a
    process of its own, against the same entry with ``--device cpu``."""
    t0 = time.perf_counter()
    golden = json.load(open(os.path.join(REPO, "test", "golden.json")))
    # (i) the 6 extract digests of test/golden.json
    ex = os.path.join(work, "extract")
    os.makedirs(ex)
    t = time.perf_counter()
    run_extract(os.path.join(REPO, "test", "data", "sample_R1.fastq.gz"),
                os.path.join(REPO, "test", "data", "sample_R2.fastq.gz"),
                os.path.join(ex, "ex"), bpattern=BPATTERN)
    bad = [rel for rel, want in golden["extract"].items()
           if text_digest(os.path.join(ex, rel.removeprefix("extract/"))) != want]
    if len(golden["extract"]) != 6 or bad:
        raise AssertionError(f"extract goldens diverge: {bad}")
    emit("fastq_extract_goldens", digests=6, seconds=time.perf_counter() - t)

    # (ii) phase 5's widths at FASTQ_FRAGMENTS
    (r1, r2, fa), sim_s = _simulated_pair(work, FASTQ_FRAGMENTS, 42)
    big = _fastq2bam([["fastq2bam", "-f1", r1, "-f2", r2, "-o", os.path.join(work, "f2b"),
                       "-n", "sim", "-r", fa, *_BUILTIN,
                       "--host_workers", str(FASTQ_WORKERS)]], card)[0]
    emit("fastq2bam", fragments=FASTQ_FRAGMENTS, simulate_s=sim_s, **big)
    shutil.rmtree(os.path.join(work, "f2b"))

    # (iii) byte parity over --host_workers, then consensus on the card
    (r1, r2, fa), sim_s = _simulated_pair(work, FASTQ_PARITY_FRAGMENTS, 43)
    outs = {n: os.path.join(work, f"f2b{n}") for n in (1, FASTQ_WORKERS)}
    rows = _fastq2bam([["fastq2bam", "-f1", r1, "-f2", r2, "-o", out, "-n", "s", "-r", fa,
                        *_BUILTIN, "--host_workers", str(n)] for n, out in outs.items()], card)
    files = _files(outs[1])
    if len(files) != 9 or _files(outs[FASTQ_WORKERS]) != files:
        raise AssertionError(f"fastq2bam --host_workers 1 and {FASTQ_WORKERS} wrote other bytes")
    bam = os.path.join(outs[1], "bamfiles", "s.sorted.bam")
    trees = {}
    for label, device in (("card", dev.type), ("cpu", "cpu")):
        # the aligner writes NM on every read: rescue and DCS take the walks
        acc: dict[str, float] = {}
        calls: dict[str, int] = {}
        restores = [
            _synced_timer(singleton_correction, "_run_rescue_walk", acc, "rescue_walk_s", calls),
            _synced_timer(dcs_maker, "_run_dcs_windows", acc, "dcs_walk_s", calls)]
        consensus_vote.launches = 0
        try:
            t = time.perf_counter()
            res = cli_main(["consensus", "-i", bam, "-o", os.path.join(work, f"fq_{label}"),
                            "-n", "s", "--scorrect", "True", "--device", device])
            wall = time.perf_counter() - t
        finally:
            for restore in restores:
                restore()
        if calls != {"rescue_walk_s": 1, "dcs_walk_s": 1}:
            raise AssertionError(f"consensus on the fastq2bam BAM: walks taken {calls}")
        trees[label] = {"wall_s": wall, "steps_s": res["walls"], **acc,
                        "b1_launches": consensus_vote.launches}
    if trees["card"]["b1_launches"] == 0 and dev.type == "cuda":
        raise AssertionError("consensus on the fastq2bam BAM never launched B1")
    held = _served_tree(os.path.join(work, "fq_card", "s"), os.path.join(work, "fq_cpu", "s"),
                        "s", ganged=False)
    qc = _qc_readers(os.path.join(work, "fq_card", "s"), os.path.join(work, "fq_cpu", "s"), work)
    row = {"card": card, "fragments": FASTQ_PARITY_FRAGMENTS, "simulate_s": sim_s, "qc": qc,
           "fastq2bam": {f"host_workers_{r['host_workers']}": r for r in rows},
           "files_equal": len(files), **held, "card_run": trees["card"],
           "cpu_run": trees["cpu"],
           "card_wall_per_fragment_s": trees["card"]["wall_s"] / FASTQ_PARITY_FRAGMENTS,
           "phase6_tagged_wall_per_fragment_s": tagged["tagged"]["wall_s"] / OBJECT_FRAGMENTS}
    emit("fastq_consensus", **row)

    # (iv) the standalone stage entries on sample.bam
    sample = os.path.join(REPO, "test", "data", "sample.bam")
    entries = {}
    for label, device in (("card", dev.type), ("cpu", "cpu")):
        base = os.path.join(work, f"entries_{label}")
        for sub in ("sscs", "singleton", "dcs"):
            os.makedirs(os.path.join(base, sub))
        sscs, sing = os.path.join(base, "sscs", "golden"), os.path.join(base, "singleton", "golden")
        argvs = {
            "sscs_maker": ["--infile", sample, "--outfile", sscs],
            "singleton_correction": ["--singleton", sscs + ".singleton.sorted.bam",
                                     "--bamfile", sscs + ".sscs.sorted.bam", "--outfile", sing],
            "dcs_maker": ["--infile", sscs + ".sscs.sorted.bam",
                          "--outfile", os.path.join(base, "dcs", "golden")],
        }
        for entry, argv in argvs.items():
            argv = [*argv, "--device", device]
            t = time.perf_counter()
            if label == "cpu":  # the reference: this process, the plain versions
                importlib.import_module(f"consensuscruncher_tpu_torch.stages.{entry}").main(argv)
                entries[f"{entry}/cpu_s"] = time.perf_counter() - t
                continue
            proc = subprocess.run(
                [sys.executable, "-c", _ENTRY, REPO,
                 f"consensuscruncher_tpu_torch.stages.{entry}", *argv],
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"{entry} --device {device} failed:\n{proc.stderr[-3000:]}")
            counts = json.loads(proc.stdout.strip().splitlines()[-1])
            if entry == "sscs_maker" and device == "cuda" and counts["b1_launches"] == 0:
                raise AssertionError(f"{entry} on the card never launched B1")
            entries[entry] = {"command_s": time.perf_counter() - t, **counts}
        plots = os.path.join(base, "plots")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "consensuscruncher_tpu_torch.stages.generate_plots",
             "--families", sscs + ".read_families.txt", "--stats", sscs + ".sscs_stats.json",
             sing + ".singleton_stats.json", "--metrics", sscs + ".metrics.json",
             "--outdir", plots], cwd=REPO, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"generate_plots failed:\n{proc.stderr[-3000:]}")
        entries[f"generate_plots/{label}_s"] = time.perf_counter() - t
        if sorted(os.listdir(plots)) != ["family_size.png", "read_recovery.png",
                                         "stage_times.png"]:
            raise AssertionError(f"generate_plots wrote {sorted(os.listdir(plots))}")
        for name in os.listdir(plots):
            with open(os.path.join(plots, name), "rb") as fh:
                decode_png(fh.read())
    card_base, cpu_base = (os.path.join(work, f"entries_{label}") for label in ("card", "cpu"))
    held = 0
    for rel in sorted(_bam_sha256(cpu_base)):
        if _records(os.path.join(card_base, rel)) != _records(os.path.join(cpu_base, rel)):
            raise AssertionError(f"stage entries: {rel} differs between the card and the CPU")
        held += 1
    for rel in ("sscs/golden.sscs_stats.txt", "sscs/golden.read_families.txt",
                "singleton/golden.singleton_stats.txt", "dcs/golden.dcs_stats.txt"):
        if _no_backend(os.path.join(card_base, rel)) != _no_backend(os.path.join(cpu_base, rel)):
            raise AssertionError(f"stage entries: {rel} differs between the card and the CPU")
    goldens = {k: v for k, v in golden["consensus"].items()
               if k.startswith(("sscs/", "singleton/"))}
    bad = golden_mismatches(card_base, goldens)
    if held != 8 or len(goldens) != 11 or bad:
        raise AssertionError(f"stage entries: {held} BAMs held; goldens diverge: {bad}")
    emit("fastq_stage_entries", card=card, bams_equal=held, goldens=len(goldens), **entries)
    seconds = time.perf_counter() - t0
    emit("fastq_flow", card=card, seconds=seconds)
    return {"seconds": seconds, "fastq2bam": big, "consensus": row, "entries": entries,
            "qc": qc}


LIBRARY_FRAGMENTS = 20_000  # (i): phase 5's widths, its fragments cut for time
HOST_FRAGMENTS = 2_000  # (ii): the object path votes each position in Python
HOST_BACKENDS = ("reference", "cpu")
# The host backends in a process of their own: no CUDA context may open and
# no kernel may build there.
_HOST_RUNS = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from consensuscruncher_tpu_torch.cli import main
from consensuscruncher_tpu_torch.ops import cuda_lib

def refuse(*_a, **_k):
    raise AssertionError("a host backend built a kernel")

cuda_lib.build = refuse
walls = []
for argv in json.loads(sys.argv[2]):
    t = time.perf_counter()
    main(argv)
    walls.append(time.perf_counter() - t)
print(json.dumps({"walls_s": walls, "cuda_initialized": torch.cuda.is_initialized()}))
"""


def _library_families(bam: str) -> tuple[list, list]:
    """The ragged ``(key, seqs, quals)`` families of size >= 2 of ``bam``
    (the dense wire's per-family events) and its family blocks'
    ``(block, fam_idx, keys)`` items (the stream wire's)."""
    fams, items = [], []
    with ColumnarReader(bam) as reader:
        for kind, tag, members in stream_families_columnar(reader, reader.header, "|"):
            if kind == "family" and len(members) > 1:
                fams.append((len(fams), [m.codes for m in members],
                             [m.qual if m.qual.size else np.zeros(m.seq_len, np.uint8)
                              for m in members]))
    with ColumnarReader(bam) as reader:
        for n, (kind, block, _b) in enumerate(
                stream_family_blocks(reader, reader.header, "|")):
            if kind != "bad":
                multi = np.nonzero(block.sizes >= 2)[0]
                if len(multi):
                    items.append((block, multi, [(n, int(j)) for j in multi]))
    return fams, items


def _stream_entry(entry, source: list, dev) -> tuple[list, float, int]:
    """``entry`` over ``source`` on ``dev``: its per-family results, the
    synchronised wall and the B1 launches, counted from 0."""
    consensus_vote.launches = 0
    t = time.perf_counter()
    out = list(entry(iter(source), consensus_vote.ConsensusConfig(), dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t, consensus_vote.launches


def _linear_fetch(path: str, ref: str, beg: int, end: int) -> list:
    out = []
    with BamReader(path) as reader:
        for read in reader:
            if read.ref != ref or read.is_unmapped:
                continue
            span = max(sum(n for op, n in read.cigar if op in "MDN=X"), 1)
            if read.pos < end and read.pos + span > beg:
                out.append((read.qname, read.flag, read.pos))
    return out


def phase_library_host(dev, work: str, card: str) -> dict:
    """Phase 14: (i) the library's member-stream entries on the card, (ii)
    the host backends in a process of their own against the card's runs,
    (iii) a region fetch over a card-written BAM."""
    started = time.perf_counter()
    lib_bam = os.path.join(work, "lib.bam")
    simulate_bam_fast(lib_bam, SimConfig(n_fragments=LIBRARY_FRAGMENTS,
                                         ref_len=40 * LIBRARY_FRAGMENTS, seed=44))
    fams, items = _library_families(lib_bam)
    entries = {}
    for name, entry, source in (
            ("families_stream", consensus_segment.consensus_families_stream, fams),
            ("blocks_stream", consensus_segment.consensus_blocks_stream, items)):
        got, wall, launches = _stream_entry(entry, source, dev)
        want, plain_wall, _ = _stream_entry(entry, source, torch.device("cpu"))
        if launches <= 0 or len(got) != len(want) or any(
                gk != wk or not np.array_equal(gb, wb) or not np.array_equal(gq, wq)
                for (gk, gb, gq), (wk, wb, wq) in zip(got, want)):
            raise AssertionError(f"{name}: card {len(got)} families, {launches} launches, "
                                 f"against {len(want)} plain")
        entries[name] = {"families": len(got), "b1_launches": launches, "wall_s": wall,
                         "plain_wall_s": plain_wall}
    emit("library_stream", fragments=LIBRARY_FRAGMENTS, card=card, **entries)

    host_bam = os.path.join(work, "host.bam")
    simulate_bam_fast(host_bam, SimConfig(n_fragments=HOST_FRAGMENTS,
                                          ref_len=40 * HOST_FRAGMENTS, seed=45))
    inputs = {"sample": SAMPLE_BAM,
              "adv": os.path.join(REPO, "test", "data", "sample_adversarial.bam"),
              "host": host_bam}
    card_walls = {}
    for name, bam in inputs.items():
        card_walls[name] = _one_shot(bam, os.path.join(work, "host_card"), name, dev)["wall_s"]
    argvs = [["consensus", "-i", bam, "-o", os.path.join(work, f"host_{backend}"), "-n", name,
              "--scorrect", "True", "--backend", backend]
             for backend in HOST_BACKENDS for name, bam in inputs.items()]
    proc = subprocess.run([sys.executable, "-c", _HOST_RUNS, REPO, json.dumps(argvs)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"the host backends failed:\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if res["cuda_initialized"]:
        raise AssertionError("a host backend opened a CUDA context")
    walls = iter(res["walls_s"])
    runs = {}
    for backend in HOST_BACKENDS:
        for name in inputs:
            _same_tree(os.path.join(work, f"host_{backend}", name), name,
                       os.path.join(work, "host_card", name), name)
            runs[f"{name}/{backend}"] = {"wall_s": next(walls),
                                         "card_wall_s": card_walls[name]}
    emit("host_backends", card=card, host_fragments=HOST_FRAGMENTS, runs=runs,
         cuda_initialized=False)

    sscs = os.path.join(work, "host_card", "host", "sscs", "host.sscs.sorted.bam")
    rng = np.random.default_rng(14)
    regions = 0
    with IndexedBamReader(sscs) as reader:
        ref, length = reader.header.refs[0]
        for _ in range(25):
            beg = int(rng.integers(0, length))
            end = int(min(length, beg + rng.integers(1, 30_000)))
            got = [(r.qname, r.flag, r.pos) for r in reader.fetch(ref, beg, end)]
            if got != _linear_fetch(sscs, ref, beg, end):
                raise AssertionError(f"fetch {ref}:{beg}-{end} differs from a linear scan")
            regions += bool(got)
        whole = sum(1 for _ in reader.fetch(ref))
    with BamReader(sscs) as reader:
        if whole != sum(1 for _ in reader) or not regions:
            raise AssertionError(f"fetch of {ref}: {whole} records, {regions} regions hit")
    seconds = time.perf_counter() - started
    emit("fetch", records=whole, regions_with_records=regions, seconds=seconds)
    return {"entries": entries, "runs": runs, "seconds": seconds}


# ------------------------------------------------------- training (phase 15)

TRAIN_WEIGHT_TOL = 1e-4  # the trained weights, against the committed file and the CPU run
TRAIN_ACCURACY_TOL = 1e-3  # the held-out accuracies, likewise
TRAIN_RATE_STEPS = 100  # the steps timed for the card's steps/s
# The card against the CPU on a cut run: the CPU at the defaults took 23.5 s
# of the phase's 40 s budget on the card's host (PERF.md section 4).
TRAIN_CUT = ("--samples", "24000", "--steps", "100")
VOTE_FAMILIES = 256  # the dense bucket's families voted one at a time
COMMITTED_CHECKPOINT = os.path.join(REPO, "consensuscruncher_tpu_torch", "policies",
                                    "checkpoints", distilled.CHECKPOINT_NAME)


def _train(device: str, out: str, *extra: str) -> tuple[dict, float]:
    """The trainer's command on ``device`` (its defaults, less ``extra``):
    the document it wrote and its seconds."""
    t = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        rc = distill_train.main(["--out", out, "--device", device, *extra])
    seconds = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"distill_train --device {device} exited {rc}")
    with open(out) as fh:
        return json.load(fh), seconds


def _held_to(doc: dict, want: dict, what: str) -> dict:
    """A trained document against another at the stated tolerances: every
    weight, every held-out accuracy, every ``n`` exact, distilled above
    majority on mixed and degraded, the rest equal but ``meta.tool``."""
    weight = max(float(np.abs(np.asarray(doc[k], np.float64) - np.asarray(want[k])).max())
                 for k in ("w1", "b1", "w2", "b2"))
    got_acc, want_acc = doc["meta"]["holdout_accuracy"], want["meta"]["holdout_accuracy"]
    accuracy = max(abs(got_acc[r][k] - want_acc[r][k])
                   for r in want_acc for k in ("distilled", "majority"))
    rest = [{k: v for k, v in d.items() if k not in ("w1", "b1", "w2", "b2", "meta")}
            | {"meta": {k: v for k, v in d["meta"].items()
                        if k not in ("tool", "holdout_accuracy")}} for d in (doc, want)]
    if (weight > TRAIN_WEIGHT_TOL or accuracy > TRAIN_ACCURACY_TOL or rest[0] != rest[1]
            or any(got_acc[r]["n"] != want_acc[r]["n"] for r in want_acc)
            or any(got_acc[r]["distilled"] <= got_acc[r]["majority"]
                   for r in ("mixed", "degraded"))
            or doc["meta"]["tool"] != distill_train.TOOL):
        raise AssertionError(f"trained checkpoint against {what}: weights {weight}, "
                             f"accuracy {accuracy}: {got_acc} vs {want_acc}")
    return {"max_weight_diff": weight, "max_accuracy_diff": accuracy}


def _step_rate(dev) -> dict:
    """The card's full-batch Adam steps at the defaults' data: steps/s over
    ``TRAIN_RATE_STEPS`` synchronised steps, and the CUDA launches of one
    step as the profiler sees them."""
    args = distill_train.build_parser().parse_args([])
    rng, _per, counts, qsums, fam, labels = distill_train.make_data(args.seed, args.samples)
    with distill_train.highest_precision():
        feats = distilled.features(*(torch.from_numpy(a).to(dev) for a in (counts, qsums, fam)),
                                   qual_cap=distill_train.QUAL_CAP)
        _hold, tr = distill_train.split(rng, len(feats))
        x = feats[torch.from_numpy(tr).to(dev)]
        y = torch.from_numpy(labels[tr]).to(dev, torch.int64)
        params = {k: torch.from_numpy(v).to(dev)
                  for k, v in distill_train.init_params(rng, args.hidden).items()}
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
        step = [0]

        def one():
            step[0] += 1
            distill_train.adam_step(params, m, v, step[0], x, y, args.lr)

        one()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(TRAIN_RATE_STEPS):
            one()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = torch_launches(one)
    return {"steps_per_s": TRAIN_RATE_STEPS / seconds, "train_rows": int(len(tr)),
            "launches_per_step": launches["launches"], "copies_per_step": launches["copies"]}


def phase_training(dev, sim_bam: str, dense_batch, work: str, card: str) -> dict:
    """Phase 15: (i) the trainer at its defaults on the card, held to the
    committed checkpoint, and at ``TRAIN_CUT`` on the card and on the CPU,
    held to each other; the card's steps/s and launches per step; (ii) the card-trained
    file loaded as ``DistilledPolicy(checkpoint=...)``, phase 7's stream
    batch voted by it on the card against its plain version; (iii)
    ``majority_family_vote`` on the dense bucket's families, one B1 dense
    launch each (counted from 0), against its plain version."""
    started = time.perf_counter()
    with open(COMMITTED_CHECKPOINT) as fh:
        committed = json.load(fh)
    card_doc, card_s = _train("cuda", os.path.join(work, "trained_card.json"))
    cut_doc, cut_s = _train("cuda", os.path.join(work, "cut_card.json"), *TRAIN_CUT)
    cpu_doc, cpu_s = _train("cpu", os.path.join(work, "cut_cpu.json"), *TRAIN_CUT)
    rate = _step_rate(dev)
    emit("training", card=card, steps=card_doc["meta"]["steps"],
         samples=card_doc["meta"]["samples"], card_s=card_s, **rate,
         card_vs_committed=_held_to(card_doc, committed, "the committed file"),
         holdout=card_doc["meta"]["holdout_accuracy"], cut=" ".join(TRAIN_CUT),
         cut_card_s=cut_s, cut_cpu_s=cpu_s,
         cut_card_vs_cpu=_held_to(cut_doc, cpu_doc, "the CPU run"),
         cut_holdout=cut_doc["meta"]["holdout_accuracy"])

    policy = distilled.DistilledPolicy(checkpoint=os.path.join(work, "trained_card.json"))
    batch = main_path_batch(sim_bam)
    n = batch.n_real
    wire, a, w = consensus_segment.encode_member_batch(batch)
    a_h, book = torch.from_numpy(a), torch.from_numpy(w)
    b_d = book.to(dev) if wire == "raw" else book
    sizes = torch.from_numpy(batch.sizes[:n])
    lengths = torch.from_numpy(batch.lengths[:n])
    out_len = consensus_segment._out_len(batch)
    cfg = consensus_vote.ConsensusConfig()
    errs: list[int] = []
    before = consensus_vote.launches
    got = consensus_segment.stream_vote(wire, a_h.to(dev), b_d, sizes, cfg, out_len, lengths,
                                        policy=policy)
    if consensus_vote.launches != before:
        raise AssertionError("the trained head's vote launched B1")
    want = consensus_segment.stream_vote(wire, a_h, book, sizes, cfg, out_len, lengths,
                                         policy=policy)
    _check_equal("trained/main_path_batch/planes", got[0].cpu(), want[0], errs)
    _check_equal("trained/main_path_batch/qc", got[1].cpu(), want[1], errs)
    called = int((want[0][0] != N).sum())
    emit("training_policy", card=card, families=n, wire=wire, out_len=out_len,
         called_bases=called, max_abs_err=max(errs))

    k = min(VOTE_FAMILIES, dense_batch.n_real)
    planes = [torch.from_numpy(x[:k]) for x in (dense_batch.bases, dense_batch.quals)]
    fam_sizes = dense_batch.fam_sizes[:k].tolist()
    card_planes = [x.to(dev) for x in planes]
    num, den = cfg.cutoff_rational
    kw = dict(num=num, den=den, qual_threshold=cfg.qual_threshold, qual_cap=cfg.qual_cap)
    consensus_vote.launches = 0
    got = [majority_family_vote(card_planes[0][i], card_planes[1][i], fam_sizes[i], **kw,
                                with_qc=bool(i % 2)) for i in range(k)]
    torch.cuda.synchronize()
    launches = consensus_vote.launches
    if launches != k:
        raise AssertionError(f"majority_family_vote: {launches} B1 launches for {k} calls")
    vote_errs: list[int] = []
    for i, outs in enumerate(got):
        want = majority_family_vote(planes[0][i], planes[1][i], fam_sizes[i], **kw,
                                    with_qc=bool(i % 2))
        for j, (g, w_) in enumerate(zip(outs, want)):
            _check_equal(f"majority_family_vote/{i}/{j}", g.cpu(), w_, vote_errs)

    def card_call():
        majority_family_vote(card_planes[0][0], card_planes[1][0], fam_sizes[0], **kw)

    t = time.perf_counter()
    for i in range(k):
        majority_family_vote(planes[0][i], planes[1][i], fam_sizes[i], **kw)
    plain_ms = (time.perf_counter() - t) / k * 1e3
    vote = {"launches": launches, "calls": k, "max_abs_err": max(vote_errs),
            "call_ms": cuda_ms(card_call, 200), "plain_ms": plain_ms,
            "shape": {"F": int(planes[0].shape[1]), "L": int(planes[0].shape[2])}}
    emit("majority_family_vote", card=card, **vote)
    seconds = time.perf_counter() - started
    emit("training_phase", seconds=seconds)
    return {"vote": vote, "card_s": card_s, "rate": rate, "seconds": seconds}


# ------------------------------------------- quality and capacity (phase 16)

# BENCH_QC_r17.json's config: the committed quality baseline's run, whose
# accuracy rows and qc doc the port reproduces exactly
QC_BASELINE = os.path.join(REPO, "BENCH_QC_r17.json")
QC_CONFIG = ("--fragments", "400", "--seed", "7", "--degraded_rate", "0.5",
             "--policies", "majority,delegation,distilled")
QC_CARD_REPEATS = "2"
RIGGED_B2 = [0.0, 50.0, 0.0, 0.0, 0.0]  # the distilled head calls C at full confidence
# the load generator at its own input sizes (24/96/48 fragments a class, 3
# inputs a class); its levels cut from 0.5,1,2,4 at 30 s each, for the
# smoke's time limit (PERF.md section 4).  A 3 s level offers too few jobs
# to fill the daemon's queue, so the knee it reports is the top level
# offered, not the daemon's capacity (PERF.md section 5 has 6 s levels)
LOADGEN_CUT = ("--levels", "1,2,4", "--duration", "3")
PROF_ENV = {"CCT_PROF": "1", "CCT_PROF_HZ": "199"}


def _quiet(fn, *args):
    """``fn(*args)`` with its stdout and stderr captured; printed to stderr
    only when it raises."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            return fn(*args)
    except BaseException:
        print(out.getvalue()[-6000:], file=sys.stderr, flush=True)
        raise


def _harness(out: str, *argv: str) -> tuple[dict, list]:
    """``accuracy_harness`` in this process, its artifact at ``out``: the
    artifact and each pipeline run's policy, QC flag, wall and B1 launches
    (all, and those with the QC rider), each count set to 0 just before
    the run and read just after."""
    runs: list[dict] = []
    original = accuracy_harness._run_pipeline

    def counted(bam, run_out, name, target, qc_on, policy="majority"):
        consensus_vote.launches = consensus_vote.qc_launches = 0
        wall = original(bam, run_out, name, target, qc_on, policy)
        runs.append({"run": os.path.basename(run_out), "policy": policy, "qc": qc_on,
                     "wall_s": wall, "b1_launches": consensus_vote.launches,
                     "qc_launches": consensus_vote.qc_launches})
        return wall

    accuracy_harness._run_pipeline = counted
    try:
        with mock.patch.dict(os.environ):  # the harness sets CCT_QC per run
            rc = _quiet(accuracy_harness.main, ["--out", out, *argv])
    finally:
        accuracy_harness._run_pipeline = original
    if rc != 0:
        raise AssertionError(f"accuracy_harness {argv} exited {rc}")
    with open(out) as fh:
        return json.load(fh), runs


def _check_runs(what: str, runs: list, dev) -> int:
    """On the card every majority run launches B1, with the rider on every
    launch of a qc-on run and on none of a qc-off run; a policy run votes
    with torch ops and launches no B1 (as phase 7 holds).  Returns the B1
    launches."""
    for run in runs:
        if dev.type != "cuda":
            continue
        if run["policy"] != "majority":
            bad = run["b1_launches"] != 0
        else:
            bad = run["b1_launches"] == 0 or run["qc_launches"] != (
                run["b1_launches"] if run["qc"] else 0)
        if bad:
            raise AssertionError(f"{what}: run {run}")
    return sum(run["b1_launches"] for run in runs)


def _qc_gate(fresh: str, *argv: str) -> dict:
    """``qc_gate --smoke`` on ``fresh`` (the default baseline, the newest
    committed ``BENCH_QC_r*.json``): its exit code and verdict."""
    verdict = fresh + ".verdict.json"
    rc = _quiet(qc_gate.main, ["--fresh", fresh, "--smoke", "--out", verdict, *argv])
    with open(verdict) as fh:
        doc = json.load(fh)
    return {"rc": rc, "baseline": doc["baseline"], "checks": len(doc["checks"]),
            "failed": [c["name"] for c in doc["checks"] if not c["ok"]]}


def _policy_rows(doc: dict) -> dict:
    return {policy: {"per_base_error": row["per_base_error"], "recovered": row["recovered"],
                     "variants": {lv: {k: v[k] for k in ("recall", "fp_per_mb")}
                                  for lv, v in row["variants"].items()}}
            for policy, row in doc["accuracy"]["policies"].items()}


def phase_quality(dev, work: str, card: str) -> dict:
    """(i) The accuracy harness at ``BENCH_QC_r17.json``'s config on the card
    (the default device) and with ``--device cpu --repeats 1``: the two
    artifacts' ``accuracy`` and ``qc`` equal; ``qc_gate --smoke`` passes the
    card's against the committed baseline, and fails the ``--corrupt 0.02``
    control and a run under a rigged distilled checkpoint."""
    started = time.perf_counter()
    root = os.path.join(work, "quality")
    os.makedirs(root)
    target = [] if dev.type == "cuda" else ["--device", "cpu"]
    card_doc, card_runs = _harness(os.path.join(root, "card.json"), *QC_CONFIG,
                                   "--repeats", QC_CARD_REPEATS,
                                   "--workdir", os.path.join(root, "card"), *target)
    if card_doc["config"]["device"] != dev.type:
        raise AssertionError(f"the harness ran on {card_doc['config']['device']}")
    cpu_doc, _ = _harness(os.path.join(root, "cpu.json"), *QC_CONFIG, "--repeats", "1",
                          "--workdir", os.path.join(root, "cpu"), "--device", "cpu")
    with open(QC_BASELINE) as fh:
        baseline = json.load(fh)
    for key in ("accuracy", "qc"):
        if card_doc[key] != cpu_doc[key]:
            raise AssertionError(f"the card's {key} differs from the CPU's")
        if card_doc[key] != baseline[key]:
            raise AssertionError(f"the card's {key} differs from {QC_BASELINE}'s")
    honest = _qc_gate(os.path.join(root, "card.json"))
    if honest["rc"] != 0:
        raise AssertionError(f"qc_gate failed the honest card run: {honest}")

    corrupt_doc, corrupt_runs = _harness(os.path.join(root, "corrupt.json"), "--repeats", "1",
                                         "--corrupt", "0.02", *target,
                                         "--workdir", os.path.join(root, "corrupt"))
    corrupt = _qc_gate(os.path.join(root, "corrupt.json"))
    rigged_ckpt = os.path.join(root, "distilled_rigged.json")
    with open(COMMITTED_CHECKPOINT) as fh:
        ckpt = json.load(fh)
    with open(rigged_ckpt, "w") as fh:
        json.dump(dict(ckpt, b2=RIGGED_B2), fh)
    with mock.patch.dict(os.environ, CCT_DISTILLED_CHECKPOINT=rigged_ckpt):
        _rigged_doc, rigged_runs = _harness(os.path.join(root, "rigged.json"), "--repeats",
                                            "1", "--policy", "distilled", *target,
                                            "--workdir", os.path.join(root, "rigged"))
    rigged = _qc_gate(os.path.join(root, "rigged.json"))
    if corrupt["rc"] == 0 or rigged["rc"] == 0:
        raise AssertionError(f"qc_gate passed a control: corrupt {corrupt}, rigged {rigged}")
    launches = {"card": _check_runs("card harness", card_runs, dev),
                "corrupt": _check_runs("corrupt control", corrupt_runs, dev),
                "rigged": _check_runs("rigged control", rigged_runs, dev)}
    seconds = time.perf_counter() - started
    row = {"card": card, "config": " ".join(QC_CONFIG), "repeats": int(QC_CARD_REPEATS),
           "accuracy": _policy_rows(card_doc), "qc_overhead_pct": card_doc["qc_overhead_pct"],
           "stage_wall_s": card_doc["stage_wall_s"],
           "cpu_stage_wall_s": cpu_doc["stage_wall_s"], "equal_to_cpu": True,
           "equal_to": os.path.basename(QC_BASELINE),
           "gate": {"honest": honest, "corrupt": corrupt, "rigged": rigged},
           "corrupt_per_base_error": corrupt_doc["accuracy"]["policies"]["majority"][
               "per_base_error"],
           "b1_launches": launches, "runs": card_runs, "seconds": seconds}
    emit("quality", **row)
    return row


def _loadgen_pass(dev, root: str, tag: str, **env) -> tuple[dict, dict, float]:
    """One load-generator pass in this process against its own spawned
    ``serve`` (on the card; tracing on, ``env`` inherited), the kernel
    library phase 2 built as its ``--compile_cache``: the artifact, and,
    read from the daemon before it stops, its B1 launches and its gangs'
    B1 dense launches (``serve.gang_batches`` trace events)."""
    seen: dict = {}
    original = loadgen._pull_attribution

    def read_daemon(client):
        seen["b1_launches"] = client.metrics()["kernel_launches"]["vote"]
        events = client.request({"op": "trace"})["trace"]["events"]
        gangs = [e["args"] for e in events if e["name"] == "serve.gang_batches"]
        seen.update(gangs=len(gangs), gang_batches=sum(g["batches"] for g in gangs),
                    gang_b1_launches=sum(g["launches"] for g in gangs))
        return original(client)

    out = os.path.join(root, f"{tag}.json")
    argv = ["--workdir", os.path.join(root, tag), *LOADGEN_CUT,
            "--compile_cache", cuda_lib.BUILD_DIR, "--device", dev.type, "--out", out]
    loadgen._pull_attribution = read_daemon
    t = time.perf_counter()
    try:
        with mock.patch.dict(os.environ, CCT_TRACE="1",
                             CCT_TRACE_DIR=os.path.join(root, f"{tag}_trace"), **env):
            rc = _quiet(loadgen.main, argv)
    finally:
        loadgen._pull_attribution = original
    seconds = time.perf_counter() - t
    with open(out) as fh:
        doc = json.load(fh)
    # tools/ci_check.sh's structural asserts (less the autotune table: A11)
    if (rc != 0 or not doc["levels"] or any(lv["aggregate"]["lost"] for lv in doc["levels"])
            or not doc["knee"]["max_throughput_jobs_per_s"] > 0
            or not doc["slo"]["classes"]):
        raise AssertionError(f"loadgen {tag}: rc {rc}, levels {doc['levels']}, "
                             f"knee {doc['knee']}")
    if not seen.get("gangs") or (dev.type == "cuda" and (
            seen["gang_b1_launches"] == 0 or seen["gang_b1_launches"] != seen["gang_batches"])):
        raise AssertionError(f"loadgen {tag}: the daemon's gangs {seen}")
    return doc, seen, seconds


def _level_rows(doc: dict) -> list:
    return [{"offered_jobs_per_s": lv["offered_jobs_per_s"],
             "aggregate": lv["aggregate"], "max_schedule_slip_s": lv["max_schedule_slip_s"],
             "classes": {q: {k: c[k] for k in ("submitted", "done", "shed", "shed_ratio",
                                              "p50_s", "p99_s", "throughput_jobs_per_s")}
                         for q, c in lv["classes"].items()},
             "recompiles_total": lv["recompiles_total"]} for lv in doc["levels"]]


def phase_capacity(dev, work: str, card: str) -> dict:
    """(ii) Two load-generator passes against a ``serve`` daemon on the card
    (the tool's input sizes, ``LOADGEN_CUT``), the second under the
    sampling profiler: each artifact passes ``tools/ci_check.sh``'s
    structural asserts, ``perf_gate --smoke`` passes pass 2 against pass 1,
    and each pass's daemon ganged its jobs into B1 dense launches."""
    started = time.perf_counter()
    root = os.path.join(work, "capacity")
    os.makedirs(root)
    passes = {}
    for tag, env in (("pass1", {}), ("pass2", {**PROF_ENV,
                                              "CCT_PROF_DIR": os.path.join(root, "profs")})):
        doc, daemon, seconds = _loadgen_pass(dev, root, tag, **env)
        passes[tag] = {"knee": doc["knee"], "levels": _level_rows(doc),
                       "preflight_recompiles_total": doc["preflight_recompiles_total"],
                       "daemon": daemon, "attribution": doc.get("attribution", {}).get("fleet"),
                       "seconds": seconds}
        emit("capacity", card=card, cut=" ".join(LOADGEN_CUT), **{"pass": tag},
             **passes[tag])
    verdict = os.path.join(root, "perf_gate.json")
    rc = _quiet(perf_gate.main, ["--fresh", os.path.join(root, "pass2.json"), "--baseline",
                                 os.path.join(root, "pass1.json"), "--smoke", "--out", verdict])
    with open(verdict) as fh:
        gate = json.load(fh)
    if rc != 0 or not passes["pass2"]["attribution"]:
        raise AssertionError(f"perf_gate exited {rc}: {gate}")
    seconds = time.perf_counter() - started
    row = {"card": card, "perf_gate": {"rc": rc, "checks": len(gate["checks"])},
           "dense_gang_launches": sum(p["daemon"]["gang_b1_launches"] for p in passes.values()),
           "seconds": seconds}
    emit("capacity_gate", **row)
    return {**row, "passes": passes}


def phase_yardsticks(dev, work: str, card: str) -> dict:
    """Phase 16: the quality (i) and capacity (ii) yardsticks on the card."""
    started = time.perf_counter()
    quality = phase_quality(dev, work, card)
    capacity = phase_capacity(dev, work, card)
    seconds = time.perf_counter() - started
    emit("yardsticks_phase", seconds=seconds, quality_s=quality["seconds"],
         capacity_s=capacity["seconds"])
    return {"quality": quality, "capacity": capacity, "seconds": seconds}


# ------------------------------------------------------------ phase 17: the soaks

# the soak's kill lands 0.1-0.3 s after the submits (seed 7 draws 0.82 of
# the mean): before the first of three sample.bam jobs can finish
SOAK_ARGS = ("--jobs", "3", "--seed", "7", "--kill-after", "0.2")
# the conductor's --smoke leg (seed 7, 3 workers, 3 unique jobs) at 4
# random events on top of the structural ones, not --smoke's 8: the
# smoke's time limit (PERF.md section 4)
CHAOS_SEED, CHAOS_WORKERS, CHAOS_JOBS, CHAOS_EVENTS = 7, 3, 3, 4
LAUNCH_KEYS = ("b1_launches", "qc_launches", "gangs", "gang_b1_launches")
BACKGROUND_WAIT_S = 900
STRUCTURAL = ("add_member", "poison_submit", "kill_active_router", "restart_router",
              "perm_kill_worker", "disk_full", "decommission_member", "zombie_return")


def _daemon_launches(client) -> dict:
    """A live daemon's B1 launches (the wrapper's counts in its process: all,
    and those with the QC rider) and its gangs' B1 dense launches (its
    ``serve.gang_batches`` trace events), read over its socket.  The soak
    and the conductor run ``--gang_size 1``: a gang of one runs its job
    solo through ``_run_job``'s ``consensus`` (B1 on the stream wire), so
    their gangs launch nothing."""
    events = client.request({"op": "trace"})["trace"]["events"]
    gangs = [e["args"] for e in events if e["name"] == "serve.gang_batches"]
    launches = client.metrics()["kernel_launches"]
    return {"b1_launches": launches["vote"], "qc_launches": launches["vote_qc"],
            "gangs": len(gangs), "gang_b1_launches": sum(g["launches"] for g in gangs)}


def phase_trace_check(snapshot: str, card: str) -> dict:
    """(i) The port's trace checker over phase 12 (i)'s merged fleet trace
    and its workers' journals."""
    trace = os.path.join(snapshot, "trace.json")
    journals = sorted(os.path.join(snapshot, f"{n}.journal") for n in FLEET_MEMBERS)
    t = time.perf_counter()
    schema = trace_check.check_trace(trace)
    summary = trace_check.fleet_summary(trace, journals)
    seconds = time.perf_counter() - t
    if schema or summary["problems"] or not summary["spans"] or not summary["terminal_keys"]:
        raise AssertionError(f"trace_check on phase 12's fleet trace: schema {schema[:10]}, "
                             f"{summary}")
    row = {"card": card, "schema_problems": 0, "seconds": seconds,
           **{k: v for k, v in summary.items() if k != "problems"},
           "fleet_problems": len(summary["problems"])}
    emit("soak_trace_check", **row)
    return row


def phase_soak(dev, work: str, card: str) -> dict:
    """(ii) ``serve_soak`` in this process against its supervised daemon on
    the card, traced, the tool run as it stands: the smoke reads the
    daemon over its socket as the soak signals it (the first daemon just
    before the kill -9, the restarted one just before the SIGTERM that
    drains it), its jobs by the keys the soak submitted, and the flight
    dumps from the workdir."""
    root = os.path.join(work, "soak")
    sock = os.path.join(root, "soak.sock")
    keys: list = []
    seen: dict = {}
    real_kill = os.kill

    class Client(ServeClient):
        def submit_full(self, spec, trace=None):
            reply = super().submit_full(spec, trace)
            keys.append(reply["key"])
            return reply

    def kill(pid, sig):
        what = signal.Signals(sig).name
        if what in ("SIGKILL", "SIGTERM") and what not in seen:
            t = time.perf_counter()
            try:
                c = ServeClient(sock, retries=2, retry_base_s=0.1)
                seen[what] = {"t": t, "pid": pid, "uptime_s": c.healthz()["uptime_s"],
                              "replayed": c.metrics()["cumulative"]["jobs_replayed"],
                              "jobs": [c.status(key=k) for k in keys], **_daemon_launches(c)}
            except Exception as exc:  # the soak's own checks go on; this one fails below
                seen[what] = {"unreadable": repr(exc)}
        real_kill(pid, sig)

    argv = [*SOAK_ARGS, "--device", dev.type, "--workdir", root]
    out = io.StringIO()
    t = time.perf_counter()
    # the shards and the daemon's flight dumps in the workdir, where the
    # soak looks for its journal-replay dump
    with mock.patch.dict(os.environ, CCT_TRACE="1", CCT_TRACE_DIR=root), \
            mock.patch.object(serve_soak, "ServeClient", Client), \
            mock.patch.object(serve_soak.os, "kill", kill), \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = serve_soak.main(argv)
    seconds = time.perf_counter() - t
    dumps = sorted(json.load(open(p))["reason"]
                   for p in glob.glob(os.path.join(root, "flight-*.json")))
    killed, drained = seen.get("SIGKILL", {}), seen.get("SIGTERM", {})
    if rc != 0 or "pid" not in killed or "pid" not in drained or drained["replayed"] < 1 \
            or "journal-replay" not in dumps or killed["pid"] == drained["pid"]:
        raise AssertionError(f"serve_soak {argv}: rc {rc}, dumps {dumps}, {seen}\n"
                             f"{out.getvalue()[-6000:]}")
    if dev.type == "cuda" and drained["b1_launches"] == 0:
        raise AssertionError(f"the restarted daemon's replayed jobs launched no B1: {seen}")
    row = {"card": card, "argv": " ".join(SOAK_ARGS), "seconds": seconds,
           # the kill to the restarted daemon's start: its up-time subtracted
           "restart_s": drained["t"] - killed["t"] - drained["uptime_s"],
           "replayed": drained["replayed"], "dumps": dumps,
           "jobs": [{"state": j["state"], "wall_s": j.get("wall_s")} for j in drained["jobs"]],
           "before_kill": {k: killed[k] for k in LAUNCH_KEYS},
           "after_restart": {k: drained[k] for k in LAUNCH_KEYS},
           "b1_launches": killed["b1_launches"] + drained["b1_launches"]}
    emit("soak", **row)
    return row


def _compute_apps() -> int | None:
    """The processes holding a context on the card, as ``nvidia-smi
    --query-compute-apps`` lists them (None where it cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return sum(ln.strip().isdigit() for ln in out.splitlines())


def phase_chaos(dev, work: str, card: str) -> dict:
    """(iii) The conductor's ``--smoke`` leg in this process, its fleet on
    the card: each spawn, kill and event timed; each worker read before it
    is killed and at the end, with the workers alive and the card's
    compute apps then."""
    root = os.path.join(work, "chaos")
    c = chaos_conductor.Conductor(root, CHAOS_SEED, workers=CHAOS_WORKERS,
                                  max_unique_jobs=CHAOS_JOBS, device=dev.type)
    rec: dict = {"spawns": [], "kills": [], "events": [], "reads": []}
    real = {name: getattr(c, name) for name in
            ("_spawn_worker", "_spawn_router", "_kill9", "teardown")}

    def read(name: str, when: str) -> None:
        w = c.workers[name]
        try:
            got = _daemon_launches(ServeClient(w["sock"], retries=2, retry_base_s=0.1))
        except Exception as exc:  # a dying worker may no longer answer
            got = {"unreadable": type(exc).__name__}
        # nvidia-smi names host pids, which a container's do not match: the
        # live workers come from the conductor, the card's total from it
        live = sum(v["proc"] is not None and v["proc"].poll() is None
                   for v in c.workers.values())
        rec["reads"].append({"worker": name, "pid": w["proc"].pid, "when": when,
                             "live_workers": live, "compute_apps": _compute_apps(), **got})

    def spawn_worker(name):
        real["_spawn_worker"](name)
        rec["spawns"].append({"tag": name, "t_s": time.perf_counter() - t0})

    def spawn_router(rid, standby):
        real["_spawn_router"](rid, standby)
        rec["spawns"].append({"tag": rid, "t_s": time.perf_counter() - t0})

    def kill9(proc, what):
        name = next((n for n, w in c.workers.items() if w["proc"] is proc), None)
        if name is not None and proc.poll() is None:
            read(name, "before kill")
        real["_kill9"](proc, what)
        rec["kills"].append({"what": what, "t_s": time.perf_counter() - t0})

    def teardown():
        for name, w in c.workers.items():
            if w["proc"] is not None and w["proc"].poll() is None:
                read(name, "end")
        real["teardown"]()

    def timed(name, handler):
        def run():
            t = time.perf_counter()
            try:
                return handler()
            finally:
                rec["events"].append({"event": name, "seconds": time.perf_counter() - t})
        return run

    c._spawn_worker, c._spawn_router, c._kill9, c.teardown = (
        spawn_worker, spawn_router, kill9, teardown)
    for name in dir(c):
        if name.startswith("ev_"):
            setattr(c, name, timed(name[3:], getattr(c, name)))
    t0 = time.perf_counter()
    rc = _quiet(c.run, CHAOS_EVENTS)
    seconds = time.perf_counter() - t0
    summary = getattr(c, "trace_summary", None) or {}
    # the port keeps the reference's lost poison verdict (ROADMAP): rc 1 is
    # taken only where the run met its conditions and it is the one violation
    holder = chaos_conductor.reference_poison_fault(c, rc)
    if c.takeovers_seen < 1 or c.adoptions_seen < 1 or c.quarantines_seen < 1 \
            or c.brownouts_seen < 1 or summary.get("orphans") != 0:
        raise AssertionError(f"chaos_conductor --smoke: rc {rc}, violations {c.violations}, "
                             f"trace {summary}")
    launches = sum(r.get("b1_launches", 0) for r in rec["reads"])
    if dev.type == "cuda" and launches == 0:
        raise AssertionError(f"no worker of the fleet launched B1: {rec['reads']}")
    structural = {}
    for ev in rec["events"]:
        if ev["event"] in STRUCTURAL:
            structural.setdefault(ev["event"], []).append(ev["seconds"])
    apps = [r["compute_apps"] for r in rec["reads"] if r["compute_apps"] is not None]
    row = {"card": card, "seed": CHAOS_SEED, "workers": CHAOS_WORKERS,
           "random_events": CHAOS_EVENTS, "events": len(rec["events"]), "seconds": seconds,
           "rc": rc, "outcome": "clean" if holder is None else "reference_poison_fault",
           "reference_poison_fault": holder and {"holder": holder,
                                                 "violation": c.violations[0]},
           "submits": len(c.acked), "unique_jobs": len({a["out"] for a in c.acked}),
           "takeovers": c.takeovers_seen, "adoptions": c.adoptions_seen,
           "quarantines": c.quarantines_seen, "brownouts": c.brownouts_seen,
           "final_epoch": c.last_epoch, "trace": summary,
           "spawns": len(rec["spawns"]),
           "worker_spawns": sum(sp["tag"].startswith("w") for sp in rec["spawns"]),
           "kills": len(rec["kills"]), "structural_event_s": structural,
           "event_s": [[ev["event"], ev["seconds"]] for ev in rec["events"]],
           "worker_reads": rec["reads"], "b1_launches": launches,
           "most_live_workers": max((r["live_workers"] for r in rec["reads"]), default=None),
           "most_compute_apps": max(apps, default=None)}
    emit("chaos", **row)
    return row


# ------------------------------------------------- phases in processes of their own

# each process imports this script, runs its phases in order and writes
# their rows; a phase's own JSON lines count ``t_s`` from its process's start
_BACKGROUND = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke
dev = torch.device(sys.argv[2])
rows = {name: getattr(chip_smoke, fn)(dev, *args) for name, fn, args in json.loads(sys.argv[3])}
with open(sys.argv[4], "w") as fh:
    json.dump(rows, fh, default=str)
"""


class _Background:
    """Phases ``[(name, function, args)]``, each called as ``function(dev,
    *args)``, in a process of their own started now: :meth:`join` echoes
    their JSON lines and returns their rows by name, or raises with the
    process's log tail; :meth:`kill` stops it and every process it
    started."""

    def __init__(self, tag: str, dev, work: str, calls: list):
        self.tag, self.names = tag, [name for name, _fn, _args in calls]
        self.out = os.path.join(work, f"{tag}.json")
        self.log = os.path.join(work, f"{tag}.log")
        with open(self.log, "w") as log:
            # a process group of its own: a failed smoke stops its fleets with it
            self.proc = subprocess.Popen(
                [sys.executable, "-c", _BACKGROUND, REPO, dev.type, json.dumps(calls), self.out],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        self.started = time.perf_counter()

    def join(self) -> dict:
        waited = time.perf_counter()
        rc = self.proc.wait(timeout=BACKGROUND_WAIT_S)
        with open(self.log) as fh:
            text = fh.read()
        if rc != 0:
            raise AssertionError(f"{self.tag} ({', '.join(self.names)}) exited {rc}:\n"
                                 f"{text[-6000:]}")
        for line in text.splitlines():
            if line.startswith('{"phase"'):
                print(line, flush=True)
        with open(self.out) as fh:
            rows = json.load(fh)
        now = time.perf_counter()
        emit(f"{self.tag}_process", phases=self.names, seconds=now - self.started,
             waited_s=now - waited)
        return rows

    def kill(self) -> None:
        # the group outlives its leader while a process it started runs on
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()


# every process this run starts inherits it through its environment,
# whatever process group or parent it ends up with
RUN_MARK = "CHIP_SMOKE_RUN"


def _marked_processes() -> dict:
    """``{pid: command line}`` of every other process whose environment
    carries this run's :data:`RUN_MARK`."""
    mark = f"{RUN_MARK}={os.environ[RUN_MARK]}".encode()
    found = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/environ", "rb") as fh:
                if mark not in fh.read().split(b"\0"):
                    continue
            with open(f"/proc/{entry}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace").strip()
            with open(f"/proc/{entry}/stat") as fh:
                state = fh.read().rsplit(")", 1)[1].split()[0]
        except OSError:  # gone meanwhile, or not ours to read
            continue
        if state != "Z":  # a zombie has ended; its parent's exit reaps it
            found[int(entry)] = cmd[:300]
    return found


def stop_leftovers() -> None:
    """SIGKILL every process of this run still running once its phases
    have ended, and name each in a ``leftovers`` line."""
    found = _marked_processes()
    for pid in found:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + 30
    while _marked_processes() and time.monotonic() < deadline:
        time.sleep(0.2)
    emit("leftovers", count=len(found), processes=[{"pid": pid, "cmd": cmd}
                                                   for pid, cmd in sorted(found.items())],
         still_running=sorted(_marked_processes()))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # 100,000 fragments (1.1M reads): with phase 17 the smoke fits its time
    # limit on slower card hosts only at this depth (PERF.md section 4)
    p.add_argument("--fragments", type=int, default=100_000,
                   help="simulated duplex fragments for phase 5 (default 100000)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    started = time.perf_counter()
    rates = phase_card()
    phase_build()

    os.environ[RUN_MARK] = f"{os.getpid()}-{time.time_ns()}"
    os.makedirs(os.path.join(REPO, ".scratch"), exist_ok=True)
    work = tempfile.mkdtemp(dir=os.path.join(REPO, ".scratch"))
    backgrounds: list = []
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
        walls = phase_walls(dev, sim_bam, work, rates["card"], scale["wall_s"])
        tagged = phase_tagged(dev, work, rates["card"])
        dense, dense_batch = phase_dense(dev, os.path.join(work, "obj.bam"), work, rates)
        phase_mm1(dev, work, rates["card"])
        policies = phase_policy_batches(dev, sim_bam, dense_batch, rates)
        policy_runs = phase_policy_runs(dev, work, rates["card"])
        policy_scale = phase_policy_scale(dev, sim_bam, work, scale["qc_plane"],
                                          rates["card"])
        path = phase_fused_path(dev, book, batches, reference)
        t = time.perf_counter()
        phase_host_workers(dev, sim_bam, work, scale, walls["staged_uninstrumented_wall_s"],
                           rates["card"])
        phase_batch(dev, work, {"obj": tagged["untagged"]["wall_s"],
                                "degraded": policy_runs["degraded/majority"]["wall_s"]},
                    rates["card"])
        phase_config_profile(dev, work, rates["card"])
        emit("whole_command", seconds=time.perf_counter() - t)
        t = time.perf_counter()
        phase_devices(dev, sim_bam, work, scale, walls, rates["card"])
        emit("multi_device", seconds=time.perf_counter() - t)
        serve = phase_serve(dev, work, {
            "obj": {"wall_s": tagged["untagged"]["wall_s"],
                    "launches": tagged["untagged"]["sscs_launches"]},
            "p": {"wall_s": policy_runs["degraded/majority"]["wall_s"],
                  "launches": policy_runs["degraded/majority"]["b1_launches"]}},
            rates["card"])
        emit("serve", seconds=serve["seconds"])
        # phase 17 (ii)-(iii) beside phases 12-15, not after phase 16: in
        # series the smoke outgrows its time limit (PERF.md section 7); their
        # fleets' process starts stay off phase 16's latencies and phase
        # 11's gangs, and phases 12-15's lines carry "beside": "soaks"
        torch.cuda.empty_cache()  # this process's cached card memory
        soaks_bg = _Background("soaks", dev, work, [("soak", "phase_soak", [work, rates["card"]]),
                                                 ("chaos", "phase_chaos", [work, rates["card"]])])
        backgrounds.append(soaks_bg)
        BESIDE["beside"] = "soaks"
        fleet = phase_fleet(dev, work, serve["one_shot"], rates["card"])
        emit("fleet", seconds=fleet["seconds"])
        checked = phase_trace_check(fleet["trace_snapshot"], rates["card"])
        fastq = phase_fastq(dev, work, tagged, rates["card"])
        library = phase_library_host(dev, work, rates["card"])
        training = phase_training(dev, sim_bam, dense_batch, work, rates["card"])
        BESIDE.clear()
        soaks = {"trace_check": checked, **soaks_bg.join()}
        yardsticks = phase_yardsticks(dev, work, rates["card"])
    finally:
        for bg in backgrounds:
            bg.kill()
        stop_leftovers()
        shutil.rmtree(work, ignore_errors=True)
    smoke_s = time.perf_counter() - started
    emit("smoke", seconds=smoke_s)

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
         "rider_bound_ms": vote["qc"]["rider_bound_ms"],
         "library_families_stream_launches": library["entries"]["families_stream"]["b1_launches"],
         "library_blocks_stream_launches": library["entries"]["blocks_stream"]["b1_launches"],
         "accuracy_harness_launches": sum(yardsticks["quality"]["b1_launches"].values()),
         "soak_launches": soaks["soak"]["b1_launches"],
         "chaos_launches": soaks["chaos"]["b1_launches"]},
        {**DENSE_VOTE, "launches": dense["launches"], "max_abs_err": dense["max_abs_err"],
         "ms": dense["ms"], "plain_ms": dense["plain_ms"], "bound_ms": dense["bound_ms"],
         "bound_by": dense["bound_by"], "library_ms": None, "library_note": NO_LIBRARY,
         "qc_launches": dense["qc_launches"], "path": dense["path"], "shape": dense["shape"],
         "serve_gang_launches": serve["large"]["launches"],
         "serve_small_gang_launches": serve["small"]["launches"],
         "serve_small_alone_launches": sum(serve["small"]["alone_dense_b1_launches"].values()),
         "fleet_gang_launches": fleet["route"]["gang_b1_launches"],
         "majority_family_vote_launches": training["vote"]["launches"],
         "loadgen_launches": yardsticks["capacity"]["dense_gang_launches"]},
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
    obs = fleet["obs"]
    print(json.dumps({"fleet_obs": {
        "card": rates["card"], "smoke_s": smoke_s,
        "commands": obs["commands"], "readers_cuda_initialized": obs["cuda_initialized"],
        "critpath": {name: {k: seg[k] for k in ("p50_ms", "p99_ms")}
                     for name, seg in obs["critpath"]["segments"].items()},
        "critpath_jobs": obs["critpath"]["jobs"],
        "dominant_queue_antagonist": obs["critpath"]["dominant_queue_antagonist"],
        "prof": {node: {"shares": a["shares"], "wall_ms": a["wall_ms"], "jobs": a["jobs"]}
                 for node, a in obs["prof"]["nodes"].items()},
        "trace": obs["trace"], "export": obs["export"],
        "history": obs["history"], "qc_diff": fastq["qc"]}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
