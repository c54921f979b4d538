"""SSCS stage: collapse UMI families into single-strand consensus sequences.

Port of ``consensuscruncher_tpu/stages/sscs_maker.py`` (the stream-wire
block path).  Reference parity: ``ConsensusCruncher/SSCS_maker.py``.
Outputs (pinned names; ``<p>`` = output prefix):

- ``<p>.sscs.sorted.bam``       consensus reads (families of size >= 2)
- ``<p>.singleton.sorted.bam``  size-1 families (renamed to consensus qname,
  barcode preserved in ``XT``, for downstream correction/pairing)
- ``<p>.badReads.bam``          unmapped/secondary/supplementary/qcfail/
  mate-unmapped/barcode-less reads
- ``<p>.sscs_stats.txt|.json``  stage stats
- ``<p>.read_families.txt``     family-size histogram
- ``<p>.time_tracker.txt``      wall-clock marks
- ``<p>.metrics.json``          phase walls, families/s, reads/s and the
  cumulative counters (batches, families, transfer bytes, deflate)

The host decodes the BAM column-wise and groups reads into families of
size >= 2 that ship to ``device`` and come back voted, on one of two wires
(bit-identical outputs):

- ``stream`` (the default): family blocks, packed member-stream batches
  (``ops.consensus_segment``), records assembled column-wise;
- ``dense``: per-family events (``grouping.stream_families_columnar``),
  padded ``(B, F, L)`` batches (``ops.consensus_dense``), records emitted
  one family at a time (:func:`emit_consensus`).

The host backends of the JAX package run here as they are, touching no
torch device (``backend``): ``cpu`` votes the columnar per-family events
with ``core.consensus_cpu.consensus_maker_numpy``, ``reference`` decodes
reads one by one (``io.bam.BamReader``), groups them with
``grouping.stream_families`` and votes with the per-position Counter loop
``consensus_maker``.

The sorting writers buffer records in memory and write the
coordinate-sorted BAMs at close, or hand them to the next stage in memory
(``stream_out``).  A host worker reads one BAI coordinate range of the
shared input (``input_range``); a sample batch hands the stage its
input's decode already running (``prestaged``, :func:`prestage_blocks`).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from consensuscruncher_tpu_torch.core import tags as tags_mod
from consensuscruncher_tpu_torch.core.consensus_cpu import consensus_maker, consensus_maker_numpy
from consensuscruncher_tpu_torch.core.consensus_read import (
    _KEEP_FLAGS,
    build_consensus_read,
    modal_cigar,
)
from consensuscruncher_tpu_torch.core.qnames import build_strings, const, fixed, ragged
from consensuscruncher_tpu_torch.io.bam import BamReader, BamWriter
from consensuscruncher_tpu_torch.io.columnar import (
    ColumnarReader,
    SortingBamWriter,
    open_batch_source,
)
from consensuscruncher_tpu_torch.io.encode import (
    ConsensusRecordWriter,
    RenameRetagWriter,
    cigar_string_to_words,
)
from consensuscruncher_tpu_torch.obs import qc as obs_qc
from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.ops.consensus_dense import consensus_families
from consensuscruncher_tpu_torch.ops.consensus_segment import consensus_blocks_stream_batched
from consensuscruncher_tpu_torch.ops.consensus_vote import ConsensusConfig
from consensuscruncher_tpu_torch.ops.residency import record_keys
from consensuscruncher_tpu_torch.parallel.batching import rectangularize
from consensuscruncher_tpu_torch.parallel.mesh import device_mesh
from consensuscruncher_tpu_torch.parallel.prefetch import start_prefetch
from consensuscruncher_tpu_torch.policies import DEFAULT_POLICY, get_policy
from consensuscruncher_tpu_torch.stages.grouping import (
    MemberView,
    stream_families,
    stream_families_columnar,
    stream_family_blocks,
)
from consensuscruncher_tpu_torch.utils.profiling import (
    Counters,
    add_counter_deltas,
    counter_marks,
    write_metrics,
)
from consensuscruncher_tpu_torch.utils import sanitize
from consensuscruncher_tpu_torch.utils.backend_probe import check_host_backend, record_backend
from consensuscruncher_tpu_torch.utils.ragged import gather_runs
from consensuscruncher_tpu_torch.utils.stats import (
    FamilySizeHistogram,
    StageStats,
    TimeTracker,
)


@dataclass
class SscsResult:
    sscs_bam: str
    singleton_bam: str
    bad_bam: str
    stats: StageStats | None  # None when reconstructed from a resume skip
    histogram: FamilySizeHistogram | None

    @classmethod
    def from_prefix(cls, out_prefix: str) -> "SscsResult":
        """Path-only result for a stage skipped by --resume."""
        p = output_paths(out_prefix)
        return cls(p["sscs"], p["singleton"], p["bad"], None, None)


def output_paths(out_prefix: str) -> dict[str, str]:
    """Canonical output paths for a prefix — the single naming authority
    shared by the stage body and the CLI's resume manifest."""
    return {
        "sscs": f"{out_prefix}.sscs.sorted.bam",
        "singleton": f"{out_prefix}.singleton.sorted.bam",
        "bad": f"{out_prefix}.badReads.bam",
        "stats_txt": f"{out_prefix}.sscs_stats.txt",
        "stats_json": f"{out_prefix}.sscs_stats.json",
        "families": f"{out_prefix}.read_families.txt",
        "time_tracker": f"{out_prefix}.time_tracker.txt",
    }


@dataclass
class PrestagedBlocks:
    """An input's decode already running on a producer thread.

    Built by :func:`prestage_blocks` for the multi-sample batch: while
    sample N's pipeline runs, sample N+1's columnar decode + family
    grouping fills a bounded queue, so its SSCS stage starts with blocks
    already in hand.  ``close()`` is idempotent and safe on an unconsumed
    prestage (a resume-skipped stage must not leak the producer thread or
    the open reader).
    """

    reader: object  # the input's ColumnarReader (its header heads the outputs)
    events: object  # parallel.prefetch.start_prefetch iterator

    @property
    def header(self):
        """The input's header (the reader's), which heads the outputs."""
        return self.reader.header

    def close(self) -> None:
        try:
            self.events.close()
        finally:
            self.reader.close()


def prestage_blocks(in_bam: str, bdelim: str = tags_mod.DEFAULT_BDELIM,
                    depth: int = 4) -> PrestagedBlocks:
    """Start decoding ``in_bam`` into FamilyBlock events NOW, on a
    background thread behind a ``depth``-bounded queue (memory bound:
    blocks are the unit).  Consume via ``run_sscs(..., prestaged=...)``
    with the same ``bdelim``."""
    reader = ColumnarReader(in_bam)
    events = start_prefetch(stream_family_blocks(reader, reader.header, bdelim), depth=depth)
    return PrestagedBlocks(reader, events)


def write_singleton(singleton_writer, tag, members) -> None:
    """Route a size-1 family: rename to the consensus qname, preserve the
    barcode in ``XT``/``XF`` tags (dict-replace: a read's own tags stay in
    front)."""
    out = members[0].materialize()  # BamRead: identity
    out.qname = tags_mod.sscs_qname(tag)
    out.tags = dict(out.tags)
    out.tags["XT"] = ("Z", tag.barcode)
    out.tags["XF"] = ("i", 1)
    singleton_writer.write(out)


def emit_consensus(rec_writer, tag, members, codes, quals) -> None:
    """Encode one consensus read of columnar ``MemberView`` members: the
    bytes of ``core.consensus_read.build_consensus_read`` +
    ``io.bam.encode_record`` (the modal cigar of the members of the
    consensus length, their top mapq, ``XT``/``XF``), built column-wise."""
    t = members[0]
    length = codes.shape[0]
    cand = [m for m in members if m.seq_len == length]
    first = cand[0].cigar_bytes() if cand else None
    if first is not None and all(np.array_equal(m.cigar_bytes(), first) for m in cand[1:]):
        # np.array copy: a zero-copy view would pin the whole source batch
        # buffer inside the record writer until its next flush
        words = np.array(np.ascontiguousarray(first).view("<u4"))
    else:  # mixed cigars / all-truncated: exact modal_cigar semantics
        words = cigar_string_to_words(modal_cigar(members, length))
    tag_blob = (
        b"XTZ" + tag.barcode.encode("ascii")
        + b"\x00XFi" + struct.pack("<i", len(members))
    )
    rec_writer.add(
        tags_mod.sscs_qname(tag), t.flag & _KEEP_FLAGS, t.rid, t.pos,
        max(m.mapq for m in members), words, t.mrid, t.mate_pos,
        t.tlen, codes, quals, tag_blob,
    )


def _member_arrays(members):
    seqs, quals = [], []
    for m in members:
        s = m.codes  # uniform across BamRead and columnar MemberView
        q = m.qual if m.qual.size else np.zeros(s.shape[0], dtype=np.uint8)
        seqs.append(s)
        quals.append(q)
    return seqs, quals


def manifest_entry(in_bam: str, out_prefix: str, cutoff: float, qualscore: int,
                   bdelim: str, input_range: str | None = None,
                   policy: str = DEFAULT_POLICY) -> tuple[list, list, dict]:
    """The stage's ``manifest.json`` entry: ``(inputs, outputs, params)``.

    The one authority for what ``consensus --resume`` checks before it
    skips the stage: the CLI records and checks it, and the serve gang
    records it for each job it ran, so a served job's resume skips SSCS.
    ``cutoff``/``qualscore`` are compared typed (float, int), ``in_bam``
    and ``input_range`` as the argv gives them.  badReads.bam is no
    output (--cleanup deletes it and nothing downstream reads it), nor are
    time_tracker and metrics.json (they change every run).  ``policy``
    joins the params only off the default, so a pre-policy manifest still
    satisfies a default resume."""
    paths = output_paths(out_prefix)
    return ([in_bam],
            [paths[k] for k in ("sscs", "singleton", "stats_txt", "stats_json", "families")],
            {"cutoff": float(cutoff), "qualscore": int(qualscore), "bdelim": bdelim,
             "input_range": input_range,
             **({"policy": policy} if policy != DEFAULT_POLICY else {})})


def _commit_in_memory(writer, path: str, level: int):
    """Finish ``writer``'s sort in memory and write its file now (durable
    before the manifest names it); the in-memory records are returned for
    a hand-off.  A spilled sort just closes to its file (None)."""
    from consensuscruncher_tpu_torch.core.streamgraph import StreamFallback

    try:
        mem = writer.close_to_memory()
    except StreamFallback:
        writer.close()
        return None
    mem.write(path, level=level, index=True)
    return mem


class SscsSink:
    """The outputs and the accounting of one SSCS stage: the bad-read, SSCS
    and singleton writers, the stats, the family-size histogram, the time
    marks and the cumulative counters, and the families awaiting their
    vote.  :func:`run_sscs` fills one per run; the serve gang
    (``serve.scheduler.gang_sscs``) fills one per job of its merged
    stream, so a served job's files, stats and sidecars are written by the
    same code as the one-shot stage's."""

    def __init__(self, out_prefix: str, header, level: int = 6):
        self.prefix = out_prefix
        self.paths = output_paths(out_prefix)
        self.level = level
        self.bad_writer = BamWriter(self.paths["bad"], header, atomic=True)
        self.sscs_writer = SortingBamWriter(self.paths["sscs"], header, level=level)
        self.singleton_writer = SortingBamWriter(self.paths["singleton"], header, level=level)
        self.rec_writer = ConsensusRecordWriter(self.sscs_writer)
        self.stats = StageStats("SSCS")
        self.hist = FamilySizeHistogram()
        self.tracker = TimeTracker()
        self.cum = Counters()
        self._pending: dict[int, tuple] = {}

    def bad(self, record, reason: str) -> None:
        self.stats.incr("total_reads")
        self.stats.incr(f"bad_{reason}")
        self.stats.incr("bad_reads")
        self.bad_writer.write(record)

    def family_events(self, events):
        """Route per-family grouping events (``grouping.
        stream_families_columnar`` of the dense wire and ``--backend cpu``,
        or ``stream_families`` of ``--backend reference``): bad reads and size-1
        families are written here; yields ``(fid, seqs, quals)`` per family
        of size >= 2, whose vote comes back through :meth:`emit`."""
        next_id = 0
        for kind, a, b in events:
            if kind == "bad":
                self.bad(a, b)
                continue
            tag, members = a, b
            self.stats.incr("total_reads", len(members))
            self.hist.add(len(members))
            self.stats.incr("families")
            if len(members) == 1:
                self.stats.incr("singletons")
                write_singleton(self.singleton_writer, tag, members)
                continue
            seqs, quals = _member_arrays(members)
            self._pending[next_id] = (tag, members)
            yield next_id, seqs, quals
            next_id += 1

    def emit(self, fid: int, codes, quals) -> None:
        """Write family ``fid``'s consensus read from its voted planes."""
        tag, members = self._pending.pop(fid)
        if isinstance(members[0], MemberView):
            emit_consensus(self.rec_writer, tag, members, codes, quals)
        else:  # the object path's BamRead members (--backend reference)
            self.sscs_writer.write(build_consensus_read(
                tag, members, codes, quals, qname=tags_mod.sscs_qname(tag),
                extra_tags={"XT": ("Z", tag.barcode)}))
        self.stats.incr("sscs_written")

    def abort(self) -> None:
        """Never promote a partial output on error."""
        for w in (self.bad_writer, self.sscs_writer, self.singleton_writer):
            w.abort()

    def close(self, stream_out=None, handoff: bool = False):
        """Commit the outputs once the votes are written (``rec_writer``
        flushed).  With ``stream_out`` (a ``core.streamgraph.StreamOut``)
        the sorted SSCS/singleton records are handed off in memory: the
        SSCS BAM still materializes (a final output, on the write-behind
        pool) and the singleton BAM only as a tap.  With ``handoff`` both
        files are written now and their records are returned as
        ``{"sscs", "singleton"}`` for the caller's streaming chain (None
        when a sort spilled).  Otherwise the files are written; returns
        None."""
        self.tracker.mark("consensus")
        self.bad_writer.close()
        mem = None
        if stream_out is not None:
            stream_out.capture("sscs", self.sscs_writer.close_to_memory(),
                               file_path=self.paths["sscs"], level=self.level)
            stream_out.capture("singleton", self.singleton_writer.close_to_memory(),
                               file_path=self.paths["singleton"] if stream_out.taps else None,
                               level=self.level)
        elif handoff:
            mem = {"sscs": _commit_in_memory(self.sscs_writer, self.paths["sscs"], self.level),
                   "singleton": _commit_in_memory(self.singleton_writer,
                                                  self.paths["singleton"], self.level)}
            if mem["sscs"] is None or mem["singleton"] is None:
                mem = None
        else:
            self.sscs_writer.close()  # lexsort + final BGZF write
            self.singleton_writer.close()
        self.tracker.mark("sort")
        return mem

    def write_sidecars(self, device, cutoff: float,
                       policy: str = DEFAULT_POLICY, marks=None) -> None:
        """The stats, histogram, time-tracker and ``metrics.json`` sidecars.
        ``device``: the votes' ``torch.device``, or the host backend's name;
        either is recorded under the ``backend`` stats key.  A non-default
        ``policy`` is recorded under the ``policy`` stats key, so default
        sidecars keep their golden bytes.  ``marks``
        (``utils.profiling.counter_marks``) adds the process counters'
        deltas since then to the cumulative block."""
        record_backend(self.stats, device)
        self.stats.set("cutoff", cutoff)
        if policy != DEFAULT_POLICY:
            self.stats.set("policy", policy)
        self.stats.write(self.paths["stats_txt"])
        self.hist.write(self.paths["families"])
        self.tracker.write(self.paths["time_tracker"])
        self.cum.add("families_out", self.stats.get("sscs_written"))
        if marks is not None:
            add_counter_deltas(self.cum, marks)
        write_metrics(
            f"{self.prefix}.metrics.json", "SSCS", self.tracker.as_phases(),
            {"backend": self.stats.get("backend"), "jax_backend": None,
             "n_families": self.stats.get("families"),
             "n_reads": self.stats.get("total_reads")},
            cumulative=self.cum.snapshot())


def run_sscs(
    in_bam,
    out_prefix: str,
    device: torch.device,
    cutoff: float = 0.7,
    qual_threshold: int = 0,
    bdelim: str = tags_mod.DEFAULT_BDELIM,
    level: int = 6,
    residency=None,
    qc=None,
    stream_out=None,
    wire: str = "stream",
    policy: str = DEFAULT_POLICY,
    input_range=None,
    prestaged: PrestagedBlocks | None = None,
    devices: int | None = None,
    backend: str | None = None,
) -> SscsResult:
    """Run the SSCS stage with the family votes on ``device``, or on the
    host with ``backend``.

    ``wire``: ``"stream"`` (packed member-stream batches, the default) or
    ``"dense"`` (padded ``(B, F, L)`` batches); bit-identical outputs.

    ``residency``: an ``ops.packing.resident_planes`` store on ``device``;
    on the stream wire, every batch's vote planes are registered there
    before they are downloaded, for rescue and DCS to gather (the dense
    wire fills no store, as in the JAX package).

    ``qc``: an ``obs.qc.QcAccumulator``, armed as the plane sink around
    this stage's vote loop only: every vote batch then carries the QC
    rider (on the card, inside the vote kernel; on the CPU, in the plain
    version) and feeds its sums to the accumulator.

    ``stream_out``: a ``core.streamgraph.StreamOut``; when given, the
    sorted SSCS/singleton outputs are handed off in memory
    (``close_to_memory``) instead of committed to disk here — the SSCS
    BAM still materializes (final output, via the write-behind pool) but
    the singleton BAM becomes a debug tap, written only when the stream
    asked for taps.  ``in_bam`` may then also be an in-memory batch
    source instead of a path.

    ``policy``: the registered vote policy of the family votes
    (``policies/``), resolved (and its checkpoint loaded) before any
    output exists; majority, the default, runs the SSCS kernel, any other
    policy votes by torch ops on ``device`` on either wire.  A
    non-default policy is recorded under the ``policy`` stats key, so
    default sidecars keep their golden bytes.  Unlike the JAX package,
    whose numpy ``cpu`` backend refuses a non-majority policy, every
    policy runs on either device: the port's CPU runs the same torch
    program as the card.

    ``input_range``: an ``io.columnar.BamRange``; read only that BAI
    coordinate range of ``in_bam`` (a ``--host_workers`` worker's share).

    ``prestaged``: an eagerly-started decode of THIS input from
    :func:`prestage_blocks` (the sample batch's overlap), consumed on the
    stream wire; byte-identical outputs.  A prestage that cannot be
    consumed (with ``input_range``, or on the dense wire) is closed and the
    input decoded normally.  The stage closes it on every path.

    ``devices``: family-shard every vote batch over a mesh of this many
    shards, built once for the stage (``parallel.mesh.device_mesh``: shard
    ``k`` on visible card ``k mod count``, or CPU shards on the CPU), on
    either wire; None or 1 = ``device`` alone.  As in the JAX package, a
    mesh takes the majority vote only (any other policy raises before any
    output exists), fills no residency store and arms no QC rider, so
    ``qc.json`` then has no vote plane.

    ``backend``: ``"cpu"`` or ``"reference"``, the JAX package's host
    backends (``utils.backend_probe.HOST_BACKENDS``; ``device`` is then
    ignored, and may be None): the numpy twin over the columnar family
    events, or the object path (per-read decode, ``stream_families``, the
    Counter vote).  They touch no torch device, and refuse what the JAX
    host backends refuse, with its messages: a non-majority ``policy``,
    ``devices > 1``, and ``input_range`` under ``reference``.  ``wire``,
    ``residency`` and ``qc`` are ignored, and a ``prestaged`` decode is
    closed unread, as in the JAX package.

    Besides the stats, the stage writes ``<p>.metrics.json``: phase walls,
    and in its ``cumulative`` block the batches and families voted, the
    bytes moved to and from the card, and the BGZF deflate wall and bytes
    (``utils.profiling.write_metrics``)."""
    if backend is not None:
        return _run_sscs_host(in_bam, out_prefix, backend, cutoff, qual_threshold, bdelim,
                              level, stream_out, wire, policy, input_range, prestaged,
                              devices)
    if prestaged is not None and (input_range is not None or wire != "stream"):
        # a prestage that cannot be consumed must not leak its producer
        # thread and open reader: close it and decode normally
        prestaged.close()
        prestaged = None
    if wire not in ("stream", "dense"):
        raise ValueError(f"unknown wire {wire!r} (expected 'stream' or 'dense')")
    vote_policy = get_policy(policy)
    mesh = None
    if devices is not None and devices > 1:
        if vote_policy.name != DEFAULT_POLICY:
            raise ValueError(f"vote policy {vote_policy.name!r} is single-device only")
        mesh = device_mesh(device, devices)
    vote_policy.prepare()
    marks = counter_marks()
    cfg = ConsensusConfig(cutoff=cutoff, qual_threshold=qual_threshold)

    if prestaged is not None:
        reader = prestaged.reader
    elif input_range is not None:
        reader = ColumnarReader(in_bam, bam_range=input_range)
    else:
        reader = open_batch_source(in_bam)
    header = reader.header
    sink = SscsSink(out_prefix, header, level)
    stats, hist, cum = sink.stats, sink.hist, sink.cum
    singleton_writer, rec_writer = sink.singleton_writer, sink.rec_writer
    single_surgery = RenameRetagWriter(singleton_writer)
    xf1 = struct.pack("<i", 1)

    def block_items():
        """Route FamilyBlock events; yield the size >= 2 families of each
        block as ``(block, fam_idx, keys)`` for the device batches."""
        block_events = (prestaged.events if prestaged is not None
                        else stream_family_blocks(reader, header, bdelim))
        for kind, a, b in block_events:
            if kind == "bad":
                sink.bad(a, b)
                continue
            block = a
            sizes = block.sizes
            stats.incr("total_reads", int(sizes.sum()))
            stats.incr("families", block.n_fam)
            hist.add_array(sizes)
            multi = np.nonzero(sizes >= 2)[0]
            stats.incr("singletons", block.n_fam - len(multi))
            for j in np.nonzero(sizes == 1)[0]:
                j = int(j)
                batch, idx = block.tmpl_src(j)
                if batch.tags_start[idx] == batch.rec_off[idx + 1]:
                    # tag-less record: rename + retag as batched blob surgery
                    single_surgery.add(
                        batch, idx,
                        bytes(block.qname_data[block.qname_off[j]:block.qname_off[j + 1]]),
                        b"XTZ" + bytes(block.bcm[j, : block.bclen[j]]) + b"\x00XFi" + xf1,
                    )
                    continue
                # existing tags: dict-replace semantics (surgery only
                # appends); flush first to preserve file order
                single_surgery.flush()
                out = batch.materialize(idx)
                out.qname = block.qname(j)
                out.tags = dict(out.tags)
                out.tags["XT"] = ("Z", block.barcode(j))
                out.tags["XF"] = ("i", 1)
                singleton_writer.write(out)
            if len(multi):
                yield block, multi, [(block, int(j)) for j in multi]

    def block_runs(keys):
        """``(block, i, k, js)`` per same-block run ``keys[i:k]`` of a device
        batch (runs are contiguous — buckets fill in block order); ``js``
        are the run's family indices in ``block``."""
        n = len(keys)
        i = 0
        while i < n:
            block = keys[i][0]
            k = i + 1
            while k < n and keys[k][0] is block:
                k += 1
            yield block, i, k, np.fromiter((keys[t][1] for t in range(i, k)), np.int64, k - i)
            i = k

    def emit_batch(keys, lengths, out_b, out_q):
        """Array-level consensus emission: one encode pass per same-block
        run of a device batch."""
        lpad = out_b.shape[1]
        flat_b, flat_q = out_b.reshape(-1), out_q.reshape(-1)
        for block, i, k, js in block_runs(keys):
            rows = np.arange(i, k, dtype=np.int64)
            lens = lengths[i:k]
            codes_data, _ = gather_runs(flat_b, rows * lpad, lens)
            qual_data, _ = gather_runs(flat_q, rows * lpad, lens)
            qn_lens = block.qname_off[js + 1] - block.qname_off[js]
            qn_data, _ = gather_runs(block.qname_data, block.qname_off[js], qn_lens)
            cig_lens = block.cigar_off[js + 1] - block.cigar_off[js]
            cig_data, _ = gather_runs(block.cigar_data, block.cigar_off[js], cig_lens)
            fam_sizes = block.sizes[js].astype("<i4")
            tag_data, tag_off = build_strings(k - i, [
                const(b"XTZ"),
                ragged(block.bcm.reshape(-1), block.bclen[js],
                       starts=js * block.bcm.shape[1]),
                const(b"\x00XFi"),
                fixed(fam_sizes.view(np.uint8).reshape(k - i, 4)),
            ])
            rec_writer.add_columns(
                qn_data, qn_lens,
                block.tmpl_flag[js] & _KEEP_FLAGS,
                block.tmpl_rid[js], block.tmpl_pos[js], block.mapq_max[js],
                cig_data, cig_lens,
                block.tmpl_mrid[js], block.tmpl_mpos[js], block.tmpl_tlen[js],
                codes_data, lens, qual_data,
                tag_data, np.diff(tag_off),
            )
            stats.incr("sscs_written", k - i)

    on_device_batch = None
    if residency is not None and wire == "stream" and mesh is None:
        def on_device_batch(batch, planes):
            # row i of the planes is batch.keys[i]; the store key is the
            # family's consensus qname + NUL + the record flag (LE), since
            # R1 and R2 records share the qname.  Rescue and DCS build the
            # same key from the BAM record (dcs_maker._store_keys).
            keys = [record_keys(blk.qname_data, blk.qname_off[js],
                                blk.qname_off[js + 1] - blk.qname_off[js],
                                blk.tmpl_flag[js] & _KEEP_FLAGS)
                    for blk, _i, _k, js in block_runs(batch.keys)]
            residency.append(np.concatenate(keys) if keys else [], batch.lengths[:batch.n_real],
                             planes, batch.n_real)

    ok = False
    if qc is not None:
        obs_qc.set_plane_sink(qc)
    try:
        # CCT_SANITIZE=1: a host sync in the vote loop outside its
        # sanctioned batch transfers raises (utils.sanitize); the
        # sscs.sync_probe fault site plants one
        if wire == "stream":
            with sanitize.guarded_stage("sscs", device), \
                    obs_trace.span("sscs.device_loop", wire="stream"):
                for keys, lengths, out_b, out_q in consensus_blocks_stream_batched(
                        block_items(), cfg, device, on_device_batch, vote_policy, mesh):
                    sanitize.sync_probe("sscs.sync_probe", device)
                    cum.add("batches_dispatched")
                    cum.add("families_in", len(keys))
                    obs_trace.event("device.batch", n_real=len(keys))
                    emit_batch(keys, lengths, out_b, out_q)
        else:
            def on_batch(batch):
                sanitize.sync_probe("sscs.sync_probe", device)
                cum.add("batches_dispatched")
                cum.add("families_in", batch.n_real)
                obs_trace.event("device.batch", n_real=batch.n_real)

            # the producer thread runs the sink's family_events, which writes
            # the bad and singleton records: the generator's close joins it
            # before the writers close below
            stream = consensus_families(
                sink.family_events(stream_families_columnar(reader, header, bdelim)),
                cfg, device, on_batch=on_batch, policy=vote_policy, mesh=mesh)
            try:
                with sanitize.guarded_stage("sscs", device), \
                        obs_trace.span("sscs.device_loop", wire="dense"):
                    for fid, codes, quals in stream:
                        sink.emit(fid, codes, quals)
            finally:
                stream.close()
        rec_writer.flush()
        single_surgery.flush()
        ok = True
    finally:
        if qc is not None:
            obs_qc.set_plane_sink(None)
        if prestaged is not None:
            # join the prestage producer BEFORE closing the reader it decodes
            prestaged.close()
        reader.close()
        if not ok:  # never promote a partial output on error
            sink.abort()
    sink.close(stream_out)
    sink.write_sidecars(device, cutoff, vote_policy.name, marks)
    paths = sink.paths
    return SscsResult(paths["sscs"], paths["singleton"], paths["bad"], stats, hist)



def _run_sscs_host(in_bam, out_prefix: str, backend: str, cutoff: float, qual_threshold: int,
                   bdelim: str, level: int, stream_out, wire: str, policy: str,
                   input_range, prestaged, devices) -> SscsResult:
    """:func:`run_sscs` on a host backend (the JAX ``cpu``/``reference``
    branch of ``run_sscs``): every family of size >= 2 voted one at a time
    with numpy, in stream order, touching no torch device."""
    check_host_backend(backend)
    vote_policy = get_policy(policy)
    if vote_policy.name != DEFAULT_POLICY:
        raise ValueError(f"vote policy {vote_policy.name!r} requires the tpu backend")
    if wire not in ("stream", "dense"):
        raise ValueError(f"unknown wire {wire!r} (expected 'stream' or 'dense')")
    if devices is not None and devices > 1:
        raise ValueError("--devices > 1 requires the tpu backend")
    if prestaged is not None:  # the host backends decode their own way
        prestaged.close()
    if backend == "reference":
        if input_range is not None:
            raise ValueError("input_range requires a columnar backend")
        reader = BamReader(in_bam)
        source = stream_families(reader, reader.header, bdelim)
        vote = consensus_maker
    else:
        reader = (ColumnarReader(in_bam, bam_range=input_range) if input_range is not None
                  else open_batch_source(in_bam))
        source = stream_families_columnar(reader, reader.header, bdelim)
        vote = consensus_maker_numpy
    sink = SscsSink(out_prefix, reader.header, level)
    ok = False
    try:
        for fid, seqs, quals in sink.family_events(source):
            sink.cum.add("families_in")
            rect_s, rect_q, _ = rectangularize(seqs, quals)
            codes, cquals = vote(rect_s, rect_q, cutoff=cutoff, qual_threshold=qual_threshold)
            sink.emit(fid, codes, cquals)
        sink.rec_writer.flush()
        ok = True
    finally:
        reader.close()
        if not ok:  # never promote a partial output on error
            sink.abort()
    sink.close(stream_out)
    sink.write_sidecars(backend, cutoff)
    paths = sink.paths
    return SscsResult(paths["sscs"], paths["singleton"], paths["bad"], sink.stats, sink.hist)

def main(argv=None):
    """Standalone entry (reference: each stage script runs independently).
    The vote runs on the card unless ``--device cpu`` is given; the
    reference's ``--backend`` reads as the device (``tpu`` is the card),
    ``--backend cpu`` votes on the host in numpy, and ``--device`` wins."""
    import argparse

    from consensuscruncher_tpu_torch.utils.backend_probe import entry_device

    p = argparse.ArgumentParser(description="Make single-strand consensus sequences")
    p.add_argument("--infile", required=True, help="coordinate-sorted input BAM")
    p.add_argument("--outfile", required=True, help="output prefix (files get suffixes)")
    p.add_argument("--cutoff", type=float, default=0.7, help="consensus base fraction cutoff")
    p.add_argument("--qualscore", type=int, default=0, help="Phred threshold; lower-quality bases vote N")
    p.add_argument("--backend", choices=("cpu", "tpu"), default="tpu",
                   help="the JAX package's flag: tpu is the card, cpu the host's numpy vote")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the votes run (default cuda); wins over --backend")
    p.add_argument("--bdelim", default=tags_mod.DEFAULT_BDELIM, help="barcode delimiter in qnames")
    args = p.parse_args(argv)
    device, backend = entry_device(args.device, args.backend)
    run_sscs(
        args.infile,
        args.outfile,
        device,
        cutoff=args.cutoff,
        qual_threshold=args.qualscore,
        bdelim=args.bdelim,
        backend=backend,
    )


if __name__ == "__main__":
    main()
