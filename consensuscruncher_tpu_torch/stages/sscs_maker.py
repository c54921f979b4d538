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

The host decodes the BAM column-wise and groups reads into families of
size >= 2 that ship to ``device`` and come back voted, on one of two wires
(bit-identical outputs):

- ``stream`` (the default): family blocks, packed member-stream batches
  (``ops.consensus_segment``), records assembled column-wise;
- ``dense``: per-family events (``grouping.stream_families_columnar``),
  padded ``(B, F, L)`` batches (``ops.consensus_dense``), records emitted
  one family at a time (:func:`emit_consensus`).

The sorting writers buffer records in memory and write the
coordinate-sorted BAMs at close, or hand them to the next stage in memory
(``stream_out``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from consensuscruncher_tpu_torch.core import tags as tags_mod
from consensuscruncher_tpu_torch.core.consensus_read import _KEEP_FLAGS, modal_cigar
from consensuscruncher_tpu_torch.core.qnames import build_strings, const, fixed, ragged
from consensuscruncher_tpu_torch.io.bam import BamWriter
from consensuscruncher_tpu_torch.io.columnar import SortingBamWriter, open_batch_source
from consensuscruncher_tpu_torch.io.encode import (
    ConsensusRecordWriter,
    RenameRetagWriter,
    cigar_string_to_words,
)
from consensuscruncher_tpu_torch.obs import qc as obs_qc
from consensuscruncher_tpu_torch.ops.consensus_dense import consensus_families
from consensuscruncher_tpu_torch.ops.consensus_segment import consensus_blocks_stream_batched
from consensuscruncher_tpu_torch.ops.consensus_vote import ConsensusConfig
from consensuscruncher_tpu_torch.ops.residency import record_keys
from consensuscruncher_tpu_torch.policies import DEFAULT_POLICY, get_policy
from consensuscruncher_tpu_torch.stages.grouping import (
    stream_families_columnar,
    stream_family_blocks,
)
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
) -> SscsResult:
    """Run the SSCS stage with the family votes on ``device``.

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
    program as the card."""
    if wire not in ("stream", "dense"):
        raise ValueError(f"unknown wire {wire!r} (expected 'stream' or 'dense')")
    vote_policy = get_policy(policy)
    vote_policy.prepare()
    tracker = TimeTracker()
    stats = StageStats("SSCS")
    hist = FamilySizeHistogram()
    cfg = ConsensusConfig(cutoff=cutoff, qual_threshold=qual_threshold)

    paths = output_paths(out_prefix)
    reader = open_batch_source(in_bam)
    header = reader.header
    bad_writer = BamWriter(paths["bad"], header, atomic=True)
    sscs_writer = SortingBamWriter(paths["sscs"], header, level=level)
    singleton_writer = SortingBamWriter(paths["singleton"], header, level=level)
    single_surgery = RenameRetagWriter(singleton_writer)
    rec_writer = ConsensusRecordWriter(sscs_writer)
    xf1 = struct.pack("<i", 1)

    def block_items():
        """Route FamilyBlock events; yield the size >= 2 families of each
        block as ``(block, fam_idx, keys)`` for the device batches."""
        for kind, a, b in stream_family_blocks(reader, header, bdelim):
            if kind == "bad":
                stats.incr("total_reads")
                stats.incr(f"bad_{b}")
                stats.incr("bad_reads")
                bad_writer.write(a)
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

    pending: dict[int, tuple] = {}

    def events():
        """Route the dense wire's grouping events; yield a consensus job
        ``(id, seqs, quals)`` per family of size >= 2."""
        next_id = 0
        for kind, a, b in stream_families_columnar(reader, header, bdelim):
            if kind == "bad":
                stats.incr("total_reads")
                stats.incr(f"bad_{b}")
                stats.incr("bad_reads")
                bad_writer.write(a)
                continue
            tag, members = a, b
            stats.incr("total_reads", len(members))
            hist.add(len(members))
            stats.incr("families")
            if len(members) == 1:
                stats.incr("singletons")
                write_singleton(singleton_writer, tag, members)
                continue
            seqs, quals = _member_arrays(members)
            pending[next_id] = (tag, members)
            yield next_id, seqs, quals
            next_id += 1

    on_device_batch = None
    if residency is not None and wire == "stream":
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
        if wire == "stream":
            for keys, lengths, out_b, out_q in consensus_blocks_stream_batched(
                    block_items(), cfg, device, on_device_batch, vote_policy):
                emit_batch(keys, lengths, out_b, out_q)
        else:
            # the producer thread runs events(), which writes the bad and
            # singleton records: the generator's close joins it before the
            # writers close below
            stream = consensus_families(events(), cfg, device, policy=vote_policy)
            try:
                for fid, codes, quals in stream:
                    tag, members = pending.pop(fid)
                    emit_consensus(rec_writer, tag, members, codes, quals)
                    stats.incr("sscs_written")
            finally:
                stream.close()
        rec_writer.flush()
        single_surgery.flush()
        ok = True
    finally:
        if qc is not None:
            obs_qc.set_plane_sink(None)
        reader.close()
        if not ok:  # never promote a partial output on error
            for w in (bad_writer, sscs_writer, singleton_writer):
                w.abort()
    tracker.mark("consensus")
    bad_writer.close()
    if stream_out is not None:
        # Streaming hand-off: finish the sort in memory.  The SSCS BAM is a
        # final output (write-behind materialization); the singleton BAM
        # only exists to feed rescue, so it becomes a debug tap.
        stream_out.capture("sscs", sscs_writer.close_to_memory(),
                           file_path=paths["sscs"], level=level)
        stream_out.capture("singleton", singleton_writer.close_to_memory(),
                           file_path=paths["singleton"] if stream_out.taps else None,
                           level=level)
    else:
        sscs_writer.close()  # lexsort + final BGZF write
        singleton_writer.close()
    tracker.mark("sort")

    stats.set("backend", device.type)
    stats.set("cutoff", cutoff)
    if vote_policy.name != DEFAULT_POLICY:
        stats.set("policy", vote_policy.name)
    stats.write(paths["stats_txt"])
    hist.write(paths["families"])
    tracker.write(paths["time_tracker"])
    return SscsResult(paths["sscs"], paths["singleton"], paths["bad"], stats, hist)
