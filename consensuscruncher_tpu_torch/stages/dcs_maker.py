"""DCS stage: pair complementary-strand SSCSes into duplex consensus reads.

Port of ``consensuscruncher_tpu/stages/dcs_maker.py`` (the vectorized
pair-block path).  Reference parity: ``ConsensusCruncher/DCS_maker.py``.
Outputs:

- ``<p>.dcs.sorted.bam``             duplex consensus reads (one per strand
  pair per mate — both R1-side and R2-side DCS, pairable by qname)
- ``<p>.sscs.singleton.sorted.bam``  SSCSes with no complementary partner
- ``<p>.dcs_stats.txt|.json``

Pairing model (see core/tags.py): an SSCS's partner is ``duplex_tag(tag)``
(mirrored barcode halves, flipped read number) anchored at the SAME
``(ref, pos)``, so pairing streams one position window at a time.  A pair
produces ONE duplex read under ``dcs_qname(tag)`` with the template of the
strand whose barcode is the canonical (lexicographically smaller)
arrangement; unequal-length partners stay unpaired.  The duplex vote is
``ops.duplex`` on ``device``.

Two paths, as in the JAX package: the vectorized pair blocks, for this
pipeline's own consensus BAMs (every tag block leads with XT/XF), and the
object window walk (:func:`_run_dcs_windows`) over any other — a DCS input
that holds rescued singletons of an aligned sample, whose reads carry tags
in front of XT.  The block path raises ``grouping.ForeignTagLayout`` on
such a record; the stage drops its writers and restarts on the walk, which
votes its pairs in batches per read length on ``device``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from consensuscruncher_tpu_torch.core import tags as tags_mod
from consensuscruncher_tpu_torch.core.consensus_cpu import DEFAULT_QUAL_CAP
from consensuscruncher_tpu_torch.core.consensus_read import _KEEP_FLAGS
from consensuscruncher_tpu_torch.core.qnames import build_strings, const, fixed, ragged
from consensuscruncher_tpu_torch.core.streamgraph import StreamFallback
from consensuscruncher_tpu_torch.io.columnar import SortingBamWriter, open_batch_source
from consensuscruncher_tpu_torch.io.encode import ConsensusRecordWriter, cigar_string_to_words
from consensuscruncher_tpu_torch.ops.duplex import duplex_batch_host
from consensuscruncher_tpu_torch.ops.residency import record_keys
from consensuscruncher_tpu_torch.stages.grouping import (
    ForeignTagLayout,
    consensus_windows_columnar,
    duplex_pair_blocks,
    fam_size_of,
)
from consensuscruncher_tpu_torch.utils.ragged import gather_runs, scatter_runs
from consensuscruncher_tpu_torch.utils.stats import StageStats, TimeTracker


@dataclass
class DcsResult:
    dcs_bam: str
    sscs_singleton_bam: str
    stats: StageStats | None  # None when reconstructed from a resume skip

    @classmethod
    def from_prefix(cls, out_prefix: str) -> "DcsResult":
        """Path-only result for a stage skipped by --resume."""
        p = output_paths(out_prefix)
        return cls(p["dcs"], p["unpaired"], None)


def output_paths(out_prefix: str) -> dict[str, str]:
    """Canonical output paths for a prefix — the single naming authority
    shared by the stage body and the CLI's resume manifest."""
    return {
        "dcs": f"{out_prefix}.dcs.sorted.bam",
        "unpaired": f"{out_prefix}.sscs.singleton.sorted.bam",
        "stats_txt": f"{out_prefix}.dcs_stats.txt",
        "stats_json": f"{out_prefix}.dcs_stats.json",
    }


def _duplex_vote_batch(s1, q1, s2, q2, device: torch.device):
    """One duplex vote over stacked ``(P, L)`` pairs on ``device`` — the
    single dispatch shared by DCS and the singleton rescue."""
    return duplex_batch_host(s1, q1, s2, q2, DEFAULT_QUAL_CAP, device)


class _PinnedMember:
    """Self-contained snapshot of a consensus read for deferred batching.

    A ``grouping.ConsensusReadView`` holds a reference to its whole source
    batch (tens of MB); buffering views until a length bucket fills would
    pin every touched batch in memory.  This copies exactly what the
    duplex sink needs (~2L bytes + a few scalars)."""

    __slots__ = ("codes", "qual", "flag", "rid", "pos", "mrid",
                 "mate_pos", "tlen", "mapq", "xf", "cigar")

    def __init__(self, view):
        self.codes = np.array(view.codes)
        self.qual = np.array(view.qual)
        self.flag = view.flag
        self.pos = view.pos
        self.mate_pos = view.mate_pos
        self.tlen = view.tlen
        self.mapq = view.mapq
        self.xf = fam_size_of(view)
        self.rid = view.rid
        self.mrid = view.mrid
        self.cigar = np.array(view.cigar_words())

    @classmethod
    def from_bam_read(cls, read, header):
        """A record whose tag block does not lead with XT, which
        ``consensus_windows_columnar`` yields as a plain ``BamRead``."""
        self = cls.__new__(cls)
        self.codes = read.codes
        q = read.qual
        self.qual = q if q.size else np.zeros(len(read.seq), dtype=np.uint8)
        self.flag = read.flag
        self.pos = read.pos
        self.mate_pos = read.mate_pos
        self.tlen = read.tlen
        self.mapq = read.mapq
        self.xf = fam_size_of(read)
        self.rid = header.ref_id(read.ref)
        self.mrid = header.ref_id(read.mate_ref)
        self.cigar = cigar_string_to_words(read.cigar)
        return self

    @property
    def seq_len(self) -> int:
        return self.codes.shape[0]


class _DuplexBatcher:
    """Accumulate strand pairs per read length; vote them on ``device`` in
    batches of ``flush_at`` (few, large device calls)."""

    def __init__(self, header, device, flush_at: int = 16384):
        self.header = header
        self.device = device
        self.flush_at = flush_at
        self._by_len: dict[int, list] = {}

    def _pin(self, read):
        if hasattr(read, "_batch"):  # columnar view: snapshot to unpin
            return _PinnedMember(read)
        return _PinnedMember.from_bam_read(read, self.header)

    def add(self, canon_tag, canon_read, other_read, sink) -> None:
        canon_read = self._pin(canon_read)
        other_read = self._pin(other_read)
        length = canon_read.seq_len
        self._by_len.setdefault(length, []).append((canon_tag, canon_read, other_read, sink))
        if len(self._by_len[length]) >= self.flush_at:
            self._flush_len(length)

    def _flush_len(self, length: int) -> None:
        entries = self._by_len.pop(length, [])
        if not entries:
            return
        s1 = np.stack([e[1].codes for e in entries])
        s2 = np.stack([e[2].codes for e in entries])
        q1 = np.stack([e[1].qual for e in entries])
        q2 = np.stack([e[2].qual for e in entries])
        out_b, out_q = _duplex_vote_batch(s1, q1, s2, q2, self.device)
        for i, (tag, canon, other, entry_sink) in enumerate(entries):
            entry_sink(tag, canon, other, out_b[i], out_q[i])

    def flush(self) -> None:
        for length in sorted(self._by_len):
            self._flush_len(length)


def _run_dcs_windows(reader, stats, unpaired_writer, rec_writer, device) -> None:
    """Object-window pairing walk (consensus BAMs whose records' tag blocks
    do not all lead with XT:Z + XF:i)."""
    batcher = _DuplexBatcher(reader.header, device)

    def sink(tag, canon, other, codes, quals):
        fam_size = canon.xf + other.xf
        length = codes.shape[0]
        words = canon.cigar if canon.seq_len == length else np.array([length << 4], np.uint32)
        tag_blob = (
            b"XTZ" + tag.barcode.encode("ascii")
            + b"\x00XFi" + struct.pack("<i", fam_size)
        )
        rec_writer.add(
            tags_mod.dcs_qname(tag), canon.flag & _KEEP_FLAGS, canon.rid,
            canon.pos, canon.mapq, words, canon.mrid, canon.mate_pos,
            canon.tlen, codes, quals, tag_blob,
        )
        stats.incr("dcs_written")

    for _key, window in consensus_windows_columnar(reader):
        paired: set = set()
        for tag in sorted(window, key=str):
            if tag in paired:
                continue
            stats.incr("sscs_total")
            partner = tags_mod.duplex_tag(tag)
            other = window.get(partner)
            if other is None or partner in paired:
                stats.incr("sscs_unpaired")
                unpaired_writer.write(window[tag].materialize())
                continue
            stats.incr("sscs_total")  # partner consumed here
            paired.add(tag)
            paired.add(partner)
            read, oread = window[tag], other
            if read.seq_len != oread.seq_len:
                stats.incr("sscs_unpaired", 2)
                stats.incr("length_mismatch_pairs")
                unpaired_writer.write(read.materialize())
                unpaired_writer.write(oread.materialize())
                continue
            # canonical strand: barcode lexicographically <= its mirror
            if tag.barcode <= partner.barcode:
                batcher.add(tag, read, oread, sink)
            else:
                batcher.add(partner, oread, read, sink)
            stats.incr("pairs")
    batcher.flush()


def _store_keys(sources, src_arr, row_arr, ps) -> np.ndarray:
    """Store key per selected row (``ops.residency.record_keys``): qname
    bytes + NUL + little-endian record flag — the keys ``ops.residency``
    indexes consensus planes by.  The flag tells apart the R1/R2 records
    that share a family qname in the SSCS BAM; the capture side
    (``stages.sscs_maker``) builds the same key from the grouping block's
    qname and template flag."""
    parts = []
    for si, batch in enumerate(sources):
        m = np.nonzero(src_arr[ps] == si)[0]
        if m.size:
            rows = row_arr[ps[m]]
            parts.append((m, record_keys(batch.buf, batch.qname_start[rows],
                                         batch.l_qname[rows] - 1, batch.flag[rows])))
    out = np.zeros(len(ps), dtype=np.dtype((np.bytes_, max(
        [keys.itemsize for _m, keys in parts], default=1))))
    for m, keys in parts:
        out[m] = keys
    return out


def _consume_pair_blocks(reader, stats, unpaired_writer, rec_writer,
                         device: torch.device, resident=None) -> None:
    """Vectorized pairing (``grouping.duplex_pair_blocks``): unpaired reads
    pass through as raw blobs, pairs vote in one device batch per length
    group, and duplex records assemble through the columnar record writer.

    ``resident``: the SSCS stage's ``ops.residency`` store.  Pairs whose
    two members are both resident vote by gather on the card; the rest
    vote by upload (:func:`_duplex_vote_batch`).  Identical bytes either
    way."""
    header = reader.header
    for blk in duplex_pair_blocks(reader, header):
        # guard zero increments: stats only carry the counters a run touched
        if blk.stats_total:
            stats.incr("sscs_total", blk.stats_total)
        if blk.stats_unpaired:
            stats.incr("sscs_unpaired", blk.stats_unpaired)
        if blk.stats_pairs:
            stats.incr("pairs", blk.stats_pairs)
        if blk.stats_mismatch:
            stats.incr("length_mismatch_pairs", blk.stats_mismatch)

        # unpaired: raw length-prefixed blob passthrough, in emission order
        k = 0
        nu = len(blk.unpaired_row)
        while k < nu:
            si = int(blk.unpaired_src[k])
            k2 = k
            while k2 < nu and blk.unpaired_src[k2] == si:
                k2 += 1
            batch = blk.sources[si]
            rows = blk.unpaired_row[k:k2]
            data, _ = gather_runs(
                batch.buf, batch.rec_off[rows],
                batch.rec_off[rows + 1] - batch.rec_off[rows],
            )
            unpaired_writer.write_encoded(data)
            k = k2

        n_pairs = blk.n_pairs
        if n_pairs == 0:
            continue
        # per-pair canon columns (vectorized per source)
        flagc = np.empty(n_pairs, np.int64)
        ridc = np.empty(n_pairs, np.int64)
        posc = np.empty(n_pairs, np.int64)
        mridc = np.empty(n_pairs, np.int64)
        mposc = np.empty(n_pairs, np.int64)
        tlenc = np.empty(n_pairs, np.int64)
        mapqc = np.empty(n_pairs, np.int64)
        lseqc = np.empty(n_pairs, np.int64)
        ncigc = np.empty(n_pairs, np.int64)
        cstartc = np.empty(n_pairs, np.int64)
        for si, batch in enumerate(blk.sources):
            m = blk.pair_canon_src == si
            rows = blk.pair_canon_row[m]
            flagc[m] = batch.flag[rows]
            ridc[m] = batch.ref_id[rows]
            posc[m] = batch.pos[rows]
            mridc[m] = batch.mate_ref_id[rows]
            mposc[m] = batch.mate_pos[rows]
            tlenc[m] = batch.tlen[rows]
            mapqc[m] = batch.mapq[rows]
            lseqc[m] = batch.l_seq[rows]
            ncigc[m] = batch.n_cigar[rows]
            cstartc[m] = batch.cigar_start[rows]

        def member_rows(src_arr, row_arr, sel, L):
            out_c = np.empty((int(sel.sum()), L), np.uint8)
            out_q = np.empty_like(out_c)
            pos_sel = np.nonzero(sel)[0]
            for si, batch in enumerate(blk.sources):
                m = src_arr[pos_sel] == si
                if not m.any():
                    continue
                rows = row_arr[pos_sel[m]]
                codes, coff = batch.seq_codes()
                quals, _ = batch.quals()
                lens = np.full(int(m.sum()), L, np.int64)
                data, _off = gather_runs(codes, coff[rows], lens)
                out_c[m] = data.reshape(-1, L)
                data, _off = gather_runs(quals, coff[rows], lens)
                out_q[m] = data.reshape(-1, L)
            return out_c, out_q

        for L in np.unique(lseqc):
            L = int(L)
            sel = lseqc == L
            ps = np.nonzero(sel)[0]
            hit = np.zeros(len(ps), bool)
            if resident is not None:
                idx1 = resident.rows_for(_store_keys(
                    blk.sources, blk.pair_canon_src, blk.pair_canon_row, ps), L)
                idx2 = resident.rows_for(_store_keys(
                    blk.sources, blk.pair_other_src, blk.pair_other_row, ps), L)
                if idx1 is not None:
                    hit = (idx1 >= 0) & (idx2 >= 0)
            out_b = np.empty((len(ps), L), np.uint8)
            out_q = np.empty_like(out_b)
            if hit.any():
                out_b[hit], out_q[hit] = resident.duplex_pairs(
                    idx1[hit], idx2[hit], L, qual_cap=DEFAULT_QUAL_CAP)
            if not hit.all():
                miss = np.zeros_like(sel)
                miss[ps[~hit]] = True
                s1, q1 = member_rows(blk.pair_canon_src, blk.pair_canon_row, miss, L)
                s2, q2 = member_rows(blk.pair_other_src, blk.pair_other_row, miss, L)
                out_b[~hit], out_q[~hit] = _duplex_vote_batch(s1, q1, s2, q2, device)
            k = len(ps)
            # canon cigar bytes per pair, gathered per source batch
            cig_lens = ncigc[ps]
            cig_data = np.empty(int(cig_lens.sum()) * 4, np.uint8)
            dst = np.zeros(k, np.int64)
            np.cumsum(4 * cig_lens[:-1], out=dst[1:])
            for si, batch in enumerate(blk.sources):
                m = blk.pair_canon_src[ps] == si
                if not m.any():
                    continue
                scatter_runs(cig_data, dst[m], batch.buf,
                             4 * cig_lens[m], src_starts=cstartc[ps[m]])
            qn_lens = blk.qname_off[ps + 1] - blk.qname_off[ps]
            qn_data, _ = gather_runs(blk.qname_data, blk.qname_off[ps], qn_lens)
            xf_le = blk.pair_xf[ps].astype("<i4").view(np.uint8).reshape(k, 4)
            tag_data, tag_off = build_strings(k, [
                const(b"XTZ"),
                ragged(blk.pair_bcm.reshape(-1), blk.pair_bclen[ps],
                       starts=ps * blk.pair_bcm.shape[1]),
                const(b"\x00XFi"),
                fixed(xf_le),
            ])
            rec_writer.add_columns(
                qn_data, qn_lens,
                flagc[ps] & _KEEP_FLAGS, ridc[ps], posc[ps], mapqc[ps],
                np.ascontiguousarray(cig_data).view("<u4"), cig_lens,
                mridc[ps], mposc[ps], tlenc[ps],
                out_b.reshape(-1), np.full(k, L, np.int64), out_q.reshape(-1),
                tag_data, np.diff(tag_off),
            )
            stats.incr("dcs_written", k)


def run_dcs(sscs_bam, out_prefix: str, device: torch.device,
            level: int = 6, residency=None, stream_out=None) -> DcsResult:
    """Pair the SSCSes of ``sscs_bam`` with the duplex votes on ``device``;
    ``residency`` is the SSCS stage's plane store (or None: every pair
    votes by upload; the window walk never uses it).

    ``stream_out``: a ``core.streamgraph.StreamOut``; the DCS and
    unpaired-SSCS outputs (both finals) hand off in memory for the
    all-unique merges while materializing on the write-behind pool.
    ``sscs_bam`` may then be an in-memory batch source, which the window
    walk cannot re-read: a foreign tag layout raises ``StreamFallback``
    (the CLI re-runs the staged pipeline)."""
    tracker = TimeTracker()
    stats = StageStats("DCS")
    paths = output_paths(out_prefix)
    reader = open_batch_source(sscs_bam)
    dcs_writer = SortingBamWriter(paths["dcs"], reader.header, level=level)
    unpaired_writer = SortingBamWriter(paths["unpaired"], reader.header, level=level)
    rec_writer = ConsensusRecordWriter(dcs_writer)
    ok = False
    try:
        try:
            _consume_pair_blocks(reader, stats, unpaired_writer, rec_writer, device,
                                 residency)
        except ForeignTagLayout as exc:
            if stream_out is not None:
                raise StreamFallback(f"DCS: {exc}") from exc
            # restart from scratch on the object walk (nothing promoted yet;
            # the buffered writers are simply dropped)
            reader.close()
            dcs_writer.abort()
            unpaired_writer.abort()
            stats = StageStats("DCS")
            reader = open_batch_source(sscs_bam)
            dcs_writer = SortingBamWriter(paths["dcs"], reader.header, level=level)
            unpaired_writer = SortingBamWriter(paths["unpaired"], reader.header,
                                               level=level)
            rec_writer = ConsensusRecordWriter(dcs_writer)
            _run_dcs_windows(reader, stats, unpaired_writer, rec_writer, device)
        rec_writer.flush()
        ok = True
    finally:
        reader.close()
        if not ok:
            dcs_writer.abort()
            unpaired_writer.abort()
    tracker.mark("pairing")
    if stream_out is not None:
        stream_out.capture("dcs", dcs_writer.close_to_memory(),
                           file_path=paths["dcs"], level=level)
        stream_out.capture("unpaired", unpaired_writer.close_to_memory(),
                           file_path=paths["unpaired"], level=level)
    else:
        dcs_writer.close()
        unpaired_writer.close()
    tracker.mark("sort")
    stats.set("backend", device.type)
    stats.write(paths["stats_txt"])
    tracker.write(f"{out_prefix}.dcs.time_tracker.txt")
    return DcsResult(paths["dcs"], paths["unpaired"], stats)
