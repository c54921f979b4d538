"""Singleton correction: rescue size-1 families against the complementary strand.

Port of ``consensuscruncher_tpu/stages/singleton_correction.py``.
Reference parity: ``ConsensusCruncher/singleton_correction.py``.  A
singleton is rescued when a complementary-strand partner exists at the same
genomic anchor — an SSCS (singleton-SSCS rescue) or another singleton
(singleton-singleton rescue, both reads corrected and written).  Outputs:

- ``<p>.sscs.rescue.sorted.bam``       singletons corrected against an SSCS
- ``<p>.singleton.rescue.sorted.bam``  singletons corrected against a singleton
- ``<p>.remaining.singleton.sorted.bam``  uncorrected singletons
- ``<p>.singleton_stats.txt|.json``
- ``<p>.singleton.metrics.json``  phase walls (and, on the block path, the
  cumulative counters)

The correction is the duplex vote of singleton vs partner
(``dcs_maker._duplex_vote_batch`` on ``device``, or per pair in numpy on a
host backend, ``--backend cpu|reference``): agreement keeps the base
with summed-capped quality, disagreement yields N.  Partners of unequal
read length are not rescued.

Two paths, as in the JAX package:

- the vectorized block rescue (exact complementary-tag matching), for this
  pipeline's own SSCS-stage outputs (XT/XF-led tag blocks);
- the object window walk (:func:`_run_rescue_walk`), for
  ``--max_mismatch > 0`` (Hamming-tolerant partners through
  ``ops.singleton``) and for singletons whose tag block does not lead with
  XT — every singleton of an aligned input, whose reads already carry tags
  (``NM``, ...) that the SSCS stage keeps in front of ``XT``/``XF``.  The
  block path raises ``grouping.ForeignTagLayout`` on such a record; the
  stage then drops its writers and restarts on the walk.  The walk's
  corrections vote in batches per read length on ``device`` (the JAX walk
  votes each on the host); the sorting writers order records at close, so
  the deferred writes change no byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from consensuscruncher_tpu_torch.core import tags as tags_mod
from consensuscruncher_tpu_torch.core.consensus_cpu import DEFAULT_QUAL_CAP
from consensuscruncher_tpu_torch.core.streamgraph import StreamFallback
from consensuscruncher_tpu_torch.io.bam import BamRead, BamReader
from consensuscruncher_tpu_torch.io.columnar import SortingBamWriter, open_batch_source
from consensuscruncher_tpu_torch.io.encode import encode_records
from consensuscruncher_tpu_torch.ops import singleton as hamming
from consensuscruncher_tpu_torch.stages.dcs_maker import _duplex_vote_batch, _store_keys
from consensuscruncher_tpu_torch.stages.grouping import (
    ForeignTagLayout,
    consensus_windows,
    singleton_rescue_blocks,
)
from consensuscruncher_tpu_torch.utils.backend_probe import check_host_backend, record_backend
from consensuscruncher_tpu_torch.utils.phred import decode_seq, encode_seq
from consensuscruncher_tpu_torch.utils.profiling import (
    Counters,
    add_counter_deltas,
    counter_marks,
    write_metrics,
)
from consensuscruncher_tpu_torch.utils.ragged import gather_runs, scatter_runs
from consensuscruncher_tpu_torch.utils.stats import StageStats, TimeTracker

_XR_SSCS = np.frombuffer(b"XRZsscs\x00", np.uint8)
_XR_SINGLE = np.frombuffer(b"XRZsingleton\x00", np.uint8)


@dataclass
class SingletonResult:
    sscs_rescue_bam: str
    singleton_rescue_bam: str
    remaining_bam: str
    stats: StageStats | None  # None when reconstructed from a resume skip

    @classmethod
    def from_prefix(cls, out_prefix: str) -> "SingletonResult":
        """Path-only result for a stage skipped by --resume."""
        p = output_paths(out_prefix)
        return cls(p["sscs_rescue"], p["singleton_rescue"], p["remaining"], None)


def output_paths(out_prefix: str) -> dict[str, str]:
    """Canonical output paths for a prefix — the single naming authority
    shared by the stage body and the CLI's resume manifest."""
    return {
        "sscs_rescue": f"{out_prefix}.sscs.rescue.sorted.bam",
        "singleton_rescue": f"{out_prefix}.singleton.rescue.sorted.bam",
        "remaining": f"{out_prefix}.remaining.singleton.sorted.bam",
        "stats_txt": f"{out_prefix}.singleton_stats.txt",
        "stats_json": f"{out_prefix}.singleton_stats.json",
    }


def _run_rescue_blocks(singleton_bam, sscs_bam, writers, stats, device,
                       resident=None, cum=None) -> None:
    """RescueBlock decisions -> batched duplex votes -> columnar record
    rebuild (original record + new seq/qual + appended XR tag).

    ``resident``: the SSCS stage's ``ops.residency`` store.  On the
    singleton-vs-SSCS route a resident partner is gathered on the card
    instead of uploaded, and the rescue output is registered in the store
    under the singleton's key, so the later DCS pass gathers it too.
    Misses vote by upload; identical bytes either way.  ``cum``: a
    ``utils.profiling.Counters`` that counts the resident and the uploaded
    pair votes."""
    s_reader = open_batch_source(singleton_bam)
    x_reader = open_batch_source(sscs_bam)
    try:
        for blk in singleton_rescue_blocks(s_reader, x_reader, s_reader.header):
            # guard zero increments: stats files are parity artifacts and
            # only carry the counters a run touched
            for key, val in (
                ("singletons_total", blk.stats_total),
                ("rescued_by_sscs", blk.stats_sscs),
                ("rescued_by_singleton", blk.stats_singleton),
                ("remaining", blk.stats_remaining),
                ("length_mismatch", blk.stats_mismatch),
            ):
                if val:
                    stats.incr(key, val)

            # remaining singletons: raw blob passthrough
            k = 0
            nr = len(blk.remaining_row)
            while k < nr:
                si = int(blk.remaining_src[k])
                k2 = k
                while k2 < nr and blk.remaining_src[k2] == si:
                    k2 += 1
                batch = blk.sources[si]
                rows = blk.remaining_row[k:k2]
                data, _ = gather_runs(
                    batch.buf, batch.rec_off[rows],
                    batch.rec_off[rows + 1] - batch.rec_off[rows],
                )
                writers["remaining"].write_encoded(data)
                k = k2

            n_resc = len(blk.rescue_row)
            if n_resc == 0:
                continue
            # per-rescue READ columns gathered per source batch (the partner
            # contributes only its seq/qual, via member_mat below)
            flag = np.empty(n_resc, np.int64)
            rid = np.empty(n_resc, np.int64)
            posc = np.empty(n_resc, np.int64)
            mridc = np.empty(n_resc, np.int64)
            mposc = np.empty(n_resc, np.int64)
            tlenc = np.empty(n_resc, np.int64)
            mapqc = np.empty(n_resc, np.int64)
            lseqc = np.empty(n_resc, np.int64)
            for si, batch in enumerate(blk.sources):
                m = blk.rescue_src == si
                if not m.any():
                    continue
                rows = blk.rescue_row[m]
                flag[m] = batch.flag[rows]
                rid[m] = batch.ref_id[rows]
                posc[m] = batch.pos[rows]
                mridc[m] = batch.mate_ref_id[rows]
                mposc[m] = batch.mate_pos[rows]
                tlenc[m] = batch.tlen[rows]
                mapqc[m] = batch.mapq[rows]
                lseqc[m] = batch.l_seq[rows]

            def member_mat(src_arr, row_arr, sel, L):
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
                    out_c[m] = codes[coff[rows][:, None] + np.arange(L)]
                    out_q[m] = quals[coff[rows][:, None] + np.arange(L)]
                return out_c, out_q

            for route_name, route in (("sscs_rescue", 0), ("singleton_rescue", 1)):
                rmask = blk.rescue_route == route
                if not rmask.any():
                    continue
                for L in np.unique(lseqc[rmask]):
                    L = int(L)
                    sel = rmask & (lseqc == L)
                    ps = np.nonzero(sel)[0]
                    s1m, q1m = member_mat(blk.rescue_src, blk.rescue_row, sel, L)
                    hit = np.zeros(len(ps), bool)
                    if route == 0 and resident is not None:
                        # singleton vs SSCS: the partner is an SSCS record,
                        # so gather its planes from the store
                        idx2 = resident.rows_for(_store_keys(
                            blk.sources, blk.partner_src, blk.partner_row, ps), L)
                        if idx2 is not None:
                            hit = idx2 >= 0
                    out_b, out_q = np.empty_like(s1m), np.empty_like(q1m)
                    if hit.any():
                        out_b[hit], out_q[hit] = resident.duplex_against(
                            s1m[hit], q1m[hit], idx2[hit], L,
                            register_keys=_store_keys(blk.sources, blk.rescue_src,
                                                       blk.rescue_row, ps[hit]),
                            qual_cap=DEFAULT_QUAL_CAP)
                    if not hit.all():
                        miss = np.zeros_like(sel)
                        miss[ps[~hit]] = True
                        s2m, q2m = member_mat(blk.partner_src, blk.partner_row, miss, L)
                        out_b[~hit], out_q[~hit] = _duplex_vote_batch(
                            s1m[~hit], q1m[~hit], s2m, q2m, device)
                    if cum is not None:
                        cum.add("resident_pair_votes", int(hit.sum()))
                        cum.add("staged_pair_votes", int((~hit).sum()))
                    kk = len(ps)
                    # original qname / cigar / tag bytes, gathered per source
                    qn_start = np.empty(kk, np.int64)
                    qn_len = np.empty(kk, np.int64)
                    cg_start = np.empty(kk, np.int64)
                    cg_len = np.empty(kk, np.int64)
                    tg_start = np.empty(kk, np.int64)
                    tg_len = np.empty(kk, np.int64)
                    src_of = np.empty(kk, np.int64)
                    for si, batch in enumerate(blk.sources):
                        m = blk.rescue_src[ps] == si
                        if not m.any():
                            continue
                        rows = blk.rescue_row[ps[m]]
                        qn_start[m] = batch.qname_start[rows]
                        qn_len[m] = batch.l_qname[rows] - 1
                        cg_start[m] = batch.cigar_start[rows]
                        cg_len[m] = batch.n_cigar[rows]
                        tg_start[m] = batch.tags_start[rows]
                        tg_len[m] = batch.rec_off[rows + 1] - batch.tags_start[rows]
                        src_of[m] = si

                    def gath(starts, lens):
                        data = np.empty(int(lens.sum()), np.uint8)
                        doff = np.zeros(kk, np.int64)
                        np.cumsum(lens[:-1], out=doff[1:])
                        for si, batch in enumerate(blk.sources):
                            m = src_of == si
                            if not m.any():
                                continue
                            scatter_runs(data, doff[m], batch.buf, lens[m],
                                         src_starts=starts[m])
                        return data
                    qn_data = gath(qn_start, qn_len)
                    cg_data = gath(cg_start, 4 * cg_len)
                    tg_old = gath(tg_start, tg_len)
                    # append XR:Z per record — value from the PARTNER's
                    # family size (XF > 1 -> "sscs")
                    xr_is_sscs = blk.partner_xf[ps] > 1
                    xr_len = np.where(xr_is_sscs, len(_XR_SSCS), len(_XR_SINGLE))
                    new_len = tg_len + xr_len
                    new_off = np.zeros(kk, np.int64)
                    np.cumsum(new_len[:-1], out=new_off[1:])
                    tg_new = np.empty(int(new_len.sum()), np.uint8)
                    scatter_runs(tg_new, new_off, tg_old, tg_len)
                    for m, blob_arr in ((xr_is_sscs, _XR_SSCS),
                                        (~xr_is_sscs, _XR_SINGLE)):
                        if not m.any():
                            continue
                        mat = np.broadcast_to(blob_arr, (int(m.sum()), len(blob_arr)))
                        scatter_runs(tg_new, (new_off + tg_len)[m],
                                     np.ascontiguousarray(mat).reshape(-1),
                                     np.full(int(m.sum()), len(blob_arr), np.int64))
                    blob = encode_records(
                        qn_data, qn_len,
                        flag[ps], rid[ps], posc[ps], mapqc[ps],
                        np.ascontiguousarray(cg_data).view("<u4"), cg_len,
                        mridc[ps], mposc[ps], tlenc[ps],
                        out_b.reshape(-1), np.full(kk, L, np.int64),
                        out_q.reshape(-1),
                        tg_new, new_len,
                    )
                    writers[route_name].write_encoded(blob)
    finally:
        s_reader.close()
        x_reader.close()


def _merge_windows(a: Iterator, b: Iterator) -> Iterator[tuple[dict, dict]]:
    """Lockstep position-join of two sorted window streams."""
    wa = next(a, None)
    wb = next(b, None)
    while wa is not None or wb is not None:
        if wb is None or (wa is not None and wa[0] < wb[0]):
            yield wa[1], {}
            wa = next(a, None)
        elif wa is None or wb[0] < wa[0]:
            yield {}, wb[1]
            wb = next(b, None)
        else:
            yield wa[1], wb[1]
            wa = next(a, None)
            wb = next(b, None)


def _member(read: BamRead) -> tuple[np.ndarray, np.ndarray]:
    """A read's base codes and quals (qual '*' as zeros)."""
    q = read.qual if read.qual.size else np.zeros(len(read.seq), dtype=np.uint8)
    return encode_seq(read.seq), q


def _corrected(read: BamRead, partner: BamRead, codes, quals) -> BamRead:
    """``read`` with its duplex-voted ``codes``/``quals`` against ``partner``
    and the ``XR`` tag naming the partner's kind (its ``XF`` > 1: an SSCS)."""
    out = BamRead(
        qname=read.qname, flag=read.flag, ref=read.ref, pos=read.pos, mapq=read.mapq,
        cigar=read.cigar, mate_ref=read.mate_ref, mate_pos=read.mate_pos, tlen=read.tlen,
        seq=decode_seq(codes), qual=quals, tags=dict(read.tags),
    )
    out.tags["XR"] = ("Z", "sscs" if "XF" in partner.tags and partner.tags["XF"][1] > 1
                      else "singleton")
    return out


class _Corrections:
    """The walk's corrections, voted in batches per read length on
    ``device`` (the port of the JAX walk's per-read ``correct_singleton``)
    and written to ``writers[route]`` when a batch is flushed."""

    def __init__(self, writers, device, flush_at: int = 16384):
        self.writers = writers
        self.device = device
        self.flush_at = flush_at
        self._by_len: dict[int, list] = {}

    def add(self, route: str, read: BamRead, partner: BamRead) -> None:
        entries = self._by_len.setdefault(len(read.seq), [])
        entries.append((route, read, partner))
        if len(entries) >= self.flush_at:
            self._flush_len(len(read.seq))

    def _flush_len(self, length: int) -> None:
        entries = self._by_len.pop(length, [])
        if not entries:
            return
        first = [_member(e[1]) for e in entries]
        second = [_member(e[2]) for e in entries]
        out_b, out_q = _duplex_vote_batch(
            np.stack([m[0] for m in first]), np.stack([m[1] for m in first]),
            np.stack([m[0] for m in second]), np.stack([m[1] for m in second]),
            self.device)
        for i, (route, read, partner) in enumerate(entries):
            self.writers[route].write(_corrected(read, partner, out_b[i], out_q[i]))

    def flush(self) -> None:
        for length in sorted(self._by_len):
            self._flush_len(length)


def _same_fields(t: tags_mod.FamilyTag, mirror: tags_mod.FamilyTag) -> bool:
    """``t`` agrees with ``mirror`` on every field but the barcode's
    content: a Hamming candidate."""
    return ((t.ref, t.pos, t.mate_ref, t.mate_pos, t.read_number, t.orientation)
            == (mirror.ref, mirror.pos, mirror.mate_ref, mirror.mate_pos,
                mirror.read_number, mirror.orientation)
            and len(t.barcode) == len(mirror.barcode))


def _barcode_codes(barcode: str) -> np.ndarray:
    return encode_seq(barcode.replace(tags_mod.BARCODE_SEP, ""))


def _hamming_partner(tag, candidates: dict, max_mismatch: int, device):
    """Barcode-tolerant partner lookup among same-anchor candidates whose
    non-barcode tag fields match the mirrored tag exactly: one
    ``ops.singleton.best_matches`` call per tag, as the JAX walk makes.
    The walk itself replays these decisions from chunked distances
    (:class:`_WindowDistances`); this form is their reference."""
    mirror = tags_mod.duplex_tag(tag)
    pool = [t for t in candidates if _same_fields(t, mirror)]
    if not pool:
        return None
    a = _barcode_codes(mirror.barcode)[None, :]
    b = np.stack([_barcode_codes(t.barcode) for t in pool])
    idx = hamming.best_matches(a, b, max_mismatch=max_mismatch, device=device)[0]
    return pool[idx] if idx >= 0 else None


class _WindowDistances:
    """Every Hamming distance one window's walk can ask for: each
    singleton's mirrored barcode against every SSCS and every singleton
    barcode of the window, from one ``ops.singleton.pair_distances`` call
    for a whole chunk of windows (:func:`_chunk_distances`)."""

    def __init__(self, s_tags: list, x_tags: list, dist: np.ndarray):
        # dist: (singles, singles + SSCSes), rows the singles' mirrors
        self.row = {t: i for i, t in enumerate(s_tags)}
        self.sscs_col = {t: j for j, t in enumerate(x_tags)}
        self.to_single, self.to_sscs = dist[:, :len(s_tags)], dist[:, len(s_tags):]

    def partner(self, tag, candidates: dict, pool: str, max_mismatch: int):
        """:func:`_hamming_partner`'s decision for ``tag`` among
        ``candidates`` (a window pool in its dict order, ``pool`` naming
        it: ``"sscs"`` or ``"single"``)."""
        mirror = tags_mod.duplex_tag(tag)
        cands = [t for t in candidates if _same_fields(t, mirror)]
        if not cands:
            return None
        if pool == "sscs":
            dist, col = self.to_sscs, self.sscs_col
        else:
            dist, col = self.to_single, self.row
        row = dist[self.row[tag], [col[t] for t in cands]]
        idx = int(hamming.choose(row[None, :], max_mismatch)[0])
        return cands[idx] if idx >= 0 else None


def _chunk_distances(windows: list, device) -> list:
    """One :class:`_WindowDistances` per ``(singles, sscses)`` window of
    a chunk, from one device call over all of the chunk's pairs."""
    codes, qi, pj, shapes = [], [], [], []
    base = 0
    for singles, sscses in windows:
        s_tags, x_tags = list(singles), list(sscses)
        ns, nx = len(s_tags), len(x_tags)
        shapes.append((s_tags, x_tags))
        if ns == 0:
            continue
        # rows: the singles' mirrored barcodes, then the singles' and the
        # SSCSes' own barcodes
        codes += [_barcode_codes(tags_mod.mirror_barcode(t.barcode)) for t in s_tags]
        codes += [_barcode_codes(t.barcode) for t in s_tags + x_tags]
        q = base + np.repeat(np.arange(ns), ns + nx)
        p = base + ns + np.tile(np.arange(ns + nx), ns)
        qi.append(q)
        pj.append(p)
        base += 2 * ns + nx
    width = max((c.shape[0] for c in codes), default=0)
    mat = np.full((len(codes), width), 0xFF, dtype=np.uint8)
    for r, c in enumerate(codes):
        mat[r, :c.shape[0]] = c
    qi = np.concatenate(qi) if qi else np.zeros(0, np.int64)
    pj = np.concatenate(pj) if pj else np.zeros(0, np.int64)
    dist = hamming.pair_distances(mat, qi, pj, device)
    out, k = [], 0
    for s_tags, x_tags in shapes:
        ns, nx = len(s_tags), len(x_tags)
        out.append(_WindowDistances(s_tags, x_tags,
                                    dist[k:k + ns * (ns + nx)].reshape(ns, ns + nx)))
        k += ns * (ns + nx)
    return out


def _window_chunks(windows: Iterator, max_pairs: int = 1 << 20):
    """Group consecutive windows into chunks of about ``max_pairs``
    singleton-candidate pairs (a window with no singleton closes no
    chunk early and costs no pair)."""
    chunk, pairs = [], 0
    for singles, sscses in windows:
        chunk.append((singles, sscses))
        pairs += len(singles) * (len(singles) + len(sscses))
        if pairs >= max_pairs:
            yield chunk
            chunk, pairs = [], 0
    if chunk:
        yield chunk


def _walk_window(singles: dict, sscses: dict, stats, writers, corrections,
                 max_mismatch: int, hamming_partner) -> None:
    """The rescue decisions of one position window (the JAX walk's loop
    body): exact mirror among the SSCSes, then among the singletons not
    yet consumed, then (``max_mismatch > 0``) ``hamming_partner(tag,
    candidates, pool)`` among the SSCSes and then the other unconsumed
    singletons."""
    done: set = set()
    for tag in sorted(singles, key=str):
        if tag in done:
            continue
        stats.incr("singletons_total")
        read = singles[tag]
        mirror = tags_mod.duplex_tag(tag)

        partner_tag, pool = None, None
        if mirror in sscses:
            partner_tag, pool = mirror, sscses
        elif mirror in singles and mirror != tag and mirror not in done:
            partner_tag, pool = mirror, singles
        elif max_mismatch > 0:
            partner_tag = hamming_partner(tag, sscses, "sscs")
            pool = sscses
            if partner_tag is None:
                # exclude self AND already-consumed singletons — a
                # singleton may be corrected at most once
                avail = {t: r for t, r in singles.items() if t != tag and t not in done}
                partner_tag = hamming_partner(tag, avail, "single")
                pool = singles

        partner = pool.get(partner_tag) if partner_tag is not None else None
        if partner is None or len(partner.seq) != len(read.seq):
            if partner is not None:
                stats.incr("length_mismatch")
            stats.incr("remaining")
            writers["remaining"].write(read)
            continue

        if pool is sscses:
            stats.incr("rescued_by_sscs")
            corrections.add("sscs_rescue", read, partner)
        else:
            # symmetric singleton-singleton rescue: correct both now
            stats.incr("rescued_by_singleton", 2)
            stats.incr("singletons_total")
            corrections.add("singleton_rescue", read, partner)
            corrections.add("singleton_rescue", partner, read)
            done.add(partner_tag)


def _run_rescue_walk(singleton_bam, sscs_bam, writers, stats, max_mismatch: int,
                     device) -> None:
    """The object window walk over both inputs (``grouping.
    consensus_windows``): a chunk of windows at a time, each chunk's
    Hamming distances from one device call when ``max_mismatch > 0``."""
    corrections = _Corrections(writers, device)
    with BamReader(singleton_bam) as s_reader, BamReader(sscs_bam) as x_reader:
        windows = _merge_windows(consensus_windows(s_reader), consensus_windows(x_reader))
        for chunk in _window_chunks(windows):
            # a host backend (device None) takes the numpy distances
            dists = (_chunk_distances(chunk, device or torch.device("cpu"))
                     if max_mismatch > 0 else [None] * len(chunk))
            for (singles, sscses), dist in zip(chunk, dists):
                if not singles:
                    continue
                _walk_window(
                    singles, sscses, stats, writers, corrections, max_mismatch,
                    None if dist is None else
                    (lambda tag, cands, pool, d=dist: d.partner(tag, cands, pool,
                                                                 max_mismatch)))
    corrections.flush()


def run_singleton_correction(singleton_bam, sscs_bam, out_prefix: str,
                             device: torch.device | None, max_mismatch: int = 0,
                             level: int = 6, residency=None,
                             stream_out=None, backend: str | None = None) -> SingletonResult:
    """Singleton rescue with the duplex votes on ``device``.

    ``backend``: ``"cpu"`` or ``"reference"``, a host backend
    (``utils.backend_probe.HOST_BACKENDS``): ``device`` is ignored, the
    votes and the Hamming matcher run in numpy on the host and
    ``residency`` is not used, as in the JAX package.

    ``max_mismatch == 0`` (exact complementary-tag matching, the default)
    runs the vectorized block path; ``max_mismatch > 0`` (and foreign tag
    layouts) the object window walk.  ``residency`` is the SSCS stage's
    plane store (or None: every rescue votes by upload); the walk never
    uses it, as in the JAX package.

    ``stream_out``: a ``core.streamgraph.StreamOut``; outputs hand off in
    memory — remaining singletons stay a final output (write-behind
    materialization), the two rescue BAMs become debug taps.
    ``singleton_bam`` / ``sscs_bam`` may then be in-memory batch sources.
    It needs the block path: the walk re-reads its inputs as files, so a
    foreign tag layout raises ``StreamFallback`` (the CLI re-runs the
    staged pipeline) and ``max_mismatch > 0`` raises ``ValueError``."""
    if backend is not None:
        check_host_backend(backend)
        device, residency = None, None
    tracker = TimeTracker()
    stats = StageStats("singleton_correction")
    cum = Counters()
    marks = counter_marks()
    all_paths = output_paths(out_prefix)
    paths = {k: all_paths[k] for k in ("sscs_rescue", "singleton_rescue", "remaining")}
    if stream_out is not None and max_mismatch != 0:
        raise ValueError("streaming hand-off requires the vectorized rescue path")
    if hasattr(singleton_bam, "header"):
        header = singleton_bam.header
    else:
        with BamReader(singleton_bam) as hdr_reader:
            header = hdr_reader.header
    walk = max_mismatch != 0
    if not walk:
        writers = {k: SortingBamWriter(p, header, level=level) for k, p in paths.items()}
        ok = False
        try:
            _run_rescue_blocks(singleton_bam, sscs_bam, writers, stats, device, residency,
                               cum)
            ok = True
        except ForeignTagLayout as exc:
            if stream_out is not None:
                # in-memory sources cannot be re-read as files by the walk
                raise StreamFallback(f"singleton rescue: {exc}") from exc
            # restart from scratch on the walk below (nothing was promoted)
            walk = True
            stats = StageStats("singleton_correction")
        finally:
            if not ok:
                for w in writers.values():
                    w.abort()
    if walk:
        writers = {k: SortingBamWriter(p, header, level=level) for k, p in paths.items()}
        try:
            _run_rescue_walk(singleton_bam, sscs_bam, writers, stats, max_mismatch, device)
        except BaseException:
            for w in writers.values():
                w.abort()
            raise
    if stream_out is not None:
        stream_out.capture("remaining", writers["remaining"].close_to_memory(),
                           file_path=paths["remaining"], level=level)
        for k in ("sscs_rescue", "singleton_rescue"):
            stream_out.capture(k, writers[k].close_to_memory(),
                               file_path=paths[k] if stream_out.taps else None,
                               level=level)
    else:
        for w in writers.values():
            w.close()  # lexsort + final BGZF write
    stats.set("max_mismatch", max_mismatch)
    record_backend(stats, backend or device)
    stats.write(all_paths["stats_txt"])
    tracker.mark("rescue")
    tracker.write(f"{out_prefix}.singleton.time_tracker.txt")
    # as in the JAX package, the walk's sidecar carries no cumulative block
    if not walk:
        add_counter_deltas(cum, marks)
    write_metrics(
        f"{out_prefix}.singleton.metrics.json", "singleton_correction", tracker.as_phases(),
        {"backend": stats.get("backend"), "jax_backend": None,
         "singletons": stats.get("singletons_total")},
        cumulative=None if walk else cum.snapshot())
    return SingletonResult(paths["sscs_rescue"], paths["singleton_rescue"],
                           paths["remaining"], stats)


def main(argv=None):
    """Standalone entry (reference: each stage script runs independently).
    The rescue's duplex votes run on the card unless ``--device cpu`` is
    given; the reference's ``--backend`` reads as the device (``tpu`` is
    the card), ``--backend cpu`` votes and matches on the host in numpy,
    and ``--device`` wins."""
    import argparse

    from consensuscruncher_tpu_torch.utils.backend_probe import entry_device

    p = argparse.ArgumentParser(description="Rescue singletons against the complementary strand")
    p.add_argument("--singleton", required=True, help="sorted singleton BAM")
    p.add_argument("--bamfile", required=True, help="sorted SSCS BAM")
    p.add_argument("--outfile", required=True, help="output prefix")
    p.add_argument("--max-mismatch", type=int, default=0,
                   help="barcode Hamming tolerance (0 = exact complementary match)")
    p.add_argument("--backend", choices=("cpu", "tpu"), default="tpu",
                   help="the JAX package's flag: tpu is the card, cpu the host's numpy vote")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the votes run (default cuda); wins over --backend")
    args = p.parse_args(argv)
    device, backend = entry_device(args.device, args.backend)
    run_singleton_correction(args.singleton, args.bamfile, args.outfile, device,
                             args.max_mismatch, backend=backend)


if __name__ == "__main__":
    main()
