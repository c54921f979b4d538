"""Singleton correction: rescue size-1 families against the complementary strand.

Port of ``consensuscruncher_tpu/stages/singleton_correction.py`` (the
vectorized exact-match block rescue; ``--max_mismatch > 0`` is not ported
yet).  Reference parity: ``ConsensusCruncher/singleton_correction.py``.  A
singleton is rescued when a complementary-strand partner exists at the same
genomic anchor — an SSCS (singleton-SSCS rescue) or another singleton
(singleton-singleton rescue, both reads corrected and written).  Outputs:

- ``<p>.sscs.rescue.sorted.bam``       singletons corrected against an SSCS
- ``<p>.singleton.rescue.sorted.bam``  singletons corrected against a singleton
- ``<p>.remaining.singleton.sorted.bam``  uncorrected singletons
- ``<p>.singleton_stats.txt|.json``

The correction is the duplex vote of singleton vs partner
(``dcs_maker._duplex_vote_batch`` on ``device``): agreement keeps the base with summed-capped quality,
disagreement yields N.  Partners of unequal read length are not rescued.
The inputs must be this pipeline's own SSCS-stage outputs (XT/XF-led tag
blocks); anything else raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from consensuscruncher_tpu_torch.core.consensus_cpu import DEFAULT_QUAL_CAP
from consensuscruncher_tpu_torch.io.bam import BamReader
from consensuscruncher_tpu_torch.io.columnar import SortingBamWriter, open_batch_source
from consensuscruncher_tpu_torch.io.encode import encode_records
from consensuscruncher_tpu_torch.stages.dcs_maker import _duplex_vote_batch, _store_keys
from consensuscruncher_tpu_torch.stages.grouping import singleton_rescue_blocks
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
                       resident=None) -> None:
    """RescueBlock decisions -> batched duplex votes -> columnar record
    rebuild (original record + new seq/qual + appended XR tag).

    ``resident``: the SSCS stage's ``ops.residency`` store.  On the
    singleton-vs-SSCS route a resident partner is gathered on the card
    instead of uploaded, and the rescue output is registered in the store
    under the singleton's key, so the later DCS pass gathers it too.
    Misses vote by upload; identical bytes either way."""
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


def run_singleton_correction(singleton_bam, sscs_bam, out_prefix: str,
                             device: torch.device, level: int = 6,
                             residency=None, stream_out=None) -> SingletonResult:
    """Exact complementary-tag rescue with the duplex votes on ``device``;
    ``residency`` is the SSCS stage's plane store (or None: every rescue
    votes by upload).

    ``stream_out``: a ``core.streamgraph.StreamOut``; outputs hand off in
    memory — remaining singletons stay a final output (write-behind
    materialization), the two rescue BAMs become debug taps.
    ``singleton_bam`` / ``sscs_bam`` may then be in-memory batch sources."""
    tracker = TimeTracker()
    stats = StageStats("singleton_correction")
    all_paths = output_paths(out_prefix)
    paths = {k: all_paths[k] for k in ("sscs_rescue", "singleton_rescue", "remaining")}
    if hasattr(singleton_bam, "header"):
        header = singleton_bam.header
    else:
        with BamReader(singleton_bam) as hdr_reader:
            header = hdr_reader.header
    writers = {k: SortingBamWriter(p, header, level=level) for k, p in paths.items()}
    ok = False
    try:
        _run_rescue_blocks(singleton_bam, sscs_bam, writers, stats, device, residency)
        ok = True
    finally:
        if not ok:
            for w in writers.values():
                w.abort()
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
    stats.set("max_mismatch", 0)
    stats.set("backend", device.type)
    stats.write(all_paths["stats_txt"])
    tracker.mark("rescue")
    tracker.write(f"{out_prefix}.singleton.time_tracker.txt")
    return SingletonResult(paths["sscs_rescue"], paths["singleton_rescue"],
                           paths["remaining"], stats)
