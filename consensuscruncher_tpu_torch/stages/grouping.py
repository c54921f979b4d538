"""Streaming UMI-family grouping from a coordinate-sorted BAM.

Reference parity: ``ConsensusCruncher/consensus_helper.py:read_bam`` (SURVEY.md
§3.2), which fills whole-chromosome ``tag -> [reads]`` dicts.  Rebuilt as a
**position-windowed stream**: every member of a family shares the read's own
``(ref, pos)`` (that pair is part of the family key), so once the sorted
stream advances past a position, all families anchored there are complete and
can be flushed.  Memory is bounded by one position window instead of one
chromosome, and no BAI index / per-region ``fetch`` is needed at all.

Read filtering (pinned; reference routes these to a "badRead" BAM):
unmapped, mate-unmapped, secondary, supplementary, QC-fail reads, and reads
whose qname carries no barcode delimiter.  Duplicate-flagged reads are kept —
UMI consensus is itself the deduplicator.

Port of ``consensuscruncher_tpu/stages/grouping.py``, which holds the
same grouping rules at three altitudes; a semantic change must land in all
of them:

1. OBJECT PATH (``stream_families``, ``consensus_windows``,
   ``classify_bad``, ``derive_tag``): per-read ``BamRead`` objects — the
   grouping of ``consensus --backend reference``, the rescue window walk,
   and the readable statement of the rules.  Not to be optimized: it is
   the reference-style baseline the other paths are timed against.
2. COLUMNAR PER-FAMILY PATH (``stream_families_columnar``,
   ``consensus_windows_columnar``): batch decode, per-family emission —
   the dense wire, ``--backend cpu`` and the DCS window walk.
3. BLOCK PATH (``stream_family_blocks`` / ``duplex_pair_blocks`` /
   ``singleton_rescue_blocks``): the vectorized producers of the main
   path.  They take this pipeline's own consensus BAMs only (every tag
   block leads with ``XT:Z`` + ``XF:i``) and raise
   :class:`ForeignTagLayout` on any other record; the rescue and DCS
   stages then restart on their window walks.
"""

from __future__ import annotations

import functools
from typing import Iterable, Iterator

import numpy as np

from consensuscruncher_tpu_torch.core import qnames as qnames_mod
from consensuscruncher_tpu_torch.core import tags as tags_mod
from consensuscruncher_tpu_torch.utils.ragged import gather_runs
from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.io.bam import (
    BamHeader,
    BamRead,
    FMUNMAP,
    FPAIRED,
    FQCFAIL,
    FREAD1,
    FREVERSE,
    FSECONDARY,
    FSUPPLEMENTARY,
    FUNMAP,
)


class NotCoordinateSorted(ValueError):
    pass


class ForeignTagLayout(ValueError):
    """A consensus record whose tag block does not lead with ``XT:Z`` +
    ``XF:i``: the block producers cannot parse it, and the rescue and DCS
    stages restart on their object window walks (nothing else does)."""


def derive_tag(read):
    """Reconstruct a consensus read's family tag (coords/flags + XT barcode).

    Consensus/singleton reads written by the SSCS stage carry their barcode
    in ``XT``; everything else in the family key lives on the read itself.
    """
    if "XT" not in read.tags:
        raise ValueError(f"consensus read {read.qname} lacks the XT barcode tag")
    return tags_mod.unique_tag(read, read.tags["XT"][1])


def consensus_windows(reader):
    """Group a coordinate-sorted consensus BAM into per-(ref,pos) windows.

    OBJECT PATH (see module docstring): the readable statement of the
    windowing rule, and the rescue walk's reader (foreign tag layouts,
    ``--max_mismatch > 0``).

    Yields ``(key, {FamilyTag: read})`` with ``key = (ref_id, pos)``.  Shared
    by the DCS and singleton-correction stages (their pairing partners always
    share the anchor position).  Raises :class:`NotCoordinateSorted` on
    order violations — silent mispairing on unsorted input would complete
    "successfully" with everything unpaired.
    """
    window: dict = {}
    cur = None
    for read in reader:
        tag = derive_tag(read)
        key = (reader.header.ref_id(read.ref), read.pos)
        if cur is not None and key < cur:
            raise NotCoordinateSorted(
                f"consensus BAM is not coordinate-sorted: {read.qname} at "
                f"{read.ref}:{read.pos} after ref_id={cur[0]} pos={cur[1]}"
            )
        if cur is not None and key != cur:
            yield cur, window
            window = {}
        cur = key
        window[tag] = read
    if window:
        yield cur, window


def classify_bad(read: BamRead, bdelim: str) -> str | None:
    """Reason string if the read must be routed to the badRead BAM, else None."""
    if read.is_unmapped:
        return "unmapped"
    if not read.is_paired or read.mate_is_unmapped:
        return "mate_unmapped"
    if read.is_secondary:
        return "secondary"
    if read.is_supplementary:
        return "supplementary"
    if read.is_qcfail:
        return "qcfail"
    try:
        tags_mod.barcode_from_qname(read.qname, bdelim)
    except ValueError:
        return "no_barcode"
    return None


def stream_families(
    reads: Iterable[BamRead],
    header: BamHeader,
    bdelim: str = tags_mod.DEFAULT_BDELIM,
) -> Iterator[tuple[str, object, object]]:
    """Yield ``("bad", read, reason)`` and ``("family", tag, [reads])`` events.

    OBJECT PATH (see module docstring): the grouping walk of ``consensus
    --backend reference``.  Families are emitted as soon as the sorted
    stream passes their anchor position (by position, then tag string).
    Raises :class:`NotCoordinateSorted` if the input violates coordinate
    order.
    """
    pending: dict[tags_mod.FamilyTag, list[BamRead]] = {}
    cur: tuple[int, int] | None = None  # (ref_id, pos) high-water mark

    def flush() -> Iterator[tuple[str, object, object]]:
        for tag in sorted(pending, key=lambda t: (t.pos, str(t))):
            yield "family", tag, pending[tag]
        pending.clear()

    for read in reads:
        reason = classify_bad(read, bdelim)
        if reason is not None:
            yield "bad", read, reason
            continue
        key = (header.ref_id(read.ref), read.pos)
        if cur is not None and key < cur:
            raise NotCoordinateSorted(
                f"input BAM is not coordinate-sorted: {read.qname} at {read.ref}:{read.pos} "
                f"after ref_id={cur[0]} pos={cur[1]} — run sort first"
            )
        if cur is not None and key != cur:
            yield from flush()
        cur = key
        tag = tags_mod.unique_tag(read, tags_mod.barcode_from_qname(read.qname, bdelim))
        pending.setdefault(tag, []).append(read)
    yield from flush()

# ------------------------------------------------------------- columnar path
#
# Vectorized twin of the JAX package's object-path stream_families over
# io.columnar batches (the host-side
# Amdahl fix, SURVEY.md §7 hard-part #3): per-READ work — decode, bad-read
# classification, barcode extraction, family-key building, sortedness
# checking — happens as numpy column operations over whole batches; Python
# objects exist only per FAMILY (the tag + one lightweight view per member).
# Event stream, filtering semantics, and emission order are identical to
# stream_families (same events, same flush-per-coordinate model, families
# sorted by str(tag) within a coordinate), so stage outputs are byte-equal.

# classify_bad reason codes, in classify_bad's priority order.
_BAD_REASONS = (None, "unmapped", "mate_unmapped", "secondary",
                "supplementary", "qcfail", "no_barcode")



def _block_span(fn):
    """``fn`` run in the ``grouping.block`` span: classifying a batch or
    building a block, never across a ``yield``."""
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with obs_trace.span("grouping.block"):
            return fn(*args, **kwargs)

    return spanned


@_block_span
def _classify_batch(batch, bdelim_byte: int):
    """Vectorized classify_bad + barcode locate for one batch.

    Returns ``(reason, last, bclen)`` — reason 0 = good (codes index
    _BAD_REASONS), ``last`` the delimiter column in the qname matrix.
    """
    flag = batch.flag
    qm = batch.qname_matrix
    qlen = batch.l_qname - 1  # int64, actual qname length
    w = qm.shape[1]
    eq = qm == bdelim_byte
    has = eq.any(axis=1)
    last = np.where(has, w - 1 - np.argmax(eq[:, ::-1], axis=1), -1)
    bclen = np.where(has, qlen - last - 1, 0)
    reason = np.select(
        [
            (flag & FUNMAP) != 0,
            ((flag & FPAIRED) == 0) | ((flag & FMUNMAP) != 0),
            (flag & FSECONDARY) != 0,
            (flag & FSUPPLEMENTARY) != 0,
            (flag & FQCFAIL) != 0,
            ~(has & (bclen > 0)),
        ],
        [1, 2, 3, 4, 5, 6],
        default=0,
    ).astype(np.int8)
    return reason, last, bclen


class MemberView:
    """Zero-copy member of a columnar family: consensus inputs as views,
    template/BAM fields materialized lazily from the owning batch."""

    __slots__ = ("codes", "qual", "_batch", "_idx")

    def __init__(self, codes, qual, batch, idx):
        self.codes = codes
        self.qual = qual
        self._batch = batch
        self._idx = idx

    @property
    def seq_len(self) -> int:
        return self.codes.shape[0]

    @property
    def mapq(self) -> int:
        return int(self._batch.mapq[self._idx])

    @property
    def flag(self) -> int:
        return int(self._batch.flag[self._idx])

    @property
    def ref(self) -> str:
        return self._batch.header.ref_name(int(self._batch.ref_id[self._idx]))

    @property
    def pos(self) -> int:
        return int(self._batch.pos[self._idx])

    @property
    def mate_ref(self) -> str:
        return self._batch.header.ref_name(int(self._batch.mate_ref_id[self._idx]))

    @property
    def mate_pos(self) -> int:
        return int(self._batch.mate_pos[self._idx])

    @property
    def tlen(self) -> int:
        return int(self._batch.tlen[self._idx])

    @property
    def rid(self) -> int:
        return int(self._batch.ref_id[self._idx])

    @property
    def mrid(self) -> int:
        return int(self._batch.mate_ref_id[self._idx])

    def cigar_string(self) -> str:
        return self._batch.cigar_string(self._idx)

    def cigar_bytes(self) -> np.ndarray:
        """Raw little-endian cigar words as a byte view (cheap equality)."""
        b = self._batch
        start = int(b.cigar_start[self._idx])
        return b.buf[start : start + 4 * int(b.n_cigar[self._idx])]

    def cigar_words(self) -> np.ndarray:
        return np.ascontiguousarray(self.cigar_bytes()).view("<u4")

    def materialize(self) -> BamRead:
        """Full BamRead (singleton renames, bad-read writes)."""
        return self._batch.materialize(self._idx)


class _Seg:
    """Good-read rows of one coordinate, within one columnar batch."""

    __slots__ = ("batch", "gidx", "bcm", "bclen", "mate_rid", "mate_pos",
                 "rn", "rev", "codes_data", "codes_off", "qual_data", "qual_off")

    def __init__(self, batch, gidx, bcm, bclen, mate_rid, mate_pos, rn, rev,
                 codes_data, codes_off, qual_data, qual_off):
        self.batch = batch
        self.gidx = gidx
        self.bcm = bcm
        self.bclen = bclen
        self.mate_rid = mate_rid
        self.mate_pos = mate_pos
        self.rn = rn
        self.rev = rev
        self.codes_data = codes_data
        self.codes_off = codes_off
        self.qual_data = qual_data
        self.qual_off = qual_off

    def __len__(self):
        return len(self.gidx)


def _good_segments(batch, reason, last, bclen):
    """Split a batch's good rows into per-coordinate _Seg runs (in stream
    order) and validate coordinate sortedness among them."""
    good = np.nonzero(reason == 0)[0]
    if good.size == 0:
        return [], None
    rid = batch.ref_id[good]
    pos = batch.pos[good]
    ok = (rid[1:] > rid[:-1]) | ((rid[1:] == rid[:-1]) & (pos[1:] >= pos[:-1]))
    if not ok.all():
        i = int(np.argmin(ok)) + 1
        read = batch.materialize(int(good[i]))
        raise NotCoordinateSorted(
            f"input BAM is not coordinate-sorted: {read.qname} at "
            f"{read.ref}:{read.pos} after ref_id={int(rid[i - 1])} "
            f"pos={int(pos[i - 1])} — run sort first"
        )
    # coordinate run boundaries among good rows
    change = np.nonzero((rid[1:] != rid[:-1]) | (pos[1:] != pos[:-1]))[0] + 1
    bounds = np.concatenate([[0], change, [good.size]])

    qm = batch.qname_matrix
    w = qm.shape[1]
    wb = int(bclen[good].max(initial=0))
    cols = np.arange(wb, dtype=np.int64)
    src = last[good][:, None] + 1 + cols[None, :]
    valid = cols[None, :] < bclen[good][:, None]
    bcm = np.where(valid, qm[good[:, None], np.minimum(src, w - 1)], 0).astype(np.uint8)

    codes_data, codes_off = batch.seq_codes()
    qual_data, qual_off = batch.quals()
    rn = np.where((batch.flag[good] & FREAD1) != 0, 1, 2).astype(np.int8)
    rev = ((batch.flag[good] & FREVERSE) != 0).astype(np.int8)
    segs = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        g = good[a:b]
        segs.append(_Seg(
            batch, g, bcm[a:b], bclen[g],
            batch.mate_ref_id[g], batch.mate_pos[g], rn[a:b], rev[a:b],
            codes_data, codes_off, qual_data, qual_off,
        ))
    return segs, (int(rid[-1]), int(pos[-1]))


def _emit_group(segs: list[_Seg], header: BamHeader):
    """All families of one coordinate (possibly spanning batches): lexsort
    by key columns (stable -> members keep stream order), split runs, build
    one FamilyTag per family, emit sorted by str(tag) — exactly the object
    path's ``sorted(pending, key=(pos, str(tag)))`` within-coordinate order."""
    if len(segs) == 1:
        s = segs[0]
        bcm, bclen = s.bcm, s.bclen
        mate_rid, mate_pos = s.mate_rid, s.mate_pos
        rn, rev = s.rn, s.rev
    else:
        wb = max(s.bcm.shape[1] for s in segs)
        bcm = np.zeros((sum(len(s) for s in segs), wb), dtype=np.uint8)
        row = 0
        for s in segs:
            bcm[row : row + len(s), : s.bcm.shape[1]] = s.bcm
            row += len(s)
        bclen = np.concatenate([s.bclen for s in segs])
        mate_rid = np.concatenate([s.mate_rid for s in segs])
        mate_pos = np.concatenate([s.mate_pos for s in segs])
        rn = np.concatenate([s.rn for s in segs])
        rev = np.concatenate([s.rev for s in segs])

    n = bcm.shape[0]
    # lexsort: last key is primary; barcode bytes most-significant overall
    keys = [rev, rn, mate_pos, mate_rid]
    keys += [bcm[:, j] for j in range(bcm.shape[1] - 1, -1, -1)]
    order = np.lexsort(keys)

    kb = bcm[order]
    same = np.ones(n, dtype=bool)
    if n > 1:
        same[1:] = (
            (kb[1:] == kb[:-1]).all(axis=1)
            & (mate_rid[order][1:] == mate_rid[order][:-1])
            & (mate_pos[order][1:] == mate_pos[order][:-1])
            & (rn[order][1:] == rn[order][:-1])
            & (rev[order][1:] == rev[order][:-1])
        )
    starts = np.nonzero(~same)[0]
    bounds = np.concatenate([[0], starts, [n]])

    # map flat group-local row -> (segment, local row)
    seg_of = np.repeat(np.arange(len(segs)), [len(s) for s in segs])
    loc = np.concatenate([np.arange(len(s)) for s in segs])

    s0 = segs[0]
    anchor_ref = header.ref_name(int(s0.batch.ref_id[s0.gidx[0]]))
    anchor_pos = int(s0.batch.pos[s0.gidx[0]])

    families = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        rows = order[a:b]
        first = rows[0]
        barcode = bcm[first, : bclen[first]].tobytes().decode("ascii")
        tag = tags_mod.FamilyTag(
            barcode=barcode,
            ref=anchor_ref,
            pos=anchor_pos,
            mate_ref=header.ref_name(int(mate_rid[first])),
            mate_pos=int(mate_pos[first]),
            read_number=int(rn[first]),
            orientation="rev" if rev[first] else "fwd",
        )
        members = []
        for r in rows:
            s = segs[seg_of[r]]
            i = int(s.gidx[loc[r]])
            codes = s.codes_data[s.codes_off[i] : s.codes_off[i + 1]]
            qual = s.qual_data[s.qual_off[i] : s.qual_off[i + 1]]
            members.append(MemberView(codes, qual, s.batch, i))
        families.append((str(tag), tag, members))
    families.sort(key=lambda t: t[0])
    for _, tag, members in families:
        yield "family", tag, members


def stream_families_columnar(
    creader,
    header: BamHeader,
    bdelim: str = tags_mod.DEFAULT_BDELIM,
) -> Iterator[tuple[str, object, object]]:
    """Per-family grouping events over a ``io.columnar.ColumnarReader``
    (the JAX package's object-path ``stream_families``, column-wise):
    ``("bad", BamRead, reason)`` and ``("family", FamilyTag,
    [MemberView])``, families emitted once the sorted stream passes their
    anchor, by position then ``str(tag)`` — the block path's order.  Raises
    :class:`NotCoordinateSorted` on order violations."""
    bdelim_byte = ord(bdelim)
    carry: list[_Seg] = []
    carry_key: tuple[int, int] | None = None
    for batch in creader.batches():
        reason, last, bclen = _classify_batch(batch, bdelim_byte)
        bad = np.nonzero(reason != 0)[0]
        for i in bad:
            yield "bad", batch.materialize(int(i)), _BAD_REASONS[int(reason[i])]
        segs, _tail = _good_segments(batch, reason, last, bclen)
        if not segs:
            continue
        s0 = segs[0]
        first_key = (int(s0.batch.ref_id[s0.gidx[0]]), int(s0.batch.pos[s0.gidx[0]]))
        if carry and carry_key is not None:
            if first_key < carry_key:
                read = s0.batch.materialize(int(s0.gidx[0]))
                raise NotCoordinateSorted(
                    f"input BAM is not coordinate-sorted: {read.qname} at "
                    f"{read.ref}:{read.pos} after ref_id={carry_key[0]} "
                    f"pos={carry_key[1]} — run sort first"
                )
            if first_key == carry_key:
                carry.append(segs.pop(0))
            if segs:  # a later coordinate arrived: the carry is complete
                yield from _emit_group(carry, header)
                carry = []
        for seg in segs[:-1]:
            yield from _emit_group([seg], header)
        if segs:
            tail = segs[-1]
            carry.append(tail)
            carry_key = (
                int(tail.batch.ref_id[tail.gidx[0]]),
                int(tail.batch.pos[tail.gidx[0]]),
            )
    if carry:
        yield from _emit_group(carry, header)


# -------------------------------------------------- columnar consensus path
#
# Columnar twin of the JAX package's consensus_windows for the DCS stage: SSCS/consensus BAMs
# are read as columnar batches; the XT (family barcode) and XF (family
# size) tags the SSCS stage writes FIRST in every record's tag block are
# parsed vectorized from a fixed byte window, with a per-read object
# fallback for records whose tag block doesn't lead with XT (foreign BAMs).

_XT_WINDOW = 96  # tag-block prefix bytes scanned vectorized (barcode + XF)


class ConsensusReadView(MemberView):
    """A consensus read in a columnar batch: MemberView + parsed XT/XF."""

    __slots__ = ("xt", "xf")

    def __init__(self, codes, qual, batch, idx, xt: str, xf: int):
        super().__init__(codes, qual, batch, idx)
        self.xt = xt
        self.xf = xf

    @property
    def fam_size(self) -> int:
        return self.xf


def fam_size_of(read) -> int:
    """XF family size of a consensus read (BamRead or ConsensusReadView)."""
    xf = getattr(read, "xf", None)
    if xf is not None:
        return xf
    return read.tags.get("XF", ("i", 1))[1]


def _parse_xt_xf(batch):
    """Vectorized XT:Z + XF:i parse from each record's tag-block prefix.

    Returns ``(ok, bc_start, bc_len, xf)`` — rows with ``ok=False`` need the
    object fallback.  Offsets are into ``batch.buf`` so barcode bytes can be
    sliced per read without another gather.
    """
    ts = batch.tags_start
    te = batch.rec_off[1:]
    n = batch.n
    span = te - ts
    w = int(min(_XT_WINDOW, span.max(initial=0)))
    if w < 8:
        return np.zeros(n, bool), ts, np.zeros(n, np.int64), np.ones(n, np.int64)
    cols = np.arange(w, dtype=np.int64)
    idx = ts[:, None] + cols[None, :]
    win = np.where(idx < te[:, None], batch.buf[np.minimum(idx, len(batch.buf) - 1)], 0)
    ok = (win[:, 0] == ord("X")) & (win[:, 1] == ord("T")) & (win[:, 2] == ord("Z"))
    z = win[:, 3:] == 0
    has_nul = z.any(axis=1)
    zpos = np.argmax(z, axis=1).astype(np.int64)  # first NUL at/after byte 3
    ok &= has_nul
    # XF:i must follow the barcode NUL and fit inside the scanned window.
    xf_off = 3 + zpos + 1
    fits = xf_off + 7 <= w
    ok &= fits
    safe = np.where(ok, xf_off, 0)
    tag_ok = (
        (np.take_along_axis(win, safe[:, None], 1)[:, 0] == ord("X"))
        & (np.take_along_axis(win, (safe + 1)[:, None], 1)[:, 0] == ord("F"))
        & (np.take_along_axis(win, (safe + 2)[:, None], 1)[:, 0] == ord("i"))
    )
    ok &= tag_ok
    b = [np.take_along_axis(win, (safe + 3 + k)[:, None], 1)[:, 0].astype(np.int64)
         for k in range(4)]
    xf_raw = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
    xf = np.where(xf_raw >= 1 << 31, xf_raw - (1 << 32), xf_raw)  # int32 LE
    return ok, ts + 3, zpos, xf


def consensus_windows_columnar(creader):
    """Columnar twin of :func:`consensus_windows` over a ColumnarReader.

    Yields ``(key, {FamilyTag: ConsensusReadView-or-BamRead})`` with the same
    semantics (last read wins a duplicate tag, NotCoordinateSorted on order
    violations, one window per distinct (ref_id, pos)).
    """
    header = creader.header
    window: dict = {}
    cur = None
    for batch in creader.batches():
        ok, bc_start, bc_len, xf = _parse_xt_xf(batch)
        codes_data, codes_off = batch.seq_codes()
        qual_data, qual_off = batch.quals()
        rid_col, pos_col = batch.ref_id, batch.pos
        flag_col = batch.flag
        buf = batch.buf
        for i in range(batch.n):
            if ok[i]:
                codes = codes_data[codes_off[i] : codes_off[i + 1]]
                qual = qual_data[qual_off[i] : qual_off[i + 1]]
                xt = buf[bc_start[i] : bc_start[i] + bc_len[i]].tobytes().decode("ascii")
                read = ConsensusReadView(codes, qual, batch, i, xt, int(xf[i]))
            else:  # foreign tag layout: full object decode
                read = batch.materialize(i)
                if "XT" not in read.tags:
                    raise ValueError(
                        f"consensus read {read.qname} lacks the XT barcode tag"
                    )
                xt = read.tags["XT"][1]
            rid = int(rid_col[i])
            tag = tags_mod.FamilyTag(
                barcode=xt,
                ref=header.ref_name(rid),
                pos=int(pos_col[i]),
                mate_ref=header.ref_name(int(batch.mate_ref_id[i])),
                mate_pos=int(batch.mate_pos[i]),
                read_number=1 if (int(flag_col[i]) & FREAD1) else 2,
                orientation="rev" if (int(flag_col[i]) & FREVERSE) else "fwd",
            )
            key = (rid, int(pos_col[i]))
            if cur is not None and key < cur:
                qname = batch.materialize(i).qname
                raise NotCoordinateSorted(
                    f"consensus BAM is not coordinate-sorted: {qname} at "
                    f"{tag.ref}:{tag.pos} after ref_id={cur[0]} pos={cur[1]}"
                )
            if cur is not None and key != cur:
                yield cur, window
                window = {}
            cur = key
            window[tag] = read
    if window:
        yield cur, window


# ------------------------------------------------------------ family blocks
#
# The fully-vectorized producer (v3): ONE FamilyBlock per columnar batch
# (the trailing coordinate defers to the next batch, exactly like the
# window carry above).  The coordinate is part of the family key, so
# grouping lexsorts it together with the barcode/mate/flag columns; runs of
# equal keys are families, stable sort preserves member stream order, and
# families emit sorted by (rid, pos, str(tag)) — the object path's global
# order.  Per-family Python shrinks to tag/qname strings and dict inserts;
# everything else is array passes.


class FamilyBlock:
    """All families of one columnar batch, as struct-of-arrays.

    Per family (emission order): ``sizes``, ``target_len`` (modal member
    length, ties -> longer), ``tmpl_*`` template fields, ``mapq_max``,
    barcode bytes (``bcm``/``bclen``), consensus qnames
    (``qname_data``/``qname_off`` — prebuilt ``sscs_qname`` strings),
    modal cigars (``cigar_data``/``cigar_off`` uint32 words), and the
    template source rows (``src_chunk``/``src_row`` into ``batches``).
    Per member (family-contiguous): ``mem_start``/``mem_len`` into
    ``data_chunks[mem_chunk[i]]`` (codes and quals share offsets), with
    ``fam_off`` boundaries.

    ``tags`` materializes ``FamilyTag`` objects lazily (tests, stats text) —
    the hot path never touches it.
    """

    __slots__ = ("sizes", "target_len", "tmpl_flag", "tmpl_rid",
                 "tmpl_pos", "tmpl_mrid", "tmpl_mpos", "tmpl_tlen",
                 "mapq_max", "bcm", "bclen", "qname_data", "qname_off",
                 "cigar_data", "cigar_off", "src_chunk", "src_row",
                 "batches", "ref_names", "data_chunks",
                 "mem_chunk", "mem_start", "mem_len", "fam_off",
                 "_tags_cache")

    @property
    def n_fam(self) -> int:
        return len(self.sizes)

    def qname(self, j: int) -> str:
        return bytes(
            self.qname_data[self.qname_off[j]:self.qname_off[j + 1]]
        ).decode("ascii")

    def barcode(self, j: int) -> str:
        return bytes(self.bcm[j, : self.bclen[j]]).decode("ascii")

    def cigar_words_of(self, j: int) -> np.ndarray:
        """Family ``j``'s modal cigar, as its uint32 BAM words."""
        return self.cigar_data[self.cigar_off[j]:self.cigar_off[j + 1]]

    def tmpl_src(self, j: int):
        return self.batches[int(self.src_chunk[j])], int(self.src_row[j])

    @property
    def tags(self) -> list:
        """FamilyTag objects in emission order (lazy; cold paths only)."""
        if self._tags_cache is None:
            def _rname(i):
                return self.ref_names[i] if i >= 0 else "*"

            rn = np.where((self.tmpl_flag & FREAD1) != 0, 1, 2)
            rev = (self.tmpl_flag & FREVERSE) != 0
            self._tags_cache = [
                tags_mod.FamilyTag(
                    barcode=self.barcode(j),
                    ref=_rname(int(self.tmpl_rid[j])),
                    pos=int(self.tmpl_pos[j]),
                    mate_ref=_rname(int(self.tmpl_mrid[j])),
                    mate_pos=int(self.tmpl_mpos[j]),
                    read_number=int(rn[j]),
                    orientation="rev" if rev[j] else "fwd",
                )
                for j in range(self.n_fam)
            ]
        return self._tags_cache


class _BlockSrc:
    """Good rows of one batch contributing to a block (or carried over)."""

    __slots__ = ("batch", "rows", "bcm", "bclen", "codes_data", "codes_off",
                 "qual_data")

    def __init__(self, batch, rows, bcm, bclen):
        self.batch = batch
        self.rows = rows
        self.bcm = bcm
        self.bclen = bclen
        self.codes_data, self.codes_off = batch.seq_codes()
        self.qual_data, _ = batch.quals()


def _modal_lengths(fam_ids, lens, n_fam):
    """Per-family modal member length, ties -> longer (the pinned
    ``parallel.batching.consensus_length`` semantics), vectorized."""
    order = np.lexsort((lens, fam_ids))
    f, l = fam_ids[order], lens[order]
    new_run = np.ones(len(f), dtype=bool)
    new_run[1:] = (f[1:] != f[:-1]) | (l[1:] != l[:-1])
    run_idx = np.nonzero(new_run)[0]
    run_fam, run_len = f[run_idx], l[run_idx]
    counts = np.diff(np.concatenate([run_idx, [len(f)]]))
    # per family pick (max count, then max len): lexsort runs by
    # (fam, count, len) and take the LAST run of each family
    ro = np.lexsort((run_len, counts, run_fam))
    last = np.zeros(len(ro), dtype=bool)
    if len(ro):
        last[-1] = True
        last[:-1] = run_fam[ro][1:] != run_fam[ro][:-1]
    out = np.zeros(n_fam, dtype=np.int64)
    out[run_fam[ro][last]] = run_len[ro][last]
    return out


def _fill_rows_at(mat, row_idx, data, off, lens):
    """mat[row_idx[i], :lens[i]] = data[off[i]:off[i+1]] for all i.

    ``data``/``off`` come from gather_runs, so the source is packed tight —
    this is :func:`utils.ragged.scatter_runs` over the flattened matrix."""
    from consensuscruncher_tpu_torch.utils.ragged import scatter_runs

    scatter_runs(mat.reshape(-1), row_idx.astype(np.int64) * mat.shape[1],
                 data, lens)


def _modal_cigars(sources, srci, gidx, fam_off, mem_len, target, n_fam):
    """Per-family modal cigar words (core.consensus_read.modal_cigar
    semantics), COLUMNAR: returns ``(words, nwords, off)`` — one packed
    ``<u4`` array with per-family word counts/offsets in family order —
    instead of a per-family list (the list form cost one np.array + one
    .view per family, ~8% of warm SSCS stage wall at 10M reads).

    Vectorized all-candidates-equal fast path; exact Counter-of-strings
    fallback for the rare mixed families.  ``srci``/``gidx``: per member
    (family-contiguous order) the source index and original batch row.
    """
    from consensuscruncher_tpu_torch.io.columnar import ragged_gather
    from consensuscruncher_tpu_torch.utils.ragged import scatter_runs

    n = len(srci)
    sizes = np.diff(fam_off)
    target_rep = np.repeat(target, sizes)
    cand = mem_len == target_rep

    nc = np.empty(n, dtype=np.int64)
    cstart = np.empty(n, dtype=np.int64)
    for k, s in enumerate(sources):
        m = srci == k
        rows = gidx[m]
        nc[m] = s.batch.n_cigar[rows]
        cstart[m] = s.batch.cigar_start[rows]

    BIG = n + 1
    idx = np.where(cand, np.arange(n), BIG)
    first_cand = np.minimum.reduceat(idx, fam_off[:-1]) if n_fam else idx[:0]
    has_cand = first_cand < BIG
    fc = np.where(has_cand, first_cand, 0)

    def assemble(nwords, fill_all_eq):
        """Pack per-family words: no-cand families emit [target << 4]."""
        off = np.zeros(n_fam + 1, dtype=np.int64)
        np.cumsum(nwords, out=off[1:])
        words = np.zeros(int(off[-1]), dtype=np.uint32)
        no_cand = np.nonzero(~has_cand)[0]
        words[off[no_cand]] = (target[no_cand].astype(np.int64) << 4).astype(np.uint32)
        fill_all_eq(words, off)
        return words, nwords, off

    wmax = int(nc[cand].max(initial=0)) if n else 0
    if wmax == 0:
        nwords = np.where(has_cand, 0, 1).astype(np.int64)
        return assemble(nwords, lambda words, off: None)

    # candidate cigar byte matrix; non-candidates copy their family's first
    # candidate so they can never break the equality test
    fc_rep = np.repeat(fc, sizes)
    eff = np.where(cand, np.arange(n), fc_rep)
    W = 4 * wmax
    mat = np.zeros((n, W), dtype=np.uint8)
    lens = 4 * nc[eff]
    for k, s in enumerate(sources):
        m = srci[eff] == k
        rows = np.nonzero(m)[0]
        if rows.size:
            data, off2 = ragged_gather(s.batch.buf, cstart[eff][rows], lens[rows])
            _fill_rows_at(mat, rows, data, off2, lens[rows])

    eq = (mat == mat[fc_rep]).all(axis=1) & (nc[eff] == nc[fc_rep])
    all_eq = np.logical_and.reduceat(eq, fam_off[:-1]) if n_fam else eq[:0]

    fallback = np.nonzero(has_cand & ~all_eq)[0]
    fb_words: dict[int, np.ndarray] = {}
    for j in fallback:  # rare: mixed candidate cigars inside one family
        from collections import Counter

        from consensuscruncher_tpu_torch.io.bam import cigar_from_string
        from consensuscruncher_tpu_torch.io.encode import cigar_string_to_words

        counts = Counter(
            sources[int(srci[i])].batch.cigar_string(int(gidx[i]))
            for i in range(fam_off[j], fam_off[j + 1])
            if cand[i]
        )
        fb_words[int(j)] = cigar_string_to_words(
            cigar_from_string(counts.most_common(1)[0][0])
        )

    nwords = np.where(has_cand, nc[fc], 1).astype(np.int64)
    for j, w in fb_words.items():
        nwords[j] = len(w)

    def fill(words, off):
        vec = np.nonzero(has_cand & all_eq)[0]
        if vec.size:
            flat = np.ascontiguousarray(mat).view("<u4").reshape(n, wmax)
            # one ragged gather-scatter: family j's words are row fc[j]'s
            # first nwords[j] uint32s
            data, d_off = ragged_gather(flat.reshape(-1),
                                        fc[vec] * wmax, nwords[vec])
            scatter_runs(words, off[vec], data, nwords[vec])
        for j, w in fb_words.items():
            words[off[j] : off[j] + len(w)] = w

    return assemble(nwords, fill)


def _header_name_pool(header: BamHeader):
    """(ref_names, qnames ref-name pool) for a header, cached on the header
    instance — rebuilt-per-block encode+sort of every contig name is pure
    waste on many-contig references (GRCh38 ~3.4k, transcriptomes 100k+)."""
    cached = getattr(header, "_cct_name_pool", None)
    if cached is None:
        ref_names = [header.ref_name(i) for i in range(len(header.refs))]
        cached = (ref_names, qnames_mod.ref_name_pool(ref_names))
        header._cct_name_pool = cached
    return cached


@_block_span
def _build_block(sources: list[_BlockSrc], header: BamHeader) -> FamilyBlock:
    """Vectorized family construction over one or more row sources."""
    def col(fn):
        return np.concatenate([fn(s) for s in sources])

    rid = col(lambda s: s.batch.ref_id[s.rows])
    pos = col(lambda s: s.batch.pos[s.rows])
    mrid = col(lambda s: s.batch.mate_ref_id[s.rows])
    mpos = col(lambda s: s.batch.mate_pos[s.rows])
    flag = col(lambda s: s.batch.flag[s.rows])
    mapq = col(lambda s: s.batch.mapq[s.rows].astype(np.int64))
    tlen = col(lambda s: s.batch.tlen[s.rows])
    mstart = col(lambda s: s.codes_off[s.rows])
    mlen = col(lambda s: s.codes_off[s.rows + 1] - s.codes_off[s.rows])
    gidx = col(lambda s: s.rows)
    srci = np.repeat(
        np.arange(len(sources), dtype=np.int64), [len(s.rows) for s in sources]
    )
    bclen = np.concatenate([s.bclen for s in sources])
    wb = max((s.bcm.shape[1] for s in sources), default=0)
    n = len(rid)
    bcm = np.zeros((n, wb), dtype=np.uint8)
    row = 0
    for s in sources:
        bcm[row : row + len(s.rows), : s.bcm.shape[1]] = s.bcm
        row += len(s.rows)

    rn = np.where((flag & FREAD1) != 0, 1, 2).astype(np.int8)
    rev = ((flag & FREVERSE) != 0).astype(np.int8)

    keys = [rev, rn, mpos, mrid]
    keys += [bcm[:, j] for j in range(wb - 1, -1, -1)]
    keys += [pos, rid]
    order = np.lexsort(keys)

    def srt(a):
        return a[order]

    kb = bcm[order]
    same = np.ones(n, dtype=bool)
    if n > 1:
        same[1:] = (
            (kb[1:] == kb[:-1]).all(axis=1)
            & (srt(rid)[1:] == srt(rid)[:-1])
            & (srt(pos)[1:] == srt(pos)[:-1])
            & (srt(mrid)[1:] == srt(mrid)[:-1])
            & (srt(mpos)[1:] == srt(mpos)[:-1])
            & (srt(rn)[1:] == srt(rn)[:-1])
            & (srt(rev)[1:] == srt(rev)[:-1])
        )
    fam_start = np.nonzero(~same)[0]
    fam_off = np.concatenate([[0], fam_start, [n]]) if n else np.zeros(1, np.int64)
    sizes = np.diff(fam_off)
    n_fam = len(sizes)
    fam_ids = np.repeat(np.arange(n_fam), sizes)

    mem_len_s = srt(mlen)
    target = _modal_lengths(fam_ids, mem_len_s, n_fam)
    mapq_max = np.maximum.reduceat(srt(mapq), fam_off[:-1]) if n else srt(mapq)

    first = order[fam_off[:-1]]
    cig_words, cig_nwords, cig_src_off = _modal_cigars(
        sources, srt(srci), srt(gidx), fam_off, mem_len_s, target, n_fam
    )

    # emission order (rid, pos, str(tag)) — the object path's global order —
    # via the vectorized tag-string builder; no per-family Python
    ref_names, pool = _header_name_pool(header)
    frid, fpos = rid[first], pos[first]
    fmrid, fmpos = mrid[first], mpos[first]
    frn = rn[first].astype(np.int64)
    frev = rev[first].astype(bool)
    fbcm, fbclen = bcm[first], bclen[first].astype(np.int64)
    tag_data, tag_off = qnames_mod.tag_strings_columnar(
        fbcm, fbclen, frid, fpos, fmrid, fmpos, frn, frev, pool
    )
    perm_arr = qnames_mod.lexsort_strings(tag_data, tag_off, leaders=[frid, fpos])

    blk = FamilyBlock()
    blk._tags_cache = None
    blk.ref_names = ref_names
    blk.sizes = sizes[perm_arr]
    blk.target_len = target[perm_arr]
    blk.tmpl_flag = flag[first][perm_arr]
    blk.tmpl_rid = frid[perm_arr]
    blk.tmpl_pos = fpos[perm_arr]
    blk.tmpl_mrid = fmrid[perm_arr]
    blk.tmpl_mpos = fmpos[perm_arr]
    blk.tmpl_tlen = tlen[first][perm_arr]
    blk.mapq_max = mapq_max[perm_arr]
    blk.bcm = fbcm[perm_arr]
    blk.bclen = fbclen[perm_arr]
    blk.qname_data, blk.qname_off = qnames_mod.sscs_qnames_columnar(
        blk.bcm, blk.bclen, blk.tmpl_rid, blk.tmpl_pos, blk.tmpl_mrid,
        blk.tmpl_mpos, frn[perm_arr], frev[perm_arr], pool,
    )
    cig_lens = cig_nwords[perm_arr]
    blk.cigar_off = np.zeros(n_fam + 1, dtype=np.int64)
    np.cumsum(cig_lens, out=blk.cigar_off[1:])
    blk.cigar_data, _ = gather_runs(cig_words, cig_src_off[perm_arr], cig_lens)
    blk.src_chunk = srci[first][perm_arr]
    blk.src_row = gidx[first][perm_arr]
    blk.batches = [s.batch for s in sources]
    blk.data_chunks = [(s.codes_data, s.qual_data) for s in sources]
    # permute member geometry to emission order without per-family slicing:
    # rank families by perm, stable-argsort members by their family's rank
    fam_rank = np.empty(n_fam, dtype=np.int64)
    fam_rank[perm_arr] = np.arange(n_fam)
    msel = np.argsort(fam_rank[fam_ids], kind="stable")
    final = order[msel]
    blk.mem_start = mstart[final]
    blk.mem_len = mlen[final]
    blk.mem_chunk = srci[final].astype(np.int32)  # >256 carry sources is legal
    new_off = np.zeros(n_fam + 1, dtype=np.int64)
    np.cumsum(blk.sizes, out=new_off[1:])
    blk.fam_off = new_off
    return blk


def stream_family_blocks(
    creader,
    header: BamHeader,
    bdelim: str = tags_mod.DEFAULT_BDELIM,
) -> Iterator[tuple[str, object, object]]:
    """Block producer: ``("bad", read, reason)`` / ``("block", FamilyBlock,
    None)`` events with stream_families' grouping/order/filter semantics."""
    bdelim_byte = ord(bdelim)
    carry: list[_BlockSrc] = []
    carry_key: tuple[int, int] | None = None
    for batch in creader.batches():
        reason, last, bclen = _classify_batch(batch, bdelim_byte)
        bad = np.nonzero(reason != 0)[0]
        for i in bad:
            yield "bad", batch.materialize(int(i)), _BAD_REASONS[int(reason[i])]
        good = np.nonzero(reason == 0)[0]
        if good.size == 0:
            continue
        with obs_trace.span("grouping.block"):
            rid = batch.ref_id[good]
            pos = batch.pos[good]
            ok = (rid[1:] > rid[:-1]) | ((rid[1:] == rid[:-1]) & (pos[1:] >= pos[:-1]))
            if not ok.all():
                i = int(np.argmin(ok)) + 1
                read = batch.materialize(int(good[i]))
                raise NotCoordinateSorted(
                    f"input BAM is not coordinate-sorted: {read.qname} at "
                    f"{read.ref}:{read.pos} after ref_id={int(rid[i - 1])} "
                    f"pos={int(pos[i - 1])} — run sort first"
                )
            first_key = (int(rid[0]), int(pos[0]))
            if carry_key is not None and first_key < carry_key:
                read = batch.materialize(int(good[0]))
                raise NotCoordinateSorted(
                    f"input BAM is not coordinate-sorted: {read.qname} at "
                    f"{read.ref}:{read.pos} after ref_id={carry_key[0]} "
                    f"pos={carry_key[1]} — run sort first"
                )
            # barcode matrix for good rows
            qm = batch.qname_matrix
            w = qm.shape[1]
            wb = int(bclen[good].max(initial=0))
            cols = np.arange(wb, dtype=np.int64)
            src = last[good][:, None] + 1 + cols[None, :]
            valid = cols[None, :] < bclen[good][:, None]
            bcm = np.where(valid, qm[good[:, None], np.minimum(src, w - 1)], 0).astype(np.uint8)

            # defer the trailing coordinate (it may continue in the next batch)
            tail_mask = (rid == rid[-1]) & (pos == pos[-1])
            n_tail = int(tail_mask.sum())
            body_n = good.size - n_tail
            body_src = (
                _BlockSrc(batch, good[:body_n], bcm[:body_n], bclen[good[:body_n]])
                if body_n else None
            )
            tail_src = _BlockSrc(batch, good[body_n:], bcm[body_n:], bclen[good[body_n:]])

        if body_n:
            if carry and first_key == carry_key:
                # carry's coordinate continues into this batch's body
                yield "block", _build_block(carry + [body_src], header), None
            elif carry:
                yield "block", _build_block(carry, header), None
                yield "block", _build_block([body_src], header), None
            else:
                yield "block", _build_block([body_src], header), None
            carry = [tail_src]
        else:  # whole batch is one coordinate
            if carry and first_key == carry_key:
                carry.append(tail_src)
            else:
                if carry:
                    yield "block", _build_block(carry, header), None
                carry = [tail_src]
        carry_key = (int(rid[-1]), int(pos[-1]))
    if carry:
        yield "block", _build_block(carry, header), None


# --------------------------------------------------------- duplex pair blocks
#
# Vectorized DCS pairing: the per-read tag/dict/str walk of
# consensus_windows_columnar is per read; this producer pairs whole
# batches at once.  A read's duplex partner has the mirrored barcode, the
# flipped read number, and identical coordinates/orientation — so the
# CANONICAL key (lexicographic min of barcode and its mirror, read number
# flipped accordingly; palindromic barcodes normalize the read number to 1)
# is equal for exactly a tag and its partner.  One lexsort over
# (coordinate, canonical key) groups pairs; runs dedupe by full tag (dict
# last-wins semantics) and split into pairs / unpaired singles.  Emission
# order inside a coordinate window reproduces the object path's
# sorted-by-str(tag) walk exactly (pair order by the smaller member str,
# unpaired and length-mismatch reads interleaved by the same keys).


class PairBlock:
    """Pairing results for one batch of consensus reads.

    ``pair_*``: per pair in emission order — (source, row) of the
    canonical-strand read and its partner, the canonical barcode bytes
    (``pair_bcm``/``pair_bclen``), the prebuilt ``dcs_qname`` strings
    (``qname_data``/``qname_off``), and the combined family size.
    ``unpaired``: (source, row) in emission order.  ``sources``: the
    ColumnarBatches rows refer to.
    """

    __slots__ = ("sources", "pair_canon_src", "pair_canon_row",
                 "pair_other_src", "pair_other_row", "pair_bcm",
                 "pair_bclen", "qname_data", "qname_off", "pair_xf",
                 "unpaired_src", "unpaired_row", "stats_total",
                 "stats_unpaired", "stats_pairs", "stats_mismatch")

    @property
    def n_pairs(self) -> int:
        return len(self.pair_xf)


def _mirror_bcm(bcm: np.ndarray, bclen: np.ndarray):
    """Vectorized barcode mirror: ``"A.B" -> "B.A"`` per row (rows without
    a separator mirror to themselves, like tags_mod.mirror_barcode)."""
    n, w = bcm.shape
    sep_byte = ord(tags_mod.BARCODE_SEP)
    is_sep = bcm == sep_byte
    has = is_sep.any(axis=1)
    sep = np.where(has, np.argmax(is_sep, axis=1), bclen)  # first '.'
    rlen = np.where(has, bclen - sep - 1, 0)
    # mirror_barcode parity: no separator OR an empty right half ("AB.")
    # both mirror to themselves
    mirrors_self = ~has | (rlen == 0)
    cols = np.arange(w, dtype=np.int64)
    # output col j: j < rlen -> right half; j == rlen -> '.'; else left half
    src = np.where(
        cols[None, :] < rlen[:, None],
        sep[:, None] + 1 + cols[None, :],
        cols[None, :] - rlen[:, None] - 1,
    )
    out = np.take_along_axis(bcm, np.clip(src, 0, w - 1), axis=1)
    out[cols[None, :] == rlen[:, None]] = sep_byte
    out[cols[None, :] >= bclen[:, None]] = 0
    mirrored = np.where(mirrors_self[:, None], bcm, out)
    return mirrored


def duplex_pair_blocks(creader, header: BamHeader) -> Iterator[PairBlock]:
    """Yield one :class:`PairBlock` per columnar batch of a consensus BAM
    (trailing coordinate carried, exactly like the family-block producer).

    Requires every record's tag block to lead with XT:Z + XF:i (true for
    all BAMs this pipeline writes); the caller probes the first batch and
    falls back to the object path otherwise.
    """
    carry: list[tuple] | None = []
    carry_key = None
    for batch in creader.batches():
        with obs_trace.span("grouping.block"):
            ok, bc_start, bc_len, xf = _parse_xt_xf(batch)
            if not ok.all():
                raise ForeignTagLayout("foreign tag layout (no XT/XF prefix)")
            n = batch.n
            rid, pos = batch.ref_id, batch.pos
            if n:
                sorted_ok = (rid[1:] > rid[:-1]) | ((rid[1:] == rid[:-1]) & (pos[1:] >= pos[:-1]))
                if not sorted_ok.all():
                    i = int(np.argmin(sorted_ok)) + 1
                    read = batch.materialize(i)
                    raise NotCoordinateSorted(
                        f"consensus BAM is not coordinate-sorted: {read.qname} at "
                        f"{read.ref}:{read.pos}"
                    )
            first_key = (int(rid[0]), int(pos[0])) if n else None
            if carry_key is not None and first_key is not None and first_key < carry_key:
                read = batch.materialize(0)
                raise NotCoordinateSorted(
                    f"consensus BAM is not coordinate-sorted: {read.qname} at "
                    f"{read.ref}:{read.pos} after ref_id={carry_key[0]} pos={carry_key[1]}"
                )
            # barcode matrix for the whole batch
            bcm = _barcode_matrix(batch.buf, bc_start, bc_len)

            rows = np.arange(n, dtype=np.int64)
            tail_mask = (rid == rid[-1]) & (pos == pos[-1]) if n else np.zeros(0, bool)
            n_tail = int(tail_mask.sum())
            body_n = n - n_tail
            src_new_body = (batch, rows[:body_n], bcm[:body_n], bc_len[:body_n], xf[:body_n])
            src_new_tail = (batch, rows[body_n:], bcm[body_n:], bc_len[body_n:], xf[body_n:])

        if body_n:
            if carry and first_key == carry_key:
                yield _build_pair_block(carry + [src_new_body], header)
            elif carry:
                yield _build_pair_block(carry, header)
                yield _build_pair_block([src_new_body], header)
            else:
                yield _build_pair_block([src_new_body], header)
            carry = [src_new_tail]
        else:
            if carry and first_key == carry_key:
                carry.append(src_new_tail)
            else:
                if carry:
                    yield _build_pair_block(carry, header)
                carry = [src_new_tail]
        if n:
            carry_key = (int(rid[-1]), int(pos[-1]))
    if carry:
        yield _build_pair_block(carry, header)


@_block_span
def _build_pair_block(sources: list[tuple], header: BamHeader) -> PairBlock:
    def col(fn):
        return np.concatenate([fn(s) for s in sources])

    batches = [s[0] for s in sources]
    rows_of = [s[1] for s in sources]
    rid = col(lambda s: s[0].ref_id[s[1]])
    pos = col(lambda s: s[0].pos[s[1]])
    mrid = col(lambda s: s[0].mate_ref_id[s[1]])
    mpos = col(lambda s: s[0].mate_pos[s[1]])
    flag = col(lambda s: s[0].flag[s[1]])
    lseq = col(lambda s: s[0].l_seq[s[1]])
    xf = col(lambda s: s[4])
    bclen = np.concatenate([s[3] for s in sources])
    wb = max((s[2].shape[1] for s in sources), default=0)
    n = len(rid)
    bcm = np.zeros((n, wb), dtype=np.uint8)
    r0 = 0
    for s in sources:
        bcm[r0 : r0 + len(s[1]), : s[2].shape[1]] = s[2]
        r0 += len(s[1])
    srci = np.repeat(np.arange(len(sources), dtype=np.int64),
                     [len(s[1]) for s in sources])
    grow = col(lambda s: s[1])

    rn = np.where((flag & FREAD1) != 0, 1, 2).astype(np.int8)
    rev = ((flag & FREVERSE) != 0).astype(np.int8)

    mirror = _mirror_bcm(bcm, bclen)
    a = np.ascontiguousarray(bcm).view(f"S{max(wb,1)}").ravel()
    b = np.ascontiguousarray(mirror).view(f"S{max(wb,1)}").ravel()
    bc_lt = a < b
    bc_eq = a == b
    canon_is_self = bc_lt | bc_eq
    canon_bcm = np.where(bc_lt[:, None] | bc_eq[:, None], bcm, mirror)
    canon_rn = np.where(bc_eq, 1, np.where(bc_lt, rn, 3 - rn)).astype(np.int8)

    keys = [rev, canon_rn, mpos, mrid]
    keys += [canon_bcm[:, j] for j in range(wb - 1, -1, -1)]
    keys += [pos, rid]
    order = np.lexsort(keys)

    def srt(arr):
        return arr[order]

    kb = canon_bcm[order]
    same = np.ones(n, dtype=bool)
    if n > 1:
        same[1:] = (
            (kb[1:] == kb[:-1]).all(axis=1)
            & (srt(rid)[1:] == srt(rid)[:-1])
            & (srt(pos)[1:] == srt(pos)[:-1])
            & (srt(mrid)[1:] == srt(mrid)[:-1])
            & (srt(mpos)[1:] == srt(mpos)[:-1])
            & (srt(canon_rn)[1:] == srt(canon_rn)[:-1])
            & (srt(rev)[1:] == srt(rev)[:-1])
        )
    # ---- vectorized run walk (the object semantics, no per-run Python) ----
    # run id per SORTED element; stable lexsort => within-run order is
    # stream order (srci, grow)
    run_id = np.cumsum(~same) if n else np.zeros(0, np.int64)
    n_runs = int(run_id[-1]) + 1 if n else 0
    rn_sorted = rn[order].astype(np.int64)

    # Dedupe by full tag, dict last-wins.  Within a run the full tag is
    # uniquely determined by the read number: non-palindromic barcodes put
    # rn == canon_rn on the canonical side and 3 - canon_rn on the mirror
    # side; palindromic barcodes have one bcm and rn in {1,2}.  So "last
    # stream occurrence of each (barcode, rn)" == "last sorted occurrence
    # of each (run, rn)".
    gk = run_id * 2 + (rn_sorted - 1)
    keep = np.ones(n, dtype=bool)
    if n > 1:
        s2 = np.lexsort((np.arange(n), gk))
        g = gk[s2]
        last = np.ones(n, dtype=bool)
        last[:-1] = g[1:] != g[:-1]
        keep = np.zeros(n, dtype=bool)
        keep[s2[last]] = True
    sidx = np.nonzero(keep)[0]            # sorted-domain survivor indices
    srun = run_id[sidx]                   # non-decreasing
    counts = np.bincount(srun, minlength=n_runs) if n_runs else np.zeros(0, np.int64)
    run_start = np.searchsorted(srun, np.arange(n_runs))
    stats_total = int(len(sidx))

    orig = order[sidx]                    # original-domain survivor rows
    _ref_names, pool = _header_name_pool(header)
    tag_data, tag_off = qnames_mod.tag_strings_columnar(
        bcm[orig], bclen[orig].astype(np.int64), rid[orig], pos[orig],
        mrid[orig], mpos[orig], rn[orig].astype(np.int64),
        rev[orig].astype(bool), pool,
    )
    tag_starts, tag_lens = tag_off[:-1], np.diff(tag_off)

    singles = np.nonzero(counts == 1)[0]
    doubles = np.nonzero(counts >= 2)[0]
    i_s = run_start[doubles]              # survivor slots of each candidate pair
    j_s = i_s + 1
    i_o, j_o = orig[i_s], orig[j_s]       # original-domain rows
    cmp = qnames_mod.compare_string_rows(
        tag_data, tag_starts[i_s], tag_lens[i_s], tag_starts[j_s], tag_lens[j_s]
    ) if len(doubles) else np.zeros(0, np.int8)
    i_first = cmp <= 0                    # str(tag_i) <= str(tag_j)
    mism = lseq[i_o] != lseq[j_o]

    # ---- unpaired events: single survivors (key: own str, tiebreak 0) and
    # both members of length-mismatched pairs (key: min str, tiebreak 0/1) —
    # merged and sorted by ((rid, pos), key_str, tiebreak), the walk's order
    mm = np.nonzero(mism)[0]
    first_slot = np.where(i_first[mm], i_s[mm], j_s[mm])
    second_slot = np.where(i_first[mm], j_s[mm], i_s[mm])
    up_slot = np.concatenate([run_start[singles], first_slot, second_slot])
    # sort-key string: own tag for singles, the pair's min str for both
    # mismatch members
    key_slot = np.concatenate([run_start[singles], first_slot, first_slot])
    up_k = np.concatenate([
        np.zeros(len(singles), np.int64),
        np.zeros(len(mm), np.int64),
        np.ones(len(mm), np.int64),
    ])
    up_orig = orig[up_slot]
    up_perm = qnames_mod.lexsort_string_refs(
        tag_data, tag_starts[key_slot], tag_lens[key_slot],
        leaders=[rid[up_orig], pos[up_orig]], trailers=[up_k],
    )
    up_rows = up_orig[up_perm]

    # ---- pair events: canonical member first, sorted by ((rid,pos), min str)
    ok = np.nonzero(~mism)[0]
    pi_s, pj_s = i_s[ok], j_s[ok]
    pi_o, pj_o = i_o[ok], j_o[ok]
    cs_i, cs_j = canon_is_self[pi_o], canon_is_self[pj_o]
    pick_i = np.where(cs_i & cs_j, i_first[ok], cs_i)
    canon_o = np.where(pick_i, pi_o, pj_o)
    other_o = np.where(pick_i, pj_o, pi_o)
    pkey_slot = np.where(i_first[ok], pi_s, pj_s)  # min-str member
    pair_perm = qnames_mod.lexsort_string_refs(
        tag_data, tag_starts[pkey_slot], tag_lens[pkey_slot],
        leaders=[rid[canon_o], pos[canon_o]],
    )
    canon_o, other_o = canon_o[pair_perm], other_o[pair_perm]
    pair_xf = (xf[pi_o] + xf[pj_o])[pair_perm].astype(np.int64)

    blk = PairBlock()
    blk.sources = batches
    blk.pair_canon_src = srci[canon_o]
    blk.pair_canon_row = grow[canon_o]
    blk.pair_other_src = srci[other_o]
    blk.pair_other_row = grow[other_o]
    blk.pair_xf = pair_xf
    # canonical barcode + prebuilt dcs qnames (emission order) for the
    # columnar record writer
    blk.pair_bcm = canon_bcm[canon_o]
    blk.pair_bclen = bclen[canon_o].astype(np.int64)
    blk.qname_data, blk.qname_off = qnames_mod.dcs_qnames_columnar(
        blk.pair_bcm, blk.pair_bclen, rid[canon_o], pos[canon_o],
        mrid[canon_o], mpos[canon_o], pool,
    )
    blk.unpaired_src = srci[up_rows]
    blk.unpaired_row = grow[up_rows]
    blk.stats_total = stats_total
    blk.stats_unpaired = int(len(up_rows))
    blk.stats_pairs = int(len(canon_o))
    blk.stats_mismatch = int(mism.sum())
    return blk


# ---------------------------------------------------------------------------
#
# Vectorized singleton rescue (stages/singleton_correction.py's exact-match
# path).  Mirrors the object window-walk's pinned semantics — including its
# order-dependent quirks — as array passes over canonical duplex-key runs
# spanning BOTH inputs (the singleton BAM and the SSCS BAM):
#
# Within one canonical-key run (same coords/orientation, barcode == or
# mirror-of, read number on either side) at most four distinct members can
# exist — {singleton, SSCS} x {read number 1, 2} — because a full tag is
# either a >=2 family (SSCS) or a size-1 family (singleton), never both.
# The walk processes singletons in sorted-str order per (ref, pos) window:
#   1. partner = mirrored tag in the SSCS dict, else the singleton dict
#      (not itself, not already consumed); no partner -> remaining.
#   2. unequal read lengths -> remaining (+length_mismatch), partner NOT
#      consumed.
#   3. SSCS rescue writes the corrected singleton; singleton-singleton
#      rescue writes BOTH corrected reads and consumes the partner.
# Order-dependent quirk reproduced deliberately: when the second-processed
# singleton of a mutual pair was NOT consumed (because the first took an
# SSCS partner), it can re-rescue the first against itself — double-writing
# the first read.  The emitted categories below encode exactly that table.


class RescueBlock:
    """Rescue decisions for one coordinate-complete slab of both inputs.

    ``sources``: ColumnarBatches referenced by (src, row) pairs.
    ``remaining_*``: uncorrected singletons, raw-blob passthrough order.
    ``rescue_*`` (parallel arrays, emission order): the read to correct,
    its vote partner, and the route — 0 = SSCS rescue, 1 = singleton-
    singleton.  Stats fields mirror the object walk's counters.
    """

    __slots__ = ("sources", "remaining_src", "remaining_row",
                 "rescue_src", "rescue_row", "partner_src", "partner_row",
                 "rescue_route", "partner_xf", "stats_total", "stats_sscs",
                 "stats_singleton", "stats_remaining", "stats_mismatch")


def _barcode_matrix(buf: np.ndarray, bc_start: np.ndarray, bc_len: np.ndarray) -> np.ndarray:
    """``(n, max(bc_len))`` zero-padded barcode byte matrix (clamped gather)
    — shared by the duplex-pair and rescue block builders."""
    wb = int(bc_len.max(initial=0))
    cols = np.arange(wb, dtype=np.int64)
    idx = bc_start[:, None] + cols[None, :]
    return np.where(
        cols[None, :] < bc_len[:, None],
        buf[np.minimum(idx, len(buf) - 1)], 0,
    ).astype(np.uint8)


@_block_span
def _rescue_src_prep(batch) -> tuple:
    """(rows, bcm, bclen, xf) of the XT/XF-parsed rows of a batch."""
    ok, bc_start, bc_len, xf = _parse_xt_xf(batch)
    if not ok.all():
        raise ForeignTagLayout("foreign tag layout (no XT/XF prefix)")
    n = batch.n
    bcm = _barcode_matrix(batch.buf, bc_start, bc_len)
    return np.arange(n, dtype=np.int64), bcm, bc_len.astype(np.int64), xf.astype(np.int64)


def singleton_rescue_blocks(s_creader, x_creader, header: BamHeader) -> Iterator[RescueBlock]:
    """Yield :class:`RescueBlock`s over the singleton BAM (``s``) and the
    SSCS BAM (``x``), pulling batches from both in coordinate lockstep so
    every (ref, pos) anchor is complete within one block."""
    def batches_with_meta(creader, srctype):
        prev_key = None
        for batch in creader.batches():
            rid, pos = batch.ref_id, batch.pos
            if batch.n:
                sorted_ok = (rid[1:] > rid[:-1]) | ((rid[1:] == rid[:-1]) & (pos[1:] >= pos[:-1]))
                first_key = (int(rid[0]), int(pos[0]))
                if not sorted_ok.all() or (prev_key is not None and first_key < prev_key):
                    i = int(np.argmin(sorted_ok)) + 1 if not sorted_ok.all() else 0
                    read = batch.materialize(i)
                    raise NotCoordinateSorted(
                        f"input BAM is not coordinate-sorted: {read.qname} at "
                        f"{read.ref}:{read.pos}"
                    )
                prev_key = (int(rid[-1]), int(pos[-1]))
            yield srctype, batch

    streams = [batches_with_meta(s_creader, 1), batches_with_meta(x_creader, 0)]
    heads: list = [next(st, None) for st in streams]
    # carry: list of (srctype, batch, rows, bcm, bclen, xf) with rows >= the
    # emitted boundary
    carry: list[tuple] = []

    def last_key(item):
        _t, b = item
        return (int(b.ref_id[-1]), int(b.pos[-1])) if b.n else None

    while heads[0] is not None or heads[1] is not None:
        # take every stream whose current batch is present; boundary = the
        # smallest last-key among them (keys >= boundary may continue)
        live = [h for h in heads if h is not None]
        bkeys = [k for k in (last_key(h) for h in live) if k is not None]
        boundary = min(bkeys) if bkeys else None
        pieces = list(carry)
        carry = []
        for si in (0, 1):
            h = heads[si]
            if h is None:
                continue
            srctype, batch = h
            if batch.n:
                rows, bcm, bclen, xf = _rescue_src_prep(batch)
                pieces.append((srctype, batch, rows, bcm, bclen, xf))
            heads[si] = next(streams[si], None)
        done_streams = heads[0] is None and heads[1] is None
        emit_pieces: list[tuple] = []
        with obs_trace.span("grouping.block"):
            for srctype, batch, rows, bcm, bclen, xf in pieces:
                if done_streams or boundary is None:
                    emit_pieces.append((srctype, batch, rows, bcm, bclen, xf))
                    continue
                key_ge = (batch.ref_id[rows] > boundary[0]) | (
                    (batch.ref_id[rows] == boundary[0]) & (batch.pos[rows] >= boundary[1])
                )
                cut = int(np.argmax(key_ge)) if key_ge.any() else len(rows)
                if cut:
                    emit_pieces.append((srctype, batch, rows[:cut], bcm[:cut], bclen[:cut],
                                        xf[:cut]))
                if cut < len(rows):
                    carry.append((srctype, batch, rows[cut:], bcm[cut:], bclen[cut:], xf[cut:]))
        if emit_pieces:
            yield _build_rescue_block(emit_pieces, header)
    if carry:
        yield _build_rescue_block(carry, header)


@_block_span
def _build_rescue_block(pieces: list[tuple], header: BamHeader) -> RescueBlock:
    def col(fn):
        return np.concatenate([fn(p) for p in pieces])

    batches = [p[1] for p in pieces]
    srct = np.concatenate([
        np.full(len(p[2]), p[0], dtype=np.int8) for p in pieces
    ])
    rid = col(lambda p: p[1].ref_id[p[2]])
    pos = col(lambda p: p[1].pos[p[2]])
    mrid = col(lambda p: p[1].mate_ref_id[p[2]])
    mpos = col(lambda p: p[1].mate_pos[p[2]])
    flag = col(lambda p: p[1].flag[p[2]])
    lseq = col(lambda p: p[1].l_seq[p[2]])
    xf = np.concatenate([p[5] for p in pieces])
    bclen = np.concatenate([p[4] for p in pieces])
    grow = col(lambda p: p[2])
    srci = np.repeat(np.arange(len(pieces), dtype=np.int64),
                     [len(p[2]) for p in pieces])
    wb = max((p[3].shape[1] for p in pieces), default=0)
    n = len(rid)
    bcm = np.zeros((n, wb), dtype=np.uint8)
    r0 = 0
    for p in pieces:
        bcm[r0 : r0 + len(p[2]), : p[3].shape[1]] = p[3]
        r0 += len(p[2])

    rn = np.where((flag & FREAD1) != 0, 1, 2).astype(np.int8)
    rev = ((flag & FREVERSE) != 0).astype(np.int8)
    mirror = _mirror_bcm(bcm, bclen)
    a = np.ascontiguousarray(bcm).view(f"S{max(wb, 1)}").ravel()
    b = np.ascontiguousarray(mirror).view(f"S{max(wb, 1)}").ravel()
    bc_lt, bc_eq = a < b, a == b
    canon_bcm = np.where((bc_lt | bc_eq)[:, None], bcm, mirror)
    canon_rn = np.where(bc_eq, 1, np.where(bc_lt, rn, 3 - rn)).astype(np.int8)

    keys = [rev, canon_rn, mpos, mrid]
    keys += [canon_bcm[:, j] for j in range(wb - 1, -1, -1)]
    keys += [pos, rid]
    order = np.lexsort(keys)

    def srt(arr):
        return arr[order]

    kb = canon_bcm[order]
    same = np.ones(n, dtype=bool)
    if n > 1:
        same[1:] = (
            (kb[1:] == kb[:-1]).all(axis=1)
            & (srt(rid)[1:] == srt(rid)[:-1])
            & (srt(pos)[1:] == srt(pos)[:-1])
            & (srt(mrid)[1:] == srt(mrid)[:-1])
            & (srt(mpos)[1:] == srt(mpos)[:-1])
            & (srt(canon_rn)[1:] == srt(canon_rn)[:-1])
            & (srt(rev)[1:] == srt(rev)[:-1])
        )
    run_id = np.cumsum(~same) if n else np.zeros(0, np.int64)
    n_runs = int(run_id[-1]) + 1 if n else 0

    # slot per (srctype, rn): last stream occurrence wins (window-dict
    # last-wins semantics; duplicates are impossible for pipeline outputs)
    orig = order  # sorted-domain -> original-domain
    slot = np.full((4, n_runs), -1, dtype=np.int64)
    sl_of = (srct[orig].astype(np.int64) * 2 + (rn[orig].astype(np.int64) - 1))
    slot[sl_of, run_id] = orig
    x1, x2, s1, s2 = slot[0], slot[1], slot[2], slot[3]

    # tag strings for singleton members (the walk's processing order)
    _ref_names, pool = _header_name_pool(header)
    sing_members = np.concatenate([s1[s1 >= 0], s2[s2 >= 0]])
    tag_pos = np.full(n, -1, dtype=np.int64)
    tag_pos[sing_members] = np.arange(len(sing_members))
    if len(sing_members):
        tag_data, tag_off = qnames_mod.tag_strings_columnar(
            bcm[sing_members], bclen[sing_members], rid[sing_members],
            pos[sing_members], mrid[sing_members], mpos[sing_members],
            rn[sing_members].astype(np.int64), rev[sing_members].astype(bool),
            pool,
        )
        tag_starts, tag_lens = tag_off[:-1], np.diff(tag_off)
    else:
        tag_data = np.empty(0, np.uint8)
        tag_starts = tag_lens = np.empty(0, np.int64)

    # ---- decision table over runs ----
    p_s1, p_s2 = s1 >= 0, s2 >= 0
    p_x1, p_x2 = x1 >= 0, x2 >= 0
    L = np.zeros(n + 1, dtype=np.int64)
    L[:n] = lseq
    lx1, lx2 = L[x1], L[x2]
    ls1, ls2 = L[s1], L[s2]

    # events: (order_key, read, partner, route) collected per category then
    # emission-sorted.  route: 0 sscs, 1 singleton.  remaining: (order_key,
    # read).  order keys reproduce the walk: windows ascend (rid,pos), then
    # sorted-str of the PROCESSED singleton's tag; a singleton-pair write
    # emits corrected self then corrected partner adjacently.
    rescue_read: list[np.ndarray] = []
    rescue_partner: list[np.ndarray] = []
    rescue_route: list[np.ndarray] = []
    rescue_key: list[np.ndarray] = []     # (member whose str orders the event)
    rescue_sub: list[np.ndarray] = []     # intra-event sequence (0 self, 1 partner)
    remaining: list[np.ndarray] = []
    remaining_key: list[np.ndarray] = []
    n_mismatch = 0
    n_pair_events = 0
    n_pair_c = 0  # pairs whose partner was already processed (case c)

    def cmp_str(mem_a, mem_b):
        return qnames_mod.compare_string_rows(
            tag_data,
            tag_starts[tag_pos[mem_a]], tag_lens[tag_pos[mem_a]],
            tag_starts[tag_pos[mem_b]], tag_lens[tag_pos[mem_b]],
        )

    # -- runs with exactly one singleton --
    for s_slot, x_m, l_s, l_xm, has_s, has_other_s in (
        (s1, x2, ls1, lx2, p_s1, p_s2),
        (s2, x1, ls2, lx1, p_s2, p_s1),
    ):
        only = has_s & ~has_other_s
        xm_p = only & (x_m >= 0)
        ok_len = xm_p & (l_s == l_xm)
        rescue_read.append(s_slot[ok_len])
        rescue_partner.append(x_m[ok_len])
        rescue_route.append(np.zeros(int(ok_len.sum()), np.int8))
        rescue_key.append(s_slot[ok_len])
        rescue_sub.append(np.zeros(int(ok_len.sum()), np.int8))
        mm = xm_p & (l_s != l_xm)
        n_mismatch += int(mm.sum())
        rem = only & ((~xm_p) | mm)
        remaining.append(s_slot[rem])
        remaining_key.append(s_slot[rem])

    # -- runs with both singletons --
    both = p_s1 & p_s2
    bi = np.nonzero(both)[0]
    if len(bi):
        c = cmp_str(s1[bi], s2[bi]) <= 0
        first = np.where(c, s1[bi], s2[bi])
        second = np.where(c, s2[bi], s1[bi])
        # mirror sscs of a singleton with read number r is slot x[3-r]
        fx = np.where(c, x2[bi], x1[bi])
        sx = np.where(c, x1[bi], x2[bi])
        lf, lsec = L[first], L[second]
        lfx, lsx = L[fx], L[sx]

        f_has_x = fx >= 0
        A = f_has_x & (lf == lfx)          # first sscs-rescued
        B = f_has_x & (lf != lfx)          # first mismatch-remaining
        CD = ~f_has_x
        C = CD & (lf == lsec)              # singleton pair; second consumed
        D = CD & (lf != lsec)              # first mismatch-remaining

        rescue_read.append(first[A])
        rescue_partner.append(fx[A])
        rescue_route.append(np.zeros(int(A.sum()), np.int8))
        rescue_key.append(first[A])
        rescue_sub.append(np.zeros(int(A.sum()), np.int8))
        n_mismatch += int(B.sum()) + int(D.sum())
        remaining.append(first[B | D])
        remaining_key.append(first[B | D])
        # case C: corrected(first vs second) + corrected(second vs first),
        # ordered by first's str
        for sub, rd, pt in ((0, first, second), (1, second, first)):
            rescue_read.append(rd[C])
            rescue_partner.append(pt[C])
            rescue_route.append(np.ones(int(C.sum()), np.int8))
            rescue_key.append(first[C])
            rescue_sub.append(np.full(int(C.sum()), sub, np.int8))
        n_pair_events += int(C.sum())

        # step 2: second processes unless case C consumed it
        live = ~C
        s_has_x = live & (sx >= 0)
        a_m = s_has_x & (lsec == lsx)
        rescue_read.append(second[a_m])
        rescue_partner.append(sx[a_m])
        rescue_route.append(np.zeros(int(a_m.sum()), np.int8))
        rescue_key.append(second[a_m])
        rescue_sub.append(np.zeros(int(a_m.sum()), np.int8))
        b_m = s_has_x & (lsec != lsx)
        c_m = live & (sx < 0) & (lsec == lf)   # pairs with already-processed first
        d_m = live & (sx < 0) & (lsec != lf)
        n_mismatch += int(b_m.sum()) + int(d_m.sum())
        remaining.append(second[b_m | d_m])
        remaining_key.append(second[b_m | d_m])
        for sub, rd, pt in ((0, second, first), (1, first, second)):
            rescue_read.append(rd[c_m])
            rescue_partner.append(pt[c_m])
            rescue_route.append(np.ones(int(c_m.sum()), np.int8))
            rescue_key.append(second[c_m])
            rescue_sub.append(np.full(int(c_m.sum()), sub, np.int8))
        n_pair_events += int(c_m.sum())
        n_pair_c += int(c_m.sum())

    def emission_order(keys_members, subs=None):
        """Sort events by (rid, pos, str(key member), sub)."""
        if len(keys_members) == 0:
            return np.empty(0, np.int64)
        trail = [subs] if subs is not None else None
        return qnames_mod.lexsort_string_refs(
            tag_data,
            tag_starts[tag_pos[keys_members]], tag_lens[tag_pos[keys_members]],
            leaders=[rid[keys_members], pos[keys_members]],
            trailers=trail,
        )

    blk = RescueBlock()
    blk.sources = batches
    if rescue_read:
        rr = np.concatenate(rescue_read)
        rp = np.concatenate(rescue_partner)
        rt = np.concatenate(rescue_route)
        rk = np.concatenate(rescue_key)
        rs = np.concatenate(rescue_sub)
        perm = emission_order(rk, rs)
        rr, rp, rt = rr[perm], rp[perm], rt[perm]
    else:
        rr = rp = np.empty(0, np.int64)
        rt = np.empty(0, np.int8)
    blk.rescue_src = srci[rr] if len(rr) else np.empty(0, np.int64)
    blk.rescue_row = grow[rr] if len(rr) else np.empty(0, np.int64)
    blk.partner_src = srci[rp] if len(rp) else np.empty(0, np.int64)
    blk.partner_row = grow[rp] if len(rp) else np.empty(0, np.int64)
    blk.rescue_route = rt
    # the XR tag derives from the PARTNER's family size (object rule:
    # XF > 1 -> "sscs"), not from the route
    blk.partner_xf = xf[rp] if len(rp) else np.empty(0, np.int64)
    if remaining:
        rm = np.concatenate(remaining)
        rmk = np.concatenate(remaining_key)
        perm = emission_order(rmk)
        rm = rm[perm]
    else:
        rm = np.empty(0, np.int64)
    blk.remaining_src = srci[rm] if len(rm) else np.empty(0, np.int64)
    blk.remaining_row = grow[rm] if len(rm) else np.empty(0, np.int64)
    n_singles = int(len(sing_members))
    blk.stats_total = n_singles + n_pair_c
    blk.stats_sscs = int((rt == 0).sum())
    blk.stats_singleton = int((rt == 1).sum())
    blk.stats_remaining = int(len(rm))
    blk.stats_mismatch = n_mismatch
    return blk
