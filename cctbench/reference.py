"""The plain reference of both configurations: what the program should write.

Plain PyTorch and NumPy, importing nothing of the program.  It works out
again, from the reads the benchmark generated, everything the program
derives from them: the UMI families, each family's vote, the singleton
correction, the duplex pairing and every output record, byte for byte
(all but the BAM ``bin`` field), and the stats files' counts.

The semantics (ConsensusCruncher's, as the program's documentation pins
them; Wang et al., NAR 2019;47(15):e87):

- a family is the reads that share (barcode, ref, pos, mate ref, mate pos,
  read number, orientation); its duplex partner mirrors the barcode halves
  and flips the read number;
- the vote, per position over a family of ``F`` reads: a read whose qual
  is below the threshold votes N; the modal lane wins, ties to the lane
  seen first; it passes iff the lane is not N and ``count * den >= num *
  F`` with the cutoff ``num / den`` exact; a pass keeps ``min(sum of the
  agreeing quals, cap)``, anything else is ``(N, 0)``;
- the duplex vote keeps a base where both strands hold it and it is not
  N, with ``min(q1 + q2, cap)``, else ``(N, 0)``;
- a family of one is a singleton, renamed to its family's consensus qname;
  it is corrected against its partner family's consensus when that family
  has two or more reads, else against its partner singleton, else kept;
- the DCS input is the SSCSs and the corrected singletons; each pair of
  partners gives one duplex record under the canonical strand's template
  (the barcode that sorts first; on a palindromic barcode, read 1).

``vote`` selects the arithmetic: ``exact`` is the configurations' (int32
tallies, the cutoff as an exact ratio); ``qual_sum_uint8``, the control,
holds the quality sums in eight bits, the step below the int32 tallies
that the configurations state.
"""

from __future__ import annotations

import struct
from fractions import Fraction

import numpy as np
import torch

N = 4
NUM_LANES = 5
KEEP_FLAGS = 0x1 | 0x2 | 0x10 | 0x20 | 0x40 | 0x80
VOTES = ("exact", "qual_sum_uint8")


def cutoff_ratio(cutoff: float) -> tuple[int, int]:
    """The cutoff as the exact ratio a person typed (0.7 -> 7/10)."""
    frac = Fraction(cutoff).limit_denominator(1000)
    return frac.numerator, frac.denominator


def vote_dense(bases: torch.Tensor, quals: torch.Tensor, sizes: torch.Tensor,
               consensus: dict, vote: str = "exact") -> tuple[torch.Tensor, torch.Tensor]:
    """The family vote over ``(B, F, L)`` uint8 member planes, members
    ``[0, sizes[b])`` of each row live; returns ``(B, L)`` uint8 bases and
    quals (a row of size 0 votes ``(N, 0)``)."""
    if vote not in VOTES:
        raise ValueError(f"unknown vote {vote!r}")
    num, den = cutoff_ratio(float(consensus["cutoff"]))
    cap, threshold = int(consensus["qual_cap"]), int(consensus["qual_threshold"])
    f = bases.shape[1]
    dev = bases.device
    sizes = sizes.to(dev)
    live = (torch.arange(f, device=dev)[None, :] < sizes[:, None])[:, :, None]  # (B, F, 1)
    eff = torch.where((quals >= threshold) & live, bases, N)
    counts, qsums = [], []
    for lane in range(NUM_LANES):
        eq = (eff == lane) & live
        counts.append(eq.sum(1, dtype=torch.int32))
        # the agreeing quals: for lanes A-T exactly the members voting them
        # (an N lane never passes, so its sum is never read)
        agree = torch.where(eq, quals, 0)
        if vote == "qual_sum_uint8":
            qsums.append(agree.sum(1, dtype=torch.uint8).to(torch.int32))
        else:
            qsums.append(agree.sum(1, dtype=torch.int32))
    count = torch.stack(counts, -1)                                   # (B, L, 5)
    top = count.amax(-1)
    modal = count.argmax(-1)
    tied = torch.nonzero((count == top[..., None]).sum(-1) > 1)
    if len(tied):
        # a tie goes to the lane its first member voted for
        col = eff[tied[:, 0], :, tied[:, 1]]                          # (k, F)
        top_lane = count[tied[:, 0], tied[:, 1]] == top[tied[:, 0], tied[:, 1], None]
        is_top = torch.gather(top_lane, 1, col.to(torch.int64)) & live[tied[:, 0], :, 0]
        modal[tied[:, 0], tied[:, 1]] = col.gather(
            1, is_top.to(torch.uint8).argmax(1, keepdim=True))[:, 0].to(modal.dtype)
    qsum = torch.stack(qsums, -1).gather(-1, modal[..., None])[..., 0]
    size = sizes[:, None].to(torch.int64)
    passed = (modal != N) & (top.to(torch.int64) * den >= num * size) & (size > 0)
    return (torch.where(passed, modal, N).to(torch.uint8),
            torch.where(passed, qsum.clamp(max=cap), 0).to(torch.uint8))


def duplex_vote(s1, q1, s2, q2, cap: int):
    """The two-strand vote, elementwise (numpy or torch)."""
    if isinstance(s1, torch.Tensor):
        agree = (s1 == s2) & (s1 < N)
        qsum = (q1.to(torch.int32) + q2.to(torch.int32)).clamp(max=cap)
        return (torch.where(agree, s1, N).to(torch.uint8),
                torch.where(agree, qsum, 0).to(torch.uint8))
    agree = (s1 == s2) & (s1 < N)
    qsum = np.minimum(q1.astype(np.int32) + q2.astype(np.int32), cap)
    return (np.where(agree, s1, N).astype(np.uint8),
            np.where(agree, qsum, 0).astype(np.uint8))


# ------------------------------------------------------------- the mesh step

def duplex_step(bases_a, quals_a, sizes_a, bases_b, quals_b, sizes_b, consensus: dict,
                vote: str = "exact", block: int = 512, per_pair: bool = False):
    """The whole-pipeline duplex step: both strands' family votes and their
    DCS over ``(B, F, L)`` planes, with the stats ``[pairs with a strand,
    pairs with both, N bases of those pairs' DCS, their DCS qual sum]``.
    Returns ``(planes, stats)``: ``(6, B, L)`` uint8 (SSCS a, its quals,
    SSCS b, its quals, DCS, its quals) and ``(4,)`` int64, or with
    ``per_pair`` each pair's stats ``(B, 4)``, on the planes' device,
    computed ``block`` pairs at a time."""
    cap = int(consensus["qual_cap"])
    b = bases_a.shape[0]
    out = torch.empty((6, b, bases_a.shape[2]), dtype=torch.uint8, device=bases_a.device)
    sa = torch.as_tensor(np.asarray(sizes_a)).to(bases_a.device)
    sb = torch.as_tensor(np.asarray(sizes_b)).to(bases_a.device)
    for lo in range(0, b, block):
        hi = min(b, lo + block)
        va = vote_dense(bases_a[lo:hi], quals_a[lo:hi], sa[lo:hi], consensus, vote)
        vb = vote_dense(bases_b[lo:hi], quals_b[lo:hi], sb[lo:hi], consensus, vote)
        both = ((sa[lo:hi] > 0) & (sb[lo:hi] > 0))[:, None]
        db, dq = duplex_vote(va[0], va[1], vb[0], vb[1], cap)
        out[:, lo:hi] = torch.stack([va[0], va[1], vb[0], vb[1],
                                     torch.where(both, db, N), torch.where(both, dq, 0)])
    both = (sa > 0) & (sb > 0)
    stats = torch.stack([((sa > 0) | (sb > 0)).to(torch.int64), both.to(torch.int64),
                         ((out[4] == N) & both[:, None]).sum(1),
                         torch.where(both[:, None], out[5].to(torch.int64), 0).sum(1)], 1)
    return out, stats if per_pair else stats.sum(0)


# -------------------------------------------------------- the consensus command

def _tag_bytes(barcode: bytes, size: int, extra: bytes = b"") -> bytes:
    return b"XTZ" + barcode + b"\x00XFi" + struct.pack("<i", size) + extra


def _barcode_strings(left: np.ndarray, right: np.ndarray, umi: int) -> list[bytes]:
    letters = np.frombuffer(b"ACGT", np.uint8)
    shifts = 2 * np.arange(umi - 1, -1, -1)
    mat = np.concatenate([letters[(left[:, None] >> shifts) & 3],
                          np.full((len(left), 1), ord("."), np.uint8),
                          letters[(right[:, None] >> shifts) & 3]], axis=1)
    return [row.tobytes() for row in np.ascontiguousarray(mat)]


def _sscs_qnames(bcs, ref: bytes, pos, mate_pos, rn, rev) -> list[bytes]:
    """``barcode:ref:lo:ref:hi:R<n>:<ori>``, the read number and the
    orientation taken at the fragment's lower end."""
    low_self = pos <= mate_pos
    lo, hi = np.minimum(pos, mate_pos), np.maximum(pos, mate_pos)
    low_rn = np.where(low_self, rn, 3 - rn)
    low_rev = np.where(low_self, rev, ~rev)
    return [b"%s:%s:%d:%s:%d:R%d:%s" % (bc, ref, a, ref, z, r, b"rev" if v else b"fwd")
            for bc, a, z, r, v in zip(bcs, lo.tolist(), hi.tolist(), low_rn.tolist(),
                                      low_rev.tolist())]


def _dcs_qnames(bcs, ref: bytes, pos, mate_pos) -> list[bytes]:
    lo, hi = np.minimum(pos, mate_pos), np.maximum(pos, mate_pos)
    return [b"%s:%s:%d:%s:%d" % (bc, ref, a, ref, z)
            for bc, a, z in zip(bcs, lo.tolist(), hi.tolist())]


_FIXED = np.dtype([("flag", "<u2"), ("ref", "<i4"), ("pos", "<i4"), ("mapq", "u1"),
                   ("mate_ref", "<i4"), ("mate_pos", "<i4"), ("tlen", "<i4")])


def record_keys(qnames, flag, ref, pos, mapq, cigars, mate_ref, mate_pos, tlen, codes,
                quals, tags) -> list[bytes]:
    """One bytes string per record holding every field but ``bin``: the
    form in which the program's records and the reference's are compared."""
    n = len(qnames)
    fixed = np.zeros(n, _FIXED)
    for name, col in (("flag", flag), ("ref", ref), ("pos", pos), ("mapq", mapq),
                      ("mate_ref", mate_ref), ("mate_pos", mate_pos), ("tlen", tlen)):
        fixed[name] = col
    fixed_b = fixed.tobytes()
    w = _FIXED.itemsize
    body = np.ascontiguousarray(np.concatenate([codes, quals], axis=1)) if n else None
    lb = body.shape[1] if n else 0
    body_b = body.tobytes() if n else b""
    return [q + b"\x00" + fixed_b[i * w:(i + 1) * w] + c + body_b[i * lb:(i + 1) * lb] + t
            for i, (q, c, t) in enumerate(zip(qnames, cigars, tags))]


def _families(reads):
    """Group reads into families: ``(order, starts, sizes, key)`` with
    ``order`` the reads sorted by family and file order, ``key`` the
    ``(n_families, 2)`` int64 family keys."""
    rn = np.where(reads.flag & 0x40, 1, 2)
    rev = (reads.flag & 0x10) != 0
    umi = reads.umi_len
    k1 = (((reads.bc_left << (2 * umi)) | reads.bc_right) << 2) | ((rn - 1) << 1) | rev
    k2 = (reads.pos << 32) | reads.mate_pos
    order = np.lexsort((k2, k1))  # stable: file order inside a family
    s1, s2 = k1[order], k2[order]
    brk = np.ones(len(order), bool)
    brk[1:] = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
    starts = np.nonzero(brk)[0]
    sizes = np.diff(np.append(starts, len(order)))
    return order, starts, sizes, np.stack([s1[starts], s2[starts]], 1)


def _partner_keys(key: np.ndarray, umi: int) -> np.ndarray:
    """The duplex partner's key: barcode halves swapped, read number flipped."""
    k1 = key[:, 0]
    rev, rn0 = k1 & 1, (k1 >> 1) & 1
    bc = k1 >> 2
    mask = (1 << (2 * umi)) - 1
    mirror = ((bc & mask) << (2 * umi)) | (bc >> (2 * umi))
    return np.stack([(mirror << 2) | ((1 - rn0) << 1) | rev, key[:, 1]], 1)


def _lookup(keys: np.ndarray, wanted: np.ndarray) -> np.ndarray:
    """Row of ``keys`` (unique rows) equal to each row of ``wanted``, or -1."""
    _, inv = np.unique(np.concatenate([keys, wanted]), axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    where = np.full(inv.max() + 1 if len(inv) else 0, -1, np.int64)
    where[inv[:len(keys)]] = np.arange(len(keys))
    return where[inv[len(keys):]]


def _vote_families(reads, order, starts, sizes, consensus, vote, device, rows=1 << 18):
    """The vote of the families ``starts``/``sizes`` (of ``order``): the
    families of each size in dense blocks of about ``rows`` member rows."""
    nfam = len(starts)
    length = reads.codes.shape[1]
    out_b = np.empty((nfam, length), np.uint8)
    out_q = np.empty((nfam, length), np.uint8)
    codes = torch.from_numpy(reads.codes)
    quals = torch.from_numpy(reads.quals)
    for f in np.unique(sizes).tolist():
        of_size = np.nonzero(sizes == f)[0]
        for lo in range(0, len(of_size), max(1, rows // f)):
            fams = of_size[lo:lo + max(1, rows // f)]
            members = torch.from_numpy(order[starts[fams][:, None] + np.arange(f)[None, :]])
            vb, vq = vote_dense(codes[members].to(device), quals[members].to(device),
                                torch.full((len(fams),), f), consensus, vote)
            out_b[fams], out_q[fams] = vb.cpu().numpy(), vq.cpu().numpy()
    return out_b, out_q


def consensus_outputs(reads, consensus: dict, vote: str = "exact",
                      device: str = "cpu") -> dict:
    """The records (:func:`record_keys`) of every output the comparison
    reads, and the stats files' counts."""
    cap = int(consensus["qual_cap"])
    umi = reads.umi_len
    ref = reads.ref_name.encode()
    cigar = struct.pack("<I", reads.codes.shape[1] << 4)
    order, starts, sizes, key = _families(reads)
    nfam = len(starts)
    first = order[starts]                      # each family's template read
    single = sizes == 1
    multi, singles = np.nonzero(~single)[0], np.nonzero(single)[0]
    # each family's record planes: the vote, or a singleton's own read
    rec_b, rec_q = reads.codes[first].copy(), reads.quals[first].copy()
    rec_b[multi], rec_q[multi] = _vote_families(reads, order, starts[multi], sizes[multi],
                                                consensus, vote, device)
    rn = np.where(reads.flag[first] & 0x40, 1, 2)
    rev = (reads.flag[first] & 0x10) != 0
    bcs = _barcode_strings(reads.bc_left[first], reads.bc_right[first], umi)
    pos, mate_pos = reads.pos[first], reads.mate_pos[first]
    qn = _sscs_qnames(bcs, ref, pos, mate_pos, rn, rev)
    flag = np.where(single, reads.flag[first], reads.flag[first] & KEEP_FLAGS)
    mapq = np.maximum.reduceat(reads.mapq[order], starts)
    tags = [_tag_bytes(bc, int(s)) for bc, s in zip(bcs, sizes.tolist())]

    def records(rows, codes=None, quals=None, qnames=None, flags=None, row_tags=None):
        rows = np.asarray(rows, np.int64)
        n = len(rows)
        return record_keys(
            [qn[i] for i in rows.tolist()] if qnames is None else qnames,
            flag[rows] if flags is None else flags, np.zeros(n), pos[rows], mapq[rows],
            [cigar] * n, np.zeros(n), mate_pos[rows], reads.tlen[first[rows]],
            rec_b[rows] if codes is None else codes, rec_q[rows] if quals is None else quals,
            [tags[i] for i in rows.tolist()] if row_tags is None else row_tags)

    # singleton correction: against the partner family's SSCS, else the
    # partner singleton, else kept
    partner = _lookup(key, _partner_keys(key[singles], umi))
    found = partner >= 0
    by_sscs = found.copy()
    by_sscs[found] = sizes[partner[found]] >= 2
    by_single = found & ~by_sscs
    rescued, p_of = singles[found], partner[found]
    cb, cq = duplex_vote(rec_b[rescued], rec_q[rescued], rec_b[p_of], rec_q[p_of], cap)
    for i, s in zip(rescued.tolist(), by_sscs[found].tolist()):
        tags[i] += b"XRZsscs\x00" if s else b"XRZsingleton\x00"
    rec_b[rescued], rec_q[rescued] = cb, cq
    remaining = singles[~found]

    # DCS over the SSCSs and the corrected singletons
    dcs_in = np.sort(np.concatenate([multi, rescued]))
    mate = _lookup(key[dcs_in], _partner_keys(key[dcs_in], umi))
    paired = mate >= 0
    k1 = key[dcs_in, 0]
    left, right = (k1 >> 2) >> (2 * umi), (k1 >> 2) & ((1 << (2 * umi)) - 1)
    canon = paired & ((left < right) | ((left == right) & (((k1 >> 1) & 1) == 0)))
    c_rows, o_rows = dcs_in[canon], dcs_in[mate[canon]]
    db, dq = duplex_vote(rec_b[c_rows], rec_q[c_rows], rec_b[o_rows], rec_q[o_rows], cap)
    c_bcs = [bcs[i] for i in c_rows.tolist()]
    dcs = records(c_rows, db, dq, qnames=_dcs_qnames(c_bcs, ref, pos[c_rows], mate_pos[c_rows]),
                  flags=flag[c_rows] & KEEP_FLAGS,
                  row_tags=[_tag_bytes(b, int(sizes[c] + sizes[o])) for b, c, o in
                            zip(c_bcs, c_rows.tolist(), o_rows.tolist())])
    unpaired = dcs_in[~paired]

    sscs = records(multi)
    sscs_rescue = records(singles[by_sscs])
    singleton_rescue = records(singles[by_single])
    outputs = {
        "sscs": sscs,
        "sscs_rescue": sscs_rescue,
        "singleton_rescue": singleton_rescue,
        "dcs": dcs,
        "all_unique_sscs": sscs + sscs_rescue + singleton_rescue + records(remaining),
        "all_unique_dcs": dcs + records(unpaired),
    }
    stats = {
        "sscs": {"total_reads": reads.n, "families": nfam, "singletons": len(singles),
                 "sscs_written": len(multi)},
        "singleton": {"singletons_total": len(singles), "rescued_by_sscs": int(by_sscs.sum()),
                      "rescued_by_singleton": int(by_single.sum()),
                      "remaining": len(remaining)},
        "dcs": {"sscs_total": len(dcs_in), "pairs": len(c_rows), "dcs_written": len(c_rows),
                "sscs_unpaired": int((~paired).sum())},
    }
    return {"records": outputs, "stats": stats}
