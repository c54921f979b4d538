"""The object paths' host helpers in the port, against the JAX package's.

- ``core/tags.py``: ``split_barcode``, ``mirror_barcode``,
  ``barcode_from_qname``, ``flip_orientation``, ``unique_tag``,
  ``mate_tag``, ``duplex_tag``, ``sscs_qname``, ``dcs_qname`` on seeded
  tags and reads;
- ``io/bam.BamRead``'s flag properties on every flag value, and
  ``utils/phred``'s ``decode_seq``/``complement_codes``;
- ``core/duplex_cpu.duplex_consensus`` on seeded strands;
- ``grouping.classify_bad`` per read against the column-wise
  classification and the JAX one, on the adversarial BAM;
- ``sscs_maker.emit_consensus`` (column-wise) against the object form,
  ``core.consensus_read.build_consensus_read`` + ``io.bam.encode_record``,
  and the JAX ``emit_consensus``, on the adversarial BAM's families (mixed
  lengths and cigars).
"""

import os

import numpy as np
import pytest

from consensuscruncher_tpu.core import duplex_cpu as jax_duplex
from consensuscruncher_tpu.core import tags as jax_tags
from consensuscruncher_tpu.io import bam as jax_bam
from consensuscruncher_tpu.io import encode as jax_encode
from consensuscruncher_tpu.stages import grouping as jax_grouping
from consensuscruncher_tpu.stages import sscs_maker as jax_sscs
from consensuscruncher_tpu.utils import phred as jax_phred
from consensuscruncher_tpu_torch.core import tags
from consensuscruncher_tpu_torch.core.consensus_read import build_consensus_read
from consensuscruncher_tpu_torch.core.duplex_cpu import duplex_consensus
from consensuscruncher_tpu_torch.io.bam import BamRead, BamReader, encode_record
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.io.encode import ConsensusRecordWriter
from consensuscruncher_tpu_torch.parallel.batching import rectangularize
from consensuscruncher_tpu_torch.stages import grouping
from consensuscruncher_tpu_torch.stages.sscs_maker import _member_arrays, emit_consensus
from consensuscruncher_tpu_torch.utils import phred

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADVERSARIAL = os.path.join(REPO, "test", "data", "sample_adversarial.bam")
FLAGS = [0, 1, 3, 16, 35, 67, 83, 99, 131, 147, 163, 256, 512, 1024, 2048, 4095]


def _fields(tag):
    return (tag.barcode, tag.ref, tag.pos, tag.mate_ref, tag.mate_pos, tag.read_number,
            tag.orientation)


def _seeded_tags(seed, n=200):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        halves = ["".join(rng.choice(list("ACGTN"), int(rng.integers(0, 5)))) for _ in range(2)]
        barcode = halves[0] + ("." + halves[1] if rng.random() < 0.9 else "")
        out.append(dict(barcode=barcode, ref=str(rng.choice(["chr1", "chr2"])),
                        pos=int(rng.integers(0, 50)), mate_ref=str(rng.choice(["chr1", "chr2"])),
                        mate_pos=int(rng.integers(0, 50)), read_number=int(rng.integers(1, 3)),
                        orientation=str(rng.choice(["fwd", "rev"]))))
    return out


def test_tag_model_equals_jax():
    for kw in _seeded_tags(5):
        got, want = tags.FamilyTag(**kw), jax_tags.FamilyTag(**kw)
        assert str(got) == str(want)
        for fn in ("mate_tag", "duplex_tag"):
            assert _fields(getattr(tags, fn)(got)) == _fields(getattr(jax_tags, fn)(want)), fn
        for fn in ("sscs_qname", "dcs_qname"):
            assert getattr(tags, fn)(got) == getattr(jax_tags, fn)(want), fn
        for fn in ("split_barcode", "mirror_barcode"):
            assert getattr(tags, fn)(kw["barcode"]) == getattr(jax_tags, fn)(kw["barcode"])
        if all(tags.split_barcode(kw["barcode"])):  # both halves: an involution
            assert tags.duplex_tag(tags.duplex_tag(got)) == got
    assert [tags.flip_orientation(o) for o in ("fwd", "rev")] == ["rev", "fwd"]
    assert tags.barcode_from_qname("M1:1:2|AAC.GGT") == jax_tags.barcode_from_qname(
        "M1:1:2|AAC.GGT") == "AAC.GGT"
    for bad in ("M1:1:2", "M1:1:2|"):
        with pytest.raises(ValueError, match="no barcode"):
            tags.barcode_from_qname(bad)


@pytest.mark.parametrize("flag", FLAGS)
def test_read_flags_and_unique_tag_equal_jax(flag):
    kw = dict(qname="q|AC.GT", flag=flag, ref="chr1", pos=7, mate_ref="chr2", mate_pos=9,
              seq="ACGTN")
    got, want = BamRead(**kw), jax_bam.BamRead(**kw)
    for prop in ("is_paired", "is_unmapped", "mate_is_unmapped", "is_reverse",
                 "mate_is_reverse", "is_read1", "is_read2", "is_secondary",
                 "is_supplementary", "is_qcfail", "is_duplicate", "seq_len"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert _fields(tags.unique_tag(got, "AC.GT")) == _fields(
        jax_tags.unique_tag(want, "AC.GT"))


def test_phred_and_duplex_helpers_equal_jax():
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 6, 300).astype(np.uint8)
    assert phred.decode_seq(codes) == jax_phred.decode_seq(codes)
    assert np.array_equal(phred.complement_codes(codes), jax_phred.complement_codes(codes))
    for _ in range(20):
        s1, s2 = (rng.integers(0, 5, 50).astype(np.uint8) for _ in range(2))
        s2 = np.where(rng.random(50) < 0.6, s1, s2).astype(np.uint8)
        q1, q2 = (rng.integers(0, 45, 50).astype(np.uint8) for _ in range(2))
        got = duplex_consensus(s1, q1, s2, q2, qual_cap=60)
        want = jax_duplex.duplex_consensus(s1, q1, s2, q2, qual_cap=60)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="above N"):
        duplex_consensus(codes[:5], codes[:5], np.full(5, 5, np.uint8), codes[:5])


def test_classify_bad_equals_columns_and_jax():
    with ColumnarReader(ADVERSARIAL) as reader:
        want_codes = np.concatenate([grouping._classify_batch(b, ord("|"))[0]
                                     for b in reader.batches()])
    with BamReader(ADVERSARIAL) as reader:
        reads = list(reader)
    with jax_bam.BamReader(ADVERSARIAL) as reader:
        jax_reads = list(reader)
    got = [grouping.classify_bad(r, "|") for r in reads]
    assert got == [jax_grouping.classify_bad(r, "|") for r in jax_reads]
    assert got == [grouping._BAD_REASONS[int(c)] for c in want_codes]
    assert any(g is not None for g in got) and any(g is None for g in got)


class _Blobs:
    def __init__(self):
        self.blobs = []

    def write_encoded(self, blob):
        self.blobs.append(bytes(blob))


@pytest.mark.parametrize("bam", ["sample_adversarial.bam", "sample.bam"])
def test_emit_consensus_equals_object_form_and_jax(bam):
    """One record per family of size >= 2, from the first member's
    rectangularized row as its 'consensus'."""
    from consensuscruncher_tpu.io.columnar import ColumnarReader as JaxColumnarReader

    path = os.path.join(REPO, "test", "data", bam)
    got, want, jax_got = _Blobs(), [], _Blobs()
    rec = ConsensusRecordWriter(got)
    jax_rec = jax_encode.ConsensusRecordWriter(jax_got)
    with ColumnarReader(path) as reader:
        header = reader.header
        with JaxColumnarReader(path) as jax_reader:
            events = grouping.stream_families_columnar(reader, header)
            jax_events = jax_grouping.stream_families_columnar(jax_reader, jax_reader.header)
            for (kind, tag, members), (_k, jtag, jmembers) in zip(events, jax_events):
                if kind != "family" or len(members) < 2:
                    continue
                seqs, quals = _member_arrays(members)
                codes, cquals, _len = rectangularize(seqs, quals)
                emit_consensus(rec, tag, members, codes[0], cquals[0])
                jax_sscs.emit_consensus(jax_rec, None, jtag, jmembers, codes[0], cquals[0])
                read = build_consensus_read(tag, members, codes[0], cquals[0],
                                            qname=tags.sscs_qname(tag),
                                            extra_tags={"XT": ("Z", tag.barcode)})
                want.append(encode_record(read, header))
    rec.flush()
    jax_rec.flush()
    assert len(want) > 20
    assert b"".join(got.blobs) == b"".join(want) == b"".join(jax_got.blobs)
