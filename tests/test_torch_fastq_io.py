"""The port's FASTQ, FASTA and SAM codecs against the JAX package's.

Each case feeds the same bytes (made from a seed with numpy) through
``consensuscruncher_tpu.io.{fastq,fasta,sam}`` and their copies in
``consensuscruncher_tpu_torch.io``, and wants equal records, equal bytes
written (BGZF included: the tag FASTQs of ``fastq2bam`` are compared as
files) and equal errors on malformed input: CRLF line ends, no final
newline, a short quality line, a bad header or separator, a record cut
short; the batch reader over many small chunks.
"""

import gzip
import io

import numpy as np
import pytest

from consensuscruncher_tpu.io import bam as jax_bam
from consensuscruncher_tpu.io import fasta as jax_fasta
from consensuscruncher_tpu.io import fastq as jax_fastq
from consensuscruncher_tpu.io import sam as jax_sam
from consensuscruncher_tpu_torch.io import bam as port_bam
from consensuscruncher_tpu_torch.io import fasta as port_fasta
from consensuscruncher_tpu_torch.io import fastq as port_fastq
from consensuscruncher_tpu_torch.io import sam as port_sam
from consensuscruncher_tpu_torch.utils import phred

SAM_TEXT = """\
@HD\tVN:1.6\tSO:unsorted
@SQ\tSN:chr1\tLN:1000000
@SQ\tSN:chr2\tLN:500000
r1|AAA.CCC\t99\tchr1\t101\t60\t10M\t=\t301\t210\tACGTACGTAC\tIIIIIIIIII\tNM:i:0\tMD:Z:10
r2\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*
r3\t147\tchr2\t7\t37\t3S5M1I1M\tchr1\t50\t-9\tACGTAcGTAC\t+5?IIIII#!\tXA:A:c\tXF:f:0.5\tXB:B:s,1,-2\tXH:H:1AE3
"""


def _fields(read) -> dict:
    out = dict(vars(read))
    out["qual"] = np.asarray(read.qual).tolist()
    return out


def test_phred_text_helpers_match_jax():
    from consensuscruncher_tpu.utils import phred as jax_phred

    rng = np.random.default_rng(0)
    quals = rng.integers(0, 94, 200).astype(np.uint8)
    text = jax_phred.array_to_qual_string(quals)
    assert phred.array_to_qual_string(quals) == text
    for form in (text, text.encode()):
        assert np.array_equal(phred.qual_string_to_array(form),
                              jax_phred.qual_string_to_array(form))
    assert np.array_equal(phred.quals_to_array(quals.tolist()),
                          jax_phred.quals_to_array(quals.tolist()))


def test_sam_records_and_format_match_jax():
    jh, jrecs = jax_sam.read_sam(io.StringIO(SAM_TEXT))
    ph, precs = port_sam.read_sam(io.StringIO(SAM_TEXT))
    assert (ph.text, ph.refs) == (jh.text, jh.refs)
    jrecs, precs = list(jrecs), list(precs)
    assert [_fields(r) for r in precs] == [_fields(r) for r in jrecs]
    lines = [port_sam.format_record(r) for r in precs]
    assert lines == [jax_sam.format_record(r) for r in jrecs]
    assert [_fields(port_sam.parse_record(ln)) for ln in lines] == [_fields(r) for r in precs]


def test_sam_to_bam_bytes_match_jax(tmp_path):
    paths = {}
    for tag, sam_mod, bam_mod in (("jax", jax_sam, jax_bam), ("port", port_sam, port_bam)):
        header, records = sam_mod.read_sam(io.StringIO(SAM_TEXT))
        paths[tag] = tmp_path / f"{tag}.bam"
        with bam_mod.BamWriter(str(paths[tag]), header) as w:
            for r in records:
                w.write(r)
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    with port_bam.BamReader(str(paths["port"])) as rd:
        back = [port_sam.format_record(r) for r in rd]
    assert back[:2] == [ln for ln in SAM_TEXT.splitlines() if not ln.startswith("@")][:2]


def _random_records(rng, n, read_len=30):
    bases = np.frombuffer(b"ACGTN", np.uint8)
    recs = []
    for i in range(n):
        length = int(rng.integers(1, read_len + 1))
        seq = bases[rng.integers(0, 5, length)].tobytes().decode()
        qual = (33 + rng.integers(0, 42, length)).astype(np.uint8).tobytes().decode()
        name = f"inst:1:{i}:xy" + (" 1:N:0:GAT" if i % 3 == 0 else "")
        recs.append((name, seq, qual))
    return recs


@pytest.mark.parametrize("suffix,level", [(".fastq.gz", 6), (".fastq.gz", 0),
                                          (".fastq.gz", 9), (".fastq", 6)])
def test_fastq_writer_bytes_and_reader_match_jax(tmp_path, suffix, level):
    recs = _random_records(np.random.default_rng(level), 300)
    blob = b"".join(f"@{n}\n{s}\n+\n{q}\n".encode() for n, s, q in recs[150:])
    out = {}
    for tag, mod in (("jax", jax_fastq), ("port", port_fastq)):
        path = tmp_path / f"{tag}{suffix}"
        with mod.FastqWriter(str(path), level=level) as w:
            for rec in recs[:150]:
                w.write(*rec)
            w.write_bytes(blob)
        out[tag] = path.read_bytes()
    assert out["port"] == out["jax"]
    path = str(tmp_path / f"port{suffix}")
    assert list(port_fastq.read_fastq(path)) == list(jax_fastq.read_fastq(path)) == recs
    with pytest.raises(ValueError, match="FastqWriter"):
        port_fastq._open_text(path, "w")


def _batches(mod, path, chunk_bytes):
    cols = ("name_start", "name_len", "seq_start", "seq_len", "qual_start")
    out = []
    for b in mod.read_fastq_batches(path, chunk_bytes=chunk_bytes):
        out.append((b.n, b.data.tobytes(), [getattr(b, c).tolist() for c in cols]))
    return out


@pytest.mark.parametrize("chunk_bytes", [1024, 7, 32 << 20])
def test_batch_reader_matches_jax(tmp_path, chunk_bytes):
    recs = _random_records(np.random.default_rng(5), 200)
    path = str(tmp_path / "x.fq.gz")
    with gzip.GzipFile(path, "wb", mtime=0) as fh:
        for name, seq, qual in recs:
            fh.write(f"@{name}\n{seq}\n+\n{qual}\n".encode())
    got = _batches(port_fastq, path, chunk_bytes)
    assert got == _batches(jax_fastq, path, chunk_bytes)
    flat = []
    for n, data, (ns, nl, ss, sl, qs) in got:
        for i in range(n):
            flat.append((data[ns[i]:ns[i] + nl[i]].decode(), data[ss[i]:ss[i] + sl[i]].decode(),
                         data[qs[i]:qs[i] + sl[i]].decode()))
    assert flat == recs


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as exc:
        return ("ValueError", str(exc))


# text -> what the object reader and the batch reader both do with it
FASTQ_CASES = {
    "crlf": b"@a comment\r\nACGT\r\n+\r\nIIII\r\n@b\r\nAC\r\n+x\r\nII\r\n",
    "no_trailing_newline": b"@a\nACGT\n+\nIIII",
    "empty": b"",
    "short_qual": b"@a\nACGT\n+\nIII\n",
    "bad_header": b"@a\nACGT\n+\nIIII\nb\nAC\n+\nII\n",
    "bad_separator": b"@a\nACGT\n-\nIIII\n",
    "truncated": b"@a\nACGT\n+\nIIII\n@b\nAC\n",
    "empty_seq": b"@a\n\n+\n\n",
}


@pytest.mark.parametrize("case", sorted(FASTQ_CASES))
def test_fastq_edge_input_matches_jax(tmp_path, case):
    path = tmp_path / f"{case}.fq"
    path.write_bytes(FASTQ_CASES[case])
    p = str(path)
    for reader in ("read_fastq", "read_fastq_batches"):
        def run(mod):
            fn = getattr(mod, reader)
            items = list(fn(p))
            if reader == "read_fastq":
                return items
            return [(b.n, b.seq_len.tolist(), b.name_len.tolist()) for b in items]

        assert _outcome(lambda: run(port_fastq)) == _outcome(lambda: run(jax_fastq)), reader
    if case == "crlf":
        assert list(port_fastq.read_fastq(p)) == [("a comment", "ACGT", "IIII"), ("b", "AC", "II")]


FASTA_TEXT = ">chr1 first\nACGTac\ngtNN\n\n>chr2\nTTTT\n"


@pytest.mark.parametrize("gz", [False, True])
def test_fasta_matches_jax(tmp_path, gz):
    path = tmp_path / ("r.fa.gz" if gz else "r.fa")
    if gz:
        with gzip.open(path, "wt") as fh:
            fh.write(FASTA_TEXT)
    else:
        path.write_text(FASTA_TEXT)
    assert list(port_fasta.iter_fasta(path)) == list(jax_fasta.iter_fasta(path))
    assert port_fasta.read_fasta(path) == jax_fasta.read_fasta(path) == {
        "chr1": "ACGTACGTNN", "chr2": "TTTT"}
    rng = np.random.default_rng(3)
    recs = {f"c{i}": np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes().decode()
            for i, n in enumerate((1, 70, 141))}
    for width in (70, 13):
        port_fasta.write_fasta(tmp_path / "p.fa", recs, width=width)
        jax_fasta.write_fasta(tmp_path / "j.fa", recs, width=width)
        assert (tmp_path / "p.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()
        assert port_fasta.read_fasta(tmp_path / "p.fa") == recs


@pytest.mark.parametrize("text,match", [("ACGT\n>a\nAC\n", "before first"),
                                        (">a\nAC\n>a x\nGG\n", "duplicate")])
def test_fasta_errors_match_jax(tmp_path, text, match):
    path = tmp_path / "bad.fa"
    path.write_text(text)
    assert _outcome(lambda: port_fasta.read_fasta(path)) == \
        _outcome(lambda: jax_fasta.read_fasta(path))
    with pytest.raises(ValueError, match=match):
        port_fasta.read_fasta(path)
