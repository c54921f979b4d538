"""The port's built-in aligner (``stages/align``) against the JAX package's.

Held on a seeded random genome (two refs) and on ``simulate_fastq_pairs``
output, each case through both packages:

- the k-mer index, single-read hits (exact, two substitutions, reverse
  strand, garbage) and the batched placement equal the JAX aligner's;
- ``align_pairs``' FR layout and its TLEN signs (the leftmost tie
  included) equal the JAX records, and the columnar path writes the same
  BAM bytes as the object path and as the JAX columnar path, on a mixed
  workload and over a reference N run;
- ``lookup_batch`` gives the same ``(lo, hi)`` through the native
  windowed equal-range and through its numpy fallback, the largest-key
  region included;
- the fork pool at two workers writes the serial bytes (mixed lengths,
  small chunks); a worker's genuine error aborts with no output; the
  aligner's fault sites (``align.barrier``, ``align.barrier_worker``,
  ``align.pool_worker``) degrade to the serial bytes with the JAX
  warnings;
- ``simulate_fastq_pairs`` writes the JAX package's FASTQ and FASTA bytes.
"""

import gzip
import hashlib
import os

import numpy as np
import pytest

from consensuscruncher_tpu.io import bam as jax_bam
from consensuscruncher_tpu.io import columnar as jax_columnar
from consensuscruncher_tpu.stages import align as jax_align
from consensuscruncher_tpu.utils import simulate as jax_sim
from consensuscruncher_tpu_torch.io import bam as port_bam
from consensuscruncher_tpu_torch.io import columnar as port_columnar
from consensuscruncher_tpu_torch.io import native
from consensuscruncher_tpu_torch.io.fasta import write_fasta
from consensuscruncher_tpu_torch.io.fastq import read_fastq
from consensuscruncher_tpu_torch.stages import align as port_align
from consensuscruncher_tpu_torch.utils import faults
from consensuscruncher_tpu_torch.utils import simulate as port_sim

BASES = "ACGT"


def _rand_seq(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.fixture(autouse=True)
def _fresh_faults(monkeypatch):
    # the injector is cached per (spec, ledger): reset it around each test
    monkeypatch.setattr(faults, "_cached", None)
    yield
    faults._cached = None


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    rng = np.random.default_rng(21)
    refs = {"chrA": _rand_seq(rng, 12_000), "chrB": _rand_seq(rng, 8_000)}
    path = str(tmp_path_factory.mktemp("ref") / "ref.fa")
    write_fasta(path, refs)
    return path, refs, port_align.BuiltinAligner(path), jax_align.BuiltinAligner(path)


def _write_fastq_pair(path1, path2, records):
    with gzip.open(path1, "wt") as f1, gzip.open(path2, "wt") as f2:
        for qname, s1, s2 in records:
            f1.write(f"@{qname}\n{s1}\n+\n{'I' * len(s1)}\n")
            f2.write(f"@{qname}\n{s2}\n+\n{'I' * len(s2)}\n")


def test_index_and_hits_match_jax(genome):
    path, refs, port, jax = genome
    assert port.refs == jax.refs
    for attr in ("skmers", "spos", "pref_table", "gbase", "gcodes", "lens"):
        assert np.array_equal(getattr(port._sidx, attr), getattr(jax._sidx, attr)), attr
    read = refs["chrA"][2000:2100]
    mutated = "G" if read[10] != "G" else "C"
    cases = [read, read[:10] + mutated + read[11:50] + mutated + read[51:],
             port_align.revcomp(refs["chrB"][500:600]), _rand_seq(np.random.default_rng(1), 100)]
    hits = [port.align(s) for s in cases]
    assert [h and vars(h) for h in hits] == [h and vars(h) for h in map(jax.align, cases)]
    assert (hits[0].ref, hits[0].pos, hits[0].reverse, hits[0].nm, hits[0].mapq) == \
        ("chrA", 2000, False, 0, 60)
    assert (hits[1].pos, hits[1].nm) == (2000, 2)
    assert (hits[2].ref, hits[2].pos, hits[2].reverse) == ("chrB", 500, True)
    assert hits[3] is None
    assert port_align.revcomp("ACGTN") == jax_align.revcomp("ACGTN") == "NACGT"


def test_align_batch_matches_jax(genome):
    path, refs, port, jax = genome
    rng = np.random.default_rng(8)
    rows = []
    for i in range(64):
        ref = ("chrA", "chrB")[i % 2]
        lo = int(rng.integers(0, len(refs[ref]) - 100))
        s = refs[ref][lo:lo + 100]
        if i % 3 == 0:
            s = port_align.revcomp(s)
        if i % 7 == 0:
            s = _rand_seq(rng, 100)
        rows.append(np.frombuffer(s.encode(), np.uint8))
    codes = port_align._CODE[np.stack(rows)]
    got, want = port.align_batch(codes), jax.align_batch(codes)
    assert sorted(got) == sorted(want)
    for key in got:
        assert np.array_equal(got[key], want[key]), key
    assert got["mapped"].sum() >= 50


@pytest.mark.parametrize("case", ["fr_layout", "tlen_tie"])
def test_align_pairs_matches_jax(genome, case):
    path, refs, port, jax = genome
    if case == "fr_layout":
        frag = refs["chrA"][3000:3300]
        r1, r2, want = frag[:100], port_align.revcomp(frag[-100:]), (3000, 3200, 300)
    else:
        frag = refs["chrA"][5000:5100]
        r1, r2, want = frag, port_align.revcomp(frag), (5000, 5000, 100)
    q = np.full(100, 35, np.uint8)
    pairs = [("frag|AAA.CCC", r1, q, r2, q)]
    got = list(port_align.align_pairs(port, pairs, port_bam.BamHeader.from_refs(port.refs)))
    ref = list(jax_align.align_pairs(jax, pairs, jax_bam.BamHeader.from_refs(jax.refs)))
    header = port_bam.BamHeader.from_refs(port.refs)
    assert [port_bam.encode_record(r, header) for r in got] == \
        [jax_bam.encode_record(r, jax_bam.BamHeader.from_refs(jax.refs)) for r in ref]
    a, b = got
    assert (a.pos, b.pos, a.tlen, b.tlen) == (want[0], want[1], want[2], -want[2])
    assert a.flag & 0x43 == 0x43 and not a.flag & 0x10
    assert b.flag & 0x92 == 0x92 and not b.flag & 0x20
    if case == "fr_layout":
        assert b.seq == frag[-100:]  # stored forward-strand


def _mixed_records(refs, rng, n=120):
    records = []
    for i in range(n):
        ref = ("chrA", "chrB")[int(rng.integers(0, 2))]
        L = (80, 100)[int(rng.integers(0, 2))]
        lo = int(rng.integers(0, len(refs[ref]) - 2 * L))
        s1 = list(refs[ref][lo:lo + L])
        s2 = port_align.revcomp(refs[ref][lo + L:lo + 2 * L])
        for _ in range(int(rng.integers(0, 4))):
            s1[int(rng.integers(0, L))] = BASES[int(rng.integers(0, 4))]
        s1 = "".join(s1)
        if rng.random() < 0.1:
            s1 = _rand_seq(rng, L)  # junk: an unmapped mate
        if rng.random() < 0.1:
            s1 = s1[:7] + "N" + s1[8:]
        records.append((f"q{i:04d} comment text", s1, s2))
    return records


def _object_bam(aligner, r1, r2, out):
    header = port_bam.BamHeader.from_refs(aligner.refs)

    def pairs():
        for (n1, s1, q1), (n2, s2, q2) in zip(read_fastq(r1), read_fastq(r2), strict=True):
            yield (n1.split()[0], s1, np.frombuffer(q1.encode(), np.uint8) - 33, s2,
                   np.frombuffer(q2.encode(), np.uint8) - 33)

    with port_columnar.SortingBamWriter(out, header) as w:
        for read in port_align.align_pairs(aligner, pairs(), header):
            w.write(read)


@pytest.mark.parametrize("case", ["mixed", "reference_n_run"])
def test_columnar_bytes_equal_object_path_and_jax(genome, tmp_path, case):
    if case == "mixed":
        path, refs, port, jax = genome
        records = _mixed_records(refs, np.random.default_rng(44))
    else:  # read-N over reference-N counts as a match in both paths
        rng = np.random.default_rng(55)
        seq = _rand_seq(rng, 6000)
        seq = seq[:3000] + "N" * 3 + seq[3003:]
        path = str(tmp_path / "n.fa")
        write_fasta(path, {"chrN": seq})
        port, jax = port_align.BuiltinAligner(path), jax_align.BuiltinAligner(path)
        records = []
        for i in range(30):
            lo = 2950 + int(rng.integers(0, 40))
            records.append((f"n{i:03d}", seq[lo:lo + 100],
                            port_align.revcomp(seq[lo + 120:lo + 220])))
    r1, r2 = str(tmp_path / "r1.fastq.gz"), str(tmp_path / "r2.fastq.gz")
    _write_fastq_pair(r1, r2, records)
    obj, col, ref = (str(tmp_path / f"{t}.bam") for t in ("obj", "col", "jax"))
    _object_bam(port, r1, r2, obj)
    counts = port_align.align_fastqs_columnar(port, r1, r2, col)
    assert counts == jax_align.align_fastqs_columnar(jax, r1, r2, ref)
    assert counts[0] == 2 * len(records)
    assert _sha(col) == _sha(obj) == _sha(ref)
    assert _sha(col + ".bai") == _sha(ref + ".bai")
    if case == "reference_n_run":
        with port_bam.BamReader(col) as rd:
            assert sum(1 for x in rd if not x.is_unmapped and x.flag & 0x40) == 30


@pytest.mark.parametrize("branch", ["native", "numpy"])
def test_lookup_batch_both_branches_match(monkeypatch, branch):
    """The largest-key region: keys at the top of the k-mer space converge
    on lo == hi == len(index); both branches freeze converged lanes."""
    rng = np.random.default_rng(2)
    codes = np.concatenate([rng.integers(0, 4, 5000).astype(np.uint8),
                            np.full(60, 3, np.uint8)])
    idx = port_align._SortedKmerIndex([codes], 21)
    top = (np.int64(1) << 42) - 1
    keys = np.concatenate([
        np.array([top, top - 1, int(idx.skmers[-1]), int(idx.skmers[0]), 0], np.int64),
        idx.skmers[rng.integers(0, len(idx.skmers), 2000)],
        rng.integers(0, 1 << 42, 2000, dtype=np.int64),
    ])
    if branch == "numpy":
        def unavailable(*a, **k):
            raise RuntimeError("native codec unavailable")

        monkeypatch.setattr(native, "equal_range_windowed", unavailable)
    else:
        assert native.available()
    lo, hi = idx.lookup_batch(keys)
    assert np.array_equal(lo, np.searchsorted(idx.skmers, keys))
    assert np.array_equal(hi, np.searchsorted(idx.skmers, keys, side="right"))
    jlo, jhi = jax_align._SortedKmerIndex([codes], 21).lookup_batch(keys)
    assert np.array_equal(lo, jlo) and np.array_equal(hi, jhi)


def test_equal_range_windowed_matches_jax():
    from consensuscruncher_tpu.io import native as jax_native

    rng = np.random.default_rng(4)
    arr = np.sort(rng.integers(0, 500, 3000)).astype(np.int64)
    keys = rng.integers(-5, 505, 700).astype(np.int64)
    lo0 = np.zeros(700, np.int64)
    hi0 = np.full(700, len(arr), np.int64)
    got = native.equal_range_windowed(arr, keys, lo0, hi0)
    for a, b in zip(got, jax_native.equal_range_windowed(arr, keys, lo0, hi0)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="out of bounds"):
        native.equal_range_windowed(arr, keys, lo0, hi0 + 1)


@pytest.mark.parametrize("case", ["mixed_lengths", "simulated"])
def test_pool_bytes_equal_serial_and_jax(genome, tmp_path, case):
    if case == "mixed_lengths":
        path, refs, port, jax = genome
        rng = np.random.default_rng(91)
        seq = refs["chrA"]
        records = []
        for i in range(240):
            l1, l2 = int(rng.choice([80, 100, 120])), int(rng.choice([80, 100]))
            lo = int(rng.integers(0, len(seq) - 400))
            records.append((f"m{i:03d}", seq[lo:lo + l1],
                            port_align.revcomp(seq[lo + 150:lo + 150 + l2])))
        r1, r2 = str(tmp_path / "m1.fastq.gz"), str(tmp_path / "m2.fastq.gz")
        _write_fastq_pair(r1, r2, records)
    else:
        r1, r2, path = port_sim.simulate_fastq_pairs(
            str(tmp_path / "sim"), port_sim.SimConfig(n_fragments=250, ref_len=150_000,
                                                      mean_family_size=2.0, seed=31))
        port, jax = port_align.BuiltinAligner(path), jax_align.BuiltinAligner(path)
    digests = []
    for w, chunk in ((1, 10_000), (2, 16)):
        out = str(tmp_path / f"w{w}.bam")
        n, u = port_align.align_fastqs_columnar(port, r1, r2, out, workers=w, pair_chunk=chunk)
        digests.append((n, u, _sha(out), _sha(out + ".bai")))
    ref = str(tmp_path / "jax.bam")
    n, u = jax_align.align_fastqs_columnar(jax, r1, r2, ref, workers=2, pair_chunk=16)
    assert digests[0] == digests[1] == (n, u, _sha(ref), _sha(ref + ".bai"))


def test_pool_worker_error_aborts_run(genome, tmp_path):
    path, refs, _port, _jax = genome
    rng = np.random.default_rng(17)
    seq = refs["chrA"]
    records = []
    for i in range(64):
        lo = int(rng.integers(0, len(seq) - 400))
        records.append((f"d{i:03d}", seq[lo:lo + 100],
                        port_align.revcomp(seq[lo + 150:lo + 250])))
    r1, r2 = str(tmp_path / "d1.fastq.gz"), str(tmp_path / "d2.fastq.gz")
    _write_fastq_pair(r1, r2, records)

    class BrokenAligner(port_align.BuiltinAligner):
        # inherited by the forked workers; the parent never aligns itself
        def align_batch(self, codes):
            raise RuntimeError("deliberate aligner bug")

    out = str(tmp_path / "dead.bam")
    with pytest.raises(RuntimeError, match="deliberate aligner bug"):
        port_align.align_fastqs_columnar(BrokenAligner(path), r1, r2, out,
                                         workers=2, pair_chunk=16)
    assert not os.path.exists(out)
    assert port_align._POOL_ALIGNER is None


def test_qname_mismatch_exits_as_jax(genome, tmp_path):
    path, _refs, port, jax = genome
    r1, r2 = str(tmp_path / "a.fastq.gz"), str(tmp_path / "b.fastq.gz")
    _write_fastq_pair(r1, r2, [])
    with gzip.open(r1, "wt") as f:
        f.write("@x\nACGT\n+\nIIII\n")
    with gzip.open(r2, "wt") as f:
        f.write("@y\nACGT\n+\nIIII\n")
    msgs = []
    for mod, al in ((port_align, port), (jax_align, jax)):
        with pytest.raises(SystemExit, match="qname mismatch") as info:
            mod.align_fastqs_columnar(al, r1, r2, str(tmp_path / "o.bam"))
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.fixture(scope="module")
def chaos_fixture(tmp_path_factory):
    """A reference, a paired FASTQ and the serial BAM's digest."""
    rng = np.random.default_rng(77)
    ref = _rand_seq(rng, 9_000)
    d = tmp_path_factory.mktemp("chaos_align")
    fa = str(d / "ref.fa")
    write_fasta(fa, {"chrC": ref})
    records = []
    for i in range(48):
        lo = int(rng.integers(0, len(ref) - 400))
        records.append((f"c{i:03d}", ref[lo:lo + 100], port_align.revcomp(ref[lo + 150:lo + 250])))
    r1, r2 = str(d / "c1.fastq.gz"), str(d / "c2.fastq.gz")
    _write_fastq_pair(r1, r2, records)
    golden = str(d / "golden.bam")
    jax_align.align_fastqs_columnar(jax_align.BuiltinAligner(fa), r1, r2, golden,
                                    workers=1, pair_chunk=16)
    return fa, r1, r2, _sha(golden)


@pytest.mark.parametrize("site", ["align.barrier", "align.barrier_worker", "align.pool_worker"])
def test_fault_sites_recover_to_serial_bytes(chaos_fixture, tmp_path, monkeypatch, capfd, site):
    fa, r1, r2, golden = chaos_fixture
    ledger = str(tmp_path / "ledger")
    if site == "align.barrier":
        monkeypatch.setenv("CCT_FAULTS", "align.barrier=fail")
        want = "falling back to serial alignment"
    elif site == "align.barrier_worker":
        # the real timeout: every forked worker stalls 10 s, the parent waits 1.5 s
        monkeypatch.setenv("CCT_FAULTS", "align.barrier_worker=stall@8:10")
        monkeypatch.setenv("CCT_ALIGN_BARRIER_TIMEOUT_S", "1.5")
        want = "falling back to serial alignment"
    else:  # one worker dies once (the ledger spans the forked workers)
        monkeypatch.setenv("CCT_FAULTS", "align.pool_worker=exit")
        monkeypatch.setenv("CCT_FAULTS_DIR", ledger)
        want = "align pool worker died"
    out = str(tmp_path / "o.bam")
    port_align.align_fastqs_columnar(port_align.BuiltinAligner(fa), r1, r2, out,
                                     workers=2, pair_chunk=16)
    assert want in capfd.readouterr().err
    assert _sha(out) == golden
    if site == "align.pool_worker":
        assert os.listdir(ledger) == ["align.pool_worker.0"]


@pytest.mark.parametrize("kw", [
    {"n_fragments": 300, "ref_len": 200_000, "seed": 77},
    {"n_fragments": 120, "read_len": 80, "umi_len": 4, "ref_len": 60_000, "seed": 5,
     "error_rate": 0.05, "duplex_fraction": 0.3, "mean_family_size": 5.0},
])
def test_simulate_fastq_pairs_bytes_match_jax(tmp_path, kw):
    port = port_sim.simulate_fastq_pairs(str(tmp_path / "p"), port_sim.SimConfig(**kw),
                                         chunk_members=97)
    jax = jax_sim.simulate_fastq_pairs(str(tmp_path / "j"), jax_sim.SimConfig(**kw),
                                       chunk_members=97)
    for p, j in zip(port, jax):
        assert _sha(p) == _sha(j), p
    with pytest.raises(ValueError, match="read_len too short"):
        port_sim.simulate_fastq_pairs(str(tmp_path / "x"), port_sim.SimConfig(read_len=30))


def test_single_writer_sort_budget_matches_jax(monkeypatch):
    monkeypatch.setenv("CCT_SORT_BUFFER_MAX_BYTES", "12345")
    assert port_columnar.single_writer_sort_buffer_bytes() == 12345
    monkeypatch.delenv("CCT_SORT_BUFFER_MAX_BYTES")
    assert port_columnar.single_writer_sort_buffer_bytes() >= 4 << 30
    assert abs(port_columnar.single_writer_sort_buffer_bytes()
               - jax_columnar.single_writer_sort_buffer_bytes()) < 1 << 30
