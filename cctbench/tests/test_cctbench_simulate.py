"""The input generator and the BAM codec of the benchmark."""

import numpy as np
import pytest

from cctbench import bamio, simulate
from cctbench.tests.helpers import config


@pytest.mark.parametrize("name", ["cfdna-panel", "cfdna-ultradeep"])
def test_same_seed_same_reads_other_seed_other_reads(name):
    sim = config(name, 60)["simulation"]
    big = 2**31 + 12345
    a, b = simulate.make_reads(sim, big), simulate.make_reads(sim, big)
    assert a.encode() == b.encode()
    assert simulate.make_reads(sim, big + 1).encode() != a.encode()


def test_reads_follow_the_configuration():
    sim = config("cfdna-ultradeep", 80)["simulation"]
    reads = simulate.make_reads(sim, 7)
    assert reads.codes.shape[1] == sim["read_len"]
    assert (np.diff(reads.pos) >= 0).all()
    assert reads.quals.min() >= sim["qual_lo"] and reads.quals.max() <= sim["qual_hi"]
    # strand families of 50 + Poisson(10) read pairs: 2 reads a member
    assert reads.n >= 2 * 80 * 50


def test_bam_round_trip(tmp_path):
    reads = simulate.make_reads(config("cfdna-panel", 50)["simulation"], 3)
    path = str(tmp_path / "x.bam")
    reads.write(path)
    recs = bamio.read_bam(path)
    codes, quals = recs.codes_quals(reads.codes.shape[1])
    assert recs.n == reads.n
    assert np.array_equal(codes, reads.codes) and np.array_equal(quals, reads.quals)
    assert np.array_equal(recs.pos, reads.pos) and np.array_equal(recs.flag, reads.flag)
    assert recs.qnames()[0] == reads.qnames[0].tobytes()
    assert set(recs.cigars()) == {np.uint32(100 << 4).tobytes()}


def test_bgzf_rejects_a_corrupt_block():
    data = bytearray(bamio.bgzf_compress(b"x" * 100_000))
    data[30] ^= 0xFF
    with pytest.raises(Exception):
        bamio.bgzf_decompress(bytes(data))


def test_input_cache_writes_a_seed_once_and_reads_it_back(tmp_path, monkeypatch):
    from cctbench import run
    from cctbench.drivers import command

    monkeypatch.setattr(run, "CACHE_DIR", str(tmp_path))
    cfg = config("cfdna-panel", 40)
    cell = command.Cell(cfg, {"warm_fraction": 0.5}, 2**31 + 99, str(tmp_path), "cpu", False)
    path = cell.cached_input(cfg["simulation"], 2**31 + 99, "input.bam")
    stamp = __import__("os").stat(path).st_mtime_ns
    assert cell.cached_input(cfg["simulation"], 2**31 + 99, "input.bam") == path
    assert __import__("os").stat(path).st_mtime_ns == stamp
    fresh = str(tmp_path / "fresh.bam")
    simulate.make_reads(cfg["simulation"], 2**31 + 99).write(fresh)
    assert open(path, "rb").read() == open(fresh, "rb").read()
    # another seed, or another simulation block, is another file
    assert cell.cached_input(cfg["simulation"], 2**31 + 98, "input.bam") != path
    other = dict(cfg["simulation"], n_fragments=41)
    assert cell.cached_input(other, 2**31 + 99, "input.bam") != path


@pytest.mark.parametrize("name", ["cfdna-panel", "cfdna-ultradeep"])
def test_every_seed_makes_the_same_work(name):
    """Seeds deal one set of family sizes, starts and spans out in another
    order: the same reads and families of the same sizes, elsewhere."""

    def shape(reads):
        family = reads.qnames[:, 4:15]  # fragment digits, ':', strand letter
        _keys, sizes = np.unique(family, axis=0, return_counts=True)
        fwd = reads.tlen > 0
        frag = reads.qnames[fwd, 4:13]
        _f, first = np.unique(frag, axis=0, return_index=True)
        return (reads.n, sorted(sizes), sorted(np.unique(reads.pos[fwd])),
                sorted(reads.tlen[fwd][first]))

    sim = config(name, 300)["simulation"]
    a, b = simulate.make_reads(sim, 2**31 + 5), simulate.make_reads(sim, 17)
    assert shape(a) == shape(b)
    assert not np.array_equal(a.pos, b.pos) or not np.array_equal(a.codes, b.codes)
