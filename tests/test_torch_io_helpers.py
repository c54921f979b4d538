"""The port's host helpers of the library, against the JAX package.

- ``io.bai.IndexedBamReader.fetch`` returns the JAX reader's records over
  seeded random regions (and whole references, empty and reversed
  intervals) on ``test/data/sample.bam`` and on a simulated BAM, as
  ``tests/test_bai.py`` holds the JAX reader to a linear scan; a missing
  ``.bai`` is built on open, byte for byte the JAX package's;
- ``io.bgzf.total_isize`` and ``decompress_file``;
- ``ops.packing``'s host helpers (``can_pack``, ``unpack_host``,
  ``can_pack4``, ``sanitize_for_pack4``, ``unpack4_host``,
  ``unpack6_host``);
- ``utils.phred.revcomp_str``;
- ``ops.residency.ResidentPlanes.nbytes_resident`` after the same appends;
- ``utils.simulate.simulate_bam_adversarial``: the JAX BAM's bytes and the
  same expected-count dict at seeds 0-2, and the committed
  ``sample_adversarial.bam`` at its seed.

All byte or integer output: exact equality.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensuscruncher_tpu.io import bai as jax_bai
from consensuscruncher_tpu.io import bgzf as jax_bgzf
from consensuscruncher_tpu.ops import packing as jax_packing
from consensuscruncher_tpu.utils import phred as jax_phred
from consensuscruncher_tpu.utils import simulate as jax_simulate
from consensuscruncher_tpu_torch.io import bai, bgzf
from consensuscruncher_tpu_torch.io.bam import BamReader
from consensuscruncher_tpu_torch.ops import packing, residency
from consensuscruncher_tpu_torch.utils import phred, simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")
SAMPLE = os.path.join(DATA, "sample.bam")


def _rec(read):
    return (read.qname, read.flag, read.ref, read.pos, read.mapq, list(read.cigar),
            read.mate_ref, read.mate_pos, read.tlen, read.seq, bytes(read.qual),
            sorted(read.tags.items()))


@pytest.fixture(scope="module")
def sim_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fetch") / "sim.bam")
    simulate.simulate_bam_fast(path, simulate.SimConfig(n_fragments=3000, seed=11,
                                                        ref_len=2_000_000))
    return path


@pytest.mark.parametrize("which", ["sample", "sim"])
def test_fetch_equals_jax_over_random_regions(tmp_path, sim_bam, which):
    src = SAMPLE if which == "sample" else sim_bam
    path = str(tmp_path / "x.bam")
    shutil.copy(src, path)  # no .bai beside the copy: both readers build one
    rng = np.random.default_rng(5)
    with bai.IndexedBamReader(path) as got_r:
        with open(path + ".bai", "rb") as fh:
            port_bai = fh.read()
        os.unlink(path + ".bai")
        with jax_bai.IndexedBamReader(path) as want_r:
            with open(path + ".bai", "rb") as fh:
                assert fh.read() == port_bai
            assert got_r.header.refs == want_r.header.refs
            total = 0
            for ref, length in got_r.header.refs:
                whole = [_rec(r) for r in got_r.fetch(ref)]
                assert whole == [_rec(r) for r in want_r.fetch(ref)]
                total += len(whole)
                for _ in range(25):
                    beg = int(rng.integers(0, length))
                    end = int(min(length, beg + rng.integers(1, 30_000)))
                    got = [_rec(r) for r in got_r.fetch(ref, beg, end)]
                    assert got == [_rec(r) for r in want_r.fetch(ref, beg, end)], (beg, end)
                some = whole[len(whole) // 2] if whole else None
                if some is not None:
                    at = some[3] + 1
                    assert list(got_r.fetch(ref, at, at)) == []
                    assert list(got_r.fetch(ref, at, at - 100)) == []
    with BamReader(path) as r:
        assert total == sum(1 for _ in r) > 0


@pytest.mark.parametrize("name", ["sample.bam", "sample_adversarial.bam", "sample_bcerr.bam"])
def test_total_isize_and_decompress_file_equal_jax(name):
    path = os.path.join(DATA, name)
    data = bgzf.decompress_file(path)
    assert data == jax_bgzf.decompress_file(path)
    assert bgzf.total_isize(path) == jax_bgzf.total_isize(path) == len(data) > 0


def test_total_isize_refuses_bad_framing(tmp_path):
    bad = tmp_path / "bad.bam"
    bad.write_bytes(b"not a bgzf file at all")
    with pytest.raises(ValueError, match="bad BGZF framing"):
        bgzf.total_isize(str(bad))
    with open(SAMPLE, "rb") as fh:
        head = fh.read(100)
    (tmp_path / "cut.bam").write_bytes(head)
    with pytest.raises(bgzf.TruncatedBgzfError):
        bgzf.total_isize(str(tmp_path / "cut.bam"))
    with pytest.raises(jax_bgzf.TruncatedBgzfError):
        jax_bgzf.total_isize(str(tmp_path / "cut.bam"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packing_host_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    shape = (6, 5, 37 + seed)
    bases = rng.integers(0, 5, size=shape, dtype=np.uint8)
    quals = rng.choice(np.array([2, 12, 23, 37], np.uint8), size=shape)
    many = rng.integers(0, 41, size=shape, dtype=np.uint8)
    for q in (quals, many, many[..., :3]):
        assert packing.can_pack(q) == jax_packing.can_pack(q)
    acgt = bases & 3
    for b, q in ((acgt, quals), (bases, quals), (acgt, many)):
        assert packing.can_pack4(b, q) == jax_packing.can_pack4(b, q)

    book = packing.build_codebook(quals)
    packed = packing.pack(bases, quals, book)
    for g, w in zip(packing.unpack_host(packed, book), jax_packing.unpack_host(packed, book)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(packing.unpack_host(packed, book)[0], bases)

    book4 = packing.build_codebook4(quals)
    length = shape[-1]
    packed4 = packing.pack4(acgt, quals, book4)
    got4 = packing.unpack4_host(packed4, book4, length)
    for g, w in zip(got4, jax_packing.unpack4_host(packed4, book4, length)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got4[0], acgt)
    np.testing.assert_array_equal(got4[1], quals)

    packed6 = packing.pack6(acgt, quals, book)
    got6 = packing.unpack6_host(packed6, book, length)
    for g, w in zip(got6, jax_packing.unpack6_host(packed6, book, length)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got6[1], quals)

    sizes = rng.integers(0, shape[1] + 1, size=shape[0])
    lengths = rng.integers(1, length + 1, size=shape[0])
    for lens in (None, lengths):
        got = packing.sanitize_for_pack4(bases, quals, sizes, int(book4[0]), lens)
        want = jax_packing.sanitize_for_pack4(bases, quals, sizes, int(book4[0]), lens)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seq", ["", "ACGTN", "acgtnACGTN", "NNAAGGTTCC", "AcGt"])
def test_revcomp_str_equals_jax(seq):
    assert phred.revcomp_str(seq) == jax_phred.revcomp_str(seq)


def test_nbytes_resident_equals_jax():
    port = residency.ResidentPlanes("cpu")
    jax_store = jax_packing.resident_planes()
    rng = np.random.default_rng(3)
    assert port.nbytes_resident == jax_store.nbytes_resident == 0
    for i, (n_cap, n_real, width) in enumerate([(8, 5, 96), (16, 16, 128), (8, 1, 32)]):
        planes = rng.integers(0, 60, size=(2, n_cap, width), dtype=np.uint8)
        keys = [f"q{i}_{k}".encode() for k in range(n_real)]
        lengths = [width - 3] * n_real
        port.append(keys, lengths, torch.from_numpy(planes), n_real)
        jax_store.append(keys, lengths, jnp.asarray(planes), n_real)
        assert port.nbytes_resident == jax_store.nbytes_resident > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_bam_adversarial_equals_jax(tmp_path, seed):
    got = simulate.simulate_bam_adversarial(str(tmp_path / "p.bam"), seed=seed)
    want = jax_simulate.simulate_bam_adversarial(str(tmp_path / "j.bam"), seed=seed)
    assert got == want and got["bad_reads"] > 0 and got["good_reads"] > 0
    assert (tmp_path / "p.bam").read_bytes() == (tmp_path / "j.bam").read_bytes()
    assert (tmp_path / "p.bam.bai").read_bytes() == (tmp_path / "j.bam.bai").read_bytes()
    assert sorted(os.listdir(tmp_path)) == ["j.bam", "j.bam.bai", "p.bam", "p.bam.bai"]


def test_simulate_bam_adversarial_writes_the_committed_input(tmp_path):
    """``test/make_test_data.py`` made ``sample_adversarial.bam`` with seed
    20260731; ``golden.json`` keeps its expected counts and its canonical
    digest (the records, whatever the deflate)."""
    import json

    from consensuscruncher_tpu_torch.utils.digest import canonical_bam_digest

    got = simulate.simulate_bam_adversarial(str(tmp_path / "a.bam"), seed=20260731)
    with open(os.path.join(REPO, "test", "golden.json")) as fh:
        golden = json.load(fh)
    assert got == golden["adversarial_expect"]
    assert (canonical_bam_digest(str(tmp_path / "a.bam"))
            == golden["inputs"]["sample_adversarial.bam"])
