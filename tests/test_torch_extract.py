"""The port's ``stages/extract_barcodes`` against the JAX package's.

Every case writes one FASTQ pair (made from a seed with numpy) and runs
the port's vectorized extract, the port's object loop (``_force_object``)
and the JAX package's ``run_extract`` on it: all seven output files must be
the same bytes (the tag and bad-read FASTQs are BGZF, compared as files)
and the stats equal.  Cases: a pattern with spacers, short reads and
lower-case UMIs; a whitelist; a whitelist alone; the two mismatch raises
(qnames, record counts) and the pattern/whitelist refusals, each with
the JAX message; ``main``; and the 6 ``extract`` digests of
``test/golden.json`` on the committed FASTQ pair.
"""

import gzip
import itertools
import json
import os

import numpy as np
import pytest

from consensuscruncher_tpu.stages import extract_barcodes as jax_extract
from consensuscruncher_tpu_torch.stages import extract_barcodes as port_extract
from consensuscruncher_tpu_torch.utils.digest import text_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")
BPATTERN = "NNNNNNT"  # test/make_test_data.py's pattern for the committed pair
SUFFIXES = ("_r1.fastq.gz", "_r2.fastq.gz", "_r1_bad.fastq.gz", "_r2_bad.fastq.gz",
            ".barcode_distribution.txt", ".extract_stats.txt", ".extract_stats.json")


def _write_fq(path, recs):
    with gzip.GzipFile(path, "wb", mtime=0) as fh:
        for name, seq, qual in recs:
            fh.write(f"@{name}\n{seq}\n+\n{qual}\n".encode())


def _mkrecs(rng, n, read_len=40, umi=3, spacer="T", short_every=0, lower_every=0):
    r1, r2 = [], []
    bases = "ACGT"
    for i in range(n):
        u1 = "".join(bases[j] for j in rng.integers(0, 4, umi))
        u2 = "".join(bases[j] for j in rng.integers(0, 4, umi))
        body1 = "".join(bases[j] for j in rng.integers(0, 4, read_len))
        body2 = "".join(bases[j] for j in rng.integers(0, 4, read_len))
        if lower_every and i % lower_every == 0:
            u1 = u1.lower()
        s1, s2 = u1 + spacer + body1, u2 + spacer + body2
        if short_every and i % short_every == 0:
            s1 = s1[: umi - 1]
        q1 = "".join(chr(33 + int(x)) for x in rng.integers(2, 40, len(s1)))
        q2 = "".join(chr(33 + int(x)) for x in rng.integers(2, 40, len(s2)))
        name = f"inst:1:{i}:xy"
        tail1, tail2 = (" 1:N:0:GAT", "\t2:N:0:GAT") if i % 2 == 0 else ("", "")
        r1.append((name + tail1, s1, q1))
        r2.append((name + tail2, s2, q2))
    return r1, r2


def _files(prefix) -> dict:
    return {s: open(prefix + s, "rb").read() for s in SUFFIXES if os.path.exists(prefix + s)}


def _three_ways(tmp_path, r1recs, r2recs, **kw):
    f1, f2 = str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq.gz")
    _write_fq(f1, r1recs)
    _write_fq(f2, r2recs)
    runs = {"vec": port_extract.run_extract(f1, f2, str(tmp_path / "vec"), **kw),
            "obj": port_extract.run_extract(f1, f2, str(tmp_path / "obj"),
                                            _force_object=True, **kw),
            "jax": jax_extract.run_extract(f1, f2, str(tmp_path / "jax"), **kw)}
    want = _files(str(tmp_path / "jax"))
    assert len(want) == 7
    for tag in ("vec", "obj"):
        assert _files(str(tmp_path / tag)) == want, tag
        assert dict(runs[tag].stats._items) == dict(runs["jax"].stats._items), tag
    return runs["vec"]


def _whitelist(tmp_path, text):
    path = tmp_path / "wl.txt"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("case", ["pattern", "whitelist", "blist_only", "levels"])
def test_outputs_equal_jax(tmp_path, case):
    if case == "pattern":
        r1, r2 = _mkrecs(np.random.default_rng(0), 300, short_every=37, lower_every=23)
        rv = _three_ways(tmp_path, r1, r2, bpattern="NNNT")
        assert rv.stats.get("extracted") > 200 and rv.stats.get("too_short") > 0
    elif case == "whitelist":
        r1, r2 = _mkrecs(np.random.default_rng(1), 400, umi=2, spacer="")
        wl = _whitelist(tmp_path, "AA\nAC\nGT\nTg\n\n")
        rv = _three_ways(tmp_path, r1, r2, bpattern="NN", blist=wl)
        assert rv.stats.get("bad_barcode") > 0 and rv.stats.get("extracted") > 0
    elif case == "blist_only":
        r1, r2 = _mkrecs(np.random.default_rng(2), 150, umi=3, spacer="")
        wl = _whitelist(tmp_path, "\n".join("".join(t) for t in
                                            itertools.product("ACGT", repeat=3)))
        rv = _three_ways(tmp_path, r1, r2, blist=wl)
        assert rv.stats.get("extracted") == 150
    else:  # the tag FASTQs stored (level 0), the bad reads at their own level
        r1, r2 = _mkrecs(np.random.default_rng(3), 200, short_every=5)
        rv = _three_ways(tmp_path, r1, r2, bpattern="NNNT", level=0, bad_level=9)
        assert rv.stats.get("too_short") > 0


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("case", ["qname", "count"])
@pytest.mark.parametrize("force_object", [False, True])
def test_mismatch_raises_as_jax(tmp_path, case, force_object):
    r1 = [("a", "ACGTACGT", "IIIIIIII"), ("b", "ACGTACGT", "IIIIIIII")]
    r2 = [("a", "ACGTACGT", "IIIIIIII"), ("c", "ACGTACGT", "IIIIIIII")] if case == "qname" \
        else r1[:1]
    f1, f2 = str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq.gz")
    _write_fq(f1, r1)
    _write_fq(f2, r2)
    port = _error(lambda: port_extract.run_extract(f1, f2, str(tmp_path / "p"), bpattern="NN",
                                                   _force_object=force_object))
    jax = _error(lambda: jax_extract.run_extract(f1, f2, str(tmp_path / "j"), bpattern="NN",
                                                 _force_object=force_object))
    assert port == jax
    if case == "qname":
        assert "qname mismatch" in port


@pytest.mark.parametrize("kw,wl,match", [
    ({}, None, "need --bpattern"),
    ({"bpattern": "TTT"}, None, "no N"),
    ({"bpattern": "N1T"}, None, "invalid barcode pattern"),
    ({"bpattern": "NNT"}, "ACG\nTTT\n", "extracts 2-base UMIs"),
    ({}, "ACT\nACTG\n", "mixes lengths"),
    ({}, "\n\n", "empty barcode list"),
])
def test_refusals_match_jax(tmp_path, kw, wl, match):
    r1, r2 = _mkrecs(np.random.default_rng(4), 3)
    f1, f2 = str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq.gz")
    _write_fq(f1, r1)
    _write_fq(f2, r2)
    if wl is not None:
        kw = {**kw, "blist": _whitelist(tmp_path, wl)}
    port = _error(lambda: port_extract.run_extract(f1, f2, str(tmp_path / "p"), **kw))
    assert port == _error(lambda: jax_extract.run_extract(f1, f2, str(tmp_path / "j"), **kw))
    assert match in port


def test_pattern_and_tokens_match_jax():
    for pattern in ("NNT", "nAnN", "NNNNNNT"):
        port, jax = port_extract.BarcodePattern(pattern), jax_extract.BarcodePattern(pattern)
        assert (port.length, port.umi_positions) == (jax.length, jax.umi_positions)
        assert port.extract("ACGTACGT") == jax.extract("ACGTACGT")
    data = np.frombuffer(b"ab c\td efgh i", np.uint8)
    starts, lens = np.array([0, 5, 9]), np.array([4, 3, 4])
    for got, want in zip(port_extract.tok_matrix(data, starts, lens),
                         jax_extract.tok_matrix(data, starts, lens)):
        assert np.array_equal(got, want)
    assert port_extract.output_paths("x/p") == jax_extract.output_paths("x/p")


def test_main_matches_jax(tmp_path):
    r1, r2 = _mkrecs(np.random.default_rng(6), 120, short_every=11)
    f1, f2 = str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq.gz")
    _write_fq(f1, r1)
    _write_fq(f2, r2)
    wl = _whitelist(tmp_path, "\n".join("".join(t) for t in itertools.product("ACG", repeat=3)))
    for tag, mod in (("p", port_extract), ("j", jax_extract)):
        mod.main(["--read1", f1, "--read2", f2, "--outfile", str(tmp_path / tag),
                  "--bpattern", "NNNT", "--blist", wl, "--bdelim", "_"])
    assert _files(str(tmp_path / "p")) == _files(str(tmp_path / "j"))
    with open(tmp_path / "p.extract_stats.json") as fh:
        assert json.load(fh)["bad_barcode"] > 0
    with gzip.open(tmp_path / "p_r1.fastq.gz", "rt") as fh:
        assert "_" in fh.readline()


def test_extract_goldens(tmp_path):
    """The 6 ``extract`` digests of ``test/golden.json`` through the port's
    ``utils/digest.text_digest``, and every file the JAX run's bytes."""
    with open(os.path.join(REPO, "test", "golden.json")) as fh:
        golden = json.load(fh)["extract"]
    assert len(golden) == 6
    r1, r2 = (os.path.join(DATA, f"sample_R{i}.fastq.gz") for i in (1, 2))
    port_extract.run_extract(r1, r2, str(tmp_path / "ex"), bpattern=BPATTERN)
    jax_extract.run_extract(r1, r2, str(tmp_path / "jx"), bpattern=BPATTERN)
    for rel, want in golden.items():
        assert text_digest(str(tmp_path / rel.removeprefix("extract/"))) == want, rel
    assert _files(str(tmp_path / "ex")) == _files(str(tmp_path / "jx"))
