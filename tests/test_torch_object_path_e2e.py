"""The port's object paths end to end on the committed BAMs (CPU).

- ``--max_mismatch 1`` on ``sample_bcerr.bam``: the 18 digests of the
  ``consensus_mm1`` section of ``test/golden.json``, and every BAM equal
  to the JAX CLI's (``--backend xla_cpu --max_mismatch 1``) record by
  record;
- ``--wire dense`` on the three committed BAMs: their sections' digests,
  every BAM equal to the JAX CLI's ``--wire dense`` records, and
  ``qc.json`` equal to the JAX dense run's, at ``--qualscore`` 0 and (on
  ``sample.bam``) 30;
- a JAX ``--max_mismatch 1`` run that the port's ``--resume`` skips whole
  (the rescue stage's manifest params are ``{"max_mismatch": 1}`` in
  both packages).
"""

import hashlib
import json
import os

import pytest

from consensuscruncher_tpu.cli import main as jax_main
from consensuscruncher_tpu_torch.cli import main as torch_main
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")
GOLDEN = json.load(open(os.path.join(REPO, "test", "golden.json")))
STAGES = ["dcs", "merge_all_dcs", "merge_all_sscs", "merge_rescued", "singleton_correction",
          "sscs"]


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _bams(base):
    return sorted(os.path.relpath(os.path.join(root, f), base)
                  for root, _dirs, files in os.walk(base)
                  for f in files if f.endswith(".bam"))


def _sha256s(base):
    out = {}
    for rel in _bams(base):
        with open(os.path.join(base, rel), "rb") as fh:
            out[rel] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _argv(bam, name, *extra):
    return ["consensus", "-i", os.path.join(DATA, bam), "-n", name, "--scorrect", "True",
            *extra]


def _assert_records_equal(base, jbase):
    bams = _bams(jbase)
    assert bams == _bams(base) and len(bams) == 11
    for rel in bams:
        assert _records(os.path.join(base, rel)) == _records(os.path.join(jbase, rel)), rel


@pytest.fixture(scope="module")
def jax_mm1(tmp_path_factory):
    """The JAX CLI's ``--max_mismatch 1`` run of ``sample_bcerr.bam``."""
    out = tmp_path_factory.mktemp("jax_mm1")
    jax_main(_argv("sample_bcerr.bam", "golden_mm1", "--max_mismatch", "1",
                   "-o", str(out), "--backend", "xla_cpu"))
    return out / "golden_mm1"


def test_mm1_matches_goldens_and_jax_records(tmp_path, jax_mm1):
    res = torch_main(_argv("sample_bcerr.bam", "golden_mm1", "--max_mismatch", "1",
                           "-o", str(tmp_path), "--device", "cpu"))
    base = tmp_path / "golden_mm1"
    assert res["pipeline"] == "staged"
    assert len(GOLDEN["consensus_mm1"]) == 18
    assert golden_mismatches(str(base), GOLDEN["consensus_mm1"]) == []
    _assert_records_equal(str(base), str(jax_mm1))
    with open(base / "singleton" / "golden_mm1.singleton_stats.json") as fh:
        assert json.load(fh)["max_mismatch"] == 1


def test_resume_skips_a_jax_mm1_run(jax_mm1, capsys):
    before = _sha256s(str(jax_mm1))
    capsys.readouterr()
    torch_main(_argv("sample_bcerr.bam", "golden_mm1", "--max_mismatch", "1",
                     "-o", str(jax_mm1.parent), "--device", "cpu", "--resume", "True"))
    out = capsys.readouterr().out
    assert [s for s in STAGES if f"skipping {s} " in out] == STAGES
    assert _sha256s(str(jax_mm1)) == before


DENSE = [("sample.bam", "consensus", "golden", "0"),
         ("sample_adversarial.bam", "consensus_adversarial", "golden_adv", "0"),
         ("sample_bcerr.bam", "consensus_bcerr_exact", "golden_bcerr", "0"),
         ("sample.bam", None, "golden", "30")]


@pytest.mark.parametrize("bam,section,name,qualscore", DENSE)
def test_dense_wire_matches_goldens_jax_records_and_qc(tmp_path, bam, section, name,
                                                       qualscore):
    argv = _argv(bam, name, "--max_mismatch", "0", "--wire", "dense",
                 "--qualscore", qualscore)
    torch_main(argv + ["-o", str(tmp_path / "torch"), "--device", "cpu"])
    jax_main(argv + ["-o", str(tmp_path / "jax"), "--backend", "xla_cpu"])
    base, jbase = tmp_path / "torch" / name, tmp_path / "jax" / name
    if section is not None:
        assert len(GOLDEN[section]) == 18
        assert golden_mismatches(str(base), GOLDEN[section]) == []
    _assert_records_equal(str(base), str(jbase))
    with open(base / "qc.json") as fh:
        got = json.load(fh)
    with open(jbase / "qc.json") as fh:
        want = json.load(fh)
    assert got == want and got["plane"]["total_votes"] > 0
