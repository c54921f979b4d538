"""``consensus --devices N`` of the port against the JAX CLI (CPU).

The port's ``--device cpu --devices N`` runs N CPU shards through the
kernels' plain versions; the JAX CLI's ``--backend tpu --devices N`` runs
its mesh over the conftest's 8 virtual CPU devices.

- ``--devices 8`` on ``sample.bam`` and ``sample_adversarial.bam``: the
  ``consensus`` and ``consensus_adversarial`` goldens, and every BAM record
  by record (tags included) equal to the JAX CLI's ``--devices 8`` run;
- ``--devices 2`` under ``--pipeline streaming`` and under ``--wire dense``
  writes the one-device run's records; ``qc.json`` under ``--devices 2``
  is the JAX CLI's (no vote plane: neither package's mesh arms the
  rider); the resident pair votes count 0;
- ``--host_workers 2 --devices 4`` (the port of ``tests/test_cli_e2e.py``'s
  host-workers parity case) writes the one-process run's records, stats
  and plots;
- ``--policy delegation --devices 2`` raises the JAX CLI's error, before
  any output;
- a ``devices`` key in ``[consensus]`` of ``-c config.ini`` works as the
  flag does, and ``--resume`` across mesh sizes reuses every stage;
- ``worker_argv`` passes ``--devices`` as the JAX package's does, and
  ``worker_env`` gives worker *i* the distinct cards among ``(i * d + j)
  mod count``.
"""

import json
import os
from argparse import Namespace

import pytest

from consensuscruncher_tpu.cli import main as jax_main
from consensuscruncher_tpu.parallel import hostshard as jax_hostshard
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.ops import residency
from consensuscruncher_tpu_torch.parallel import hostshard
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")
GOLDEN = json.load(open(os.path.join(REPO, "test", "golden.json")))
STATS = ("sscs/{n}.sscs_stats.txt", "dcs/{n}.dcs_stats.txt",
         "singleton/{n}.singleton_stats.txt", "sscs/{n}.read_families.txt")


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _bams(base):
    return sorted(os.path.relpath(os.path.join(root, f), base)
                  for root, _dirs, files in os.walk(base) if ".ranges" not in root
                  for f in files if f.endswith(".bam"))


def _same_records(base, other):
    rels = _bams(base)
    assert rels == _bams(other) and len(rels) >= 10
    for rel in rels:
        assert _records(os.path.join(base, rel)) == _records(os.path.join(other, rel)), rel


def _no_backend(path):
    with open(path) as fh:
        return [ln for ln in fh if "backend" not in ln]


def _port(bam, out, name, *extra):
    return torch_cli.main(["consensus", "-i", os.path.join(DATA, bam), "-o", str(out),
                           "-n", name, "--scorrect", "True", "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """The port's one-device run of ``sample.bam``."""
    root = tmp_path_factory.mktemp("one")
    _port("sample.bam", root, "s")
    return root / "s"


@pytest.mark.parametrize("bam,section,name", [
    ("sample.bam", "consensus", "golden"),
    ("sample_adversarial.bam", "consensus_adversarial", "golden_adv")])
def test_devices_8_match_goldens_and_jax(tmp_path, bam, section, name):
    """``tests/test_golden.py``'s ``--devices 8`` cases."""
    _port(bam, tmp_path / "port", name, "--devices", "8")
    jax_main(["consensus", "-i", os.path.join(DATA, bam), "-o", str(tmp_path / "jax"),
              "-n", name, "--backend", "tpu", "--scorrect", "True", "--devices", "8"])
    base = tmp_path / "port" / name
    assert golden_mismatches(str(base), GOLDEN[section]) == []
    _same_records(str(base), str(tmp_path / "jax" / name))
    for rel in STATS:
        rel = rel.format(n=name)
        assert _no_backend(base / rel) == _no_backend(tmp_path / "jax" / name / rel), rel


@pytest.mark.parametrize("extra", [["--pipeline", "streaming", "--intermediate_taps", "True"], ["--wire", "dense"], []])
def test_devices_2_equal_one_device(tmp_path, one_device, extra):
    residency.pair_votes = residency.against_votes = 0
    res = _port("sample.bam", tmp_path, "s", "--devices", "2", *extra)
    assert res["pipeline"] == ("streaming" if "streaming" in extra else "staged")
    _same_records(str(tmp_path / "s"), str(one_device))
    assert (residency.pair_votes, residency.against_votes) == (0, 0)
    with open(tmp_path / "s" / "dcs" / "s.dcs.metrics.json") as fh:
        assert json.load(fh)["cumulative"]["resident_pair_votes"] == 0
    with open(tmp_path / "s" / "qc.json") as fh:
        assert json.load(fh)["plane"] is None


def test_qc_json_equals_jax_under_devices_2(tmp_path):
    _port("sample.bam", tmp_path / "port", "s", "--devices", "2")
    jax_main(["consensus", "-i", os.path.join(DATA, "sample.bam"), "-o", str(tmp_path / "jax"),
              "-n", "s", "--backend", "tpu", "--scorrect", "True", "--devices", "2"])
    docs = []
    for side in ("port", "jax"):
        with open(tmp_path / side / "s" / "qc.json") as fh:
            docs.append(json.load(fh))
    assert docs[0] == docs[1] and docs[0]["plane"] is None


def test_host_workers_times_devices_equal_one_process(tmp_path):
    """Two host workers of a 4-shard mesh each on the adversarial fixture
    (indel cigars, flag soup, unplaced tail): the one-process run's
    records, stats less backend lines, and plots."""
    src = tmp_path / "a.bam"  # the planner indexes its input in place
    src.write_bytes(open(os.path.join(DATA, "sample_adversarial.bam"), "rb").read())
    common = ["consensus", "-i", str(src), "-n", "a", "--scorrect", "True", "--device", "cpu"]
    torch_cli.main(common + ["-o", str(tmp_path / "single")])
    res = torch_cli.main(common + ["-o", str(tmp_path / "sharded"), "--host_workers", "2",
                                   "--devices", "4"])
    assert res["pipeline"] == "host_sharded[2]"
    assert not (tmp_path / "sharded" / "a" / ".ranges").exists()
    _same_records(str(tmp_path / "sharded" / "a"), str(tmp_path / "single" / "a"))
    for rel in STATS:
        rel = rel.format(n="a")
        assert _no_backend(tmp_path / "sharded" / "a" / rel) == \
            _no_backend(tmp_path / "single" / "a" / rel), rel
    for png in ("family_size", "read_recovery", "stage_times"):
        assert (tmp_path / "sharded" / "a" / "plots" / f"a.{png}.png").exists()


def test_policy_with_devices_raises_the_jax_error(tmp_path):
    argv = ["consensus", "-i", os.path.join(DATA, "sample.bam"), "-n", "s", "--scorrect",
            "True", "--policy", "delegation", "--devices", "2"]
    with pytest.raises(ValueError) as ours:
        torch_cli.main(argv + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    with pytest.raises(ValueError) as theirs:
        jax_main(argv + ["-o", str(tmp_path / "jax"), "--backend", "tpu"])
    assert str(ours.value) == str(theirs.value) == "vote policy 'delegation' is single-device only"
    assert _bams(str(tmp_path / "port")) == []


def test_config_devices_key_and_resume_across_mesh_sizes(tmp_path, one_device, capsys):
    cfg = tmp_path / "run.ini"
    cfg.write_text("[consensus]\ndevices = 2\nbackend = xla_cpu\n")
    argv = ["consensus", "-c", str(cfg), "-i", os.path.join(DATA, "sample.bam"), "-n", "s",
            "--scorrect", "True", "-o", str(tmp_path)]
    assert torch_cli.parse_args(argv).devices == 2
    assert torch_cli.parse_args(argv + ["--devices", "4"]).devices == 4
    torch_cli.main(argv)
    with open(tmp_path / "s" / "qc.json") as fh:
        assert json.load(fh)["plane"] is None  # the mesh ran: no rider
    _same_records(str(tmp_path / "s"), str(one_device))
    with open(tmp_path / "s" / "manifest.json") as fh:
        for entry in json.load(fh)["stages"].values():
            assert "devices" not in entry["params"]
    capsys.readouterr()
    torch_cli.main(argv + ["--devices", "1", "--resume", "True"])
    out = capsys.readouterr().out
    for stage in ("sscs", "singleton_correction", "merge_rescued", "dcs", "merge_all_sscs",
                  "merge_all_dcs"):
        assert f"skipping {stage} " in out


def test_worker_argv_passes_devices_as_jax_does():
    args = Namespace(device="cpu", backend="xla_cpu", cutoff=0.7, qualscore=0, scorrect=True,
                     max_mismatch=0, bdelim="|", compress_level=6, wire="stream",
                     intermediate_level=None, devices=4)
    mine = hostshard.worker_argv("x.bam", "out", "r0", args, range_spec="0:-1:eof")
    theirs = jax_hostshard.worker_argv("x.bam", "out", "r0", args, range_spec="0:-1:eof")
    assert mine[-2:] == theirs[-2:] == ["--devices", "4"]
    assert [a for a in mine if a not in ("--device", "cpu")] == \
        [a for a in theirs if a not in ("--backend", "xla_cpu")]
    args.devices = None
    assert "--devices" not in hostshard.worker_argv("x.bam", "out", "r0", args)


def test_worker_env_gives_each_worker_its_cards():
    base = {"PATH": "/bin"}

    def cards(i, n_cards, d, env=base):
        return hostshard.worker_env(env, i, "cuda", n_cards, d)["CUDA_VISIBLE_DEVICES"]

    assert [cards(i, 1, 2) for i in range(2)] == ["0", "0"]
    assert [cards(i, 3, 2) for i in range(3)] == ["0,1", "2,0", "1,2"]
    assert [cards(i, 8, 4) for i in range(2)] == ["0,1,2,3", "4,5,6,7"]
    assert [cards(i, 2, 4) for i in range(2)] == ["0,1", "0,1"]
    masked = {**base, "CUDA_VISIBLE_DEVICES": "4,6"}
    assert [cards(i, 2, 3, masked) for i in range(2)] == ["4,6", "6,4"]
    assert [cards(i, 3, 1) for i in range(4)] == ["0", "1", "2", "0"]
    assert hostshard.worker_env(base, 1, "cpu", 0, 4) == base


def test_cli_parses_devices_as_jax_does():
    argv = ["consensus", "-i", "x.bam", "-o", "out", "--devices", "3"]
    assert torch_cli.parse_args(argv).devices == 3
    assert torch_cli.parse_args(argv[:-2]).devices is None
