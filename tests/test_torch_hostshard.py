"""``--host_workers N`` of the port against the JAX package (CPU).

- The BAI reader (``BaiIndex.load``: bins, linear index, metadata) and
  ``reg2bins``, ``plan_bai_ranges`` for N = 1-5 and the ``range_argv``
  round trip equal the JAX functions' on ``sample.bam`` and
  ``sample_adversarial.bam`` (indel cigars, flag soup, unplaced tail),
  and on a BAM with fewer linear-index windows than workers (the plan
  pads with empty ranges); ``ColumnarReader(bam_range=)`` over the planned
  ranges reads every record once, as the JAX reader does.
- ``aggregate_stats`` and ``aggregate_histograms`` write the JAX files on
  the same worker files.
- ``consensus --host_workers 2 --device cpu`` on ``sample_adversarial.bam``
  writes the one-process port run's records (tags included), canonical
  digests equal to the JAX CLI's ``--host_workers 2 --backend xla_cpu``
  run, the stats less ``backend`` lines, a merged ``qc.json``, the three
  PNGs, and drops ``.ranges``.
- ``--resume`` after a killed worker reuses its committed stages; a
  changed plan is refused.
- On the card the parent builds the kernel library once and opens no CUDA
  context, and worker *i* sees card *i mod count* (``worker_env``).
- The workers get the JAX package's argv with ``--device``: ``--policy``
  is dropped, so a sharded ``--policy delegation`` run votes majority in
  both packages (a fault of the reference, kept so the two agree).
"""

import json
import os
import shutil
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

from consensuscruncher_tpu.cli import main as jax_main
from consensuscruncher_tpu.io import bai as jax_bai
from consensuscruncher_tpu.io import columnar as jax_columnar
from consensuscruncher_tpu.parallel import hostshard as jax_hostshard
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.io import bai
from consensuscruncher_tpu_torch.io.columnar import BamRange, ColumnarReader
from consensuscruncher_tpu_torch.parallel import hostshard
from consensuscruncher_tpu_torch.stages.generate_plots import decode_png
from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_bam, simulate_bam_fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")
sys.path.insert(0, os.path.join(REPO, "test"))
from make_test_data import canonical_bam_digest  # noqa: E402

STATS = ("sscs/a.sscs_stats.txt", "dcs/a.dcs_stats.txt", "singleton/a.singleton_stats.txt",
         "sscs/a.read_families.txt")
PNGS = ("family_size", "read_recovery", "stage_times")


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _bams(base):
    return sorted(os.path.relpath(os.path.join(root, f), base)
                  for root, _dirs, files in os.walk(base) for f in files if f.endswith(".bam"))


def _no_backend(path):
    with open(path) as fh:
        return [ln for ln in fh if "backend" not in ln]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Copies of the committed BAMs (the planner indexes its input in
    place) and a BAM with a single 16 kb linear-index window."""
    root = tmp_path_factory.mktemp("inputs")
    out = {}
    for name in ("sample.bam", "sample_adversarial.bam"):
        out[name] = str(root / name)
        shutil.copy(os.path.join(DATA, name), out[name])
    out["one_window.bam"] = str(root / "one_window.bam")
    simulate_bam_fast(out["one_window.bam"], SimConfig(n_fragments=30, ref_len=4_000, seed=5))
    return out


@pytest.mark.parametrize("name", ["sample.bam", "sample_adversarial.bam", "one_window.bam"])
def test_bai_and_range_plans_equal_jax(inputs, name):
    path = inputs[name]
    bai_path = bai.index_bam(path, skip_if_fresh=True)
    ours, theirs = bai.BaiIndex.load(bai_path), jax_bai.BaiIndex.load(bai_path)
    assert (ours.bins, ours.linear, ours.meta, ours.n_no_coor) == \
        (theirs.bins, theirs.linear, theirs.meta, theirs.n_no_coor)
    rng = np.random.default_rng(11)
    for beg in rng.integers(0, 1 << 28, 50):
        end = int(beg) + int(rng.integers(1, 1 << 20))
        assert bai.reg2bins(int(beg), end) == jax_bai.reg2bins(int(beg), end)
    whole = _records(path)
    for n in range(1, 6):
        plan = hostshard.plan_bai_ranges(path, n)
        assert len(plan) == n
        assert [tuple(r) for r in plan] == [tuple(r) for r in jax_hostshard.plan_bai_ranges(path, n)]
        specs = [hostshard.range_argv(r) for r in plan]
        assert specs == [jax_hostshard.range_argv(r) for r in plan]
        assert [hostshard.parse_range_argv(s) for s in specs] == plan
        # the ranges read every record once, in file order, as the JAX reader does
        got = [whole[0]]
        for r in plan:
            with ColumnarReader(path, bam_range=r) as reader, \
                    jax_columnar.ColumnarReader(path, bam_range=jax_columnar.BamRange(*r)) as jr:
                mine = [bytes(b.buf[b.rec_off[i]:b.rec_off[i + 1]])
                        for b in reader.batches() for i in range(b.n)]
                assert mine == [bytes(b.buf[b.rec_off[i]:b.rec_off[i + 1]])
                                for b in jr.batches() for i in range(b.n)]
            got += mine
        assert got == whole
    if name == "one_window.bam":  # fewer windows than workers: padded with empty ranges
        plan = hostshard.plan_bai_ranges(path, 4)
        assert plan[1:] == [BamRange(plan[0].start_voffset, plan[0].start_key,
                                     plan[0].start_key)] * 3


def test_aggregates_equal_jax(tmp_path):
    """Two sampled worker outputs (the port's runs of two BAMs) summed by
    both packages: byte-identical stats pairs and histograms."""
    for name in ("sample", "sample_bcerr"):
        torch_cli.main(["consensus", "-i", os.path.join(DATA, f"{name}.bam"),
                        "-o", str(tmp_path), "--device", "cpu"])
    for stage, rel in (("SSCS", "sscs/{n}.sscs_stats.json"),
                       ("singleton_correction", "singleton/{n}.singleton_stats.json"),
                       ("DCS", "dcs/{n}.dcs_stats.json")):
        parts = [str(tmp_path / n / rel.format(n=n)) for n in ("sample", "sample_bcerr")]
        parts.append(str(tmp_path / "missing.json"))
        hostshard.aggregate_stats(parts, stage, str(tmp_path / "t.txt"))
        jax_hostshard.aggregate_stats(parts, stage, str(tmp_path / "j.txt"))
        for ext in ("txt", "json"):
            assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    hists = [str(tmp_path / n / "sscs" / f"{n}.read_families.txt")
             for n in ("sample", "sample_bcerr")]
    hostshard.aggregate_histograms(hists, str(tmp_path / "t.hist"))
    jax_hostshard.aggregate_histograms(hists, str(tmp_path / "j.hist"))
    assert (tmp_path / "t.hist").read_bytes() == (tmp_path / "j.hist").read_bytes()


@pytest.fixture(scope="module")
def sharded(inputs, tmp_path_factory):
    """The port's one-process and ``--host_workers 2`` runs and the JAX
    CLI's ``--host_workers 2`` run of ``sample_adversarial.bam``."""
    root = tmp_path_factory.mktemp("sharded")
    src = inputs["sample_adversarial.bam"]
    common = ["consensus", "-i", src, "-n", "a", "--scorrect", "True"]
    res = torch_cli.main(common + ["-o", str(root / "one"), "--device", "cpu"])
    sharded = torch_cli.main(common + ["-o", str(root / "two"), "--device", "cpu",
                                       "--host_workers", "2"])
    jax_main(common + ["-o", str(root / "jax"), "--backend", "xla_cpu", "--host_workers", "2"])
    return {"root": root, "src": src, "one": res, "two": sharded}


def test_host_workers_equal_one_process_and_jax(sharded):
    root = sharded["root"]
    one, two, jax = root / "one" / "a", root / "two" / "a", root / "jax" / "a"
    assert sharded["two"]["pipeline"] == "host_sharded[2]"
    bams = _bams(str(one))
    assert bams == _bams(str(two)) == _bams(str(jax)) and len(bams) == 11
    for rel in bams:
        assert _records(str(two / rel)) == _records(str(one / rel)), rel
        assert canonical_bam_digest(str(two / rel)) == canonical_bam_digest(str(jax / rel)), rel
    for rel in STATS:
        assert _no_backend(two / rel) == _no_backend(one / rel) == _no_backend(jax / rel), rel
    assert not (two / ".ranges").exists()
    for png in PNGS:
        img = decode_png((two / "plots" / f"a.{png}.png").read_bytes())
        assert img.shape[2] == 3 and (jax / "plots" / f"a.{png}.png").exists()
    with open(two / "qc.json") as fh:
        qc = json.load(fh)
    with open(jax / "qc.json") as fh:
        jqc = json.load(fh)
    assert qc["pipeline"] == jqc["pipeline"] == "host_sharded[2]"
    assert qc["run"] == "a" and qc["plane"]["total_votes"] > 0
    assert qc == jqc


def test_resume_after_a_killed_worker_and_a_changed_plan(sharded, tmp_path):
    src = sharded["src"]
    common = ["--device", "cpu", "--scorrect", "True"]
    # interrupted state: only worker r0 ran to its end, the parent never merged
    ranges_dir = tmp_path / "a" / ".ranges"
    os.makedirs(ranges_dir)
    r0 = hostshard.plan_bai_ranges(src, 2)[0]
    torch_cli.main(["consensus", "-i", src, "-o", str(ranges_dir), "-n", "r0",
                    "--input_range", hostshard.range_argv(r0), *common])
    r0_sscs = ranges_dir / "r0" / "sscs" / "r0.sscs.sorted.bam"
    stamp = os.stat(r0_sscs).st_mtime_ns
    torch_cli.main(["consensus", "-i", src, "-o", str(tmp_path), "-n", "a",
                    "--host_workers", "2", "--resume", "True", *common])
    assert os.stat(r0_sscs).st_mtime_ns == stamp  # r0's SSCS was skipped
    clean = sharded["root"] / "two" / "a"
    for rel in _bams(str(clean)):
        assert _records(str(tmp_path / "a" / rel)) == _records(str(clean / rel)), rel
    # a resumed run keeps the worker tree; a changed plan is refused
    with open(ranges_dir / "ranges.json", "w") as fh:
        json.dump({"sig": {"path": "elsewhere", "size": 1, "mtime": 0, "n": 2},
                   "ranges": []}, fh)
    with pytest.raises(SystemExit, match="rerun without --resume"):
        torch_cli.main(["consensus", "-i", src, "-o", str(tmp_path), "-n", "a",
                        "--host_workers", "2", "--resume", "True", *common])


def test_run_workers_retries_a_failed_worker(tmp_path, monkeypatch):
    """A worker that fails is relaunched with its ``retry_cmd`` after the
    backoff; one that keeps failing ends the run with its stderr tail."""
    monkeypatch.setenv("CCT_RETRY_BASE_S", "0")
    flaky = ("import os, sys; m = sys.argv[1]; "
             "sys.exit(0) if os.path.exists(m) else (open(m, 'w').close(), "
             "print('first try fails', file=sys.stderr), sys.exit(3))")
    workers = [{"name": "r0", "cmd": [sys.executable, "-c", flaky, str(tmp_path / "m0")],
                "err_path": str(tmp_path / "r0.stderr")},
               {"name": "r1", "cmd": [sys.executable, "-c", "pass"],
                "err_path": str(tmp_path / "r1.stderr")}]
    hostshard.run_workers(workers, retries=1)
    assert "first try fails" in (tmp_path / "r0.stderr").read_text()  # appended, kept
    failing = [{"name": "r2", "cmd": [sys.executable, "-c",
                                      "import sys; print('boom', file=sys.stderr); sys.exit(5)"],
                "err_path": str(tmp_path / "r2.stderr")}]
    with pytest.raises(SystemExit, match=r"worker r2 rc=5 .*boom"):
        hostshard.run_workers(failing, retries=1)
    assert (tmp_path / "r2.stderr").read_text().count("boom") == 2


def test_worker_env_shares_the_visible_cards():
    base = {"PATH": "/bin"}
    assert [hostshard.worker_env(base, i, "cuda", 1)["CUDA_VISIBLE_DEVICES"]
            for i in range(4)] == ["0", "0", "0", "0"]
    assert [hostshard.worker_env(base, i, "cuda", 3)["CUDA_VISIBLE_DEVICES"]
            for i in range(5)] == ["0", "1", "2", "0", "1"]
    masked = {**base, "CUDA_VISIBLE_DEVICES": "4,6"}
    assert [hostshard.worker_env(masked, i, "cuda", 2)["CUDA_VISIBLE_DEVICES"]
            for i in range(3)] == ["4", "6", "4"]
    assert "CUDA_VISIBLE_DEVICES" not in hostshard.worker_env(base, 1, "cpu", 0)
    assert hostshard.worker_env(base, 0, "cpu", 0) == base


def test_card_parent_builds_once_and_opens_no_context(sharded, tmp_path, monkeypatch):
    """A ``--device cuda`` parent on a host with (as this test pretends)
    two cards: one ``cuda_lib.build`` before the fleet, worker *i* on card
    *i mod 2*, and no call that would open a CUDA context (on this
    CPU-only torch any such call raises).  The fleet runner stands in for
    the launch and runs each worker's argv on the CPU."""
    from consensuscruncher_tpu_torch.ops import cuda_lib

    builds, seen = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(cuda_lib, "build", lambda name: builds.append(name))
    real_run = hostshard.run_workers

    def run_on_cpu(workers, retries=1):
        for w in workers:
            cmd = w["cmd"]
            seen.append((w["env"]["CUDA_VISIBLE_DEVICES"], cmd[cmd.index("--device") + 1]))
            w["cmd"] = [*cmd[:cmd.index("--device")], "--device", "cpu",
                        *cmd[cmd.index("--device") + 2:]]
        real_run(workers, retries=0)

    monkeypatch.setattr(hostshard, "run_workers", run_on_cpu)
    torch_cli.main(["consensus", "-i", sharded["src"], "-o", str(tmp_path), "-n", "a",
                    "--scorrect", "True", "--host_workers", "3", "--device", "cuda"])
    assert builds == ["consensus_vote"]
    assert seen == [("0", "cuda"), ("1", "cuda"), ("0", "cuda")]
    assert not torch.cuda.is_initialized()
    one = sharded["root"] / "one" / "a"
    for rel in _bams(str(one)):
        assert _records(str(tmp_path / "a" / rel)) == _records(str(one / rel)), rel


def test_workers_drop_policy_as_the_reference_does(tmp_path):
    """The reference's ``worker_argv`` passes no ``--policy`` (nor
    ``--residency``, ``--pipeline``, ``--cleanup``), so its sharded
    ``--policy delegation`` run votes majority.  The port keeps that argv:
    on a degraded sample its sharded delegation run writes the
    one-process majority run's SSCS records, not delegation's."""
    args = Namespace(device="cpu", backend="xla_cpu", cutoff=0.7, qualscore=0, scorrect=True,
                     max_mismatch=0, bdelim="|", compress_level=6, wire="stream",
                     intermediate_level=None, policy="delegation", residency=False,
                     pipeline="streaming", cleanup=True, devices=None)
    mine = hostshard.worker_argv("x.bam", "out", "r0", args, range_spec="0:-1:eof")
    theirs = jax_hostshard.worker_argv("x.bam", "out", "r0", args, range_spec="0:-1:eof")
    assert mine[mine.index("--device"):mine.index("--device") + 2] == ["--device", "cpu"]
    assert [a for a in mine if a not in ("--device", "cpu")] == \
        [a for a in theirs if a not in ("--backend", "xla_cpu")]
    for flag in ("--policy", "--residency", "--pipeline", "--cleanup", "--backend"):
        assert flag not in mine

    bam = str(tmp_path / "degraded.bam")
    simulate_bam(bam, SimConfig(n_fragments=150, seed=7, degraded_read_rate=0.5))
    rel = "sscs/d.sscs.sorted.bam"
    runs = {}
    for label, extra in (("sharded", ["--host_workers", "2", "--policy", "delegation"]),
                         ("majority", []), ("delegation", ["--policy", "delegation"])):
        torch_cli.main(["consensus", "-i", bam, "-o", str(tmp_path / label), "-n", "d",
                        "--device", "cpu", *extra])
        runs[label] = _records(str(tmp_path / label / "d" / rel))
    assert runs["sharded"] == runs["majority"] != runs["delegation"]
    with open(tmp_path / "sharded" / "d" / "sscs" / "d.sscs_stats.json") as fh:
        assert "policy" not in json.load(fh)
