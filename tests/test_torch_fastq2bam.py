"""The port's ``fastq2bam`` against the JAX CLI's, and the flow from FASTQ.

The tests need no ``bwa``: the external-aligner leg runs a stub
aligner (a copy of the JAX tests' ``FAKE_BWA``: it reads each pair's
coordinates from its name and prints SAM) and the built-in leg runs
``stages/align``.  Every case runs both CLIs on the same inputs (made
from a seed with numpy) and wants every output file byte-equal (the tag
and bad-read FASTQs, barcode stats and distribution, the sorted BAM and
its BAI), the manifests equal with paths made relative:

- through the stub: default flags, ``--cleanup True`` (the tag FASTQs
  written stored, then deleted), ``--compress_level 1``, ``--blist``, and
  ``-c config.ini`` with a ``[fastq2bam]`` section;
- through ``--bwa builtin`` at ``--host_workers`` 1 and 2;
- ``--resume``: a tree written by either package is skipped by the
  other's ``--resume`` (at another ``--host_workers`` too), a changed
  input runs again;
- the missing aligner, the ``subprocess.bwa`` retries and their
  exhaustion, and the built-in aligner's indel warning, each with the
  JAX text;
- FASTQ -> ``fastq2bam`` -> ``consensus --device cpu`` against the JAX
  CLI's flow (``--backend xla_cpu``), every BAM record by record, tags
  included, and the stats less their backend lines, through the stub
  (untagged reads) and the built-in aligner (``NM`` on every read, the
  object walks).
"""

import hashlib
import json
import os
import stat

import numpy as np
import pytest

from consensuscruncher_tpu.cli import main as jax_main
from consensuscruncher_tpu_torch.cli import main as torch_main
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.io.fastq import FastqWriter
from consensuscruncher_tpu_torch.utils import faults
from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_fastq_pairs

FAKE_BWA = '''#!/usr/bin/env python3
"""Stub aligner: `fake-bwa mem <ref> <r1> <r2>` -> SAM on stdout.
Read names look like `frag<k>:<lo>:<hi>:<strand>:<i>|BC`; coordinates are
taken from the name so alignment is deterministic."""
import gzip, sys

_, _, ref, r1, r2 = sys.argv[:5]

def reads(path):
    with gzip.open(path, "rt") as fh:
        while True:
            h = fh.readline()
            if not h:
                return
            s = fh.readline().strip(); fh.readline(); q = fh.readline().strip()
            yield h[1:].strip(), s, q

print("@HD\\tVN:1.6\\tSO:unsorted")
print("@SQ\\tSN:chr1\\tLN:1000000")
for (n1, s1, q1), (n2, s2, q2) in zip(reads(r1), reads(r2)):
    name = n1.split("|")[0]
    _, lo, hi, strand, _i = name.split(":")
    lo, hi = int(lo), int(hi)
    L1, L2 = len(s1), len(s2)
    tlen = hi - lo + L2
    if strand == "A":   # R1 fwd@lo, R2 rev@hi
        f1, f2 = 99, 147
        p1, p2 = lo, hi
    else:               # strand B: R1 rev@hi, R2 fwd@lo
        f1, f2 = 83, 163
        p1, p2 = hi, lo
    print(f"{n1}\\t{f1}\\tchr1\\t{p1+1}\\t60\\t{L1}M\\tchr1\\t{p2+1}\\t{tlen}\\t{s1}\\t{q1}")
    print(f"{n1}\\t{f2}\\tchr1\\t{p2+1}\\t60\\t{L2}M\\tchr1\\t{p1+1}\\t{-tlen}\\t{s2}\\t{q2}")
'''


@pytest.fixture(autouse=True)
def _fresh_faults(monkeypatch):
    monkeypatch.setattr(faults, "_cached", None)
    monkeypatch.setenv("CCT_RETRY_BASE_S", "0.001")
    yield
    faults._cached = None


def _executable(path, text):
    path.write_text(text)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture()
def fake_bwa(tmp_path):
    return _executable(tmp_path / "fake-bwa", FAKE_BWA)


def _write_fastqs(tmp_path, n_frags=12, fam=3, seed=0):
    r1, r2 = tmp_path / "s_R1.fastq.gz", tmp_path / "s_R2.fastq.gz"
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    with FastqWriter(str(r1)) as w1, FastqWriter(str(r2)) as w2:
        for k in range(n_frags):
            lo = 1000 + 37 * k
            hi = lo + 180
            umi_a = "".join(bases[i] for i in rng.integers(0, 4, 2))
            umi_b = "".join(bases[i] for i in rng.integers(0, 4, 2))
            mol1 = "".join(bases[i] for i in rng.integers(0, 4, 50))
            mol2 = "".join(bases[i] for i in rng.integers(0, 4, 50))
            for strand in "AB":
                # inline UMI prefix: NNT pattern (2 UMI bases + T spacer)
                u1, u2 = (umi_a, umi_b) if strand == "A" else (umi_b, umi_a)
                for i in range(fam):
                    name = f"frag{k}:{lo}:{hi}:{strand}:{i}"
                    w1.write(name, u1 + "T" + mol1, "I" * 53)
                    w2.write(name, u2 + "T" + mol2, "I" * 53)
    return str(r1), str(r2)


def _files(base) -> dict:
    """Every file under ``base`` but the manifest: sha256 by relative path."""
    out = {}
    for root, _dirs, files in os.walk(base):
        for f in files:
            path = os.path.join(root, f)
            if f != "manifest.json":
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, base)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _manifest(base) -> dict:
    with open(os.path.join(base, "manifest.json")) as fh:
        stages = json.load(fh)["stages"]

    def rel(paths):
        return {os.path.relpath(p, base) if os.path.isabs(p) and p.startswith(str(base))
                else os.path.basename(p): f for p, f in paths.items()}

    return {s: (e["params"], rel(e["inputs"]), rel(e["outputs"])) for s, e in stages.items()}


def _both(tmp_path, argv, port_extra=()):
    """Run ``argv`` (no ``-o``) through both CLIs; return the two roots."""
    roots = {}
    for tag, main, extra in (("jax", jax_main, ()), ("port", torch_main, port_extra)):
        roots[tag] = tmp_path / tag
        main([*argv, "-o", str(roots[tag]), *extra])
    return roots["port"], roots["jax"]


def _assert_same_tree(port, jax):
    files = _files(jax)
    assert _files(port) == files
    assert _manifest(port) == _manifest(jax)
    return files


@pytest.mark.parametrize("variant", ["default", "cleanup", "compress_level", "blist", "config"])
def test_stub_aligner_tree_equals_jax(tmp_path, fake_bwa, variant):
    r1, r2 = _write_fastqs(tmp_path)
    argv = ["fastq2bam", "--fastq1", r1, "--fastq2", r2, "--ref", "unused.fa"]
    if variant == "config":
        ini = tmp_path / "c.ini"
        ini.write_text(f"[fastq2bam]\nbwa = {fake_bwa}\nbpattern = NNT\nname = s\n"
                       "compress_level = 2\ncleanup = True\n")
        argv += ["-c", str(ini)]
    else:
        argv += ["--name", "s", "--bwa", fake_bwa, "--bpattern", "NNT"]
    if variant == "cleanup":
        argv += ["--cleanup", "True"]
    elif variant == "compress_level":
        argv += ["--compress_level", "1"]
    elif variant == "blist":
        blist = tmp_path / "bl.txt"
        blist.write_text("AC\nGT\nTA\nCA\nGG\n")
        argv += ["--blist", str(blist)]
    port, jax = _both(tmp_path, argv)
    files = _assert_same_tree(port, jax)
    cleaned = variant in ("cleanup", "config")
    assert ("fastq_tag/s_r1.fastq.gz" in files) is not cleaned
    assert "bamfiles/s.sorted.bam" in files and "bamfiles/s.sorted.bam.bai" in files
    if cleaned:  # the deleted tag FASTQs were written stored (level 0)
        assert _manifest(port)["extract"][0]["level"] == 0


@pytest.mark.parametrize("workers", [1, 2])
def test_builtin_tree_equals_jax(tmp_path, workers):
    r1, r2, fa = simulate_fastq_pairs(str(tmp_path / "sim"), SimConfig(
        n_fragments=250, ref_len=150_000, mean_family_size=2.0, seed=31))
    argv = ["fastq2bam", "-f1", r1, "-f2", r2, "-n", "s", "--bwa", "builtin", "-r", fa,
            "--bpattern", "NNNNNNT"]
    port, jax = _both(tmp_path, argv, ("--host_workers", str(workers)))
    files = _assert_same_tree(port, jax)
    assert len(files) == 9


@pytest.fixture(scope="module")
def sim_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim")
    return simulate_fastq_pairs(str(d / "sim"), SimConfig(
        n_fragments=120, ref_len=100_000, mean_family_size=2.0, seed=23))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_skips_the_other_packages_tree(tmp_path, capsys, sim_pair, writer):
    r1, r2, fa = sim_pair
    out = tmp_path / "o"

    def argv_named(name):
        return ["fastq2bam", "-f1", r1, "-f2", r2, "-o", str(out), "-n", name,
                "--bwa", "builtin", "-r", fa, "--bpattern", "NNNNNNT", "--resume", "True"]

    argv = argv_named("s")
    first, second = (torch_main, jax_main) if writer == "port" else (jax_main, torch_main)
    first(argv)
    assert set(json.loads((out / "manifest.json").read_text())["stages"]) == {"extract", "align"}
    bam = out / "bamfiles" / "s.sorted.bam"
    mtime = bam.stat().st_mtime_ns
    capsys.readouterr()
    for run in (second, first):  # host_workers is left out of the params
        run([*argv, "--host_workers", "2"])
        msgs = capsys.readouterr().out
        assert "skipping extract" in msgs and "skipping align" in msgs
    assert bam.stat().st_mtime_ns == mtime
    # a changed name (a param) runs again
    torch_main(argv_named("t"))
    assert "skipping" not in capsys.readouterr().out


def test_resume_reruns_a_changed_input(tmp_path, capsys):
    kw = dict(n_fragments=60, ref_len=60_000, mean_family_size=2.0)
    r1, r2, fa = simulate_fastq_pairs(str(tmp_path / "sim"), SimConfig(seed=23, **kw))
    argv = ["fastq2bam", "-f1", r1, "-f2", r2, "-o", str(tmp_path / "o"), "-n", "s",
            "--bwa", "builtin", "-r", fa, "--bpattern", "NNNNNNT", "--resume", "True"]
    torch_main(argv)
    capsys.readouterr()
    simulate_fastq_pairs(str(tmp_path / "sim"), SimConfig(seed=24, **kw))
    torch_main(argv)
    assert "skipping" not in capsys.readouterr().out
    jax_main([*argv[:5], "-o", str(tmp_path / "j"), *argv[7:]])
    _assert_same_tree(tmp_path / "o", tmp_path / "j")


def _exit_message(main, argv) -> str:
    with pytest.raises(SystemExit) as info:
        main(argv)
    return str(info.value)


def test_missing_aligner_exits_as_jax(tmp_path):
    r1, r2 = _write_fastqs(tmp_path, n_frags=1, fam=1)
    argv = ["fastq2bam", "-f1", r1, "-f2", r2, "--bwa", "/nonexistent/bwa", "-r", "x.fa",
            "-p", "NNT"]
    port = _exit_message(torch_main, [*argv, "-o", str(tmp_path / "p")])
    assert port == _exit_message(jax_main, [*argv, "-o", str(tmp_path / "j")])
    assert port.startswith("aligner not found: '/nonexistent/bwa'")


def _flaky_bwa(tmp_path, marker):
    """The stub aligner, exiting 1 on its first call (marker absent)."""
    prefix = ("#!/usr/bin/env python3\nimport os, sys\n"
              f"m = {marker!r}\n"
              "if not os.path.exists(m):\n"
              "    open(m, 'w').close()\n"
              "    sys.stderr.write('transient aligner crash\\n')\n"
              "    sys.exit(1)\n")
    return _executable(tmp_path / "flaky-bwa", prefix + FAKE_BWA.split("\n", 1)[1])


def test_aligner_retries_to_the_clean_bytes(tmp_path, capfd):
    from consensuscruncher_tpu_torch.cli import align_and_sort

    r1, r2 = _write_fastqs(tmp_path, n_frags=4, fam=2)
    marker = tmp_path / "crashed.once"
    flaky = _flaky_bwa(tmp_path, str(marker))
    clean = str(tmp_path / "clean.bam")
    align_and_sort(flaky, "x.fa", r1, r2, clean)  # the first call fails, then retried
    err = capfd.readouterr().err
    assert "retry 2/3" in err and "status 1" in err
    out = str(tmp_path / "again.bam")
    os.unlink(marker)
    align_and_sort(flaky, "x.fa", r1, r2, out)
    assert open(out, "rb").read() == open(clean, "rb").read()


@pytest.mark.parametrize("spec", ["subprocess.bwa=fail@3", "subprocess.bwa=fail@2"])
def test_injected_aligner_failures_match_jax(tmp_path, monkeypatch, fake_bwa, spec):
    from consensuscruncher_tpu.cli import align_and_sort as jax_align_and_sort
    from consensuscruncher_tpu.utils import faults as jax_faults
    from consensuscruncher_tpu_torch.cli import align_and_sort

    r1, r2 = _write_fastqs(tmp_path, n_frags=2, fam=1)
    monkeypatch.setenv("CCT_FAULTS", spec)
    outcomes = []
    for fn, mod in ((align_and_sort, faults), (jax_align_and_sort, jax_faults)):
        monkeypatch.setattr(mod, "_cached", None)
        out = str(tmp_path / f"{mod.__name__}.bam")
        try:
            fn(fake_bwa, "x.fa", r1, r2, out)
            outcomes.append(("ok", open(out, "rb").read()))
        except SystemExit as exc:
            outcomes.append(("exit", str(exc)))
            assert not os.path.exists(out)  # no attempt promoted a partial BAM
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("exit" if spec.endswith("@3") else "ok")
    if spec.endswith("@3"):
        assert "injected fault" in outcomes[0][1]


def test_indel_warning_matches_jax(tmp_path, capfd):
    rng = np.random.default_rng(44)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 12_000))
    fa = tmp_path / "ref.fa"
    fa.write_text(f">chrA\n{ref}\n")
    comp = str.maketrans("ACGT", "TGCA")
    r1, r2 = tmp_path / "r1.fastq.gz", tmp_path / "r2.fastq.gz"
    with FastqWriter(str(r1)) as w1, FastqWriter(str(r2)) as w2:
        for i in range(20):
            lo = int(rng.integers(0, 10_000))
            frag = ref[lo:lo + 200]
            umi = "".join("ACGT"[j] for j in rng.integers(0, 4, 6))
            ins1, ins2 = frag[:80], frag[-80:].translate(comp)[::-1]
            junk = "".join("ACGT"[j] for j in rng.integers(0, 4, 10))
            # 10 bases deleted mid-insert on both mates: a gapped alignment
            w1.write(f"d{i}", umi + "T" + ins1[:30] + ins1[40:] + junk, "I" * 87)
            w2.write(f"d{i}", umi + "T" + ins2[:30] + ins2[40:] + junk, "I" * 87)
    argv = ["fastq2bam", "-f1", str(r1), "-f2", str(r2), "-r", str(fa), "--bwa", "builtin",
            "--bpattern", "NNNNNNT", "-n", "s"]
    warnings = []
    for tag, main in (("port", torch_main), ("jax", jax_main)):
        capfd.readouterr()
        main([*argv, "-o", str(tmp_path / tag)])
        warnings.append([ln for ln in capfd.readouterr().err.splitlines()
                         if ln.startswith("WARNING: --bwa builtin")])
    assert warnings[0] == warnings[1] and len(warnings[0]) == 1
    assert "unaligned" in warnings[0][0] and "substitutions only" in warnings[0][0]


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _no_backend(path):
    with open(path) as fh:
        if path.endswith(".json"):
            return {k: v for k, v in json.load(fh).items() if k not in ("backend", "jax_backend")}
        return [ln for ln in fh if "backend" not in ln]


@pytest.mark.parametrize("aligner", ["stub", "builtin"])
def test_fastq_to_dcs_equals_jax_flow(tmp_path, fake_bwa, aligner):
    if aligner == "stub":
        r1, r2 = _write_fastqs(tmp_path, n_frags=10, fam=3)
        align = ["--bwa", fake_bwa, "-r", "x.fa", "-p", "NNT"]
    else:
        r1, r2, fa = simulate_fastq_pairs(str(tmp_path / "sim"), SimConfig(
            n_fragments=150, ref_len=120_000, seed=19))
        align = ["--bwa", "builtin", "-r", fa, "-p", "NNNNNNT"]
    trees = {}
    for tag, main, device in (("port", torch_main, ["--device", "cpu"]),
                              ("jax", jax_main, ["--backend", "xla_cpu"])):
        out = tmp_path / tag
        main(["fastq2bam", "-f1", r1, "-f2", r2, "-o", str(out), "-n", "s", *align])
        main(["consensus", "-i", str(out / "bamfiles" / "s.sorted.bam"),
              "-o", str(out / "consensus"), "-n", "s", "--scorrect", "True", *device])
        trees[tag] = out / "consensus" / "s"
    bams = sorted(os.path.relpath(os.path.join(root, f), trees["jax"])
                  for root, _d, files in os.walk(trees["jax"])
                  for f in files if f.endswith(".bam"))
    assert len(bams) == 11
    for rel in bams:
        assert _records(str(trees["port"] / rel)) == _records(str(trees["jax"] / rel)), rel
    for rel in ("sscs/s.sscs_stats.json", "singleton/s.singleton_stats.json",
                "dcs/s.dcs_stats.json", "sscs/s.sscs_stats.txt", "dcs/s.dcs_stats.txt"):
        assert _no_backend(str(trees["port"] / rel)) == _no_backend(str(trees["jax"] / rel)), rel
    with open(trees["port"] / "dcs" / "s.dcs_stats.json") as fh:
        assert json.load(fh)["pairs"] > 0
    if aligner == "builtin":  # every mapped read carries NM: the object walks ran
        with ColumnarReader(str(tmp_path / "port" / "bamfiles" / "s.sorted.bam")) as reader:
            batch = next(reader.batches())
            assert b"NMi" in bytes(batch.buf[:int(batch.rec_off[-1])])
