"""``consensus -c config.ini`` of the port against the JAX package (CPU).

- The JAX package's ``test_consensus_with_config_ini`` case on the port
  (input, output, name and options from the config alone), its records
  equal to the JAX CLI's run of the same config.
- Precedence: a flag over the config value over the built-in default,
  resolved as the JAX ``main`` resolves them (its ``consensus`` replaced
  by a spy that keeps the resolved arguments).
- The ``[consensus]`` key ``backend`` reads as the device: the committed
  ``config.ini``'s ``backend = tpu`` resolves to ``cuda`` (the test asserts
  the resolution, not a run), ``xla_cpu`` to ``cpu``; ``cpu`` and
  ``reference`` exit naming ``--device``; a ``device`` key and
  ``--device`` win over it.  The committed config with ``--device cpu``
  writes the golden outputs.
- The ``[qc]``, ``[io]`` and ``[obs]`` folds leave an environment variable
  that is already set alone, and set it when it is not, as the JAX
  package's do, the ``[obs]`` canary keys included.
"""

import json
import os

import pytest

import consensuscruncher_tpu.cli as jax_cli
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.io import bgzf
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches
from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config.ini")
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")
GOLDEN = json.load(open(os.path.join(REPO, "test", "golden.json")))
# the keys both CLIs resolve for consensus
SHARED = ("input", "output", "name", "cutoff", "qualscore", "scorrect", "max_mismatch",
          "bdelim", "cleanup", "resume", "compress_level", "host_workers", "residency",
          "pipeline", "intermediate_taps", "policy", "wire", "intermediate_level", "profile")


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _jax_resolved(monkeypatch, argv) -> dict:
    seen = {}
    monkeypatch.setattr(jax_cli, "consensus", lambda args: seen.update(vars(args)))
    assert jax_cli.main(argv) == 0
    return seen


def _ini(path, body: str) -> str:
    path.write_text(body)
    return str(path)


def test_consensus_with_config_ini(tmp_path):
    bam = tmp_path / "in.bam"
    simulate_bam(str(bam), SimConfig(n_fragments=10, seed=3))
    for label, backend in (("torch", "xla_cpu"), ("jax", "xla_cpu")):
        cfg = _ini(tmp_path / f"{label}.ini",
                   f"[consensus]\ninput = {bam}\noutput = {tmp_path / label}\nname = cfg\n"
                   f"backend = {backend}\nscorrect = False\ncutoff = 0.8\n")
        (torch_cli.main if label == "torch" else jax_cli.main)(["consensus", "-c", cfg])
    base = tmp_path / "torch" / "cfg"
    assert (base / "all_unique" / "cfg.all.unique.sscs.bam").exists()
    assert not any((base / "singleton").iterdir())  # scorrect = False: no rescue
    with open(base / "sscs" / "cfg.sscs_stats.json") as fh:
        stats = json.load(fh)
    assert stats["backend"] == "cpu" and stats["cutoff"] == 0.8
    for rel in ("sscs/cfg.sscs.sorted.bam", "dcs/cfg.dcs.sorted.bam",
                "all_unique/cfg.all.unique.dcs.bam"):
        assert _records(str(base / rel)) == _records(str(tmp_path / "jax" / "cfg" / rel)), rel


def test_flag_over_config_over_builtin(tmp_path, monkeypatch):
    cfg = _ini(tmp_path / "run.ini",
               "[consensus]\ninput = a.bam\noutput = out\ncutoff = 0.8\nqualscore = 5\n"
               "scorrect = False\ncompress_level = 1\nhost_workers = 3\npolicy = delegation\n"
               "backend = xla_cpu\n[qc]\nenabled = True\n")
    argv = ["consensus", "-c", cfg, "--cutoff", "0.6", "--compress_level", "4", "-o", "flag"]
    mine = vars(torch_cli.parse_args(argv))
    theirs = _jax_resolved(monkeypatch, argv)
    assert {k: mine[k] for k in SHARED} == {k: theirs[k] for k in SHARED}
    assert (mine["cutoff"], mine["compress_level"], mine["output"]) == (0.6, 4, "flag")  # flags
    assert (mine["qualscore"], mine["scorrect"], mine["host_workers"]) == (5, False, 3)  # config
    assert (mine["max_mismatch"], mine["pipeline"], mine["residency"]) == (0, "staged", True)
    assert mine["device"] == "cpu" and theirs["backend"] == "xla_cpu"
    # nothing but flags: the built-in defaults, the card by default
    bare = ["consensus", "-i", "a.bam", "-o", "o"]
    mine, theirs = vars(torch_cli.parse_args(bare)), _jax_resolved(monkeypatch, bare)
    assert {k: mine[k] for k in SHARED} == {k: theirs[k] for k in SHARED}
    assert mine["device"] == "cuda" and theirs["backend"] == "tpu"
    # --host_workers 0 is every core this process may run on
    assert torch_cli.parse_args(bare + ["--host_workers", "0"]).host_workers == \
        len(os.sched_getaffinity(0))
    with pytest.raises(SystemExit):
        torch_cli.parse_args(bare + ["--host_workers", "-1"])
    with pytest.raises(SystemExit):  # no input anywhere
        torch_cli.parse_args(["consensus", "-o", "o"])


def test_backend_key_reads_as_the_device(tmp_path):
    # the committed config.ini says backend = tpu: the card (resolved, not run)
    args = torch_cli.parse_args(["consensus", "-c", CONFIG, "-i", "a.bam", "-o", "o"])
    assert (args.device, args.host_backend) == ("cuda", None)
    assert torch_cli.device_of_backend("tpu") == ("cuda", None)
    assert torch_cli.device_of_backend("xla_cpu") == ("cpu", None)
    assert torch_cli.device_of_backend(None) == (None, None)
    for backend in ("cpu", "reference"):
        assert torch_cli.device_of_backend(backend) == (None, backend)
        # backend = cpu|reference chooses the host backend, no device
        cfg = _ini(tmp_path / f"{backend}.ini", f"[consensus]\nbackend = {backend}\n")
        args = torch_cli.parse_args(["consensus", "-c", cfg, "-i", "a.bam", "-o", "o"])
        assert (args.device, args.host_backend) == (None, backend)
        # a device key or --device wins over the backend key
        args = torch_cli.parse_args(["consensus", "-c", cfg, "-i", "a.bam", "-o", "o",
                                     "--device", "cpu"])
        assert (args.device, args.host_backend) == ("cpu", None)
        both = _ini(tmp_path / f"{backend}_dev.ini",
                    f"[consensus]\nbackend = {backend}\ndevice = cuda\n")
        args = torch_cli.parse_args(["consensus", "-c", both, "-i", "a.bam", "-o", "o"])
        assert (args.device, args.host_backend) == ("cuda", None)
    with pytest.raises(SystemExit, match="expected tpu"):
        torch_cli.device_of_backend("gpu")
    with pytest.raises(SystemExit, match="config file not found"):
        torch_cli.parse_args(["consensus", "-c", str(tmp_path / "none.ini"), "-i", "a", "-o", "o"])


def test_committed_config_on_the_cpu_writes_the_goldens(tmp_path):
    torch_cli.main(["consensus", "-c", CONFIG, "-i", SAMPLE, "-o", str(tmp_path), "-n", "golden",
                    "--device", "cpu"])
    assert golden_mismatches(str(tmp_path / "golden"), GOLDEN["consensus"]) == []


def test_env_folds_keep_a_set_variable(tmp_path, monkeypatch, capsys):
    cfg = _ini(tmp_path / "run.ini",
               "[qc]\nenabled = False\n[io]\nbgzf_threads = 3\nasync_writer = False\n"
               "[obs]\ntrace = 1\ntrace_dir = /tmp/t\ncanary = 1\nunknown_key = 7\n")
    for var in ("CCT_QC", "CCT_TRACE", "CCT_TRACE_DIR", "CCT_CANARY", "CCT_BGZF_THREADS",
                "CCT_ASYNC_WRITER"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setitem(bgzf._cfg, "threads", None)
    monkeypatch.setitem(bgzf._cfg, "async_write", None)
    # set variables win
    monkeypatch.setenv("CCT_QC", "1")
    monkeypatch.setenv("CCT_TRACE", "0")
    monkeypatch.setenv("CCT_BGZF_THREADS", "5")
    monkeypatch.setenv("CCT_ASYNC_WRITER", "1")
    torch_cli._apply_qc_config(cfg)
    torch_cli._apply_obs_config(cfg)
    torch_cli._apply_io_config(cfg)
    assert (os.environ["CCT_QC"], os.environ["CCT_TRACE"]) == ("1", "0")
    assert bgzf.codec_threads() == 5 and bgzf.async_write_default()
    # unset variables take the config's values
    for var in ("CCT_QC", "CCT_TRACE", "CCT_TRACE_DIR", "CCT_BGZF_THREADS",
                "CCT_ASYNC_WRITER"):
        monkeypatch.delenv(var, raising=False)
    capsys.readouterr()
    torch_cli._apply_qc_config(cfg)
    torch_cli._apply_obs_config(cfg)
    assert os.environ["CCT_QC"] == "0"
    assert bgzf.codec_threads() == 3 and not bgzf.async_write_default()
    # [obs] folds into the tracer's and the canary prober's variables as
    # the JAX package's fold does, naming nothing on stderr
    assert (os.environ["CCT_TRACE"], os.environ["CCT_TRACE_DIR"]) == ("1", "/tmp/t")
    assert os.environ["CCT_CANARY"] == "1"
    assert capsys.readouterr().err == ""
    port_env = {k: os.environ.get(k) for k in ("CCT_TRACE", "CCT_TRACE_DIR", "CCT_CANARY")}
    for var in port_env:
        monkeypatch.delenv(var)
    jax_cli._apply_obs_config(cfg)
    assert {k: os.environ.get(k) for k in port_env} == port_env
    monkeypatch.delenv("CCT_CANARY", raising=False)
    # the committed config sets no [obs] key: nothing is named
    torch_cli._apply_obs_config(CONFIG)
    assert capsys.readouterr().err == ""
    # the same folds as the JAX package's
    monkeypatch.delenv("CCT_QC")
    jax_cli._apply_qc_config(cfg)
    assert os.environ["CCT_QC"] == "0"
