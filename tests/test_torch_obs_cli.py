"""The port's observability commands and ``consensus --backend`` against the JAX CLI (CPU).

- **The readers.** ``trace export|fleet``, ``qc report|diff``, ``prof
  report|flame`` and ``history query|trend`` through both CLIs on the same
  shard directories and ``qc.json`` trees: the same stdout, the same
  output-file bytes, and the same ``SystemExit`` text where they refuse.
  The inputs are a port ``serve --device cpu`` daemon's own trace, prof
  and history shards and served trees, and the reference tests' fixtures
  (``tests/test_prof.py``'s shard lines, ``tests/test_history.py``'s
  snapshots written by the JAX recorder, ``tests/test_qc.py``'s fake run
  trees).
- **The flags.** The six commands take exactly the JAX package's flags,
  defaults, choices, help and config section; ``consensus`` takes the JAX
  flags plus ``--device``.
- **Hygiene.** The six commands, run against the live daemon in a process
  of their own with ``torch.cuda._lazy_init`` made to raise, exit 0,
  import no JAX, no JAX package module and nothing of ``tools``, and leave
  torch with no CUDA context.
- **``--backend``.** ``consensus --backend tpu`` is the card (on a host
  without one it raises as ``--device cuda`` does, and writes nothing),
  ``xla_cpu`` the CPU (the goldens), ``cpu``/``reference`` exit naming
  ``--device``, and ``--device`` wins.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from consensuscruncher_tpu import cli as jax_cli
from consensuscruncher_tpu.obs import history as jax_history
from consensuscruncher_tpu.obs import qc as jax_qc
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.serve.client import ServeClient
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")
with open(os.path.join(REPO, "test", "golden.json")) as _fh:
    GOLDEN = json.load(_fh)
CLIS = {"port": torch_cli.main, "jax": jax_cli.main}
OBS_COMMANDS = ("trace", "prof", "critpath", "history", "qc", "top")

# a reader process of its own: each argv of the JSON list through the
# port's cli.main, with torch's CUDA initialisation made to raise
_READERS = r"""
import contextlib, io, json, sys, time
import torch

def _refuse():
    raise RuntimeError("an observability reader asked for a CUDA context")

torch.cuda._lazy_init = _refuse
from consensuscruncher_tpu_torch import cli
from consensuscruncher_tpu_torch.utils import interleave, model_check  # noqa: F401
rows = []
for argv in json.loads(sys.argv[1]):
    out, code, t = io.StringIO(), 0, time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            cli.main(argv)
        except SystemExit as exc:
            code = exc.code
    rows.append({"command": argv[:2], "code": code, "out": out.getvalue(),
                 "seconds": time.perf_counter() - t})
bad = sorted(m for m in sys.modules if m in ("jax", "jaxlib", "consensuscruncher_tpu", "tools")
             or m.startswith(("jax.", "jaxlib.", "consensuscruncher_tpu.", "tools.")))
print(json.dumps({"rows": rows, "bad": bad, "cuda_initialized": torch.cuda.is_initialized()}))
"""


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith(("CCT_TRACE", "CCT_PROF", "CCT_HISTORY"))}
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """A port ``serve --device cpu`` daemon with tracing, the profiler and
    the history recorder on serves three ``sample.bam`` jobs (the last two
    ganged into one dense dispatch behind the first); while it is up,
    the six commands run against it in a reader process of their own; then
    SIGTERM flushes its shards.  Yields the shard directories, the served
    output root and the reader process's result."""
    tmp = tmp_path_factory.mktemp("obs_daemon")
    dirs = {k: str(tmp / k) for k in ("trace", "prof", "history")}
    sock, out = str(tmp / "d.sock"), str(tmp / "out")
    log = open(tmp / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "serve", "--socket", sock,
         "--journal", str(tmp / "j.wal"), "--device", "cpu", "--node", "w0"],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        env=_clean_env(CCT_TRACE="1", CCT_TRACE_DIR=dirs["trace"], CCT_PROF="1",
                       CCT_PROF_DIR=dirs["prof"], CCT_HISTORY_DIR=dirs["history"],
                       CCT_HISTORY_INTERVAL_S="1"))
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(sock):
            assert proc.poll() is None and time.monotonic() < deadline, \
                open(tmp / "serve.log").read()
            time.sleep(0.05)
        client = ServeClient(sock)
        subs = [client.submit_full({"input": SAMPLE, "output": out, "name": f"j{i}"})
                for i in range(3)]
        for sub in subs:
            assert client.result(key=sub["key"], timeout=300)["state"] == "done"
        time.sleep(1.5)  # one history interval past the jobs
        wire = ["--socket", sock]
        argvs = [["trace", "fleet", *wire, "--out", str(tmp / "fleet.json")],
                 ["critpath", "report", *wire],
                 ["prof", "report", *wire],
                 ["history", "query", *wire, "--metric", "batches_dispatched"],
                 ["top", "--once", "True", *wire],
                 ["qc", "report", out]]
        reader = subprocess.run([sys.executable, "-c", _READERS, json.dumps(argvs)], cwd=REPO,
                                env=_clean_env(), capture_output=True, text=True, timeout=300)
        assert reader.returncode == 0, reader.stderr
        proc.terminate()
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    yield {**dirs, "out": out,
           "readers": json.loads(reader.stdout.strip().splitlines()[-1])}


@pytest.fixture
def offline(monkeypatch):
    """The wire refuses at once (port 1), so both CLIs read shards alone,
    and no observability variable of this process leaks into theirs."""
    monkeypatch.setenv("CCT_SERVE_CLIENT_RETRIES", "0")
    monkeypatch.setenv("CCT_RETRY_BASE_S", "0.01")
    for var in ("CCT_TRACE", "CCT_TRACE_DIR", "CCT_PROF", "CCT_PROF_DIR", "CCT_HISTORY_DIR"):
        monkeypatch.delenv(var, raising=False)


def _run(main, argv, capsys, out_file=None):
    """One command: ``(how it ended, stdout or SystemExit text, the bytes
    of ``out_file``)``; ``out_file`` is removed after it is read."""
    try:
        main(argv)
        result = ("ok", capsys.readouterr().out)
    except SystemExit as exc:
        capsys.readouterr()
        result = ("exit", str(exc.code))
    data = None
    if out_file and os.path.exists(out_file):
        with open(out_file, "rb") as fh:
            data = fh.read()
        os.unlink(out_file)
    return (*result, data)


def _both(argv, capsys, out_file=None):
    outs = {name: _run(main, argv, capsys, out_file) for name, main in CLIS.items()}
    assert outs["port"] == outs["jax"]
    return outs["port"]


# ------------------------------------------------- the reference fixtures

# tests/test_prof.py's shard lines: a live line, its later flush, another
PROF_LINES = [
    {"v": 1, "pid": 7, "node": "w0", "seq": 3, "samples": {"a;b": 5}, "attr": {"jobs": 1},
     "drops": 0},
    {"v": 1, "pid": 7, "node": "w0", "seq": 3, "samples": {"a;b": 9}, "attr": {"jobs": 1},
     "drops": 0},
    {"v": 1, "pid": 7, "node": "w0", "seq": 2, "samples": {"a;b": 2, "c;d": 1},
     "attr": {"jobs": 2, "job_wall_ms": 10.0, "queue_ms": 4.0, "device_dispatch_ms": 3.0},
     "drops": 3},
    {"v": 1, "pid": 8, "node": "r0", "seq": 1, "samples": {"route.forward;e.f": 4},
     "attr": {"routing_ms": 2.0}, "drops": 0},
]


@pytest.fixture
def fixture_dirs(tmp_path, monkeypatch):
    """Shard directories and qc trees built as the reference tests build
    them: prof lines by hand, history snapshots through the JAX recorder,
    qc.json docs through the JAX ``collect_run`` on fake run trees."""
    prof = tmp_path / "prof"
    prof.mkdir()
    with open(prof / "prof-7.ndjson", "w") as fh:
        fh.write("".join(json.dumps(ln) + "\n" for ln in PROF_LINES[:3]))
        fh.write('{"v": 1, "pid": 1, "seq"')  # a torn tail
    with open(prof / "prof-8.ndjson", "w") as fh:
        fh.write(json.dumps(PROF_LINES[3]) + "\n")
    hist = tmp_path / "hist"
    hist.mkdir()
    monkeypatch.setenv("CCT_HISTORY_DIR", str(hist))
    monkeypatch.delenv("CCT_HISTORY_MAX_BYTES", raising=False)
    jax_history.reset_for_tests()
    try:
        jax_history.append_snapshot({"jobs_done": 5, "batches_dispatched": 2}, {"canary_ok": 1})
        time.sleep(0.01)
        jax_history.append_snapshot({"jobs_done": 9, "batches_dispatched": 2})
        time.sleep(0.01)
        jax_history.append_snapshot({"jobs_done": 12, "batches_dispatched": 7})
    finally:
        jax_history.reset_for_tests()
        monkeypatch.delenv("CCT_HISTORY_DIR")
    runs = tmp_path / "runs"
    for name, spectrum in (("a", ((1, 5), (3, 2))), ("b", ((1, 5), (2, 4)))):
        base = runs / name
        _fake_run(base, name, spectrum)
        jax_qc.write_qc(str(base / "qc.json"), jax_qc.collect_run(str(base), name))
    empty = tmp_path / "empty"
    empty.mkdir()
    return {"prof": str(prof), "history": str(hist), "runs": str(runs), "empty": str(empty)}


def _fake_run(base, name, spectrum):
    """tests/test_qc.py's run tree: only the sidecars ``collect_run`` reads."""
    for sub in ("sscs", "singleton", "dcs"):
        os.makedirs(base / sub, exist_ok=True)
    with open(base / "sscs" / f"{name}.read_families.txt", "w") as fh:
        fh.write("family_size\tcount\n" + "".join(f"{s}\t{c}\n" for s, c in spectrum))
    docs = {"sscs": ("sscs_stats", {"total_reads": 20, "families": 7, "singletons": 5,
                                    "sscs_written": 2, "bad_reads": 0}),
            "singleton": ("singleton_stats", {"rescued_by_sscs": 2, "rescued_by_singleton": 1,
                                              "remaining": 2, "singletons_total": 5}),
            "dcs": ("dcs_stats", {"pairs": 1, "sscs_total": 2, "sscs_unpaired": 0,
                                  "dcs_written": 1})}
    for sub, (suffix, doc) in docs.items():
        with open(base / sub / f"{name}.{suffix}.json", "w") as fh:
            json.dump(doc, fh)


# ------------------------------------------------------------ trace

def test_trace_export_and_fleet_equal_jax(daemon, offline, capsys, tmp_path):
    out = str(tmp_path / "t.json")
    ok, text, data = _both(["trace", "export", "--dir", daemon["trace"], "--out", out],
                           capsys, out)
    assert ok == "ok" and data and "exported" in text
    names = {e["name"] for e in json.loads(data)["traceEvents"]}
    assert {"serve.critpath", "device.dispatch", "serve.job"} <= names
    ok, text, data = _both(["trace", "fleet", "--dir", daemon["trace"], "--out", out,
                            "--port", "1"], capsys, out)
    assert ok == "ok" and data and "merged" in text


@pytest.mark.parametrize("argv", [["trace", "export"], ["trace", "fleet", "--port", "1"]])
def test_trace_refusals_equal_jax(offline, capsys, argv, fixture_dirs):
    if argv[1] == "fleet":
        argv = argv + ["--dir", fixture_dirs["empty"]]
    assert _both(argv, capsys)[0] == "exit"


# ------------------------------------------------------------ qc

def test_qc_report_and_diff_equal_jax(daemon, fixture_dirs, capsys, tmp_path):
    doc = str(tmp_path / "qc_out.json")
    runs, served = fixture_dirs["runs"], daemon["out"]
    for argv in (["qc", "report", served], ["qc", "report", runs, "--json", doc],
                 ["qc", "report", os.path.join(runs, "a", "qc.json")],
                 ["qc", "report", served, runs, os.path.join(runs, "missing")],
                 ["qc", "diff", os.path.join(runs, "a"), os.path.join(runs, "b"), "--json", doc],
                 ["qc", "diff", os.path.join(served, "j0"), os.path.join(served, "j1")],
                 ["qc", "diff", served, runs, "--json", doc]):
        ok, text, data = _both(argv, capsys, doc)
        assert ok == "ok" and text, argv
        assert (data is not None) == ("--json" in argv)
    # two served runs of one input: every rate delta is zero
    text = _both(["qc", "diff", os.path.join(served, "j0"), os.path.join(served, "j1"),
                  "--json", doc], capsys, doc)
    assert json.loads(text[2])["spectrum_tv"] == 0.0


@pytest.mark.parametrize("argv", [["qc", "report", "{empty}"], ["qc", "diff", "{runs}"],
                                  ["qc", "diff", "{runs}", "{empty}"],
                                  ["qc", "diff", "{runs}", "{runs}", "{runs}"]])
def test_qc_refusals_equal_jax(fixture_dirs, capsys, argv):
    argv = [a.format(**fixture_dirs) for a in argv]
    assert _both(argv, capsys)[0] == "exit"


# ------------------------------------------------------------ prof

@pytest.mark.parametrize("which", ["daemon", "fixture"])
def test_prof_report_and_flame_equal_jax(daemon, fixture_dirs, offline, capsys, tmp_path,
                                         which):
    shards = daemon["prof"] if which == "daemon" else fixture_dirs["prof"]
    base = ["--dir", shards, "--port", "1"]
    doc, flame = str(tmp_path / "attr.json"), str(tmp_path / "p.collapsed")
    ok, text, data = _both(["prof", "report", *base, "--json", doc], capsys, doc)
    assert ok == "ok" and text and data
    assert _both(["prof", "report", *base, "--top", "3"], capsys)[0] == "ok"
    ok, text, data = _both(["prof", "flame", *base, "--out", flame], capsys, flame)
    assert ok == "ok" and data
    # the flame file holds every merged sample
    assert f"({sum(int(ln.rsplit(' ', 1)[1]) for ln in data.decode().split(chr(10)) if ln)} " \
        "samples)" in text


def test_prof_refusal_equal_jax(fixture_dirs, offline, capsys):
    assert _both(["prof", "report", "--dir", fixture_dirs["empty"], "--port", "1"],
                 capsys)[0] == "exit"


# ------------------------------------------------------------ history

@pytest.mark.parametrize("which,metric", [("daemon", "batches_dispatched"),
                                          ("fixture", "jobs_done")])
def test_history_query_and_trend_equal_jax(daemon, fixture_dirs, offline, capsys, which,
                                           metric):
    shards = daemon["history"] if which == "daemon" else fixture_dirs["history"]
    base = ["--dir", shards, "--port", "1"]
    for extra in ([], ["--metric", metric], ["--last", "1"], ["--node", "w0"]):
        ok, text, _ = _both(["history", "query", *base, *extra], capsys)
        assert ok == "ok", extra
    ok, text, _ = _both(["history", "trend", *base, "--metric", metric], capsys)
    assert ok == "ok" and metric in text


@pytest.mark.parametrize("argv", [["history", "query", "--dir", "{empty}"],
                                  ["history", "trend", "--dir", "{history}"]])
def test_history_refusals_equal_jax(fixture_dirs, offline, capsys, argv):
    argv = [a.format(**fixture_dirs) for a in argv] + ["--port", "1"]
    assert _both(argv, capsys)[0] == "exit"


# ------------------------------------------------------------ the flags

def _parser_of(parser, command):
    return next(a for a in parser._actions if a.dest == "command").choices[command]


def _flags(parser, command):
    sub = _parser_of(parser, command)
    return {s for a in sub._actions for s in a.option_strings} | \
        {a.dest for a in sub._actions if not a.option_strings}


def _details(parser, command):
    sub = _parser_of(parser, command)
    actions = sorted((tuple(a.option_strings), a.dest, tuple(a.choices or ()),
                      getattr(a.type, "__name__", None), a.nargs, a.default, a.help)
                     for a in sub._actions if a.dest != "help")
    return actions, {k: sub.get_default(k)
                     for k in ("config_section", "required_args", "builtin_defaults")}


@pytest.mark.parametrize("command,extra", [(c, set()) for c in OBS_COMMANDS]
                         + [("consensus", {"--device"})])
def test_commands_take_every_jax_flag(command, extra):
    port = _flags(torch_cli.build_parser(), command)
    assert port == _flags(jax_cli.build_parser(), command) | extra


@pytest.mark.parametrize("command", OBS_COMMANDS)
def test_obs_commands_parse_as_jax(command):
    assert _details(torch_cli.build_parser(), command) == \
        _details(jax_cli.build_parser(), command)


# ------------------------------------------------------------ hygiene

def test_readers_run_without_jax_or_a_cuda_context(daemon):
    res = daemon["readers"]
    assert res["bad"] == [] and res["cuda_initialized"] is False
    rows = {" ".join(r["command"]): r for r in res["rows"]}
    assert [r["code"] for r in res["rows"]] == [0] * 6, res["rows"]
    assert "merged" in rows["trace fleet"]["out"]
    assert "terminal states: done=3" in rows["critpath report"]["out"]
    assert rows["prof report"]["out"]
    hist = [json.loads(ln) for ln in rows["history query"]["out"].splitlines()]
    assert hist and all("batches_dispatched" in json.dumps(ln) for ln in hist)
    frame = rows["top --once"]["out"]
    assert frame.startswith("cct top — unix:") and "qc:" in frame
    assert "ALL" in rows["qc report"]["out"]


# ------------------------------------------------------------ --backend

def test_consensus_backend_reads_as_the_device(tmp_path):
    bare = ["consensus", "-i", "a.bam", "-o", "o"]
    assert torch_cli.parse_args(bare + ["--backend", "tpu"]).device == "cuda"
    assert torch_cli.parse_args(bare + ["--backend", "xla_cpu"]).device == "cpu"
    assert torch_cli.parse_args(bare).device == "cuda"
    for backend in ("cpu", "reference"):
        # the host backends: no device, the backend carried beside it
        args = torch_cli.parse_args(bare + ["--backend", backend])
        assert (args.device, args.host_backend) == (None, backend)
        # --device wins over the flag
        args = torch_cli.parse_args(bare + ["--backend", backend, "--device", "cpu"])
        assert (args.device, args.host_backend) == ("cpu", None)
    assert torch_cli.parse_args(bare + ["--backend", "tpu", "--device", "cpu"]).device == "cpu"
    # the flag wins over a config key
    cfg = tmp_path / "c.ini"
    cfg.write_text("[consensus]\nbackend = reference\n")
    assert torch_cli.parse_args(bare + ["-c", str(cfg), "--backend", "xla_cpu"]).device == "cpu"
    with pytest.raises(SystemExit):  # argparse refuses what JAX refuses
        torch_cli.parse_args(bare + ["--backend", "gpu"])


def test_consensus_backend_tpu_without_a_card_raises_as_device_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    errors = {}
    for label, flags in (("backend", ["--backend", "tpu"]), ("device", ["--device", "cuda"])):
        with pytest.raises(RuntimeError) as exc:
            torch_cli.main(["consensus", "-i", SAMPLE, "-o", str(tmp_path / label), *flags])
        errors[label] = str(exc.value)
        assert not (tmp_path / label / "sample").exists()
    assert errors["backend"] == errors["device"] and "CUDA is not available" in errors["backend"]


def test_consensus_backend_xla_cpu_writes_the_goldens(tmp_path):
    torch_cli.main(["consensus", "-c", os.path.join(REPO, "config.ini"), "-i", SAMPLE,
                    "-o", str(tmp_path), "-n", "golden", "--backend", "xla_cpu"])
    assert golden_mismatches(str(tmp_path / "golden"), GOLDEN["consensus"]) == []
