"""The port's serve daemon against the JAX package's (CPU).

- **The gang.** ``test/data/sample.bam`` and two small ``simulate_bam``
  samples ganged through the port's ``gang_sscs`` (``device="cpu"``: B1
  dense's plain version) and the JAX package's ``gang_sscs``: every job's
  SSCS, singleton and bad-read records byte-equal (tags included), stats
  less backend lines, the sscs manifest params.
- **Served = one-shot.** The same three jobs through a paused
  ``Scheduler`` (one gang): every BAM of each served tree equals the
  port's one-shot ``consensus`` run record by record, the stats less
  backend lines and the manifest's stage list too; ``sample.bam`` holds
  the ``consensus`` goldens.  A served job's ``qc.json`` equals the JAX
  package's served ``qc.json`` — and, like it, has no vote plane: the gang
  votes with no QC plane sink, so a served ``qc.json`` differs from the
  one-shot one (whose plane the SSCS rider fills) in ``plane`` alone.
- **Resume skips the gang's stage.** No served job runs ``run_sscs``; a
  later ``consensus --resume`` of a served job skips sscs too.
- **The streaming hand-off.** A ``pipeline: streaming`` job in a gang
  finishes from the gang's in-memory SSCS, and its finals equal the
  one-shot streaming run's.
- **Daemon round trip.** ``Scheduler`` + ``ServeServer`` + ``ServeClient``
  over a unix socket: ``sample.bam`` holds the goldens; healthz and the
  Prometheus text answer.
- **Policy and result cache.** A gang mixing policies refuses; a gang's
  policy reaches the vote explicitly; ``result_cache=`` given a root opens
  that cache plane (``test_torch_result_cache.py`` holds the cache).
"""

import json
import os

import pytest

from consensuscruncher_tpu.serve import scheduler as jax_sched
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.ops import consensus_dense
from consensuscruncher_tpu_torch.serve import scheduler as torch_sched
from consensuscruncher_tpu_torch.serve.client import ServeClient
from consensuscruncher_tpu_torch.serve.result_cache import ResultCache
from consensuscruncher_tpu_torch.serve.server import ServeServer
from consensuscruncher_tpu_torch.stages import sscs_maker
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches
from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")
SAMPLE = os.path.join(DATA, "sample.bam")
with open(os.path.join(REPO, "test", "golden.json")) as _fh:
    GOLDEN = json.load(_fh)


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


def _no_backend(path):
    with open(path) as fh:
        return [ln for ln in fh if "backend" not in ln]


def _stages(base):
    with open(os.path.join(base, "manifest.json")) as fh:
        return json.load(fh)["stages"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """sample.bam and two small simulated samples (<= 2,000 fragments)."""
    d = tmp_path_factory.mktemp("serve_inputs")
    paths = [SAMPLE]
    for seed, n in ((5, 400), (9, 300)):
        p = str(d / f"sim{seed}.bam")
        simulate_bam(p, SimConfig(n_fragments=n, seed=seed))
        paths.append(p)
    return paths


def _spec(inp, out, **over):
    spec = {"input": inp, "output": str(out), "cutoff": 0.7, "qualscore": 0,
            "scorrect": True, "max_mismatch": 0, "bdelim": "|", "compress_level": 6}
    spec.update(over)
    return spec


def _name(inp):
    """The run name: ``golden`` for sample.bam (the goldens' tree name)."""
    return "golden" if inp == SAMPLE else os.path.basename(inp).split(".")[0]


def _one_shot(inp, out, *extra):
    torch_cli.main(["consensus", "-i", inp, "-o", str(out), "-n", _name(inp),
                    "--device", "cpu", *extra])
    return os.path.join(str(out), _name(inp))


def test_gang_sscs_records_equal_jax(tmp_path, inputs):
    port = [_spec(p, tmp_path / "port") for p in inputs]
    ref = [_spec(p, tmp_path / "jax") for p in inputs]
    handoffs = torch_sched.gang_sscs(port, max_batch=64, device="cpu")
    jax_sched.gang_sscs(ref, max_batch=64)
    assert handoffs == [None, None, None]
    for p in inputs:
        name = os.path.basename(p).split(".")[0]
        got = torch_sched.job_paths(_spec(p, tmp_path / "port"))
        want = torch_sched.job_paths(_spec(p, tmp_path / "jax"))
        for k in ("sscs", "singleton", "bad"):
            assert _records(got["sscs"][k]) == _records(want["sscs"][k]), (name, k)
        assert _records(got["sscs"]["sscs"])[1:], name  # families were voted
        for k in ("stats_txt", "families"):
            assert _no_backend(got["sscs"][k]) == _no_backend(want["sscs"][k]), (name, k)
        g, w = _stages(got["base"])["sscs"], _stages(want["base"])["sscs"]
        assert g["params"] == w["params"]


def test_served_jobs_equal_one_shot_runs(tmp_path, inputs, monkeypatch):
    calls = []
    real_run_sscs = sscs_maker.run_sscs
    monkeypatch.setattr(torch_cli, "run_sscs",
                        lambda *a, **k: calls.append(a) or real_run_sscs(*a, **k))
    sched = torch_sched.Scheduler(paused=True, device="cpu", gang_size=4)
    jobs = [sched.submit(_spec(p, tmp_path / "served", name=_name(p))) for p in inputs]
    sched.release()
    for job in jobs:
        sched.wait(job.id, timeout=300)
        assert job.state == "done", job.error
        assert job.gang_size == 3
    assert calls == []  # the gang ran every job's SSCS stage
    doc = sched.metrics()
    assert doc["cumulative"]["batches_dispatched"] > 0
    sched.close()
    monkeypatch.setattr(torch_cli, "run_sscs", real_run_sscs)
    for p in inputs:
        served = torch_sched.job_paths(_spec(p, tmp_path / "served", name=_name(p)))["base"]
        one = _one_shot(p, tmp_path / "one")
        assert _bams(served) == _bams(one)
        for rel in _bams(one):
            assert _records(os.path.join(served, rel)) == _records(os.path.join(one, rel)), rel
        for sub, suffix in (("sscs", "sscs_stats.txt"), ("singleton", "singleton_stats.txt"),
                            ("dcs", "dcs_stats.txt"), ("sscs", "read_families.txt")):
            name = os.path.basename(one)
            rel = os.path.join(sub, f"{name}.{suffix}")
            assert _no_backend(os.path.join(served, rel)) == _no_backend(os.path.join(one, rel))
        assert sorted(_stages(served)) == sorted(_stages(one))
        assert _stages(served)["sscs"]["params"] == _stages(one)["sscs"]["params"]
    assert golden_mismatches(str(tmp_path / "served" / "golden"), GOLDEN["consensus"]) == []


def test_served_qc_json_equals_jax_served(tmp_path, inputs):
    """Both packages' daemons write a served job's qc.json with no vote
    plane (the gang arms no plane sink and --resume skips the SSCS rider);
    everything else equals the one-shot doc."""
    specs = inputs[:2]
    port = torch_sched.Scheduler(paused=True, device="cpu")
    ref = jax_sched.Scheduler(paused=True, backend="tpu")
    pj = [port.submit(_spec(p, tmp_path / "port")) for p in specs]
    rj = [ref.submit(_spec(p, tmp_path / "jax")) for p in specs]
    port.release()
    ref.release()
    for sched, jobs in ((port, pj), (ref, rj)):
        for job in jobs:
            sched.wait(job.id, timeout=300)
            assert job.state == "done", job.error
        sched.close()
    for p in specs:
        name = os.path.basename(p).split(".")[0]
        docs = []
        for root in ("port", "jax"):
            with open(tmp_path / root / name / "qc.json") as fh:
                docs.append(json.load(fh))
        assert docs[0] == docs[1], name
        assert docs[0]["plane"] is None
        torch_cli.main(["consensus", "-i", p, "-o", str(tmp_path / "one"), "--device", "cpu"])
        with open(tmp_path / "one" / name / "qc.json") as fh:
            want = json.load(fh)
        assert want["plane"] is not None
        assert {k: v for k, v in docs[0].items() if k != "plane"} == \
            {k: v for k, v in want.items() if k != "plane"}
    assert pj[0].qc == rj[0].qc and pj[0].qc["yields"]["sscs_written"] > 0


def test_resume_of_a_served_job_skips_sscs(tmp_path, inputs, monkeypatch, capsys):
    torch_sched.gang_sscs([_spec(p, tmp_path, name=_name(p)) for p in inputs[:2]], device="cpu")
    calls = []
    monkeypatch.setattr(consensus_dense, "consensus_families",
                        lambda *a, **k: calls.append(1) or iter(()))
    monkeypatch.setattr(torch_cli, "run_sscs",
                        lambda *a, **k: calls.append(2) or pytest.fail("sscs re-ran"))
    torch_cli.main(["consensus", "-i", SAMPLE, "-o", str(tmp_path), "-n", "golden",
                    "--device", "cpu", "--resume", "True"])
    assert calls == []
    assert "resume — skipping sscs" in capsys.readouterr().out
    assert golden_mismatches(str(tmp_path / "golden"), GOLDEN["consensus"]) == []


def test_gang_and_cli_record_one_manifest_entry(tmp_path, inputs, monkeypatch, capsys):
    """The gang records each job's sscs entry through
    ``sscs_maker.manifest_entry``, the function the CLI records and checks
    the stage with: called with the job's argv values, the entries agree
    (a non-default policy too), and the job's ``--resume`` skips sscs."""
    seen = []
    real = sscs_maker.manifest_entry
    monkeypatch.setattr(sscs_maker, "manifest_entry",
                        lambda *a: seen.append(a) or real(*a))
    specs = [_spec(p, tmp_path, policy="delegation") for p in inputs[1:]]
    torch_sched.gang_sscs(specs, device="cpu")
    gang_args = seen[0]
    argv = torch_sched.Scheduler(start=False, device="cpu")._argv(specs[0], resume=True)
    torch_cli.main(argv)
    assert "resume — skipping sscs" in capsys.readouterr().out
    assert seen[-1] == gang_args and len(seen) == 3
    entry = _stages(torch_sched.job_paths(specs[0])["base"])["sscs"]
    assert entry["params"] == real(*gang_args)[2]
    assert entry["params"]["policy"] == "delegation"


def test_streaming_job_continues_from_the_gang_handoff(tmp_path, inputs, monkeypatch):
    seen = []
    real_main = torch_cli.main

    def spy(argv=None, _sscs_handoff=None):
        seen.append(_sscs_handoff is not None)
        return real_main(argv, _sscs_handoff=_sscs_handoff)

    monkeypatch.setattr(torch_cli, "main", spy)
    sched = torch_sched.Scheduler(paused=True, device="cpu")
    jobs = [sched.submit(_spec(SAMPLE, tmp_path / "served", name="golden",
                               pipeline="streaming")),
            sched.submit(_spec(inputs[1], tmp_path / "served"))]
    sched.release()
    for job in jobs:
        sched.wait(job.id, timeout=300)
        assert job.state == "done", job.error
    sched.close()
    assert seen == [True, False]
    monkeypatch.setattr(torch_cli, "main", real_main)
    one = _one_shot(SAMPLE, tmp_path / "one", "--pipeline", "streaming")
    served = os.path.join(str(tmp_path / "served"), "golden")
    for rel in ("all_unique/golden.all.unique.sscs.bam", "all_unique/golden.all.unique.dcs.bam",
                "dcs/golden.dcs.sorted.bam", "sscs/golden.sscs.sorted.bam"):
        assert _records(os.path.join(served, rel)) == _records(os.path.join(one, rel)), rel
    with open(os.path.join(served, "run.metrics.json")) as fh:
        assert json.load(fh)["pipeline"] == "streaming"
    assert golden_mismatches(served, {k: v for k, v in GOLDEN["consensus"].items()
                                      if "all_unique" in k}) == []


def test_daemon_round_trip_holds_goldens(tmp_path):
    sched = torch_sched.Scheduler(queue_bound=8, gang_size=4, device="cpu")
    sock = str(tmp_path / "d.sock")
    server = ServeServer(sched, socket_path=sock)
    server.start()
    try:
        client = ServeClient(sock)
        assert client.healthz()["status"] == "serving"
        sub = client.submit_full(_spec(SAMPLE, tmp_path, name="golden"))
        job = client.result(key=sub["key"], timeout=300)
        assert job["state"] == "done", job.get("error")
        assert job["outputs"]["base"] == str(tmp_path / "golden")
        assert golden_mismatches(str(tmp_path / "golden"), GOLDEN["consensus"]) == []
        again = client.submit_full(_spec(SAMPLE, tmp_path, name="golden"))
        assert again["key"] == sub["key"] and again.get("duplicate")
        text = client.metrics_prometheus()
        assert "cct_families_out_total" in text and "cct_queue_wait_s_bucket" in text
        assert client.metrics()["cumulative"]["families_out"] > 0
    finally:
        server.close()
        sched.close(timeout=120)


def test_gang_policy_is_explicit_and_shared(tmp_path, inputs, monkeypatch):
    with pytest.raises(ValueError, match="share a vote policy"):
        torch_sched.gang_sscs([_spec(inputs[1], tmp_path),
                               _spec(inputs[2], tmp_path, policy="delegation")], device="cpu")
    got = []
    real = consensus_dense.consensus_families

    def spy(families, config, device, **kw):
        got.append(kw["policy"].name)
        return real(families, config, device, **kw)

    monkeypatch.setattr(consensus_dense, "consensus_families", spy)
    torch_sched.gang_sscs([_spec(p, tmp_path, policy="delegation") for p in inputs[1:]],
                          device="cpu")
    assert got == ["delegation"]
    params = _stages(torch_sched.job_paths(_spec(inputs[1], tmp_path))["base"])["sscs"]["params"]
    assert params["policy"] == "delegation"
    cached = torch_sched.Scheduler(start=False, device="cpu", node="w3",
                                   result_cache=str(tmp_path / "plane"))
    assert isinstance(cached.result_cache, ResultCache)
    assert (cached.result_cache.root, cached.result_cache.node) == (str(tmp_path / "plane"), "w3")
    assert os.path.isdir(tmp_path / "plane" / "w3")
    cached.close(timeout=10)
    with pytest.raises(ValueError, match="device"):
        torch_sched.Scheduler(start=False, device="tpu")


def test_gang_trace_names_every_job_of_a_shared_batch(tmp_path, inputs, monkeypatch):
    """With tracing on, a gang's shared dense batch is a ``device.batch``
    event naming the trace id of every job whose families rode it, each
    dispatch a ``device.dispatch`` span feeding ``device_dispatch_s``, and
    ``serve.gang_batches`` counts fewer batches than the same jobs fill
    when each is ganged alone (and no launch: the CPU runs the plain
    version)."""
    from consensuscruncher_tpu_torch.obs import metrics as obs_metrics
    from consensuscruncher_tpu_torch.obs import trace as obs_trace

    monkeypatch.setenv("CCT_TRACE", "1")
    monkeypatch.delenv("CCT_TRACE_DIR", raising=False)
    obs_trace.drain_events()
    before = obs_metrics.histograms_snapshot()["device_dispatch_s"]["count"]
    ids = ["ta", "tb", "tc"]
    torch_sched.gang_sscs([_spec(p, tmp_path) for p in inputs], max_batch=1024,
                          trace_ids=ids, device="cpu")
    events = obs_trace.drain_events()
    batches = [e for e in events if e["name"] == "device.batch"]
    dispatches = [e for e in events if e["name"] == "device.dispatch"]
    assert batches and len(dispatches) == len(batches)
    assert any(len(e["args"]["trace_ids"]) >= 2 for e in batches)
    assert obs_metrics.histograms_snapshot()["device_dispatch_s"]["count"] == \
        before + len(batches)
    (gang,) = [e for e in events if e["name"] == "serve.gang_batches"]
    commits = [e for e in events if e["name"] == "writer.commit"]
    assert sorted(e["args"]["trace_id"] for e in commits) == ids
    alone = []
    for i, p in enumerate(inputs):
        torch_sched.gang_sscs([_spec(p, tmp_path / f"alone{i}")], max_batch=1024,
                              trace_ids=[ids[i]], device="cpu")
        (solo,) = [e for e in obs_trace.drain_events() if e["name"] == "serve.gang_batches"]
        alone.append(solo["args"])
    assert gang["args"]["batches"] == len(batches) < sum(a["batches"] for a in alone)
    assert gang["args"]["launches"] == 0
    assert gang["args"]["families"] == [a["families"][0] for a in alone]


def test_job_argv_names_the_device():
    sched = torch_sched.Scheduler(start=False, device="cpu")
    argv = sched._argv(_spec(SAMPLE, "/o", name="n", pipeline="streaming"), resume=True)
    assert argv[argv.index("--device") + 1] == "cpu" and "--backend" not in argv
    assert argv[-2:] == ["--resume", "True"] and "--pipeline" in argv
    args = torch_cli.parse_args(argv)  # the port's CLI takes every flag
    assert (args.device, args.pipeline, args.name) == ("cpu", "streaming", "n")
    assert torch_cli.parse_args(["serve", "--backend", "xla_cpu"]).device == "cpu"
    assert torch_cli.parse_args(["serve", "--backend", "tpu"]).device == "cuda"
    with pytest.raises(SystemExit):
        torch_cli.parse_args(["serve", "--backend", "reference"])


def test_compile_cache_is_the_build_directory(tmp_path, monkeypatch):
    from consensuscruncher_tpu_torch.ops import cuda_lib
    from consensuscruncher_tpu_torch.serve import warmup

    monkeypatch.setattr(cuda_lib, "BUILD_DIR", cuda_lib.BUILD_DIR)
    assert warmup.setup_compilation_cache(str(tmp_path / "cache"))
    assert cuda_lib.library_path("consensus_vote").startswith(str(tmp_path / "cache") + os.sep)
    # warm launches on the CPU run B1 dense's plain version once per shape
    assert warmup.warm_shapes([(8, 4, 96), (16, 2, 128)], device="cpu") == 2
    assert warmup.warm_shapes([warmup.LIBRARY_WARM_SHAPE], device="cpu") == 1


def test_autotune_backend_is_refused_before_the_socket(tmp_path, capsys):
    """The JAX package's ``[autotune] backend`` picks a kernel per bucket;
    the port has one, so ``serve`` refuses the key (naming A11) before it
    binds its socket, and names the bucket-table keys as ignored."""
    sock = tmp_path / "d.sock"
    cfg = tmp_path / "c.ini"
    cfg.write_text("[autotune]\nbackend = dense\n")
    with pytest.raises(SystemExit, match="A11"):
        torch_cli.main(["serve", "-c", str(cfg), "--device", "cpu", "--socket", str(sock)])
    assert not sock.exists()
    cfg.write_text("[autotune]\ntable = t.json\nlearn_window = 5\n")
    with pytest.raises(ValueError, match="bad warmup shape"):
        torch_cli.main(["serve", "-c", str(cfg), "--device", "cpu", "--socket", str(sock),
                        "--warmup_shapes", "0x1x1"])
    assert "config [autotune] learn_window, table: ignored" in capsys.readouterr().err
    assert not sock.exists()
