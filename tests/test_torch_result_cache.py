"""The port's content-addressed result cache against the JAX package's (CPU).

- **Identity.** ``content_digest`` gives the JAX package's value on the
  same spec: routing fields left out, vote parameters, the name,
  ``input_range`` and a non-default policy folded in, a missing input
  None; the daemon's breaker fingerprint follows it.
- **Store.** The same payload inserted by both packages gives the same
  entry docs, and each package reads the other's plane; eviction, the
  ``serve.cache`` fault, the integrity quarantine and ``scrub`` behave as
  in the JAX package; ``cache scrub`` on a corrupted entry exits 1 in both
  CLIs.
- **Daemon.** A job answered from the cache costs no gang vote and its
  tree equals a fresh recompute byte for byte (the goldens too); the shed
  bypass admits a cached spec a forced shed refuses; the ENOSPC first
  responder evicts and retries; the router answers a cached submit
  without the fleet, as the JAX router does.
- **Host workers.** ``consensus --host_workers 2 --result_cache`` takes a
  range cached negative from the plane instead of running its worker, and
  its tree equals the JAX CLI's doing the same.
"""

import json
import os
import shutil

import pytest

from consensuscruncher_tpu import cli as jax_cli
from consensuscruncher_tpu.parallel import hostshard as jax_hostshard
from consensuscruncher_tpu.serve import journal as jax_journal
from consensuscruncher_tpu.serve import result_cache as jax_rc
from consensuscruncher_tpu.serve import router as jax_router
from consensuscruncher_tpu.serve import scheduler as jax_sched
from consensuscruncher_tpu_torch import __version__
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.ops import consensus_dense
from consensuscruncher_tpu_torch.parallel import hostshard
from consensuscruncher_tpu_torch.serve import journal as torch_journal
from consensuscruncher_tpu_torch.serve import result_cache as torch_rc
from consensuscruncher_tpu_torch.serve import router as torch_router
from consensuscruncher_tpu_torch.serve import scheduler as torch_sched
from consensuscruncher_tpu_torch.serve.client import ServeClient
from consensuscruncher_tpu_torch.serve.server import ServeServer
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches
from consensuscruncher_tpu_torch.utils.profiling import Counters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "test", "data")
SAMPLE = os.path.join(DATA, "sample.bam")
ADVERSARIAL = os.path.join(DATA, "sample_adversarial.bam")
with open(os.path.join(REPO, "test", "golden.json")) as _fh:
    GOLDEN = json.load(_fh)

RC = {"jax": jax_rc, "port": torch_rc}


def _spec(output, name="golden", **over):
    spec = {"input": SAMPLE, "output": str(output), "name": name, "cutoff": 0.7,
            "qualscore": 0, "scorrect": True, "max_mismatch": 0, "bdelim": "|",
            "compress_level": 6}
    spec.update(over)
    return spec


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _files(base, suffix=""):
    return sorted(os.path.relpath(os.path.join(root, f), base)
                  for root, _dirs, files in os.walk(base)
                  for f in files if f.endswith(suffix))


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _no_backend(path):
    with open(path) as fh:
        return [ln for ln in fh if "backend" not in ln]


def _make_payload(base, files):
    for rel, data in files.items():
        p = os.path.join(str(base), rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as fh:
            fh.write(data)


def _doc(entry):
    """An entry doc without what differs between two inserts: its time
    and where it lives."""
    return {k: v for k, v in entry.items() if k not in ("t", "dir")}


# ------------------------------------------------------------- identity

@pytest.mark.parametrize("over", [
    {}, {"tenant": "t2", "qos": "batch", "deadline_s": 5}, {"output": "/elsewhere"},
    {"cutoff": 0.8}, {"qualscore": 30}, {"scorrect": False}, {"name": "other"},
    {"input_range": "voff:0:100"}, {"policy": "delegation"}, {"policy": "majority"},
    {"input": ADVERSARIAL}, {"name": None}, {"compress_level": 1, "bdelim": ":"},
], ids=lambda o: ",".join(sorted(o)) or "base")
def test_content_digest_equals_jax(tmp_path, over):
    spec = {**_spec(tmp_path / "a"), **over}
    got = torch_rc.content_digest(spec)
    assert got == jax_rc.content_digest(spec)
    assert got is not None and len(got) == 32
    base = torch_rc.content_digest(_spec(tmp_path / "a"))
    routing = {"tenant", "qos", "deadline_s", "output"}
    # a name of None derives the input's stem, which is not "golden"
    assert (got == base) == (set(over) <= routing)
    assert __version__ == "0.1.0"


def test_missing_input_digests_to_none_in_both(tmp_path):
    for spec in (_spec(tmp_path, input=str(tmp_path / "gone.bam")), {"output": "x"}):
        assert torch_rc.content_digest(spec) is None
        assert jax_rc.content_digest(spec) is None
    fault_spec = _spec(tmp_path, input=str(tmp_path / "gone.bam"), tenant="t")
    for spec in (_spec(tmp_path / "o", tenant="t"), fault_spec):
        assert torch_sched.Scheduler._fault_domain(spec, "t") == \
            jax_sched.Scheduler._fault_domain(spec, "t")
    assert torch_sched.Scheduler._fault_domain(fault_spec, "t") == \
        f"t:{tmp_path / 'gone.bam'}"


# ---------------------------------------------------------------- store

def test_store_round_trip_equals_jax_and_planes_interchange(tmp_path):
    files = {"golden/sscs/x.bam": b"\x1f\x8b" + bytes(range(256)),
             "golden/sscs/x.txt": b"families_out\t3\n",
             "golden/plots/x.png": bytes(range(64))}
    src = tmp_path / "job_out"
    _make_payload(src, files)
    entries = {}
    for pkg, mod in RC.items():
        rc = mod.ResultCache(str(tmp_path / f"plane_{pkg}"), node="w0")
        entries[pkg] = rc.insert("ab" * 16, str(src), meta={"key": "k1"})
        assert rc.insert("ab" * 16, str(src))["t"] == entries[pkg]["t"]  # idempotent
        assert os.path.exists(os.path.join(entries[pkg]["dir"], mod.ENTRY_NAME))
        assert rc.lookup("cd" * 16) is None
    assert _doc(entries["port"]) == _doc(entries["jax"])
    # each package reads (and materializes) the other's plane: one layout
    for reader, writer in (("port", "jax"), ("jax", "port")):
        rc = RC[reader].ResultCache(str(tmp_path / f"plane_{writer}"), node="w1")
        found = rc.lookup("ab" * 16, preferred_shard="w0")
        assert found is not None and found["shard"] == "w0"
        dest = tmp_path / f"{reader}_from_{writer}"
        assert rc.materialize(found, str(dest)) == entries[writer]["bytes"]
        for rel, data in files.items():
            assert _read(os.path.join(str(dest), rel)) == data, rel
    assert _files(str(tmp_path / "plane_port")) == _files(str(tmp_path / "plane_jax"))


def test_eviction_fault_and_negative_entries_equal_jax(tmp_path, monkeypatch):
    out = {}
    for pkg, mod in RC.items():
        rc = mod.ResultCache(str(tmp_path / pkg / "plane"), node="w0", max_bytes=300)
        for i in range(4):
            src = tmp_path / pkg / f"o{i}"
            _make_payload(src, {"f.bin": bytes([i]) * 128})
            assert rc.insert(f"{i:02d}" * 16, str(src), negative=i == 3) is not None
        evicted = [e["digest"][:2] for e in rc.evict_to_budget()]
        stats = rc.shard_stats()
        negative = rc.lookup("03" * 16)["negative"]
        monkeypatch.setenv("CCT_FAULTS", "serve.cache=fail@2")
        faulted = (rc.lookup("03" * 16), rc.insert("ff" * 16, str(tmp_path / pkg / "o0")))
        monkeypatch.delenv("CCT_FAULTS")
        after = (rc.lookup("03" * 16) is not None,
                 rc.insert("ff" * 16, str(tmp_path / pkg / "o0")) is not None)
        emergency = [e["digest"][:2] for e in rc.evict_to_budget(emergency=True)]
        out[pkg] = (evicted, stats, negative, faulted, after, emergency)
    assert out["port"] == out["jax"]
    assert out["port"][:3] == (["00", "01"], {"entries": 2, "bytes": 256}, True)
    assert out["port"][3:5] == ((None, None), (True, True))


def test_integrity_quarantine_and_scrub_equal_jax(tmp_path, capfd):
    out = {}
    for pkg, mod in RC.items():
        src = tmp_path / pkg / "o"
        _make_payload(src, {"f.bin": b"k" * 32})
        counters = Counters()
        rc = mod.ResultCache(str(tmp_path / pkg / "plane"), node="w0", counters=counters)
        rc.insert("aa" * 16, str(src))
        corrupt = rc.insert("bb" * 16, str(src))
        legacy = rc.insert("cc" * 16, str(src))
        bad = rc.insert("dd" * 16, str(src))
        for e in (corrupt, bad):
            with open(os.path.join(e["dir"], "payload", "f.bin"), "wb") as fh:
                fh.write(b"x" * 32)
        epath = os.path.join(legacy["dir"], mod.ENTRY_NAME)
        with open(epath) as fh:
            doc = json.load(fh)
        for f in doc["files"]:
            del f["sha256"]
        with open(epath, "w") as fh:
            json.dump(doc, fh)
        miss = rc.lookup("dd" * 16)  # integrity: a counted miss, quarantined
        report = rc.scrub()
        report["quarantined"] = [{k: v for k, v in q.items() if k != "moved_to"}
                                 for q in report["quarantined"]]
        out[pkg] = (miss, report, counters.snapshot().get("cache_integrity_misses"),
                    sorted(os.listdir(tmp_path / pkg / "plane" / mod.QUARANTINE_DIR)),
                    rc.scrub()["entries"])
    capfd.readouterr()
    assert out["port"] == out["jax"]
    miss, report, integrity, moved, left = out["port"]
    assert miss is None and integrity == 2 and left == 2
    assert (report["entries"], report["intact"], report["legacy"], report["corrupt"]) == \
        (3, 1, 1, 1)
    assert moved == ["w0-" + "bb" * 16, "w0-" + "dd" * 16]


def test_cache_scrub_cli_exits_one_on_corruption_in_both(tmp_path, capsys):
    src = tmp_path / "o"
    _make_payload(src, {"golden/x.bam": b"\x1f\x8b" + b"A" * 64})
    for pkg, mod, main in (("port", torch_rc, torch_cli.main), ("jax", jax_rc, jax_cli.main)):
        plane = str(tmp_path / f"plane_{pkg}")
        entry = mod.ResultCache(plane, node="w0").insert("ab" * 16, str(src))
        report = tmp_path / f"{pkg}.json"
        with pytest.raises(SystemExit) as clean:
            main(["cache", "scrub", "--result_cache", plane])
        assert clean.value.code == 0, pkg
        with open(os.path.join(entry["dir"], "payload", "golden", "x.bam"), "r+b") as fh:
            fh.seek(10)
            fh.write(b"Z")
        with pytest.raises(SystemExit) as dirty:
            main(["cache", "scrub", "--result_cache", plane, "--json", str(report)])
        assert dirty.value.code == 1, pkg
        with open(report) as fh:
            assert json.load(fh)["corrupt"] == 1
        assert "1 corrupt" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="is not a directory"):
        torch_cli.main(["cache", "scrub", "--result_cache", str(tmp_path / "none")])


# ------------------------------------------------------------ scheduler

def test_cache_hit_equals_a_fresh_recompute(tmp_path, monkeypatch):
    """Two tenants ask one question: the first computes, the second is
    copied from the plane with no gang vote; both trees hold the goldens,
    the hit's files are the first tree's bytes, and its BAMs are a fresh
    one-shot recompute's bytes."""
    votes = []
    real = consensus_dense.consensus_families

    def spy(*a, **k):
        votes.append(1)
        return real(*a, **k)

    monkeypatch.setattr(consensus_dense, "consensus_families", spy)
    calls = []
    real_run_job = torch_sched.Scheduler._run_job
    monkeypatch.setattr(torch_sched.Scheduler, "_run_job",
                        lambda self, job: calls.append(job.id) or real_run_job(self, job))
    sched = torch_sched.Scheduler(queue_bound=8, gang_size=4, device="cpu",
                                  result_cache=str(tmp_path / "plane"))
    server = ServeServer(sched, socket_path=str(tmp_path / "d.sock"))
    server.start()
    try:
        client = ServeClient(str(tmp_path / "d.sock"))
        job1 = client.run(_spec(tmp_path / "first"), timeout=600)
        n_votes, n_runs = len(votes), len(calls)
        job2 = client.run(_spec(tmp_path / "second", tenant="other"), timeout=600)
    finally:
        server.close()
        sched.close(timeout=120)
    assert job1["state"] == "done" and job1["cached"] is False
    assert job2["state"] == "done" and job2["cached"] is True
    assert (len(votes), len(calls)) == (n_votes, n_runs) == (0, 1)  # solo: no gang
    snap = sched.counters.snapshot()
    assert (snap["cache_inserts"], snap["cache_hits"], snap["cache_misses"]) == (1, 1, 1)
    assert snap["cache_bytes"] > 0
    first, second = tmp_path / "first" / "golden", tmp_path / "second" / "golden"
    for base in (first, second):
        assert golden_mismatches(str(base), GOLDEN["consensus"]) == []
    assert _files(str(second)) == _files(str(first))
    for rel in _files(str(first)):
        assert _read(second / rel) == _read(first / rel), rel
    torch_cli.main(["consensus", "-i", SAMPLE, "-o", str(tmp_path / "fresh"), "-n", "golden",
                    "--device", "cpu"])
    fresh = tmp_path / "fresh" / "golden"
    assert _files(str(second), ".bam") == _files(str(fresh), ".bam")
    for rel in _files(str(fresh), ".bam"):
        assert _read(second / rel) == _read(fresh / rel), rel


def _sched(pkg, **kw):
    if pkg == "port":
        return torch_sched.Scheduler(device="cpu", **kw)
    return jax_sched.Scheduler(backend="tpu", **kw)


def _seeded_plane(tmp_path, mod, spec, node="w0"):
    src = tmp_path / "producer_out"
    _make_payload(src, {"sscs/golden.bam": b"BAM" + bytes(range(64)),
                        "sscs/golden.txt": b"stats\n"})
    plane = str(tmp_path / "plane")
    digest = mod.content_digest(spec)
    assert mod.ResultCache(plane, node=node).insert(digest, str(src)) is not None
    return plane, digest


def test_shed_bypass_admits_a_cached_spec_as_jax_does(tmp_path, monkeypatch):
    out = {}
    for pkg, mod in RC.items():
        d = tmp_path / pkg
        cached = _spec(d / "c")
        plane, _ = _seeded_plane(d, mod, cached)
        sched = _sched(pkg, start=False, paused=True, result_cache=plane)
        try:
            monkeypatch.setenv("CCT_FAULTS", "serve.shed=fail@2")
            job, created = sched.submit_info(cached)
            with pytest.raises(jax_sched.DeadlineShed if pkg == "jax"
                               else torch_sched.DeadlineShed):
                sched.submit_info(_spec(d / "u", cutoff=0.9))
            monkeypatch.delenv("CCT_FAULTS")
            snap = sched.counters.snapshot()
            out[pkg] = (created, job.state, snap.get("cache_shed_bypass"),
                        snap.get("jobs_shed"))
        finally:
            sched.shutdown()
    assert out["port"] == out["jax"] == (True, "queued", 1, 1)


class _FullJournal:
    """A journal whose appends fail with ENOSPC ``fails`` times."""

    def __init__(self, real, fails):
        self.real, self.fails, self.path = real, fails, real.path

    def append(self, rec):
        if self.fails:
            self.fails -= 1
            raise OSError(28, "No space left on device")
        return self.real.append(rec)

    def __getattr__(self, name):
        return getattr(self.real, name)


def test_enospc_evicts_the_cache_then_retries_as_jax_does(tmp_path):
    out = {}
    for pkg, mod in RC.items():
        d = tmp_path / pkg
        plane = str(d / "plane")
        cache = mod.ResultCache(plane, node="w0")
        for i in range(4):
            _make_payload(d / f"o{i}", {"f.txt": f"entry {i}\n".encode()})
            assert cache.insert(f"{i:02d}" * 16, str(d / f"o{i}")) is not None
        journal_mod = torch_journal if pkg == "port" else jax_journal
        real = journal_mod.Journal(str(d / "wal"))
        sched = _sched(pkg, start=False, paused=True, result_cache=plane, node="w0",
                       journal=_FullJournal(real, fails=1))
        try:
            job = sched.submit(_spec(d / "a"))
            sched._journal = _FullJournal(real, fails=2)
            with pytest.raises(jax_sched.BrownoutRefused if pkg == "jax"
                               else torch_sched.BrownoutRefused):
                sched.submit(_spec(d / "b"))
            snap = sched.counters.snapshot()
            out[pkg] = (job.state, snap.get("cache_evictions"), snap.get("brownout_refusals"),
                        mod.ResultCache(plane, node="w0").shard_stats()["entries"])
        finally:
            sched.shutdown()
            real.close()
    # one emergency sweep (the oldest half) let the first append through;
    # the second sweep (one more entry) could not: brownout
    assert out["port"] == out["jax"] == ("queued", 3, 1, 1)


def test_job_is_negative_reads_the_sidecar_as_jax_does(tmp_path):
    for pkg, sched_mod in (("port", torch_sched), ("jax", jax_sched)):
        sched = _sched(pkg, start=False, paused=True)
        try:
            spec = _spec(tmp_path / pkg, name="neg")
            job = sched_mod.Job(spec, key="k")
            p = sched_mod.job_paths(spec)
            os.makedirs(p["dirs"]["sscs"], exist_ok=True)
            seen = []
            for cum in ({"families_out": 0}, {"families_out": 12}, None):
                if cum is None:
                    os.unlink(p["sscs_prefix"] + ".metrics.json")
                else:
                    with open(p["sscs_prefix"] + ".metrics.json", "w") as fh:
                        json.dump({"cumulative": cum}, fh)
                seen.append(sched._job_is_negative(job))
            assert seen == [True, False, False], pkg
        finally:
            sched.close(timeout=10)


# --------------------------------------------------------------- router

class _DarkFleet:
    """Stub members that record submits — a cache answer must never
    produce one."""

    def __init__(self, names, key_fn):
        self.submits, self.names, self.key_fn = [], list(names), key_fn

    def client(self, name):
        fleet = self

        class _Client:
            address = name

            def request(self, doc, timeout=None):
                if doc["op"] == "healthz":
                    return {"ok": True, "health": {"queued": 0, "running": 0,
                                                   "status": "serving"}}
                if doc["op"] == "submit":
                    fleet.submits.append((name, doc["spec"]))
                    return {"ok": True, "job_id": 1, "key": fleet.key_fn(doc["spec"]),
                            "duplicate": False}
                raise AssertionError(doc["op"])

        return _Client()


def test_router_cache_answer_equals_jax_and_survives_restart(tmp_path):
    out = {}
    for pkg, mod, rmod, jmod in (("port", torch_rc, torch_router, torch_journal),
                                 ("jax", jax_rc, jax_router, jax_journal)):
        d = tmp_path / pkg
        spec = _spec(tmp_path / "sub", tenant="t1")  # one key for both packages
        plane, digest = _seeded_plane(d, mod, spec)
        cj = str(d / "cache_answers.journal")
        replies = []
        for _ in range(2):  # the second router is the kill -9 restart shape
            fleet = _DarkFleet(["w0", "w1"], jmod.idempotency_key)
            router = rmod.Router([(n, n) for n in fleet.names], start_monitor=False,
                                 client_factory=fleet.client, result_cache=plane,
                                 cache_journal=cj)
            router.probe_members()
            try:
                reply = router.submit(dict(spec))
                status = router.status({"key": reply["key"]})["job"]
                replies.append((reply["ok"], reply["cached"], reply["node"],
                                reply["duplicate"], reply["key"], status["state"],
                                status["cached"], fleet.submits,
                                router.counters.snapshot().get("route_cache_answers")))
            finally:
                router.close()
        base = os.path.join(str(tmp_path / "sub"), "golden")
        assert _read(os.path.join(base, "sscs", "golden.bam")).startswith(b"BAM")
        with open(cj, "rb") as fh:
            recs = [json.loads(ln) for ln in fh.read().splitlines() if ln]
        answers = [(r["kind"], r["key"], r["digest"]) for r in recs
                   if r.get("kind") == "cache_answer"]
        miss_fleet = _DarkFleet(["w0", "w1"], jmod.idempotency_key)
        router = rmod.Router([(n, n) for n in miss_fleet.names], start_monitor=False,
                             client_factory=miss_fleet.client, result_cache=plane,
                             cache_journal=str(d / "cj2.journal"))
        router.probe_members()
        try:
            miss = router.submit(_spec(d / "sub2", cutoff=0.9))
            miss_obs = (miss["ok"], bool(miss.get("cached")), len(miss_fleet.submits),
                        router.counters.snapshot().get("cache_misses"))
        finally:
            router.close()
        out[pkg] = (replies, answers, digest, miss_obs)
    assert out["port"] == out["jax"]
    replies, answers, digest, miss_obs = out["port"]
    assert [r[:4] for r in replies] == [(True, True, "cache", False), (True, True, "cache", True)]
    assert [r[5:] for r in replies] == [("done", True, [], 1), ("done", True, [], 0)]
    assert answers == [("cache_answer", replies[0][4], digest)]
    assert miss_obs == (True, False, 1, 1)


# ---------------------------------------------------- host-worker ranges

def test_host_workers_take_a_cached_negative_range_as_jax_does(tmp_path, capfd):
    """A plane holding range r1's worker output as a negative entry: both
    CLIs' ``--host_workers 2 --result_cache`` runs materialize r1 from it
    and run only r0's worker; the merged trees equal each other's and an
    uncached run's, and qc.json counts the skipped range."""
    src = str(tmp_path / "sample.bam")
    shutil.copyfile(ADVERSARIAL, src)
    ranges = hostshard.plan_bai_ranges(src, 2)
    assert [hostshard.range_argv(r) for r in ranges] == \
        [jax_hostshard.range_argv(r) for r in jax_hostshard.plan_bai_ranges(src, 2)]
    r1 = hostshard.range_argv(ranges[1])
    runs = {}
    for pkg, mod, main, dev in (("port", torch_rc, torch_cli.main, ["--device", "cpu"]),
                                ("jax", jax_rc, jax_cli.main, ["--backend", "xla_cpu"])):
        seed = tmp_path / pkg / "seed"
        main(["consensus", "-i", src, "-o", str(seed), "-n", "r1", "--input_range", r1, *dev])
        spec = {"input": src, "name": "r1", "cutoff": 0.7, "qualscore": 0, "scorrect": True,
                "max_mismatch": 0, "bdelim": "|", "compress_level": 6, "input_range": r1}
        plane = str(tmp_path / pkg / "plane")
        assert mod.ResultCache(plane, node="w0").insert(
            mod.content_digest(spec), str(seed / "r1"), negative=True) is not None
        capfd.readouterr()
        main(["consensus", "-i", src, "-o", str(tmp_path / pkg / "out"), "-n", "s",
              "--host_workers", "2", "--result_cache", plane, "--resume", "True", *dev])
        err = capfd.readouterr().err
        assert "1/2 ranges known-empty in the result cache; workers skipped ([1])" in err, pkg
        ranges_dir = tmp_path / pkg / "out" / "s" / ".ranges"
        assert (ranges_dir / "r0.stderr").exists() and not (ranges_dir / "r1.stderr").exists()
        runs[pkg] = str(tmp_path / pkg / "out" / "s")
    torch_cli.main(["consensus", "-i", src, "-o", str(tmp_path / "plain"), "-n", "s",
                    "--host_workers", "2", "--device", "cpu"])
    plain = str(tmp_path / "plain" / "s")
    bams = [b for b in _files(plain, ".bam") if not b.startswith(".ranges")]
    assert bams and [b for b in _files(runs["port"], ".bam")
                     if not b.startswith(".ranges")] == bams
    for rel in bams:
        want = _records(os.path.join(plain, rel))
        assert _records(os.path.join(runs["port"], rel)) == want, rel
        assert _records(os.path.join(runs["jax"], rel)) == want, rel
    for rel in ("sscs/s.sscs_stats.txt", "dcs/s.dcs_stats.txt", "sscs/s.read_families.txt"):
        assert _no_backend(os.path.join(runs["port"], rel)) == \
            _no_backend(os.path.join(runs["jax"], rel)), rel
    qc = {}
    for pkg, base in runs.items():
        with open(os.path.join(base, "qc.json")) as fh:
            qc[pkg] = json.load(fh)
    assert qc["port"]["ranges_skipped_negative"] == qc["jax"]["ranges_skipped_negative"] == 1
    assert qc["port"]["pipeline"] == qc["jax"]["pipeline"] == "host_sharded[2]"
