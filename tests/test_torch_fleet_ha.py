"""Fleet HA in the port against the JAX package's (CPU).

- **The ring view.** The same epochs published through both packages'
  ``RingView`` load alike and compact alike; a view cut at every byte
  replays (``load`` and ``scan``) as the JAX package replays it; the
  ``route.view_publish`` fault keeps membership live in both.
- **Fencing and takeover.** ``Scheduler.fence`` and its journal floor, the
  ``route.fence`` demotion latch and the ``route.router_down`` takeover
  behave as in the JAX package.
- **Adoption and keyed polls.** Adoption resubmits a dead member's job
  exactly once and tombstones its journal (a zombie's replay drops the
  job), the ``route.adopt`` fault leaves no tombstone, the sweep waits for
  its horizon; the locate sweep, the spec recovered from a down member's
  journal and the terminal answer from an adopted journal — all as in the
  JAX package.
- **Poison lineage.** The fleet attempt budget, its quarantined refusal
  and ``release`` over two real port daemons, as over two JAX daemons.
- **kill -9.** Two port daemons (``serve --device cpu`` processes) behind
  the port's router; the ring owner of a job kills itself with the job
  dispatched (``serve.worker=kill:SIGKILL``), the router resubmits it by
  key to the survivor, and the tree holds the goldens.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from consensuscruncher_tpu.serve import client as jax_client
from consensuscruncher_tpu.serve import journal as jax_journal
from consensuscruncher_tpu.serve import router as jax_router
from consensuscruncher_tpu.serve import scheduler as jax_sched
from consensuscruncher_tpu.serve import server as jax_server
from consensuscruncher_tpu.utils import faults as jax_faults
from consensuscruncher_tpu_torch.serve import client as torch_client
from consensuscruncher_tpu_torch.serve import journal as torch_journal
from consensuscruncher_tpu_torch.serve import router as torch_router
from consensuscruncher_tpu_torch.serve import scheduler as torch_sched
from consensuscruncher_tpu_torch.serve import server as torch_server
from consensuscruncher_tpu_torch.utils import faults as torch_faults
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")
with open(os.path.join(REPO, "test", "golden.json")) as _fh:
    GOLDEN = json.load(_fh)


class _Pkg:
    def __init__(self, name, router, journal, client, sched, server, faults):
        self.name, self.router, self.journal, self.client = name, router, journal, client
        self.sched, self.server, self.faults = sched, server, faults

    def scheduler(self, **kw):
        if self.name == "port":
            return self.sched.Scheduler(device="cpu", **kw)
        return self.sched.Scheduler(backend="tpu", **kw)


PKGS = [_Pkg("port", torch_router, torch_journal, torch_client, torch_sched, torch_server,
             torch_faults),
        _Pkg("jax", jax_router, jax_journal, jax_client, jax_sched, jax_server, jax_faults)]


def _both(scenario, tmp_path, *args):
    """Run ``scenario(pkg, dir, *args)`` through both packages; what each
    observes must be equal.  Returns the port's observation."""
    port, ref = (scenario(p, tmp_path / p.name, *args) for p in PKGS)
    assert port == ref
    return port


def _spec(output, name="golden", **over):
    spec = {"input": SAMPLE, "output": str(output), "name": name, "cutoff": 0.7,
            "qualscore": 0, "scorrect": True, "max_mismatch": 0, "bdelim": "|",
            "compress_level": 6}
    spec.update(over)
    return spec


def _no_t(doc):
    return None if doc is None else {k: v for k, v in doc.items() if k != "t"}


# ------------------------------------------------------------- ring view

def _publish_three(pkg, path, max_records=256):
    rv = pkg.router.RingView(str(path), max_records=max_records)
    rv.publish(1, "r0", "/tmp/r0.sock", [("w0", "/tmp/w0.sock")])
    rv.publish(2, "r1", ("10.0.0.2", 7780), [("w0", "/tmp/w0.sock"), ("w1", ("10.0.0.3", 7733))],
               journals={"w0": "/tmp/w0.journal"},
               warm={"compile_cache": "/build", "autotune_table": None, "result_cache": "/p"},
               attempts={"k1": 2})
    rv.publish(3, "r0", "/tmp/r0.sock", [("w0", "/tmp/w0.sock"), ("w1", "/tmp/w1.sock")])
    return rv


def test_ring_view_round_trip_and_compaction_equal_jax(tmp_path):
    def scenario(pkg, d):
        d.mkdir(parents=True)
        rv = _publish_three(pkg, d / "ring.view")
        docs = [_no_t(json.loads(ln)) for ln in (d / "ring.view").read_text().splitlines()]
        small = pkg.router.RingView(str(d / "small.view"), max_records=4)
        for e in range(1, 9):
            small.publish(e, "r0", None, [("w0", "w0")])
        records, _ = small.scan()
        return docs, _no_t(rv.load()), rv.scan()[1], len(records), small.load()["epoch"]

    docs, loaded, info, n_small, top = _both(scenario, tmp_path)
    assert loaded == docs[-1] and loaded["epoch"] == 3
    assert docs[1]["warm"] == {"compile_cache": "/build", "result_cache": "/p"}
    assert docs[1]["attempts"] == {"k1": 2} and docs[1]["address"] == ["10.0.0.2", 7780]
    assert info == {"records": 3, "skipped": 0, "torn_tail": False}
    assert n_small <= 5 and top == 8


def test_ring_view_cut_at_every_byte_replays_as_jax(tmp_path):
    """One view written by the port, cut at every byte: the port's
    ``load``/``scan`` of each cut equal the JAX package's, and a cut keeps
    exactly the records whose JSON is whole."""
    rv = _publish_three(PKGS[0], tmp_path / "ring.view")
    raw = open(rv.path, "rb").read()
    ends = [i + 1 for i, b in enumerate(raw) if raw[i:i + 1] == b"\n"]
    torn = tmp_path / "torn.view"
    for cut in range(len(raw) + 1):
        torn.write_bytes(raw[:cut])
        port, ref = torch_router.RingView(str(torn)), jax_router.RingView(str(torn))
        got = (port.load(), port.scan()[1])
        assert got == (ref.load(), ref.scan()[1]), cut
        whole = sum(1 for e in ends if e <= cut)
        assert got[1]["records"] in (whole, whole + 1), cut  # + a cut at a closing brace
        assert (got[0] or {}).get("epoch", 0) == got[1]["records"], cut


def test_view_publish_fault_keeps_membership_live_as_jax(tmp_path, monkeypatch):
    def scenario(pkg, d):
        rv_path = str(d / "ring.view")
        router = pkg.router.Router([("n0", "n0")], start_monitor=False, ring_view=rv_path,
                                   router_id="rA", client_factory=lambda addr: None)
        base = router.epoch
        monkeypatch.setenv("CCT_FAULTS", "route.view_publish=fail@1")
        out = router.member_add("n1", "n1")
        monkeypatch.delenv("CCT_FAULTS")
        stale = pkg.router.RingView(rv_path).load()["epoch"]
        router.member_add("n2", "n2")
        doc = pkg.router.RingView(rv_path).load()
        return (base, out["fleet_size"], router.epoch, stale,
                doc["epoch"], sorted(m[0] for m in doc["members"]))

    assert _both(scenario, tmp_path) == (1, 2, 3, 1, 3, ["n0", "n1", "n2"])


# ---------------------------------------------------- fencing, takeover

def test_scheduler_fence_and_its_floor_equal_jax(tmp_path):
    def scenario(pkg, d):
        d.mkdir(parents=True)
        jp = str(d / "wal")
        seen = []
        sched = pkg.scheduler(start=False, paused=True, journal=pkg.journal.Journal(jp))
        try:
            sched.fence(None)
            sched.fence(5, router="r1")
            try:
                sched.fence(4, router="r0")
            except pkg.sched.RouterFenced as e:
                seen.append(e.epoch)
            sched.fence(5)
            seen.append((sched.fence_epoch, sched.counters.snapshot()["fencing_rejections"]))
        finally:
            sched.shutdown()
            sched._journal.close()
        sched2 = pkg.scheduler(start=False, paused=True, journal=pkg.journal.Journal(jp))
        try:
            seen.append(sched2.fence_epoch)
            with pytest.raises(pkg.sched.RouterFenced):
                sched2.fence(3)
        finally:
            sched2.shutdown()
            sched2._journal.close()
        return seen

    assert _both(scenario, tmp_path) == [5, (5, 1), 5]


class _Fleet:
    """In-memory workers for one package: dedup by key, unknown-job
    replies, a kill switch per node and an optional fence epoch."""

    def __init__(self, pkg, names):
        self.pkg = pkg
        self.nodes = {n: {"dead": False, "queued": 0, "jobs": {}, "fence": None}
                      for n in names}

    def client(self, name):
        fleet = self
        error = fleet.pkg.client.ServeClientError

        class _Client:
            address = name

            def request(self, doc, timeout=None):
                node = fleet.nodes[name]
                if node["dead"]:
                    raise OSError("connection refused")
                if node["fence"] is not None and "epoch" in doc:
                    raise error("stale forward", {"ok": False, "fenced": True,
                                                  "epoch": node["fence"]})
                op = doc["op"]
                if op == "healthz":
                    return {"ok": True, "health": {"queued": node["queued"], "running": 0,
                                                   "status": "serving"}}
                if op == "submit":
                    key = fleet.pkg.journal.idempotency_key(doc["spec"])
                    dup = key in node["jobs"]
                    node["jobs"][key] = dict(doc["spec"])
                    return {"ok": True, "job_id": 1, "key": key, "duplicate": dup}
                if op in ("status", "result"):
                    if doc["key"] in node["jobs"]:
                        return {"ok": True, "job": {"job_id": 1, "key": doc["key"],
                                                    "state": "done"}}
                    raise error("unknown job_id", {"ok": False, "error": "unknown job_id",
                                                   "unknown": True})
                raise AssertionError(op)

        return _Client()


def _router(pkg, fleet, **kw):
    router = pkg.router.Router([(n, n) for n in fleet.nodes], start_monitor=False,
                               client_factory=fleet.client, **kw)
    router.probe_members()
    return router


def test_fence_demotes_the_router_as_jax(tmp_path, monkeypatch):
    def scenario(pkg, d):
        fleet = _Fleet(pkg, ["n0", "n1"])
        router = _router(pkg, fleet, ring_view=str(d / "rv"), router_id="rA")
        epoch = router.epoch
        for node in fleet.nodes.values():
            node["fence"] = 99
        first = router.submit(_spec(d / "fenced"))
        again = router.submit(_spec(d / "fenced2"))
        try:
            router.resolve("whatever")
            resolved = True
        except pkg.client.ServeClientError:
            resolved = False
        sched = pkg.scheduler(start=False, paused=True)
        try:
            monkeypatch.setenv("CCT_FAULTS", "route.fence=fail@1")
            with pytest.raises(pkg.sched.RouterFenced):
                sched.fence(12, router="rA")
            monkeypatch.delenv("CCT_FAULTS")
            sched.fence(12)
            rejections = sched.counters.snapshot()["fencing_rejections"]
        finally:
            sched.shutdown()
        return (epoch, first["ok"], router.fenced, again["ok"], again["busy"],
                again["fenced"], again["standby"], resolved, rejections)

    assert _both(scenario, tmp_path) == (1, False, True, False, True, True, True, False, 1)


def test_router_down_fault_takes_over_as_jax(tmp_path, monkeypatch):
    def scenario(pkg, d):
        d.mkdir(parents=True)
        rv_path = str(d / "ring.view")
        pkg.router.RingView(rv_path).publish(5, "r0", str(d / "nosuch.sock"), [("n0", "n0")])
        fleet = _Fleet(pkg, ["n0"])
        router = pkg.router.Router([("n0", "n0")], start_monitor=False, standby=True,
                                   ring_view=rv_path, router_id="r1", takeover_after=2,
                                   client_factory=fleet.client)
        try:
            seen = [router.standby, router.epoch, router.submit(_spec(d / "n"))["standby"]]
            monkeypatch.setenv("CCT_FAULTS", "route.router_down=fail@2")
            router.probe_active()
            seen.append(router.standby)
            router.probe_active()
            monkeypatch.delenv("CCT_FAULTS")
            seen += [router.standby, router.epoch,
                     pkg.router.RingView(rv_path).load()["router"],
                     router.counters.snapshot()["router_failovers"],
                     router.submit(_spec(d / "served"))["ok"]]
        finally:
            router.close()
        return seen

    assert _both(scenario, tmp_path) == [True, 5, True, True, False, 6, "r1", 1, True]


# ---------------------------------------------- adoption and keyed polls

def _adoption_rig(pkg, d, **kw):
    d.mkdir(parents=True, exist_ok=True)
    fleet = _Fleet(pkg, ["n0", "n1", "n2"])
    jp = str(d / "n1.journal")
    spec = _spec(d.parent / "orphan")  # in the adoption test, one key for both packages
    key = pkg.journal.idempotency_key(spec)
    j = pkg.journal.Journal(jp)
    j.append_job(41, "accepted", key=key, spec=spec)
    j.append_job(41, "running")
    j.close()
    router = pkg.router.Router([(n, n) for n in fleet.nodes], start_monitor=False, down_after=1,
                               client_factory=fleet.client, journals={"n1": jp}, **kw)
    fleet.nodes["n1"]["dead"] = True
    router.probe_members()
    return fleet, router, jp, key


def test_adoption_is_exactly_once_and_a_zombie_drops_the_job_as_jax(tmp_path):
    def scenario(pkg, d):
        fleet, router, jp, key = _adoption_rig(pkg, d)
        out = router.adopt("n1")
        landed = sorted(n for n, node in fleet.nodes.items() if key in node["jobs"])
        jobs, info = pkg.journal.replay(jp)
        out2 = router.adopt("n1", force=True)
        snap = router.counters.snapshot()
        sched = pkg.scheduler(start=False, paused=True, journal=pkg.journal.Journal(jp))
        try:
            zsnap = sched.counters.snapshot()
            zombie = (zsnap["fencing_rejections"], zsnap["jobs_replayed"],
                      sched.healthz()["queued"])
        finally:
            sched.shutdown()
            sched._journal.close()
        return (out["jobs_adopted"], out["keys"] == [key], landed, info["adopted_by"],
                jobs[41]["adopted"], out2["jobs_adopted"], snap["journals_adopted"],
                snap["jobs_adopted"], zombie)

    got = _both(scenario, tmp_path)
    assert got[:2] == (1, True) and "n1" not in got[2] and len(got[2]) == 1
    assert got[3:] == ("r0", True, 0, 2, 1, (1, 0, 0))


def test_adopt_fault_and_sweep_horizon_as_jax(tmp_path, monkeypatch):
    def scenario(pkg, d):
        fleet, router, jp, key = _adoption_rig(pkg, d / "fault")
        monkeypatch.setenv("CCT_FAULTS", "route.adopt=fail@1")
        with pytest.raises(pkg.faults.FaultError):
            router.adopt("n1")
        monkeypatch.delenv("CCT_FAULTS")
        seen = [pkg.journal.replay(jp)[1]["adopted_by"],
                router.counters.snapshot()["journals_adopted"], router.adopt("n1")["jobs_adopted"]]
        fleet, router, jp, key = _adoption_rig(pkg, d / "sweep")
        for horizon in (3600.0, 0.0, 0.0):
            router.adopt_after_s = horizon
            router.adoption_sweep()
            seen.append(router.counters.snapshot()["journals_adopted"])
        return seen

    assert _both(scenario, tmp_path) == [None, 0, 1, 0, 1, 1]


def test_keyed_polls_sweep_recover_and_answer_as_jax(tmp_path):
    def scenario(pkg, d):
        d.mkdir(parents=True)
        fleet = _Fleet(pkg, ["n0", "n1", "n2"])
        router = _router(pkg, fleet)
        key = "feedfacecafebeef"
        holder = next(n for n in fleet.nodes if n != router.resolve(key).name)
        fleet.nodes[holder]["jobs"][key] = {}
        seen = [router.status({"key": key})["job"]["state"],
                router.counters.snapshot()["route_locate_sweeps"], router.resolve(key).name]
        with pytest.raises(pkg.client.ServeClientError):
            router.status({"key": "0000000000000000"})
        # the spec recovered from a down member's journal, resubmitted
        spec = _spec(d.parent / "orphan")  # one key for both packages
        okey = pkg.journal.idempotency_key(spec)
        jp = str(d / "n1.journal")
        j = pkg.journal.Journal(jp)
        j.append_job(7, "accepted", key=okey, spec=spec)
        # a terminal job of a tombstoned journal, answered from its record
        fspec = _spec(d.parent / "finished")
        fkey = pkg.journal.idempotency_key(fspec)
        j.append_job(8, "accepted", key=fkey, spec=fspec)
        j.append_job(8, "dispatched")
        j.append_job(8, "done", outputs={"base": "/done/finished"}, wall_s=1.5)
        j.close()
        fleet2 = _Fleet(pkg, ["n0", "n1", "n2"])
        router2 = pkg.router.Router([(n, n) for n in fleet2.nodes], start_monitor=False,
                                    down_after=1, journals={"n1": jp},
                                    client_factory=fleet2.client)
        fleet2.nodes["n1"]["dead"] = True
        router2.probe_members()
        seen.append(router2.status({"key": okey})["job"]["state"])
        seen.append(sorted(n for n, node in fleet2.nodes.items() if okey in node["jobs"]))
        answer = router2.result({"key": fkey})["job"]
        snap = router2.counters.snapshot()
        seen += [answer["state"], answer["outputs"], snap["route_resubmits"],
                 snap["route_journal_answers"]]
        return seen

    got = _both(scenario, tmp_path)
    assert got[:2] == ["done", 1] and got[3] == "done" and "n1" not in got[4]
    assert got[5:] == ["done", {"base": "/done/finished"}, 1, 1]


def test_poison_lineage_and_release_over_real_daemons_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("CCT_SERVE_MAX_FLEET_ATTEMPTS", "2")

    def scenario(pkg, d):
        d.mkdir(parents=True)
        socks = {n: str(d / f"{n}.sock") for n in ("a", "b")}
        scheds = {n: pkg.scheduler(start=False, paused=True) for n in socks}
        servers = {n: pkg.server.ServeServer(scheds[n], socket_path=socks[n]) for n in socks}
        for srv in servers.values():
            srv.start()
        router = pkg.router.Router(list(socks.items()), start_monitor=False)
        rserver = pkg.router.RouterServer(router, socket_path=str(d / "r.sock"))
        try:
            spec = _spec(tmp_path / "out")  # one key for both packages
            key = pkg.journal.idempotency_key(spec)
            with router._lock:
                router._attempts[key] = 1
            sub = router.submit(spec)
            owner = scheds[sub["node"]]
            seen = [sub["ok"], sub["node"], owner.fleet_attempts(key),
                    router._budget_spend(key, "steal", strict=False),
                    router._budget_spend(key, "steal", strict=False)]
            with pytest.raises(pkg.client.ServeClientError) as ei:
                router._budget_spend(key, "failover resubmit")
            seen += [ei.value.reply["quarantined"],
                     router.counters.snapshot()["fleet_attempts_exhausted"]]
            with owner._cond:
                owner._quarantine_locked(owner._jobs[sub["job_id"]], "poison")
            out = rserver._dispatch({"op": "release", "key": key})
            miss = rserver._dispatch({"op": "release", "key": "nope"})
            seen += [out["released"], out["node"] == sub["node"], owner.quarantined_keys(),
                     router._attempts_snapshot(),
                     router.counters.snapshot()["quarantine_released"], miss["released"]]
        finally:
            rserver.close(timeout=5)
            router.close()
            for n in socks:
                servers[n].close(timeout=5)
                scheds[n].shutdown()
        return seen

    got = _both(scenario, tmp_path)
    assert got[0] is True and got[2:] == [1, True, False, True, 2, True, True, {}, {}, 1, False]


# ---------------------------------------------------------------- kill -9

def _daemon(name, sock, journal, log, faults_spec=None):
    env = {k: v for k, v in os.environ.items() if k not in ("CCT_FAULTS", "PYTHONPATH")}
    if faults_spec:
        env["CCT_FAULTS"] = faults_spec
    return subprocess.Popen(
        [sys.executable, "-m", "consensuscruncher_tpu_torch.cli", "serve", "--socket", sock,
         "--node", name, "--journal", journal, "--gang_size", "1", "--queue_bound", "8",
         "--device", "cpu", "--drain_s", "60"],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)


def test_kill9_of_the_owner_fails_over_to_the_goldens(tmp_path):
    spec = _spec(tmp_path / "job")
    key = torch_journal.idempotency_key(spec)
    owner = torch_router.HashRing(["w0", "w1"]).owner(key)
    log = open(tmp_path / "fleet.log", "wb")
    procs, members = {}, []
    for name in ("w0", "w1"):
        sock = str(tmp_path / f"{name}.sock")
        procs[name] = _daemon(name, sock, str(tmp_path / f"{name}.journal"), log,
                              "serve.worker=kill:SIGKILL" if name == owner else None)
        members.append((name, sock))
    router = torch_router.Router(members, start_monitor=False, down_after=1,
                                 client_factory=lambda a: torch_client.ServeClient(
                                     a, retries=60, retry_base_s=0.25))
    try:
        for name, _ in members:  # both daemons bound and answering
            assert router._member(name).client.request({"op": "healthz"})["health"]["node"] \
                == name
        sub = router.submit(spec)
        assert sub["ok"] and sub["node"] == owner
        assert procs[owner].wait(timeout=120) == -signal.SIGKILL  # died with the job
        t_kill = time.monotonic()
        for name, _ in members:  # fast-failing polls: the owner is a corpse
            m = router._member(name)
            m.client = torch_client.ServeClient(m.address, retries=0)
        job = router.result({"key": sub["key"], "timeout": 300})["job"]
        assert job["state"] == "done", job
        assert time.monotonic() - t_kill < 300
        assert golden_mismatches(str(tmp_path / "job" / "golden"), GOLDEN["consensus"]) == []
        snap = router.counters.snapshot()
        assert snap["member_down_events"] >= 1 and snap["route_resubmits"] == 1
        jobs, _ = torch_journal.replay(str(tmp_path / f"{owner}.journal"))
        assert [j["state"] for j in jobs.values()] == ["dispatched"]  # acked, never finished
    except BaseException:
        log.flush()
        sys.stderr.write((tmp_path / "fleet.log").read_text()[-6000:])
        raise
    finally:
        log.close()
        router.close()
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs.values():
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
