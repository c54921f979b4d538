"""The port's fleet router against the JAX package's (CPU).

- **The ring.** ``HashRing.owner``/``preference`` give the JAX package's
  members on 1,000 keys at 3 and 4 members, with members down and with a
  member added; ``parse_members`` parses alike.
- **The stub router.** Each routing scenario of the JAX package's router
  tests (sticky placement and duplicates, failover at the forward, no
  member up, the steal gates, the probe streak, drain, the fleet metrics
  merge, the key-addressed wire, the ``route.steal``/``member_down``/
  ``resubmit`` faults) runs through both packages' routers over the same
  in-memory members; what each observes is equal, and
  ``render_fleet_prometheus`` renders equal text.
- **A real fleet.** The port's router over two in-process port daemons
  (``device="cpu"``): ``sample.bam`` and two simulated samples served
  through it equal their one-shot runs (the goldens too), and the fleet
  Prometheus text of the real router doc equals the JAX renderer's.
- **The command line.** ``route``, ``cache`` and ``serve`` take every JAX
  flag (``route`` and ``serve`` also ``--device``).
"""

import json
import os

import pytest

from consensuscruncher_tpu import cli as jax_cli
from consensuscruncher_tpu.obs import metrics as jax_metrics
from consensuscruncher_tpu.serve import client as jax_client
from consensuscruncher_tpu.serve import journal as jax_journal
from consensuscruncher_tpu.serve import router as jax_router
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.obs import metrics as torch_metrics
from consensuscruncher_tpu_torch.serve import client as torch_client
from consensuscruncher_tpu_torch.serve import journal as torch_journal
from consensuscruncher_tpu_torch.serve import router as torch_router
from consensuscruncher_tpu_torch.serve import scheduler as torch_sched
from consensuscruncher_tpu_torch.serve.server import ServeServer
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches
from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")
with open(os.path.join(REPO, "test", "golden.json")) as _fh:
    GOLDEN = json.load(_fh)

PKGS = {
    "port": (torch_router, torch_journal, torch_client, torch_metrics),
    "jax": (jax_router, jax_journal, jax_client, jax_metrics),
}
KEYS = [f"key-{i}" for i in range(1000)]
#: help texts the port rewords (what the port counts, not what JAX does)
REWORDED = ("cct_recompiles_total", "cct_bytes_h2d_total", "cct_bytes_d2h_total",
            "cct_device_dispatch_s", "cct_deflate_wall_us_total")
#: the port's own counters, registered after the JAX package's keys: no JAX line
PORT_ONLY = ("cct_vote_member_positions_total", "cct_vote_output_positions_total")


def _mask_reworded(text):
    return [ln.split(" ")[:3] if ln.startswith("# HELP ") and ln.split(" ")[2] in REWORDED
            else ln for ln in text.splitlines()
            if not any(name in ln for name in PORT_ONLY)]


def _spec(output, name="golden", **over):
    spec = {"input": SAMPLE, "output": str(output), "name": name, "cutoff": 0.7,
            "qualscore": 0, "scorrect": True, "max_mismatch": 0, "bdelim": "|",
            "compress_level": 6}
    spec.update(over)
    return spec


# ------------------------------------------------------------- the ring

@pytest.mark.parametrize("n,down", [(3, ()), (3, ("n1",)), (4, ()), (4, ("n2",)),
                                    (4, ("n0", "n3"))])
def test_ring_placement_equals_jax(n, down):
    members = [f"n{i}" for i in range(n)]
    up = [m for m in members if m not in down]
    port, ref = torch_router.HashRing(members), jax_router.HashRing(members)
    owners = [port.owner(k, up=up) for k in KEYS]
    assert owners == [ref.owner(k, up=up) for k in KEYS]
    assert [port.preference(k) for k in KEYS] == [ref.preference(k) for k in KEYS]
    assert set(owners) == set(up)
    for k, o in zip(KEYS, owners):
        home = port.owner(k)
        assert o == home if home in up else o in up


def test_ring_member_add_remaps_as_jax_does():
    r3 = torch_router.HashRing(["n0", "n1", "n2"])
    r4 = torch_router.HashRing(["n0", "n1", "n2", "n3"], vnodes=64)
    moved = [k for k in KEYS if r3.owner(k) != r4.owner(k)]
    ref3 = jax_router.HashRing(["n0", "n1", "n2"])
    ref4 = jax_router.HashRing(["n0", "n1", "n2", "n3"])
    assert moved == [k for k in KEYS if ref3.owner(k) != ref4.owner(k)]
    assert 0.15 < len(moved) / len(KEYS) < 0.40
    assert {r4.owner(k) for k in moved} == {"n3"}


@pytest.mark.parametrize("text", ["a=/tmp/a.sock,b=host:7733", "/tmp/a.sock,/tmp/b.sock",
                                  "", "a=/tmp/a.sock,a=/tmp/b.sock", " x=h:1 , y=/s "])
def test_parse_members_equals_jax(text):
    def parse(mod):
        try:
            return mod.parse_members(text)
        except ValueError as e:
            return str(e)

    assert parse(torch_router) == parse(jax_router)


# ---------------------------------------------------- stub-driven router

class _StubFleet:
    """In-memory worker daemons keyed by member name, answering with the
    given package's idempotency key and client error."""

    def __init__(self, names, pkg):
        _router, journal, client, _metrics = PKGS[pkg]
        self.key_fn, self.error = journal.idempotency_key, client.ServeClientError
        self.nodes = {n: {"dead": False, "queued": 0, "jobs": {}} for n in names}

    def client(self, name):
        fleet = self

        class _Client:
            address = name

            def request(self, doc, timeout=None):
                node = fleet.nodes[name]
                if node["dead"]:
                    raise OSError("connection refused")
                op = doc["op"]
                if op == "healthz":
                    return {"ok": True, "health": {"queued": node["queued"], "running": 0,
                                                   "status": "serving"}}
                if op == "submit":
                    key = fleet.key_fn(doc["spec"])
                    dup = key in node["jobs"]
                    node["jobs"][key] = dict(doc["spec"])
                    return {"ok": True, "job_id": len(node["jobs"]), "key": key,
                            "duplicate": dup}
                if op in ("status", "result"):
                    if doc["key"] not in node["jobs"]:
                        raise fleet.error("no such job", {})
                    return {"ok": True, "job": {"state": "done", "key": doc["key"]}}
                if op == "metrics":
                    return {"ok": True, "metrics": {
                        "node": name, "cumulative": {"families_in": 5}, "histograms": {},
                        "labeled": {"counters": {}, "histograms": {}}}}
                raise AssertionError(op)

            def drain(self, timeout=None):
                fleet.nodes[name]["draining"] = True

        return _Client()


def _stub_router(pkg, n=3, **kw):
    fleet = _StubFleet([f"n{i}" for i in range(n)], pkg)
    router = PKGS[pkg][0].Router([(name, name) for name in fleet.nodes], start_monitor=False,
                                 client_factory=fleet.client, **kw)
    router.probe_members()
    return fleet, router


def _scenario_sticky(pkg, tmp_path):
    fleet, router = _stub_router(pkg)
    spec = _spec(tmp_path / "a")
    r1, r2 = router.submit(spec), router.submit(dict(spec))
    return (r1["ok"], r2["ok"], r1["node"], r2["node"], router.ring.owner(r1["key"]),
            r1["duplicate"], r2["duplicate"], router.counters.snapshot()["jobs_routed"])


def _scenario_failover(pkg, tmp_path):
    fleet, router = _stub_router(pkg)
    spec = _spec(tmp_path / "b")
    home = router.ring.owner(PKGS[pkg][1].idempotency_key(spec))
    fleet.nodes[home]["dead"] = True
    reply = router.submit(spec)
    return (home, reply["ok"], reply["node"], router._member(home).up,
            router.counters.snapshot()["member_down_events"],
            router.locate(reply["key"])["node"], router.status({"key": reply["key"]})["ok"])


def _scenario_none_up(pkg, tmp_path):
    fleet, router = _stub_router(pkg, n=2)
    for node in fleet.nodes.values():
        node["dead"] = True
    router.down_after = 1
    router.probe_members()
    reply = router.submit(_spec(tmp_path / "c"))
    return reply["ok"], reply["error"]


def _scenario_steal(pkg, tmp_path):
    fleet, router = _stub_router(pkg, steal_threshold=4, steal_margin=2)
    bspec = _spec(tmp_path / "steal", qos="batch")
    home = router.ring.owner(PKGS[pkg][1].idempotency_key(bspec))
    others = [n for n in fleet.nodes if n != home]
    seen = []
    for home_q, other_q in ((3, (0, 0)), (6, (5, 5)), (6, (0, 1))):
        fleet.nodes[home]["queued"] = home_q
        for n, q in zip(others, other_q):
            fleet.nodes[n]["queued"] = q
        router.probe_members()
        r = router.submit(dict(bspec))
        seen.append((r["node"], r["stolen"]))
    ispec = _spec(tmp_path / "steal", name="inter", qos="interactive")
    ihome = router.ring.owner(PKGS[pkg][1].idempotency_key(ispec))
    for n in fleet.nodes:
        fleet.nodes[n]["queued"] = 0 if n != ihome else 50
    router.probe_members()
    seen.append(router.submit(ispec)["stolen"])
    return home, others, seen, router.counters.snapshot()["route_steals"]


def _scenario_probe_streak(pkg, tmp_path):
    fleet, router = _stub_router(pkg, down_after=2)
    fleet.nodes["n1"]["dead"] = True
    seen = []
    for revive in (False, False, True):
        if revive:
            fleet.nodes["n1"]["dead"] = False
        router.probe_members()
        seen.append((router._member("n1").up, router.healthz()["fleet"]["up"]))
    return seen


def _scenario_drain(pkg, tmp_path):
    fleet, router = _stub_router(pkg)
    one = router.drain(timeout=5, node="n1")
    flags = (bool(fleet.nodes["n1"].get("draining")), router._draining)
    whole = router.drain(timeout=5)
    return one, flags, sorted(whole["drained"]), router.submit(_spec(tmp_path / "d"))["refused"]


def _scenario_metrics(pkg, tmp_path):
    fleet, router = _stub_router(pkg)
    router.submit(_spec(tmp_path / "m"))
    fleet.nodes["n2"]["dead"] = True
    router.down_after = 1
    router.probe_members()
    doc = router.metrics()
    text = [ln for ln in _mask_reworded(PKGS[pkg][3].render_fleet_prometheus(doc))
            if not str(ln).startswith("cct_uptime_seconds")]  # a wall clock
    return (doc["cumulative"]["jobs_routed"], doc["nodes"]["n0"]["cumulative"]["families_in"],
            doc["nodes"]["n2"], doc["fleet"], text)


def _scenario_wire(pkg, tmp_path):
    fleet, router = _stub_router(pkg)
    server = PKGS[pkg][0].RouterServer(router, port=0)
    try:
        bad = server._dispatch({"op": "status", "job_id": 7})
        sub = server._dispatch({"op": "submit", "spec": _spec(tmp_path / "wire")})
        loc = server._dispatch({"op": "locate", "key": sub["key"]})
        res = server._dispatch({"op": "result", "key": sub["key"], "timeout": 5})
        health = server._dispatch({"op": "healthz"})["health"]
        prom = server._dispatch({"op": "metrics", "format": "prometheus"})["prometheus"]
    finally:
        server.close(timeout=2)
        router.close()
    return ((bad["ok"], bad["bad_request"]), sub["node"], loc["node"] == sub["node"],
            res["job"]["state"], health["role"], "cct_fleet_members 3" in prom)


def _scenario_chaos_steal(pkg, tmp_path, monkeypatch):
    fleet, router = _stub_router(pkg, steal_threshold=2, steal_margin=1)
    bspec = _spec(tmp_path / "chaos-steal", qos="scavenger")
    home = router.ring.owner(PKGS[pkg][1].idempotency_key(bspec))
    fleet.nodes[home]["queued"] = 9
    router.probe_members()
    monkeypatch.setenv("CCT_FAULTS", "route.steal=fail@1")
    reply = router.submit(bspec)
    monkeypatch.delenv("CCT_FAULTS")
    steals = router.counters.snapshot()["route_steals"]
    return (reply["ok"], reply["node"] == home, reply["stolen"], steals,
            router.submit(dict(bspec))["stolen"])


def _scenario_chaos_down(pkg, tmp_path, monkeypatch):
    fleet, router = _stub_router(pkg)
    spec = _spec(tmp_path / "chaos-down")
    home = router.ring.owner(PKGS[pkg][1].idempotency_key(spec))
    monkeypatch.setenv("CCT_FAULTS", "route.member_down=fail@1")
    reply = router.submit(spec)
    monkeypatch.delenv("CCT_FAULTS")
    return (reply["ok"], reply["node"] != home, router._member(home).up,
            router.counters.snapshot()["member_down_events"])


def _scenario_chaos_resubmit(pkg, tmp_path, monkeypatch):
    fleet, router = _stub_router(pkg)
    sub = router.submit(_spec(tmp_path / "chaos-resubmit"))
    fleet.nodes[sub["node"]]["dead"] = True
    router.down_after = 1
    router.probe_members()
    server = PKGS[pkg][0].RouterServer(router, port=0)
    try:
        monkeypatch.setenv("CCT_FAULTS", "route.resubmit=fail@1")
        r = server._dispatch({"op": "status", "key": sub["key"]})
        monkeypatch.delenv("CCT_FAULTS")
        r2 = server._dispatch({"op": "status", "key": sub["key"]})
    finally:
        server.close(timeout=2)
        router.close()
    return (r["ok"], "route.resubmit" in r["error"], r2["ok"], r2["job"]["state"],
            router.counters.snapshot()["route_resubmits"])


@pytest.mark.parametrize("scenario,expect", [
    (_scenario_sticky, lambda o: o[:2] == (True, True) and o[2] == o[3] == o[4]
     and o[5:] == (False, True, 2)),
    (_scenario_failover, lambda o: o[1] is True and o[2] != o[0] and o[3] is False
     and o[4] == 1 and o[5] == o[2] and o[6] is True),
    (_scenario_none_up, lambda o: o[0] is False and "no fleet member is up" in o[1]),
    (_scenario_steal, lambda o: o[2][:2] == [(o[0], False)] * 2
     and o[2][2] == (o[1][0], True) and o[2][3] is False and o[3] == 1),
    (_scenario_probe_streak, lambda o: o == [(True, 3), (False, 2), (True, 3)]),
    (_scenario_drain, lambda o: o[0] == {"drained": ["n1"], "errors": {}}
     and o[1] == (True, False) and o[2] == ["n0", "n1", "n2"] and o[3] is True),
    (_scenario_metrics, lambda o: o[:3] == (1, 5, None) and o[3]["size"] == 3
     and o[3]["up"] == 2 and "cct_fleet_members_up 2" in o[4]
     and 'cct_fleet_member_up{node="n2"} 0' in o[4]
     and 'cct_families_in_total{node="n0"} 5' in o[4]
     and 'cct_families_in_total{node="n2"}' not in o[4]),
    (_scenario_wire, lambda o: o[0] == (False, True) and o[2:] == (True, "done", "router",
                                                                     True)),
], ids=lambda v: getattr(v, "__name__", "").replace("_scenario_", ""))
def test_stub_router_scenario_equals_jax(tmp_path, scenario, expect):
    got = scenario("port", tmp_path / "port")
    assert got == scenario("jax", tmp_path / "port")
    assert expect(got), got


@pytest.mark.parametrize("scenario,expect", [
    (_scenario_chaos_steal, (True, True, False, 0, True)),
    (_scenario_chaos_down, (True, True, False, 1)),
    (_scenario_chaos_resubmit, (False, True, True, "done", 1)),
], ids=lambda v: getattr(v, "__name__", "").replace("_scenario_", ""))
def test_route_fault_site_equals_jax(tmp_path, monkeypatch, capfd, scenario, expect):
    got = scenario("port", tmp_path, monkeypatch)
    assert got == scenario("jax", tmp_path, monkeypatch) == expect
    if scenario is _scenario_chaos_steal:
        assert capfd.readouterr().err.count("keeping job on home node") == 2


# ----------------------------------------------------- a real fleet (CPU)

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


def test_routed_jobs_equal_one_shot_runs_and_fleet_prometheus_equals_jax(tmp_path):
    inputs = [SAMPLE]
    for seed, n in ((5, 300), (9, 200)):
        inputs.append(str(tmp_path / f"sim{seed}.bam"))
        simulate_bam(inputs[-1], SimConfig(n_fragments=n, seed=seed))
    names = ["golden", "sim5", "sim9"]
    scheds, servers, members = {}, {}, []
    for w in ("w0", "w1"):
        scheds[w] = torch_sched.Scheduler(queue_bound=8, gang_size=2, device="cpu", node=w)
        servers[w] = ServeServer(scheds[w], socket_path=str(tmp_path / f"{w}.sock"))
        servers[w].start()
        members.append((w, str(tmp_path / f"{w}.sock")))
    router = torch_router.Router(members, start_monitor=False)
    try:
        router.probe_members()
        subs = [router.submit(_spec(tmp_path / "served", name=nm, input=p))
                for nm, p in zip(names, inputs)]
        assert all(s["ok"] for s in subs)
        for s in subs:
            assert s["node"] == router.ring.owner(s["key"])
            job = router.result({"key": s["key"], "timeout": 300})["job"]
            assert job["state"] == "done", job
        doc = router.metrics()
    finally:
        router.close()
        for w in servers:
            servers[w].close()
            scheds[w].close(timeout=120)
    assert doc["cumulative"]["jobs_routed"] == 3 and doc["fleet"]["up"] == 2
    assert sum(doc["nodes"][w]["cumulative"]["families_out"] for w in ("w0", "w1")) > 0
    text = torch_metrics.render_fleet_prometheus(doc)
    assert _mask_reworded(text) == _mask_reworded(jax_metrics.render_fleet_prometheus(doc))
    assert "cct_fleet_members 2" in text and 'cct_jobs_routed_total{node="w' in text
    assert golden_mismatches(str(tmp_path / "served" / "golden"), GOLDEN["consensus"]) == []
    for nm, p in zip(names, inputs):
        torch_cli.main(["consensus", "-i", p, "-o", str(tmp_path / "one"), "-n", nm,
                        "--device", "cpu"])
        served, one = tmp_path / "served" / nm, tmp_path / "one" / nm
        assert _bams(str(served)) == _bams(str(one))
        for rel in _bams(str(one)):
            assert _records(str(served / rel)) == _records(str(one / rel)), (nm, rel)


# ------------------------------------------------------ the command line

def _flags(parser, command):
    sub = next(a for a in parser._actions if a.dest == "command").choices[command]
    return {s for a in sub._actions for s in a.option_strings} | \
        {a.dest for a in sub._actions if not a.option_strings}


@pytest.mark.parametrize("command,extra", [("route", {"--device"}), ("cache", set()),
                                           ("serve", {"--device"})])
def test_fleet_commands_take_every_jax_flag(command, extra):
    port = _flags(torch_cli.build_parser(), command)
    assert port == _flags(jax_cli.build_parser(), command) | extra
