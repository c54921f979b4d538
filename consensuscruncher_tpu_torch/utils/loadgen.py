"""Multi-tenant open-loop load generator + capacity proof for `serve`.

Port of the JAX package's ``tools/loadgen.py``: the same flags, defaults,
traffic, artifact schema and messages, against the port's daemon.
Drives a LIVE daemon (spawned throwaway child by default, or an existing
address via ``--connect``) with sustained synthetic consensus traffic and
measures where the service knee is:

  1. pre-generate per-class input BAMs with ``utils.simulate`` — family
     sizes follow the read_families PMF (``--families_hist`` loads a real
     ``*_read_families.txt``; a built-in duplex-typical PMF otherwise);
  2. for each offered-load level (jobs/second), submit on a fixed
     open-loop arrival schedule — arrivals do NOT slow down when the
     daemon backs up, which is the whole point: admission shedding and
     quota refusals under overload are *data*, not errors
     (``ServeClient.submit_nowait``);
  3. let every accepted job reach a terminal state, then read the level's
     per-class p50/p99 latency, throughput and shed rate from the
     daemon's own tenant/qos-labeled histogram deltas (the same series
     the Prometheus exposition carries — the benchmark exercises the
     observability path it reports through);
  4. emit ``BENCH_LOADGEN_*.json``: the shed-rate / latency / throughput
     curves vs offered load, the daemon's final SLO snapshot, and a
     knee-point capacity estimate (largest offered rate whose aggregate
     shed ratio stayed under ``--shed_knee``).

The spawned child is the port's CLI (``python -m
consensuscruncher_tpu_torch.cli serve|route ... --device D``); ``--device``
is ``cuda`` (the card) by default, and ``cpu`` only when asked.  A child
that cannot serve (no card for ``--device cuda``) exits before its socket
appears, and the generator then fails naming the child's exit code and
log: nothing falls back to the CPU.  The port has no bucket autotuner
(ROADMAP A11), so the artifact's ``autotune`` is null; the recompile
counters read ``cct_recompiles_total``, which in the port counts
kernel-library builds.  ``--smoke`` shrinks everything to a few seconds.

  python -m consensuscruncher_tpu_torch.utils.loadgen --workdir /tmp/lg --smoke
  python -m consensuscruncher_tpu_torch.utils.loadgen --workdir /tmp/lg \\
      --levels 0.5,1,2,4 --duration 30 --out BENCH_LOADGEN.json
  python -m consensuscruncher_tpu_torch.utils.loadgen --workdir /tmp/lg --smoke \\
      --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import time

from consensuscruncher_tpu_torch.obs import prof as obs_prof
from consensuscruncher_tpu_torch.obs.registry import QOS_CLASSES
from consensuscruncher_tpu_torch.obs.slo import quantile_from_histogram
from consensuscruncher_tpu_torch.serve.client import (
    ServeClient,
    ServeClientError,
)
from consensuscruncher_tpu_torch.serve.supervisor import BOOT, child_env
from consensuscruncher_tpu_torch.utils.simulate import (
    SimConfig,
    simulate_bam,
)
from consensuscruncher_tpu_torch.utils.stats import FamilySizeHistogram

# seconds a spawned child may take to bind its socket (a card process
# imports torch and loads the kernel library first)
_READY_S = 300.0

# Family-size PMF used when no --families_hist is given: the shape a
# duplex library with mean family size ~3 actually produces (heavy
# singleton mass, geometric-ish tail) — matches the simulate.py Poisson
# model closely enough that bucket mixes exercise the same vote kernels.
DEFAULT_FAMILY_PMF = {
    1: 0.33, 2: 0.22, 3: 0.17, 4: 0.12, 5: 0.07,
    6: 0.04, 8: 0.03, 12: 0.02,
}

# fragments per synthetic input, by class: interactive jobs are small
# (latency-sensitive), batch jobs are the big ones, scavenger in between
_CLASS_FRAGMENTS = {"interactive": 24, "batch": 96, "scavenger": 48}
_CLASS_FRAGMENTS_SMOKE = {"interactive": 8, "batch": 20, "scavenger": 12}


def _parse_mix(text: str) -> list[tuple[str, str, float]]:
    """``tenant:qos:weight,...`` -> [(tenant, qos, weight), ...]."""
    out = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            tenant, qos, weight = part.split(":")
            w = float(weight)
        except ValueError:
            raise SystemExit(
                f"loadgen: bad --mix entry {part!r} (want tenant:qos:weight)")
        if qos not in QOS_CLASSES:
            raise SystemExit(
                f"loadgen: --mix qos {qos!r} not in {sorted(QOS_CLASSES)}")
        if w <= 0:
            raise SystemExit(f"loadgen: --mix weight must be > 0: {part!r}")
        out.append((tenant, qos, w))
    if not out:
        raise SystemExit("loadgen: --mix is empty")
    return out


def _parse_popularity(text: str) -> float | None:
    """``uniform`` -> None, ``zipf:<s>`` -> s (the rank exponent)."""
    text = (text or "uniform").strip()
    if text == "uniform":
        return None
    if text.startswith("zipf:"):
        try:
            s = float(text.split(":", 1)[1])
        except ValueError:
            raise SystemExit(f"loadgen: bad --popularity {text!r}")
        if s <= 0:
            raise SystemExit("loadgen: zipf exponent must be > 0")
        return s
    raise SystemExit(
        f"loadgen: --popularity wants 'uniform' or 'zipf:<s>', got {text!r}")


_ZIPF_WEIGHTS: dict[tuple[int, float], list[float]] = {}


def _zipf_pick(rng: random.Random, n: int, s: float) -> int:
    """Rank drawn from a finite zipf law: P(rank r) ~ 1/(r+1)^s.  The
    weights are memoised per (corpus size, exponent) — every level and
    class reuses the same table."""
    weights = _ZIPF_WEIGHTS.get((n, s))
    if weights is None:
        weights = [1.0 / float(r + 1) ** s for r in range(n)]
        _ZIPF_WEIGHTS[(n, s)] = weights
    return rng.choices(range(n), weights=weights, k=1)[0]


def _load_family_pmf(path: str) -> dict[int, float]:
    counts = FamilySizeHistogram.read(path)
    total = sum(counts.values())
    if total <= 0:
        raise SystemExit(f"loadgen: empty family histogram {path}")
    return {int(s): c / total for s, c in sorted(counts.items())}


def _sample_mean_family(rng: random.Random, pmf: dict[int, float],
                        draws: int = 24) -> float:
    """Mean of ``draws`` samples from the PMF — each synthetic input gets
    its own mean family size, so the sweep covers a mix of family-size
    regimes instead of one synthetic average."""
    sizes = list(pmf)
    weights = [pmf[s] for s in sizes]
    picked = rng.choices(sizes, weights=weights, k=draws)
    return max(1.0, sum(picked) / len(picked))


def make_inputs(workdir: str, pmf: dict[int, float], per_class: int,
                seed: int, smoke: bool) -> dict[str, list[str]]:
    """Pre-generate ``per_class`` coordinate-sorted barcoded BAMs per qos
    class (generation cost must not pollute the open-loop schedule)."""
    frags = _CLASS_FRAGMENTS_SMOKE if smoke else _CLASS_FRAGMENTS
    rng = random.Random(seed ^ 0x5EED)
    inputs: dict[str, list[str]] = {}
    base = os.path.join(workdir, "inputs")
    os.makedirs(base, exist_ok=True)
    for qos in QOS_CLASSES:
        inputs[qos] = []
        for i in range(per_class):
            path = os.path.join(base, f"{qos}{i}.bam")
            cfg = SimConfig(
                n_fragments=frags[qos],
                mean_family_size=_sample_mean_family(rng, pmf),
                seed=seed * 1000 + len(inputs[qos]) * 100
                + list(QOS_CLASSES).index(qos),
            )
            simulate_bam(path, cfg)
            inputs[qos].append(path)
    return inputs


# ------------------------------------------------------- metrics deltas

def _counter_by_qos(doc: dict, name: str) -> dict[str, int]:
    out = {qos: 0 for qos in QOS_CLASSES}
    for entry in (doc.get("labeled") or {}).get("counters", {}).get(name, []):
        out[entry["labels"]["qos"]] += int(entry["value"])
    return out


def _wall_hist_by_qos(doc: dict) -> dict[str, dict]:
    """tenant_job_wall_s series summed across tenants, keyed by qos."""
    out: dict[str, dict] = {}
    series = (doc.get("labeled") or {}).get("histograms", {}) \
        .get("tenant_job_wall_s", [])
    for h in series:
        qos = h["labels"]["qos"]
        agg = out.get(qos)
        if agg is None:
            out[qos] = {"buckets": list(h["buckets"]),
                        "counts": list(h["counts"])}
        else:
            agg["counts"] = [a + b for a, b in zip(agg["counts"], h["counts"])]
    return out


def _hist_delta(before: dict | None, after: dict) -> dict:
    if before is None:
        return {"buckets": list(after["buckets"]),
                "counts": list(after["counts"])}
    return {"buckets": list(after["buckets"]),
            "counts": [a - b for a, b in
                       zip(after["counts"], before["counts"])]}


def _delta(a: dict[str, int], b: dict[str, int]) -> dict[str, int]:
    return {k: a[k] - b.get(k, 0) for k in a}


# ----------------------------------------------- fleet (router) metrics

def _counter_by_node(doc: dict, name: str) -> dict[str, int]:
    """A node-labeled router counter (node_jobs_routed/steals/resubmits)
    as ``{node: value}``; empty against a plain daemon."""
    out: dict[str, int] = {}
    for entry in (doc.get("labeled") or {}).get("counters", {}).get(name, []):
        node = entry["labels"].get("node")
        if node:
            out[node] = out.get(node, 0) + int(entry["value"])
    return out


def _wall_hist_by_node(doc: dict) -> dict[str, dict]:
    """Each member's job-wall histogram (tenant_job_wall_s summed across
    its tenant/qos series) from the router doc's ``nodes.<name>``."""
    out: dict[str, dict] = {}
    for node, ndoc in (doc.get("nodes") or {}).items():
        series = ((ndoc or {}).get("labeled") or {}) \
            .get("histograms", {}).get("tenant_job_wall_s", [])
        agg = None
        for h in series:
            if agg is None:
                agg = {"buckets": list(h["buckets"]),
                       "counts": list(h["counts"])}
            else:
                agg["counts"] = [a + b
                                 for a, b in zip(agg["counts"], h["counts"])]
        if agg is not None:
            out[node] = agg
    return out


def _recompiles_total(doc: dict) -> int | None:
    """Process-global kernel-library builds (``cct_recompiles_total``):
    the daemon's own counter, or the
    sum over reachable fleet members when ``doc`` came from the router
    (whose own process never compiles anything)."""
    nodes = doc.get("nodes")
    if nodes is None:
        return (doc.get("cumulative") or {}).get("recompiles")
    total = 0
    for ndoc in nodes.values():
        total += ((ndoc or {}).get("cumulative") or {}).get("recompiles", 0)
    return total


def _pull_attribution(client: ServeClient) -> dict | None:
    """Fold the fleet's CCT_PROF wall attribution into the artifact.

    One ``prof`` op at the end of the run: against a router this fans
    out to every up member (``fleet: true``); against a single daemon it
    returns that process's profile.  Returns None when profiling is off
    (no samples and no attributed jobs) or the op is unsupported — older
    daemons and prof-less artifacts stay comparable."""
    try:
        reply = client.request({"op": "prof", "fleet": True}, timeout=30.0)
    except Exception:
        return None
    if not reply.get("ok") or not reply.get("prof"):
        return None
    docs = reply["prof"]
    if isinstance(docs, dict):
        docs = [docs]
    merged = obs_prof.merge_profiles(docs)
    if not merged["samples"] and not any(
            n.get("attr", {}).get("jobs") for n in merged["by_node"].values()):
        return None
    return obs_prof.attribution_doc(merged)


def _node_breakdown(before: dict, after: dict) -> dict[str, dict] | None:
    """Per-node level stats from router metric deltas: jobs routed,
    steals and failover resubmits landed on each member, plus the
    member's own p50/p99 job wall — ``None`` against a plain daemon."""
    if after.get("nodes") is None:
        return None
    routed = _delta(_counter_by_node(after, "node_jobs_routed"),
                    _counter_by_node(before, "node_jobs_routed"))
    steals = _delta(_counter_by_node(after, "node_steals"),
                    _counter_by_node(before, "node_steals"))
    resubmits = _delta(_counter_by_node(after, "node_resubmits"),
                       _counter_by_node(before, "node_resubmits"))
    walls_b = _wall_hist_by_node(before)
    walls_a = _wall_hist_by_node(after)
    out: dict[str, dict] = {}
    for node in sorted(set(routed) | set(walls_a)):
        p50 = p99 = None
        done = 0
        if node in walls_a:
            d = _hist_delta(walls_b.get(node), walls_a[node])
            done = sum(d["counts"])
            if done:
                p50 = quantile_from_histogram(d["buckets"], d["counts"], 0.50)
                p99 = quantile_from_histogram(d["buckets"], d["counts"], 0.99)
        out[node] = {
            "jobs_routed": routed.get(node, 0),
            "jobs_finished": done,
            "steals": steals.get(node, 0),
            "resubmits": resubmits.get(node, 0),
            "p50_s": None if p50 is None else round(p50, 6),
            "p99_s": None if p99 is None else round(p99, 6),
        }
    return out


# ------------------------------------------------------------ one level

def _run_level(client: ServeClient, rng: random.Random, level_idx: int,
               rate: float, duration: float, settle: float,
               mix: list[tuple[str, str, float]],
               inputs: dict[str, list[str]], outdir: str,
               zipf_s: float | None = None) -> dict:
    n_jobs = max(1, int(round(rate * duration)))
    weights = [w for _, _, w in mix]
    before = client.metrics()

    submitted: list[dict] = []
    pending: list[dict] = []
    t0 = time.monotonic()
    max_slip = 0.0
    for i in range(n_jobs):
        due = t0 + i / rate
        now = time.monotonic()
        if due > now:
            time.sleep(due - now)
        else:
            # open-loop contract check: if submission itself can't keep
            # up, the offered rate was never actually offered
            max_slip = max(max_slip, now - due)
        tenant, qos, _ = rng.choices(mix, weights=weights, k=1)[0]
        pool = inputs[qos]
        if zipf_s is not None:
            # finite-corpus popularity: repeated draws of a hot input
            # re-submit the SAME spec params (only the output dir moves),
            # so a fleet result cache can answer them without recompute
            bam = pool[_zipf_pick(rng, len(pool), zipf_s)]
        else:
            bam = rng.choice(pool)
        spec = {
            "input": bam,
            "output": os.path.join(outdir, f"j{i}"),
            "name": "lg",
            "cutoff": 0.7, "qualscore": 0, "scorrect": True,
            "max_mismatch": 0, "bdelim": "|", "compress_level": 1,
            "tenant": tenant, "qos": qos,
        }
        t_sub = time.monotonic()
        reply = client.submit_nowait(spec)
        rec = {"tenant": tenant, "qos": qos, "t_submit": t_sub}
        if reply.get("ok"):
            rec["key"] = reply["key"]
            pending.append(rec)
        else:
            rec["refused"] = ("quota" if reply.get("quota")
                              else "shed" if reply.get("shed") else "queue")
        submitted.append(rec)
    submit_wall = time.monotonic() - t0

    # settle: every accepted job must be terminal before the after-
    # snapshot, or the histogram delta would bleed into the next level
    deadline = time.monotonic() + duration + settle
    lost = 0
    while pending and time.monotonic() < deadline:
        still = []
        for rec in pending:
            try:
                job = client.status(key=rec["key"])
            except ServeClientError:
                rec["state"] = "lost"
                lost += 1
                continue
            if job["state"] in ("done", "failed"):
                rec["state"] = job["state"]
                rec["cached"] = bool(job.get("cached"))
                rec["latency_s"] = time.monotonic() - rec["t_submit"]
            else:
                still.append(rec)
        pending = still
        if pending:
            time.sleep(0.25)
    for rec in pending:
        rec["state"] = "unsettled"
    lost += len(pending)
    level_wall = time.monotonic() - t0
    after = client.metrics()
    nodes = _node_breakdown(before, after)

    # per-class stats from the daemon's own labeled series
    walls_b = _wall_hist_by_qos(before)
    walls_a = _wall_hist_by_qos(after)
    classes: dict[str, dict] = {}
    agg_done = agg_shed = agg_submitted = 0
    for qos in QOS_CLASSES:
        done = _delta(_counter_by_qos(after, "tenant_jobs_done"),
                      _counter_by_qos(before, "tenant_jobs_done"))[qos]
        failed = _delta(_counter_by_qos(after, "tenant_jobs_failed"),
                        _counter_by_qos(before, "tenant_jobs_failed"))[qos]
        shed = _delta(_counter_by_qos(after, "tenant_jobs_shed"),
                      _counter_by_qos(before, "tenant_jobs_shed"))[qos]
        quota = _delta(
            _counter_by_qos(after, "tenant_jobs_quota_refused"),
            _counter_by_qos(before, "tenant_jobs_quota_refused"))[qos]
        subs = sum(1 for r in submitted if r["qos"] == qos)
        p50 = p99 = None
        if qos in walls_a:
            d = _hist_delta(walls_b.get(qos), walls_a[qos])
            p50 = quantile_from_histogram(d["buckets"], d["counts"], 0.50)
            p99 = quantile_from_histogram(d["buckets"], d["counts"], 0.99)
        classes[qos] = {
            "submitted": subs, "done": done, "failed": failed,
            "shed": shed, "quota_refused": quota,
            "shed_ratio": round(shed / subs, 6) if subs else 0.0,
            "p50_s": None if p50 is None else round(p50, 6),
            "p99_s": None if p99 is None else round(p99, 6),
            "throughput_jobs_per_s": round(done / level_wall, 6),
        }
        agg_done += done
        agg_shed += shed
        agg_submitted += subs

    # result-cache split: ``cached`` rides the job doc (scheduler
    # describe() / router cache answers), latency is client-observed
    # submit->terminal wall — so the hit-vs-miss gap is what a caller
    # actually feels, not a server-side accounting artifact
    finished = [r for r in submitted if r.get("state") == "done"]
    hits = sorted(r["latency_s"] for r in finished if r.get("cached"))
    misses = sorted(r["latency_s"] for r in finished if not r.get("cached"))

    def _lat(lats: list[float]) -> dict:
        if not lats:
            return {"p50_s": None, "mean_s": None}
        return {"p50_s": round(lats[len(lats) // 2], 6),
                "mean_s": round(sum(lats) / len(lats), 6)}

    cache = {
        "hits": len(hits),
        "misses": len(misses),
        "hit_rate": (round(len(hits) / len(finished), 6)
                     if finished else None),
        "hit_latency": _lat(hits),
        "miss_latency": _lat(misses),
    }

    return {
        "level": level_idx,
        "offered_jobs_per_s": rate,
        "offered_jobs": n_jobs,
        "duration_s": duration,
        "submit_wall_s": round(submit_wall, 3),
        "level_wall_s": round(level_wall, 3),
        "max_schedule_slip_s": round(max_slip, 3),
        "classes": classes,
        "cache": cache,
        "nodes": nodes,
        "aggregate": {
            "submitted": agg_submitted,
            "done": agg_done,
            "shed": agg_shed,
            "lost": lost,
            "shed_ratio": (round(agg_shed / agg_submitted, 6)
                           if agg_submitted else 0.0),
            "throughput_jobs_per_s": round(agg_done / level_wall, 6),
        },
    }


def knee_estimate(levels: list[dict], shed_knee: float) -> dict:
    """Largest offered rate whose aggregate shed ratio stayed under the
    threshold (and nothing was lost), plus the best goodput seen anywhere
    — the two numbers a capacity plan needs."""
    ok = [lv for lv in levels
          if lv["aggregate"]["shed_ratio"] <= shed_knee
          and lv["aggregate"]["lost"] == 0]
    knee = max((lv["offered_jobs_per_s"] for lv in ok), default=None)
    peak = max((lv["aggregate"]["throughput_jobs_per_s"] for lv in levels),
               default=0.0)
    return {
        "shed_knee_threshold": shed_knee,
        "knee_offered_jobs_per_s": knee,
        "max_throughput_jobs_per_s": peak,
    }


# ---------------------------------------------------- fleet scale sweep

def _sweep_workers(args) -> int:
    """``--sweep_workers 1,2,4``: the full level sweep once per worker
    count (fresh fleet each time, identical traffic seed/mix), combined
    into one artifact with per-count knees, peak throughputs and
    speedups vs the 1-worker run.  ``host_cpus`` is recorded because
    fleet scaling is bounded by the silicon underneath: on a 1-CPU host
    the workers time-slice one core and the sweep measures routing
    overhead + failover correctness, not parallel speedup."""
    counts = sorted({int(c) for c in args.sweep_workers.split(",")
                     if c.strip()})
    if not counts or counts[0] < 1:
        raise SystemExit("loadgen: --sweep_workers wants counts >= 1")
    try:
        host_cpus = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        host_cpus = os.cpu_count() or 1
    runs: dict[str, dict] = {}
    worst = 0
    for n in counts:
        workdir = os.path.join(args.workdir, f"sweep_w{n}")
        out = os.path.join(args.workdir, f"sweep_w{n}.json")
        argv = [
            "--workdir", workdir, "--workers", str(n),
            "--levels", args.levels, "--duration", str(args.duration),
            "--settle", str(args.settle), "--mix", args.mix,
            "--inputs_per_class", str(args.inputs_per_class),
            "--seed", str(args.seed), "--gang_size", str(args.gang_size),
            "--queue_bound", str(args.queue_bound),
            "--class_weights", args.class_weights,
            "--slo_targets", args.slo_targets,
            "--shed_knee", str(args.shed_knee), "--out", out,
            "--device", args.device,
        ]
        if args.families_hist:
            argv += ["--families_hist", args.families_hist]
        if args.compile_cache:
            argv += ["--compile_cache", args.compile_cache]
        if args.popularity and args.popularity != "uniform":
            argv += ["--popularity", args.popularity]
        if args.result_cache:
            argv += ["--result_cache", args.result_cache]
        if args.tenant_queue_cap:
            argv += ["--tenant_queue_cap", str(args.tenant_queue_cap)]
        if args.smoke:
            argv += ["--smoke"]
        print(f"loadgen: ===== sweep: {n} worker(s) =====", flush=True)
        worst = max(worst, main(argv))
        runs[str(n)] = json.load(open(out))
    base_peak = runs[str(counts[0])]["knee"]["max_throughput_jobs_per_s"]
    scaling = {
        str(n): {
            "workers": n,
            "knee_offered_jobs_per_s":
                runs[str(n)]["knee"]["knee_offered_jobs_per_s"],
            "max_throughput_jobs_per_s":
                runs[str(n)]["knee"]["max_throughput_jobs_per_s"],
            "speedup_vs_1_worker": (
                round(runs[str(n)]["knee"]["max_throughput_jobs_per_s"]
                      / base_peak, 4) if base_peak else None),
        }
        for n in counts
    }
    doc = {
        "bench": "loadgen_fleet_sweep",
        "created_unix": time.time(),
        "host_cpus": host_cpus,
        "cpu_bound_note": (
            "worker daemons are CPU-bound on this host; throughput "
            "scaling with worker count requires at least one core per "
            "worker — with host_cpus <= worker count the fleet "
            "time-slices and the sweep measures routing overhead and "
            "correctness, not parallel speedup"),
        "config": runs[str(counts[0])]["config"],
        "scaling": scaling,
        "runs": runs,
    }
    out = args.out or time.strftime(
        "BENCH_LOADGEN_SWEEP_%Y%m%d-%H%M%SZ.json", time.gmtime())
    tmp = out + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, out)
    print(f"loadgen: wrote {out}", flush=True)
    for n in counts:
        s = scaling[str(n)]
        print(f"loadgen: {n} worker(s): knee="
              f"{s['knee_offered_jobs_per_s']} jobs/s, peak="
              f"{s['max_throughput_jobs_per_s']:g} jobs/s, speedup="
              f"{s['speedup_vs_1_worker']}", flush=True)
    return worst


# ------------------------------------------------------------------ main

def _await_socket(daemon: subprocess.Popen, address: str,
                  log_path: str) -> None:
    """Wait for the spawned child's socket; a child that exits first (no
    card for ``--device cuda``, a bad flag) fails the run loudly with its
    exit code and the tail of its log instead of a client retry storm."""
    deadline = time.monotonic() + _READY_S
    while not os.path.exists(address):
        code = daemon.poll()
        if code is not None:
            with open(log_path, "rb") as fh:
                tail = fh.read()[-2000:].decode("utf-8", "replace")
            raise SystemExit(f"loadgen: the spawned child exited {code} before "
                             f"serving (log: {log_path}):\n{tail}")
        if time.monotonic() > deadline:
            raise SystemExit(f"loadgen: no socket at {address} after "
                             f"{_READY_S:g}s (log: {log_path})")
        time.sleep(0.1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True,
                    help="scratch dir: socket, inputs, job outputs, daemon log")
    ap.add_argument("--connect", default="",
                    help="existing daemon OR fleet router (unix socket "
                         "path or host:port — the router speaks the same "
                         "keyed protocol); empty = spawn a throwaway "
                         "daemon in --workdir")
    ap.add_argument("--workers", type=int, default=0,
                    help="spawn a FLEET instead of one daemon: N worker "
                         "daemons behind a router ('route --spawn N'); "
                         "level reports gain a per-node breakdown "
                         "(0 = single daemon; ignored with --connect)")
    ap.add_argument("--sweep_workers", default="",
                    help="capacity-scaling sweep: comma-separated worker "
                         "counts (e.g. '1,2,4'); runs the FULL level "
                         "sweep once per count and writes one combined "
                         "artifact with per-count knees and speedups")
    ap.add_argument("--levels", default="0.5,1,2,4",
                    help="comma-separated offered-load levels, jobs/second")
    ap.add_argument("--duration", type=float, default=30.0,
                    help="seconds of sustained submission per level")
    ap.add_argument("--settle", type=float, default=180.0,
                    help="extra seconds to let accepted jobs finish per level")
    ap.add_argument("--mix",
                    default="alpha:interactive:6,beta:batch:3,"
                            "gamma:scavenger:1",
                    help="traffic mix as tenant:qos:weight,...")
    ap.add_argument("--families_hist", default="",
                    help="a *_read_families.txt to draw family sizes from "
                         "(default: built-in duplex-typical PMF)")
    ap.add_argument("--popularity", default="uniform",
                    help="input popularity over the finite per-class "
                         "corpus: 'uniform' (default) or 'zipf:<s>' — "
                         "zipf re-draws hot inputs with identical spec "
                         "params, so a --result_cache fleet answers the "
                         "repeats from the content-addressed store; the "
                         "level report gains a hit-rate and hit-vs-miss "
                         "latency split either way")
    ap.add_argument("--result_cache", default="",
                    help="forwarded to the spawned daemon/router: "
                         "content-addressed result store root (hits skip "
                         "recompute and return byte-identical outputs)")
    ap.add_argument("--inputs_per_class", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gang_size", type=int, default=2)
    ap.add_argument("--queue_bound", type=int, default=64)
    ap.add_argument("--class_weights",
                    default="interactive=8,batch=3,scavenger=1")
    ap.add_argument("--slo_targets",
                    default="interactive=20,batch=90,scavenger=240",
                    help="per-class SLO targets forwarded to the spawned "
                         "daemon (they double as implicit deadlines, so "
                         "overload sheds instead of queueing unboundedly)")
    ap.add_argument("--tenant_queue_cap", type=int, default=0,
                    help="per-tenant queue-slot quota for the spawned "
                         "daemon (0 = unlimited)")
    ap.add_argument("--shed_knee", type=float, default=0.05,
                    help="max aggregate shed ratio still counted as "
                         "'within capacity' for the knee estimate")
    ap.add_argument("--out", default="",
                    help="output JSON path (default: "
                         "BENCH_LOADGEN_<utc-stamp>.json in the cwd)")
    ap.add_argument("--compile_cache", default="",
                    help="forwarded to the throwaway daemon: the kernel "
                         "build directory (run twice with the same dir to "
                         "exercise the warm path: no kernel build)")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale run for CI: tiny inputs, short "
                         "levels, short settle")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="forwarded to the spawned daemon/router: where "
                         "served jobs vote (default cuda: the card; the "
                         "child exits without one). cpu runs the kernels' "
                         "plain PyTorch versions")
    args = ap.parse_args(argv)

    if args.sweep_workers:
        return _sweep_workers(args)

    if args.smoke:
        args.levels = "1,3,8"
        args.duration = 3.0
        args.settle = 60.0
        args.inputs_per_class = 1
    rates = [float(r) for r in args.levels.split(",") if r.strip()]
    if len(rates) < (1 if args.smoke else 3):
        raise SystemExit("loadgen: need at least 3 --levels for a curve")
    mix = _parse_mix(args.mix)
    zipf_s = _parse_popularity(args.popularity)
    pmf = (_load_family_pmf(args.families_hist) if args.families_hist
           else dict(DEFAULT_FAMILY_PMF))

    os.makedirs(args.workdir, exist_ok=True)
    print(f"loadgen: generating {args.inputs_per_class} input BAM(s) per "
          f"class under {args.workdir}/inputs", flush=True)
    inputs = make_inputs(args.workdir, pmf, args.inputs_per_class,
                         args.seed, args.smoke)

    daemon = None
    log_fh = None
    if args.connect:
        address = (tuple(args.connect.rsplit(":", 1))
                   if ":" in args.connect and os.sep not in args.connect
                   else args.connect)
        if isinstance(address, tuple):
            address = (address[0], int(address[1]))
    elif args.workers > 0:
        # fleet mode: the route CLI spawns the workers (per-worker
        # journal + compile cache under workdir/fleet) and fronts them
        address = os.path.join(args.workdir, "route.sock")
        daemon_cmd = [sys.executable, *BOOT,
            "route", "--spawn", str(args.workers),
            "--workdir", os.path.join(args.workdir, "fleet"),
            "--socket", address,
            "--gang_size", str(args.gang_size),
            "--queue_bound", str(args.queue_bound),
            "--device", args.device, "--drain_s", "60",
            "--class_weights", args.class_weights,
            "--slo_targets", args.slo_targets,
        ]
        if args.compile_cache:
            daemon_cmd += ["--compile_cache", args.compile_cache]
        if args.result_cache:
            daemon_cmd += ["--result_cache", args.result_cache]
        log_path = os.path.join(args.workdir, "router.log")
        log_fh = open(log_path, "ab")
        daemon = subprocess.Popen(daemon_cmd, stdout=log_fh, stderr=log_fh,
                                  env=child_env())
        print(f"loadgen: spawned router pid {daemon.pid} on {address} "
              f"({args.workers} workers; log: {log_path})", flush=True)
    else:
        address = os.path.join(args.workdir, "loadgen.sock")
        daemon_cmd = [sys.executable, *BOOT,
            "serve", "--socket", address,
            "--gang_size", str(args.gang_size),
            "--queue_bound", str(args.queue_bound),
            "--device", args.device, "--drain_s", "60",
            "--class_weights", args.class_weights,
            "--slo_targets", args.slo_targets,
        ]
        if args.tenant_queue_cap > 0:
            daemon_cmd += ["--tenant_queue_cap", str(args.tenant_queue_cap)]
        if args.compile_cache:
            daemon_cmd += ["--compile_cache", args.compile_cache]
        if args.result_cache:
            daemon_cmd += ["--result_cache", args.result_cache]
        log_path = os.path.join(args.workdir, "daemon.log")
        log_fh = open(log_path, "ab")
        daemon = subprocess.Popen(daemon_cmd, stdout=log_fh, stderr=log_fh,
                                  env=child_env())
        print(f"loadgen: spawned daemon pid {daemon.pid} on {address} "
              f"(log: {log_path})", flush=True)

    client = ServeClient(address, retries=60, retry_base_s=0.25)
    rng = random.Random(args.seed)
    levels: list[dict] = []
    rc = 0
    try:
        if daemon is not None:
            _await_socket(daemon, address, log_path)
        health = client.healthz()
        print(f"loadgen: daemon {health['status']} (pid {health['pid']}); "
              f"mix={args.mix}", flush=True)
        # Deterministic preflight: a job's dispatch shapes are a function of
        # its input + spec + gang composition (pow2-bucketed), so two rounds
        # — every job solo, then a gang_size burst of everything — cover the
        # shapes the measured levels can form.  The levels must then add
        # ZERO to the daemon's recompile counter (in the port, kernel-
        # library builds: a warm daemon builds none).
        pre_dir = os.path.join(args.workdir, "out", "preflight")
        os.makedirs(pre_dir, exist_ok=True)
        pre_jobs = [(qos, bam) for qos in sorted(inputs)
                    for bam in inputs[qos]]
        pre_seq = [0]

        def _submit_pre(qos, bam):
            spec = {
                "input": bam,
                "output": os.path.join(pre_dir, f"p{pre_seq[0]}"),
                "name": "lg-preflight",
                "cutoff": 0.7, "qualscore": 0, "scorrect": True,
                "max_mismatch": 0, "bdelim": "|", "compress_level": 1,
                "tenant": "preflight", "qos": qos,
            }
            pre_seq[0] += 1
            reply = client.submit_nowait(spec)
            return reply["key"] if reply.get("ok") else None

        def _wait_pre(keys):
            keys = [k for k in keys if k]
            deadline = time.monotonic() + args.settle
            while keys and time.monotonic() < deadline:
                keys = [k for k in keys if client.status(key=k)["state"]
                        not in ("done", "failed")]
                if keys:
                    time.sleep(0.25)

        for qos, bam in pre_jobs:       # round 1: solo (single-job paths)
            _wait_pre([_submit_pre(qos, bam)])
        burst = []                      # round 2: ganged dispatch shapes
        for _ in range(max(1, args.gang_size)):
            burst.extend(_submit_pre(qos, bam) for qos, bam in pre_jobs)
        _wait_pre(burst)
        pre_recompiles = _recompiles_total(client.metrics())
        print(f"loadgen: preflight {pre_seq[0]} job(s) settled "
              f"(recompiles_total={pre_recompiles})", flush=True)
        for idx, rate in enumerate(rates):
            outdir = os.path.join(args.workdir, "out", f"L{idx}")
            os.makedirs(outdir, exist_ok=True)
            print(f"loadgen: level {idx}: {rate:g} jobs/s for "
                  f"{args.duration:g}s ...", flush=True)
            lv = _run_level(client, rng, idx, rate, args.duration,
                            args.settle, mix, inputs, outdir,
                            zipf_s=zipf_s)
            agg = lv["aggregate"]
            print(f"loadgen: level {idx}: submitted={agg['submitted']} "
                  f"done={agg['done']} shed={agg['shed']} "
                  f"lost={agg['lost']} "
                  f"thru={agg['throughput_jobs_per_s']:g}/s "
                  f"shed_ratio={agg['shed_ratio']:g}", flush=True)
            cc = lv["cache"]
            if cc["hits"]:
                print(f"loadgen: level {idx}: cache hits={cc['hits']} "
                      f"misses={cc['misses']} "
                      f"hit_rate={cc['hit_rate']} "
                      f"hit_p50={cc['hit_latency']['p50_s']} "
                      f"miss_p50={cc['miss_latency']['p50_s']}", flush=True)
            if agg["lost"]:
                rc = 1
            if lv["nodes"]:
                for node, st in sorted(lv["nodes"].items()):
                    print(f"loadgen:   node {node}: "
                          f"routed={st['jobs_routed']} "
                          f"finished={st['jobs_finished']} "
                          f"steals={st['steals']} "
                          f"resubmits={st['resubmits']} "
                          f"p50={st['p50_s']} p99={st['p99_s']}",
                          flush=True)
            # process-global kernel-library builds after this level: a
            # warm daemon's steady-state levels must not add any (the
            # perf gate checks it's flat past level 0)
            lv["recompiles_total"] = _recompiles_total(client.metrics())
            levels.append(lv)
        final = client.metrics()
        attribution = _pull_attribution(client)
        ch = sum(lv["cache"]["hits"] for lv in levels)
        cm = sum(lv["cache"]["misses"] for lv in levels)
        cache_total = {
            "hits": ch, "misses": cm,
            "hit_rate": round(ch / (ch + cm), 6) if ch + cm else None,
        }
        doc = {
            "bench": "loadgen",
            "created_unix": time.time(),
            "config": {
                "levels_jobs_per_s": rates,
                "duration_s": args.duration,
                "mix": args.mix,
                "class_weights": args.class_weights,
                "slo_targets": args.slo_targets,
                "tenant_queue_cap": args.tenant_queue_cap,
                "gang_size": args.gang_size,
                "queue_bound": args.queue_bound,
                "families_hist": args.families_hist or "builtin",
                "popularity": args.popularity,
                "corpus_size": sum(len(v) for v in inputs.values()),
                "result_cache": args.result_cache or None,
                "seed": args.seed,
                "smoke": args.smoke,
                "workers": args.workers,
            },
            "preflight_recompiles_total": pre_recompiles,
            "levels": levels,
            "knee": knee_estimate(levels, args.shed_knee),
            "cache": cache_total,
            "slo": final.get("slo"),
            "queued_by_class": final.get("queued_by_class"),
            # no bucket autotuner in the port (ROADMAP A11)
            "autotune": None,
        }
        if attribution is not None:
            doc["attribution"] = attribution
        if final.get("nodes") is not None:  # fleet run: router doc
            doc["fleet"] = final.get("fleet")
            doc["router_cumulative"] = final.get("cumulative")
            doc["nodes_final"] = {
                node: {k: (ndoc or {}).get(k)
                       for k in ("slo", "autotune", "queued_by_class")}
                for node, ndoc in final["nodes"].items()}
        out = args.out or time.strftime("BENCH_LOADGEN_%Y%m%d-%H%M%SZ.json",
                                        time.gmtime())
        tmp = out + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, out)
        knee = doc["knee"]
        print(f"loadgen: wrote {out}", flush=True)
        print(f"loadgen: knee={knee['knee_offered_jobs_per_s']} jobs/s "
              f"(shed<= {args.shed_knee:g}), peak throughput="
              f"{knee['max_throughput_jobs_per_s']:g} jobs/s", flush=True)
        if cache_total["hits"] or cache_total["misses"]:
            print(f"loadgen: cache hit_rate={cache_total['hit_rate']} "
                  f"({cache_total['hits']} hit / "
                  f"{cache_total['misses']} miss)", flush=True)
        return rc
    finally:
        if daemon is not None:
            try:
                daemon.send_signal(signal.SIGTERM)
                daemon.wait(timeout=90)
            except Exception:
                daemon.kill()
                daemon.wait(timeout=10)
            if log_fh is not None:
                log_fh.close()


if __name__ == "__main__":
    sys.exit(main())
