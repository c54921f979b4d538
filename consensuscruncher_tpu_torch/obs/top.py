"""``cct top``: a live terminal observatory over the serve fleet.

Polls the router's (or a lone daemon's) ``metrics`` wire op in
Prometheus text form — the SAME exposition a scraper would read, so what
the operator watches and what the dashboards alert on can never drift —
and renders one compact frame per interval: router epoch and HA state,
a per-node table (up / queue depth / running / routed / steals /
resubmits / quarantined / trace spans / orphans), a per-qos SLO panel
(p50/p99 latency, shed ratio, multi-window burn rates), a ``net:`` row
(wire crc errors, duplicate frames absorbed, wire timeouts, reaped
connections, journal crc skips, cache integrity misses) and the
fleet-wide HA counters (failovers, adoptions, fencing rejections,
quarantines, breaker trips, brownout refusals, trace links).  Columns a
pre-quarantine daemon never exports render as dashes, not errors.

Everything below the socket read is PURE: :func:`parse_prometheus` turns
exposition text into ``{metric: [(labels, value), ...]}`` and
:func:`render_frame` turns that into the frame string — both are unit-
tested without a terminal or a daemon.  ``run_top`` owns the only state:
the poll loop, the cbreak keyboard (q quit, p pause, r refresh now) and
the ANSI clear between frames.  ``--once`` renders a single frame to
stdout and exits — scripts and tests use it; no tty required.

Port of ``consensuscruncher_tpu/obs/top.py``, line for line: it reads the
metric families the port's ``obs/registry.py`` names (the same names as
the reference's) over the port's ``serve/client.ServeClient`` and
``obs/prof``.  It is host code and opens no CUDA context.
"""

from __future__ import annotations

import select
import sys
import time

# ------------------------------------------------------------- parsing


def parse_prometheus(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Exposition text -> ``{metric: [(labels, value), ...]}``.

    Tolerant by design: comment/HELP/TYPE lines are skipped, a malformed
    line is dropped (never fatal — the observatory must keep rendering
    through a half-written scrape), repeated series accumulate as
    separate entries (the caller decides whether to sum or max them).
    """
    series: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            if "{" in line:
                name, rest = line.split("{", 1)
                labelblob, value = rest.rsplit("}", 1)
                labels = _parse_labels(labelblob)
            else:
                name, value = line.rsplit(None, 1)
                labels = {}
            series.setdefault(name.strip(), []).append(
                (labels, float(value)))
        except ValueError:
            continue
    return series


def _parse_labels(blob: str) -> dict:
    """``k1="v1",k2="v2"`` -> dict.  Our exposition never emits escaped
    quotes inside values, so a quote-boundary scan suffices."""
    labels: dict[str, str] = {}
    i, n = 0, len(blob)
    while i < n:
        eq = blob.find("=", i)
        if eq < 0:
            break
        key = blob[i:eq].strip().strip(",")
        q1 = blob.find('"', eq)
        q2 = blob.find('"', q1 + 1)
        if q1 < 0 or q2 < 0:
            break
        labels[key] = blob[q1 + 1:q2]
        i = q2 + 1
    return labels


def _sum(series: dict, metric: str, **match) -> float:
    return sum(v for labels, v in series.get(metric, [])
               if all(labels.get(k) == w for k, w in match.items()))


def _by_label(series: dict, metric: str, label: str) -> dict[str, float]:
    """Sum a metric's entries grouped by one label's value."""
    out: dict[str, float] = {}
    for labels, v in series.get(metric, []):
        who = labels.get(label)
        if who is not None:
            out[who] = out.get(who, 0.0) + v
    return out


def _quantile(buckets: list[tuple[float, float]], q: float) -> float | None:
    """Histogram-estimate quantile from cumulative ``(le, count)`` rows
    (the exposition's ``_bucket`` lines); None when the histogram is
    empty.  Returns the upper bound of the first bucket covering q —
    the same estimate the SLO monitor reports."""
    if not buckets:
        return None
    buckets = sorted(buckets)
    total = buckets[-1][1]
    if total <= 0:
        return None
    want = q * total
    for le, acc in buckets:
        if acc >= want:
            return le
    return buckets[-1][0]


def qos_latency(series: dict) -> dict[str, dict]:
    """Per-qos p50/p99 estimates from the fleet-merged labeled
    ``tenant_job_wall_s`` histograms (summed across tenants and nodes;
    +Inf rows are kept for totals, excluded from the estimate)."""
    per_qos: dict[str, dict[float, float]] = {}
    for labels, v in series.get("cct_tenant_job_wall_s_bucket", []):
        qos, le = labels.get("qos"), labels.get("le")
        if qos is None or le is None:
            continue
        bound = float("inf") if le == "+Inf" else float(le)
        acc = per_qos.setdefault(qos, {})
        acc[bound] = acc.get(bound, 0.0) + v
    out: dict[str, dict] = {}
    for qos, acc in per_qos.items():
        finite = [(le, n) for le, n in acc.items() if le != float("inf")]
        out[qos] = {
            "count": acc.get(float("inf"), 0.0),
            "p50": _quantile(finite, 0.50),
            "p99": _quantile(finite, 0.99),
        }
    return out


# ------------------------------------------------------------ rendering

def _fmt_n(v: float | None) -> str:
    if v is None:
        return "-"
    if v != v:  # NaN
        return "-"
    if v == int(v):
        return str(int(v))
    return f"{v:.2f}"


def _fmt_s(v: float | None) -> str:
    return "-" if v is None else f"{v:g}s"


def render_frame(series: dict, source: str,
                 paused: bool = False, now: float | None = None,
                 prof: dict | None = None) -> str:
    """One observatory frame from parsed exposition series.  Pure: the
    clock is injectable and absent fleet metrics degrade to the lone-
    daemon layout instead of failing.  ``prof`` is an optional per-node
    profiler panel (``obs.prof.top_panel`` shape), rendered when the
    operator toggled it on with the ``f`` key."""
    stamp = time.strftime("%H:%M:%S",
                          time.localtime(now if now is not None
                                         else time.time()))
    lines = [f"cct top — {source} — {stamp}"
             + ("  [paused]" if paused else "")]

    epoch = series.get("cct_router_epoch")
    if epoch:
        active = _sum(series, "cct_router_active")
        lines.append(
            f"router: epoch {_fmt_n(epoch[0][1])} "
            f"({'active' if active else 'standby/fenced'})  "
            f"fleet {_fmt_n(_sum(series, 'cct_fleet_members_up'))}"
            f"/{_fmt_n(_sum(series, 'cct_fleet_members'))} up")

    nodes = sorted(set(_by_label(series, "cct_fleet_member_up", "node"))
                   | set(_by_label(series, "cct_trace_spans_emitted_total",
                                   "node")))
    if nodes:
        up = _by_label(series, "cct_fleet_member_up", "node")
        cols = {
            "queue": _by_label(series, "cct_fleet_queue_depth", "node"),
            "run": _by_label(series, "cct_fleet_running", "node"),
            "routed": _by_label(series, "cct_node_jobs_routed_total", "node"),
            "steals": _by_label(series, "cct_node_steals_total", "node"),
            "resub": _by_label(series, "cct_node_resubmits_total", "node"),
            # quarantined poison keys per member: absent entirely on
            # pre-quarantine daemons, so the cell dash-degrades
            "quar": _by_label(series, "cct_fleet_quarantined", "node"),
            "spans": _by_label(series, "cct_trace_spans_emitted_total",
                               "node"),
            "orphans": _by_label(series, "cct_trace_orphans_total", "node"),
        }
        header = (f"{'NODE':<10} {'UP':<4} {'QUEUE':>5} {'RUN':>4} "
                  f"{'ROUTED':>7} {'STEALS':>6} {'RESUB':>5} "
                  f"{'QUAR':>4} {'SPANS':>7} {'ORPH':>4}")
        lines.append(header)
        for node in nodes:
            lines.append(
                f"{node:<10} {'up' if up.get(node) else 'DOWN':<4} "
                f"{_fmt_n(cols['queue'].get(node)):>5} "
                f"{_fmt_n(cols['run'].get(node)):>4} "
                f"{_fmt_n(cols['routed'].get(node)):>7} "
                f"{_fmt_n(cols['steals'].get(node)):>6} "
                f"{_fmt_n(cols['resub'].get(node)):>5} "
                f"{_fmt_n(cols['quar'].get(node)):>4} "
                f"{_fmt_n(cols['spans'].get(node)):>7} "
                f"{_fmt_n(cols['orphans'].get(node)):>4}")

    lat = qos_latency(series)
    burn: dict[str, dict[str, float]] = {}
    for labels, v in series.get("cct_slo_burn_rate", []):
        qos, window = labels.get("qos"), labels.get("window")
        if qos and window:
            w = burn.setdefault(qos, {})
            w[window] = max(w.get(window, 0.0), v)  # worst node wins
    if lat or burn:
        lines.append(f"{'QOS':<12} {'JOBS':>6} {'P50':>8} {'P99':>8}  BURN")
        for qos in sorted(set(lat) | set(burn)):
            row = lat.get(qos) or {}
            burns = "  ".join(
                f"{w}={b:.2f}" for w, b in sorted(
                    (burn.get(qos) or {}).items())) or "-"
            lines.append(f"{qos:<12} {_fmt_n(row.get('count')):>6} "
                         f"{_fmt_s(row.get('p50')):>8} "
                         f"{_fmt_s(row.get('p99')):>8}  {burns}")

    def _opt(metric: str) -> float | None:
        return _sum(series, metric) if metric in series else None

    # cache panel: fleet-wide content-addressed result-cache health.
    # hit% is hits/(hits+misses) over every process's cumulative series
    # (router consult-before-dispatch + worker-side lookups).
    hits = _sum(series, "cct_cache_hits_total")
    misses = _sum(series, "cct_cache_misses_total")
    if hits or misses or "cct_cache_inserts_total" in series:
        rate = 100.0 * hits / (hits + misses) if (hits + misses) else 0.0
        lines.append(
            f"cache: hits={_fmt_n(hits)}  misses={_fmt_n(misses)}  "
            f"hit%={rate:.1f}  "
            f"neg={_fmt_n(_sum(series, 'cct_cache_negative_hits_total'))}  "
            f"inserts={_fmt_n(_sum(series, 'cct_cache_inserts_total'))}  "
            f"evicted={_fmt_n(_sum(series, 'cct_cache_evictions_total'))}  "
            f"bytes={_fmt_n(_sum(series, 'cct_cache_bytes_total'))}")

    # net panel: wire/at-rest integrity and deadline-reaper health.
    # Every cell dash-degrades on pre-envelope daemons (series absent
    # entirely); a zero means "measured and clean", a dash means "this
    # daemon predates the wire envelope".
    net_cols = [
        ("crc_err", "cct_wire_crc_errors_total"),
        ("dup_drop", "cct_wire_dup_dropped_total"),
        ("timeouts", "cct_wire_timeouts_total"),
        ("reaped", "cct_conns_reaped_total"),
        ("jrnl_skip", "cct_journal_crc_skipped_total"),
        ("cache_int", "cct_cache_integrity_misses_total"),
    ]
    if any(metric in series for _, metric in net_cols):
        lines.append(
            "net: " + "  ".join(f"{label}={_fmt_n(_opt(metric))}"
                                for label, metric in net_cols))

    # qc panel: consensus-quality yield counters picked up from per-run
    # qc.json docs at job completion.  Pre-QC daemons never emit these
    # series, so each cell degrades to a dash — a dash means "daemon
    # predates QC", a zero means "measured and empty".
    qc_cols = [
        ("fam", "cct_tenant_qc_families_total"),
        ("sscs", "cct_tenant_qc_sscs_written_total"),
        ("single", "cct_tenant_qc_singletons_total"),
        ("dcs", "cct_tenant_qc_dcs_written_total"),
        ("rescued", "cct_tenant_qc_rescued_total"),
        ("docs", "cct_qc_docs_committed_total"),
        ("shed_bypass", "cct_cache_shed_bypass_total"),
        ("skipped", "cct_qc_ranges_skipped_total"),
    ]
    if any(metric in series for _, metric in qc_cols):
        dis_sum = _opt("cct_tenant_qc_disagreement_sum")
        dis_count = _opt("cct_tenant_qc_disagreement_count")
        disagree = (f"{100.0 * dis_sum / dis_count:.2f}%"
                    if dis_sum is not None and dis_count else "-")
        lines.append(
            "qc: " + "  ".join(f"{label}={_fmt_n(_opt(metric))}"
                               for label, metric in qc_cols)
            + f"  disagree={disagree}")

    # crit panel: dispatch critical-path health — the top contended
    # lock from the CCT_LOCK_LEDGER series, the dispatcher's idle share,
    # and the golden canary verdict.  Pre-critpath daemons never export
    # any of these series, so the whole row dash-degrades like net:/qc:.
    crit_metrics = ("cct_lock_wait_us_total", "cct_dispatcher_idle_us_total",
                    "cct_dispatcher_busy_us_total", "cct_canary_ok",
                    "cct_canary_runs_total")
    if any(metric in series for metric in crit_metrics):
        by_lock = _by_label(series, "cct_lock_wait_us_total", "lock")
        if by_lock:
            name, waited = max(by_lock.items(), key=lambda kv: kv[1])
            top_lock = f"{name} ({waited / 1e3:.1f}ms waited)"
        else:
            top_lock = "-"
        idle = _opt("cct_dispatcher_idle_us_total")
        busy = _opt("cct_dispatcher_busy_us_total")
        if idle is not None and (idle + (busy or 0.0)) > 0:
            idle_pct = f"{100.0 * idle / (idle + (busy or 0.0)):.1f}%"
        else:
            idle_pct = "-"
        if "cct_canary_ok" in series:
            ok_vals = [v for _labels, v in series["cct_canary_ok"]]
            canary = "OK" if all(ok_vals) else "FAIL"
            ages = [v for _labels, v in series.get("cct_canary_age_s", [])]
            if ages:
                canary += f" ({max(ages):.0f}s ago)"
        else:
            canary = "-"
        lines.append(
            f"crit: lock={top_lock}  disp_idle={idle_pct}  "
            f"canary={canary}  "
            f"probes={_fmt_n(_opt('cct_canary_runs_total'))}"
            f"/fail={_fmt_n(_opt('cct_canary_fail_total'))}")

    # per-policy qc breakdown: jobs + consensus yield by
    # consensus vote policy.  Pre-policy daemons never export these
    # series so the whole panel degrades to absence; a policy column
    # with jobs but no sscs renders the sscs cell as 0 (measured).
    pol_jobs = _by_label(series, "cct_tenant_qc_policy_jobs_total", "policy")
    pol_sscs = _by_label(series, "cct_tenant_qc_policy_sscs_written_total",
                         "policy")
    if pol_jobs or pol_sscs:
        lines.append(f"{'POLICY':<12} {'JOBS':>6} {'SSCS':>9}")
        for name in sorted(set(pol_jobs) | set(pol_sscs)):
            lines.append(f"{name:<12} {_fmt_n(pol_jobs.get(name, 0.0)):>6} "
                         f"{_fmt_n(pol_sscs.get(name, 0.0)):>9}")

    totals = [
        ("routed", "cct_jobs_routed_total"),
        ("cache_answers", "cct_route_cache_answers_total"),
        ("steals", "cct_route_steals_total"),
        ("resubmits", "cct_route_resubmits_total"),
        ("adoptions", "cct_jobs_adopted_total"),
        ("failovers", "cct_router_failovers_total"),
        ("fenced", "cct_fencing_rejections_total"),
        # poison-containment tallies (absent on pre-quarantine fleets:
        # the cells simply don't render, nothing breaks)
        ("quarantined", "cct_jobs_quarantined_total"),
        ("budget_out", "cct_fleet_attempts_exhausted_total"),
        ("breaker", "cct_breaker_open_total"),
        ("released", "cct_quarantine_released_total"),
        ("brownouts", "cct_brownout_refusals_total"),
        ("spans", "cct_trace_spans_emitted_total"),
        ("links", "cct_trace_links_total"),
        ("orphans", "cct_trace_orphans_total"),
    ]
    shown = [(label, _sum(series, metric)) for label, metric in totals
             if metric in series]
    if shown:
        lines.append("totals: " + "  ".join(f"{label}={_fmt_n(v)}"
                                            for label, v in shown))

    # prof panel (f key): per-node hottest function by self samples and
    # queue wait as a share of job wall — the live "where is the time
    # going" view over the same data ``cct prof report`` merges.
    if prof:
        lines.append(f"{'PROF':<10} {'SAMP':>6} {'QWAIT%':>6}  "
                     f"HOT (self%)")
        for node in sorted(prof):
            row = prof[node] or {}
            hot = row.get("hot") or "-"
            share = row.get("hot_share") or 0.0
            lines.append(
                f"{node:<10} {_fmt_n(row.get('samples')):>6} "
                f"{100.0 * (row.get('queue_share') or 0.0):>5.1f}%  "
                f"{hot} ({100.0 * share:.0f}%)")
    elif prof is not None:
        lines.append("prof: no samples yet (is CCT_PROF=1 on the fleet?)")
    lines.append("keys: q quit  p pause  r refresh  f prof")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------ poll loop

def _describe(address) -> str:
    if isinstance(address, str):
        return f"unix:{address}"
    host, port = address
    return f"tcp:{host}:{port}"


def _scrape(client) -> dict:
    text = client.request({"op": "metrics", "format": "prometheus"},
                          timeout=15.0)["prometheus"]
    return parse_prometheus(text)


def _scrape_prof(client) -> dict:
    """Best-effort prof-panel scrape: pull the fleet's profiles through
    the ``prof`` wire op and reduce to the per-node panel.  Any failure
    (old daemon, profiling off) degrades to an empty panel — the
    observatory keeps rendering."""
    from consensuscruncher_tpu_torch.obs import prof as obs_prof

    try:
        reply = client.request({"op": "prof", "fleet": True},
                               timeout=15.0)["prof"]
    except Exception:
        return {}
    if isinstance(reply, dict):
        reply = [reply]
    docs = [d for d in reply or [] if isinstance(d, dict)]
    return obs_prof.top_panel(obs_prof.merge_profiles(docs))


def run_top(address, interval_s: float = 2.0, once: bool = False) -> int:
    """Poll + render loop.  Returns a process exit code.  ``once`` prints
    a single frame and exits (non-tty safe); otherwise the terminal is
    put in cbreak so single keypresses land without Enter: ``q`` quits,
    ``p`` toggles pause (polling stops, the frame freezes), ``r`` forces
    an immediate refresh."""
    from consensuscruncher_tpu_torch.serve.client import ServeClient

    client = ServeClient(address, retries=1)
    source = _describe(client.address)
    if once:
        sys.stdout.write(render_frame(_scrape(client), source))
        sys.stdout.flush()
        return 0

    tty_state = None
    fd = None
    if sys.stdin.isatty():
        import termios
        import tty as _tty

        fd = sys.stdin.fileno()
        tty_state = termios.tcgetattr(fd)
        _tty.setcbreak(fd)
    paused = False
    show_prof = False
    frame = ""
    next_poll = 0.0
    try:
        while True:
            now = time.monotonic()
            if not paused and now >= next_poll:
                try:
                    frame = render_frame(
                        _scrape(client), source, paused=paused,
                        prof=_scrape_prof(client) if show_prof else None)
                except Exception as e:
                    frame = (f"cct top — {source} — scrape failed: {e}\n"
                             "keys: q quit  p pause  r refresh  f prof\n")
                next_poll = now + max(0.2, float(interval_s))
                sys.stdout.write("\x1b[2J\x1b[H" + frame)
                sys.stdout.flush()
            wait = 0.25 if paused else max(0.05, next_poll - now)
            try:
                ready, _, _ = select.select([sys.stdin], [], [],
                                            min(0.25, wait))
            except (OSError, ValueError):
                ready = []
            if not ready:
                continue
            ch = sys.stdin.read(1)
            if ch in ("q", "Q", "\x03"):
                return 0
            if ch in ("p", "P"):
                paused = not paused
                sys.stdout.write(
                    "\x1b[2J\x1b[H"
                    + frame.replace(" — ", " — ", 1)
                    + ("[paused]\n" if paused else ""))
                sys.stdout.flush()
                if not paused:
                    next_poll = 0.0  # resume refreshes immediately
            if ch in ("r", "R"):
                next_poll = 0.0
                paused = False
            if ch in ("f", "F"):
                show_prof = not show_prof
                next_poll = 0.0
                paused = False
    except KeyboardInterrupt:
        return 0
    finally:
        if tty_state is not None:
            import termios

            termios.tcsetattr(fd, termios.TCSADRAIN, tty_state)
        sys.stdout.write("\n")
        sys.stdout.flush()
