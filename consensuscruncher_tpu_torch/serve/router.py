"""Fleet router: one stateless front door over N serve daemons.

Port of ``consensuscruncher_tpu/serve/router.py`` (host code only: the
router forwards work and does none, and never opens a CUDA context; the
workers vote on the card).  The CLI's ``route`` turns the single-host
daemon into a horizontally scaled fleet: submits are **consistent-hashed
by idempotency key** onto worker daemons (each keeping its own journal
and CUDA context; a spawned fleet shares one kernel build directory),
and the router itself holds no durable state — every
byte that matters for exactly-once recovery already lives in the workers'
write-ahead journals and per-job manifests.  Kill the router and restart
it with the same member list: keys hash to the same owners, keyed polls
resolve against the workers' journal-replayed jobs, nothing is lost.

Routing discipline:

- **Sticky placement.** :class:`HashRing` maps ``idempotency_key(spec)``
  to a member through ``vnodes`` virtual points per member, so a resubmit
  of the same spec always lands on the same worker (whose journal dedup
  collapses it onto the tracked job) and membership changes remap only
  ~1/N of the key space (pinned by the ring unit tests).
- **Replay-aware failover.** A member that fails a forward (or
  ``down_after`` consecutive health probes) is marked down; requests walk
  the ring to the next *up* owner.  For a job the router has seen, the
  cached spec is **resubmitted by key** to the new owner — the workers
  share a filesystem, so the new owner's ``--resume`` path completes the
  dead node's partial work byte-identically, and the journal dedup makes
  the whole dance exactly-once.  A recovered member rejoins the ring
  automatically on its next healthy probe (rebalance: its keys simply
  resolve home again; the stand-in owner's copy of any in-flight job is
  a terminal no-op thanks to idempotent outputs).
- **Bounded work stealing.** A batch/scavenger submit whose home node has
  ``steal_threshold``-deep queues may be steered to the least-loaded up
  member when that member is at least ``steal_margin`` jobs shallower —
  interactive jobs never move (stickiness is their latency warranty), and
  a steal is an optimization only: the ``route.steal`` fault site forces
  the job home, never fails it.

Router HA (:class:`RingView`): the router is no longer a single point of
failure.  An **epoch-numbered ring-view document** — NDJSON records
appended with fsync and compacted through ``manifest.commit_file``, torn-
write tolerant exactly like the job journal — is shared by an active
router and any number of standbys.  A standby health-probes the active's
advertised address; after ``takeover_after`` consecutive failed probes it
takes over by bumping the epoch and publishing itself.  Every forward a
router sends carries its ``(epoch, router_id)``; workers **fence** stale
routers by rejecting forwards whose epoch is below the highest they have
accepted (persisted via a journal ``fence`` marker), so a zombie router
that wakes up after a takeover cannot double-dispatch — its first forward
comes back ``fenced`` and it demotes itself to a refusing standby.

Journal adoption: a member down past ``adopt_after_s`` is permanently
lost as far as its journaled jobs are concerned — so the active router
(or ``route --adopt NODE``) replays the dead member's journal,
resubmits every non-terminal job **by idempotency key** to its ring
successor (worker journal dedup + manifest ``--resume`` keep that
exactly-once and byte-identical), and appends an ``adopted`` tombstone
marker to the dead journal.  A returning zombie worker replays the
tombstone, drops the adopted jobs instead of re-running them, and counts
each drop in ``fencing_rejections``.

Poison containment: every failover/adoption/steal path above *re-runs*
a job somewhere else, which is exactly how a deterministic crasher
becomes a fleet-wide crash loop.  The ring view therefore carries a
per-key **fleet attempt lineage** (``attempts``): failover resubmit,
adoption, journal recovery and work stealing all consult and increment
it, and every submit forward hands the count to the worker (whose
scheduler journals a ``suspect`` marker before each dispatch), so
``CCT_SERVE_MAX_FLEET_ATTEMPTS`` caps a key's total attempts across
routers — including a standby that takes over mid-crash-loop, which
inherits the lineage from the view doc.  Past the cap the key comes
back ``{"quarantined": true}`` and the owning worker journals a durable
``quarantined`` marker; ``route --release KEY`` (the ``release``
op) lifts it fleet-wide and resets the lineage.

Fault sites (armed by the chaos tests through ``CCT_FAULTS``):
``route.member_down`` (a forward hits a dead member),
``route.steal`` (the steal decision itself), ``route.resubmit`` (the
failover resubmission), ``route.router_down`` (the standby's probe of the
active router), ``route.adopt`` (the adoption sweep), ``route.fence``
(worker-side epoch admission).

Wire protocol: the same NDJSON ops as :mod:`serve.server`, plus
``{"op": "locate", "key": ...}`` -> the member currently owning the key
(clients use it to re-resolve a direct worker connection after a kill).
``status``/``result`` through the router are **key-addressed** — worker
job ids are per-daemon and collide across the fleet.

Metrics: the router's ``metrics`` op merges every member's labeled
series (so per-qos dashboards keep working unchanged), nests each
member's full doc under ``nodes.<name>``, and the Prometheus rendering
(:func:`obs.metrics.render_fleet_prometheus`) adds ``cct_fleet_*``
gauges plus node-labeled per-member series.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import threading
import time
from bisect import bisect_right
from collections import OrderedDict

from consensuscruncher_tpu_torch.obs import flight as obs_flight
from consensuscruncher_tpu_torch.obs import history as obs_history
from consensuscruncher_tpu_torch.obs import metrics as obs_metrics
from consensuscruncher_tpu_torch.obs import prof as obs_prof
from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.serve import journal as journal_mod
from consensuscruncher_tpu_torch.serve.client import ServeClient, ServeClientError
from consensuscruncher_tpu_torch.serve.journal import idempotency_key
from consensuscruncher_tpu_torch.serve.server import ServeServer
from consensuscruncher_tpu_torch.utils import faults, sanitize
from consensuscruncher_tpu_torch.utils.manifest import commit_file
from consensuscruncher_tpu_torch.utils.profiling import Counters

# qos classes eligible for cross-node stealing: latency-insensitive work
# whose gang compatibility survives the move (gangs key on cutoff and
# qualscore, which travel with the spec)
STEALABLE_QOS = ("batch", "scavenger")


def _forward_timeout_s() -> float | None:
    """Default deadline for a member forward that did not bring its own:
    a blackholed worker must cost a bounded wait, never a wedged router
    thread.  0 restores the legacy unbounded behavior."""
    v = float(os.environ.get("CCT_ROUTE_FORWARD_TIMEOUT_S", "60"))
    return None if v <= 0 else v


def _probe_timeout_s() -> float:
    """Deadline for health probes (member sweeps, standby->active)."""
    return float(os.environ.get("CCT_ROUTE_PROBE_TIMEOUT_S", "5"))


class HashRing:
    """Deterministic consistent-hash ring with virtual nodes.

    ``vnodes`` points per member, positioned by sha256 of
    ``"<member>#<i>"`` — no process seeding anywhere, so every router
    (and every restart) builds the identical ring from the same member
    list.  ``owner`` walks clockwise from the key's position to the
    first member present in ``up`` (ring stability: a down member's keys
    fall to its clockwise successors; everyone else's keys do not move).
    """

    def __init__(self, members, vnodes: int = 64):
        self.vnodes = max(1, int(vnodes))
        self.members = tuple(dict.fromkeys(members))  # ordered, unique
        points = []
        for m in self.members:
            for i in range(self.vnodes):
                h = hashlib.sha256(f"{m}#{i}".encode()).digest()
                points.append((int.from_bytes(h[:8], "big"), m))
        points.sort()
        self._hashes = [p[0] for p in points]
        self._owners = [p[1] for p in points]

    @staticmethod
    def key_position(key: str) -> int:
        return int.from_bytes(
            hashlib.sha256(str(key).encode()).digest()[:8], "big")

    def owner(self, key: str, up=None) -> str | None:
        """The member owning ``key`` among ``up`` (default: all members);
        None when no candidate is up."""
        if not self._hashes:
            return None
        allowed = set(self.members if up is None else up)
        if not allowed:
            return None
        start = bisect_right(self._hashes, self.key_position(key))
        n = len(self._owners)
        for step in range(n):
            m = self._owners[(start + step) % n]
            if m in allowed:
                return m
        return None

    def preference(self, key: str) -> list[str]:
        """All members in ring-walk order from the key (first = owner,
        rest = failover order) — handy for tests and debugging."""
        out: list[str] = []
        if not self._hashes:
            return out
        start = bisect_right(self._hashes, self.key_position(key))
        n = len(self._owners)
        for step in range(n):
            m = self._owners[(start + step) % n]
            if m not in out:
                out.append(m)
                if len(out) == len(self.members):
                    break
        return out


class RingView:
    """Epoch-numbered ring-view document shared by the router pair.

    NDJSON, one record per epoch publication::

      {"address": ..., "epoch": 3, "members": [["w0", "/run/w0.sock"], ...],
       "router": "r1", "t": 1722900000.0, "v": 1}

    Durability mirrors the job journal: every :meth:`publish` appends one
    fsync'd record (open/append/fsync/close — epoch changes are rare), and
    once the file outgrows ``max_records`` it is compacted to just the
    current record through ``manifest.commit_file`` (fsync + rename +
    dir-fsync), so a crash mid-compaction leaves the old doc or the new
    one, never a mix.  :meth:`load` is torn-write tolerant: a truncated
    final record — a crash mid-append, or the byte-boundary truncations
    the torn-doc test applies — is skipped and the highest *committed*
    epoch wins.
    """

    def __init__(self, path: str, max_records: int = 256):
        self.path = str(path)
        self.max_records = max(2, int(max_records))
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._lock = sanitize.tracked_lock("ringview.lock")

    def scan(self) -> tuple[list[dict], dict]:
        """All decodable records plus ``{"records", "skipped",
        "torn_tail"}`` (the torn-doc test asserts on the info)."""
        records: list[dict] = []
        info = {"records": 0, "skipped": 0, "torn_tail": False}
        sanitize.yield_point("ringview.scan")
        if not os.path.exists(self.path):
            return records, info
        with open(self.path, "rb") as fh:
            raw = fh.read()
        lines = raw.split(b"\n")
        tail = lines.pop() if lines else b""
        if tail.strip():
            lines.append(tail)
        for idx, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict) or "epoch" not in rec:
                    raise ValueError("not a ring-view record")
                rec["epoch"] = int(rec["epoch"])
            except (ValueError, TypeError):
                info["skipped"] += 1
                if idx == len(lines) - 1 and line == tail:
                    info["torn_tail"] = True
                continue
            records.append(rec)
            info["records"] += 1
        return records, info

    def load(self) -> dict | None:
        """The committed record with the highest epoch, or None."""
        records, _info = self.scan()
        if not records:
            return None
        return max(records, key=lambda r: r["epoch"])

    def publish(self, epoch: int, router: str, address,
                members: list[tuple[str, object]],
                journals: dict | None = None,
                warm: dict | None = None,
                attempts: dict | None = None) -> dict:
        """Append one fsync'd epoch record (compacting first when the doc
        has grown past ``max_records``); returns the record.  ``warm`` is
        the fleet's warm-join state — paths to the shared kernel build
        directory (the port's compile cache) and the result-cache plane — so a
        member spawned later reads ONE document and joins hot.
        ``attempts`` is the fleet-wide per-key attempt lineage (key ->
        count): riding the epoch doc makes the retry budget survive a
        router takeover — the standby inherits exactly the counts the
        dead active had spent."""
        rec = {
            "v": 1, "epoch": int(epoch), "router": str(router),
            "address": (list(address)
                        if isinstance(address, tuple) else address),
            "members": [[name, (list(addr) if isinstance(addr, tuple)
                                else addr)] for name, addr in members],
            "t": round(time.time(), 3),
        }
        if journals:
            rec["journals"] = dict(journals)
        if warm:
            rec["warm"] = {k: v for k, v in warm.items() if v}
        if attempts:
            rec["attempts"] = {str(k): int(v) for k, v in attempts.items()}
        line = json.dumps(rec, sort_keys=True,
                          separators=(",", ":")).encode() + b"\n"
        with self._lock:
            records, _info = self.scan()
            if len(records) >= self.max_records:
                self._compact(records)
            fd = os.open(self.path,
                         os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
            try:
                os.write(fd, line)
                os.fsync(fd)
            finally:
                os.close(fd)
        return rec

    def _compact(self, records: list[dict]) -> None:
        keep = max(records, key=lambda r: r["epoch"])
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(self.path) + ".cmp.",
            dir=os.path.dirname(os.path.abspath(self.path)))
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(json.dumps(keep, sort_keys=True,
                                    separators=(",", ":")).encode() + b"\n")
            commit_file(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise


class _Member:
    """Router-side view of one worker daemon (soft state only)."""

    def __init__(self, name: str, address, client):
        self.name = name
        self.address = address
        self.client = client
        self.up = True
        self.fails = 0          # consecutive failed health probes
        self.queued = 0
        self.running = 0
        self.quarantined = 0    # parked poison keys (healthz-reported)
        self.draining = False
        self.last_seen = 0.0
        self.down_since: float | None = None   # wall clock of the outage
        self.adopted_at: float | None = None   # journal adopted this outage

    def describe(self) -> dict:
        return {
            "name": self.name,
            "address": (list(self.address)
                        if isinstance(self.address, tuple) else self.address),
            "up": self.up,
            "queued": self.queued,
            "running": self.running,
            "quarantined": self.quarantined,
            "draining": self.draining,
        }


def parse_members(text: str) -> list[tuple[str, object]]:
    """``'n0=/tmp/a.sock,n1=host:port'`` (or bare addresses, auto-named
    ``n0..``) -> ``[(name, address), ...]`` with tuple TCP addresses."""
    out: list[tuple[str, object]] = []
    for i, part in enumerate(str(text or "").split(",")):
        part = part.strip()
        if not part:
            continue
        if "=" in part and os.sep not in part.split("=", 1)[0]:
            name, addr = part.split("=", 1)
            name = name.strip()
        else:
            name, addr = f"n{i}", part
        addr = addr.strip()
        if ":" in addr and os.sep not in addr:
            host, port = addr.rsplit(":", 1)
            out.append((name, (host, int(port))))
        else:
            out.append((name, addr))
    if not out:
        raise ValueError("router: empty member list")
    names = [n for n, _ in out]
    if len(set(names)) != len(names):
        raise ValueError(f"router: duplicate member names in {names}")
    return out


class Router:
    """Stateless routing core (the :class:`RouterServer` wire shell and
    the CLI's ``route`` both drive this).

    ``members``: ``[(name, address), ...]``.  ``client_factory`` is
    dependency injection for the unit tests (anything with the
    ``ServeClient.request`` shape works).

    HA knobs (all optional; without ``ring_view`` the router is a single
    router — no epochs on forwards):

    - ``router_id`` names this router in the ring-view doc and on every
      forward;
    - ``ring_view`` is the shared epoch document (path or
      :class:`RingView`);
    - ``standby=True`` starts in the refusing-standby role: ops are
      rejected ``{"standby": true, "busy": true}`` (clients rotate to
      the active) while the monitor probes the active's advertised
      address and takes over after ``takeover_after`` failed probes;
    - ``advertise`` is the address published in the ring view (what
      standbys probe and what takeover replaces);
    - ``adopt_after_s`` + ``journals`` (member name -> journal path)
      arm the adoption sweep for permanently lost members.
    """

    def __init__(self, members, *, vnodes: int = 64,
                 steal_threshold: int = 4, steal_margin: int = 2,
                 health_interval_s: float = 2.0, down_after: int = 3,
                 spec_cache_max: int = 4096, client_factory=None,
                 start_monitor: bool = True,
                 router_id: str = "r0", ring_view=None,
                 standby: bool = False, takeover_after: int = 3,
                 advertise=None, adopt_after_s: float | None = None,
                 journals: dict | None = None,
                 result_cache=None, cache_journal: str | None = None,
                 warm_state: dict | None = None):
        self.counters = Counters()
        if client_factory is None:
            counters = self.counters

            def client_factory(address):
                # the router's own counters ride every member client so
                # forward timeouts / corrupted replies are visible in
                # this router's metrics (``wire_timeouts`` etc.)
                return ServeClient(address, connect_timeout=10.0,
                                   retries=1, retry_base_s=0.1,
                                   counters=counters)
        self._client_factory = client_factory
        self._members: dict[str, _Member] = OrderedDict()
        for name, address in members:
            self._members[name] = _Member(name, address,
                                          client_factory(address))
        self.ring = HashRing(list(self._members), vnodes=vnodes)
        self.vnodes = max(1, int(vnodes))
        self.steal_threshold = max(1, int(steal_threshold))
        self.steal_margin = max(1, int(steal_margin))
        self.health_interval_s = float(health_interval_s)
        self.down_after = max(1, int(down_after))
        self.closing = False
        self._draining = False
        self._started_at = time.time()
        self._lock = sanitize.tracked_lock("router.lock")
        # ---------------------------------------------------------- HA role
        self.router_id = str(router_id)
        if isinstance(ring_view, str):
            ring_view = RingView(ring_view)
        self.ring_view: RingView | None = ring_view
        self.standby = bool(standby)
        self.takeover_after = max(1, int(takeover_after))
        self.advertise = advertise
        self.adopt_after_s = None if adopt_after_s is None \
            else float(adopt_after_s)
        self.journals = dict(journals or {})
        # ------------------------------------- content-addressed cache
        # consult-before-dispatch: a committed entry for a submit's
        # content digest answers the submit without touching a worker.
        # ``warm_state`` (kernel build dir, cache root)
        # rides every ring-view publish so late joiners start hot.
        if isinstance(result_cache, str):
            from consensuscruncher_tpu_torch.serve.result_cache import ResultCache
            result_cache = ResultCache(result_cache,
                                       node=f"router-{router_id}",
                                       counters=self.counters)
        self.result_cache = result_cache
        self.warm_state = dict(warm_state or {})
        # key -> terminal job doc for answers already served from the
        # cache; journaled (append-fsync'd, like a terminal journal
        # answer) BEFORE the reply leaves, so a keyed poll arriving
        # after a router kill -9 still resolves against the replayed map
        self._cache_answers: dict[str, dict] = {}
        self._cache_journal: journal_mod.Journal | None = None
        if cache_journal:
            self._load_cache_journal(cache_journal)
            self._cache_journal = journal_mod.Journal(
                cache_journal, max_bytes=int(os.environ.get(
                    "CCT_ROUTE_CACHE_JOURNAL_MAX_BYTES", str(1 << 20))))
        self.fenced = False         # a worker rejected our epoch: demoted
        self._active_fails = 0      # standby's failed probes of the active
        # fleet retry budget: per-key attempt lineage spent by failover
        # resubmit / adoption / journal recovery / stealing, carried in
        # the ring view so a takeover (or restart) inherits the spend
        self.max_fleet_attempts = int(os.environ.get(
            "CCT_SERVE_MAX_FLEET_ATTEMPTS", "3"))
        self._attempts: dict[str, int] = {}
        if self.ring_view is not None:
            doc = self.ring_view.load()
            self.epoch = int((doc or {}).get("epoch") or 0)
            self._merge_attempts(doc)
            if not self.standby:
                self._claim_active()
        else:
            self.epoch = 0
        # bounded key -> {"spec", "node"} soft state; the ONLY thing the
        # failover resubmission needs, and it is reconstructible: a keyed
        # poll for an unknown key still resolves to the ring owner, whose
        # journal has the job if it was ever acknowledged anywhere
        self._placed: OrderedDict[str, dict] = OrderedDict()
        self._placed_max = max(16, int(spec_cache_max))
        self._monitor: threading.Thread | None = None
        if start_monitor:
            self.start_monitor()

    def start_monitor(self) -> None:
        if self._monitor is not None:
            return
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="route-health", daemon=True)
        self._monitor.start()

    # ------------------------------------------------------------ members

    def members(self) -> list[_Member]:
        with self._lock:
            return list(self._members.values())

    def _member(self, name: str) -> _Member:
        with self._lock:
            return self._members[name]

    def _mark_down(self, member: _Member, why: str) -> None:
        with self._lock:
            was_up = member.up
            member.up = False
            if member.down_since is None:
                member.down_since = time.time()
        if was_up:
            self.counters.add("member_down_events", 1)
            print(f"route: member {member.name} DOWN ({why}); "
                  "failing its keys over to the next ring owners",
                  file=sys.stderr, flush=True)

    def _mark_up(self, member: _Member, health: dict) -> None:
        with self._lock:
            was_down = not member.up
            member.up = True
            member.fails = 0
            member.queued = int(health.get("queued", 0))
            member.running = int(health.get("running", 0))
            member.quarantined = int(health.get("quarantined", 0) or 0)
            member.draining = health.get("status") == "draining"
            member.last_seen = time.time()
            member.down_since = None
            member.adopted_at = None
        if was_down:
            print(f"route: member {member.name} UP again; its ring range "
                  "rebalances home", file=sys.stderr, flush=True)

    def _monitor_loop(self) -> None:
        while not self.closing:
            if self.standby:
                self.probe_active()
            else:
                self.probe_members()
                self.adoption_sweep()
            deadline = time.monotonic() + self.health_interval_s
            while not self.closing and time.monotonic() < deadline:
                time.sleep(min(0.2, self.health_interval_s))

    def probe_members(self) -> None:
        """One health sweep (the monitor loop calls this; tests call it
        directly for deterministic timing)."""
        with obs_trace.span("route.probe",
                            members=len(self.members())) as sp:
            down = 0
            for member in self.members():
                try:
                    health = member.client.request(
                        {"op": "healthz"},
                        timeout=_probe_timeout_s())["health"]
                except Exception as e:
                    member.fails += 1
                    down += 1
                    if member.fails >= self.down_after and member.up:
                        self._mark_down(
                            member, f"{member.fails} failed probes: {e}")
                    continue
                self._mark_up(member, health)
            sp.note(failed_probes=down)

    # --------------------------------------------------------- HA: epochs

    def _member_list(self) -> list[tuple[str, object]]:
        with self._lock:
            return [(m.name, m.address) for m in self._members.values()]

    def _claim_active(self) -> None:
        """Become (or confirm ourselves as) the active router: bump the
        epoch past anything the ring view has seen and publish."""
        doc = self.ring_view.load()
        self.epoch = max(self.epoch, int((doc or {}).get("epoch") or 0)) + 1
        self._merge_attempts(doc)
        self.ring_view.publish(self.epoch, self.router_id,
                               self.advertise, self._member_list(),
                               journals=self.journals,
                               warm=self.warm_state,
                               attempts=self._attempts_snapshot())
        self.standby = False
        self.fenced = False
        self._active_fails = 0

    def _publish_view(self) -> None:
        """Re-publish after a membership change.  Epoch bumps so every
        observer (standby, workers via fencing) sees one total order of
        ring views; a no-ring-view router is a silent no-op."""
        if self.ring_view is None or self.standby:
            return
        self.epoch += 1
        try:
            faults.fault_point("route.view_publish")
            self.ring_view.publish(self.epoch, self.router_id,
                                   self.advertise, self._member_list(),
                                   journals=self.journals,
                                   warm=self.warm_state,
                                   attempts=self._attempts_snapshot())
        except (faults.FaultError, OSError) as e:
            # the in-memory membership change is already live and the
            # epoch bump is kept: the view doc is advertisement state for
            # standbys, and the NEXT successful publish (any membership
            # change or takeover) carries this epoch forward — a failed
            # write degrades standby visibility, never routing
            print(f"WARNING: route[{self.router_id}]: ring-view publish "
                  f"failed ({e}); epoch {self.epoch} will be advertised "
                  "by the next publish", file=sys.stderr, flush=True)

    def start(self, advertise=None) -> None:
        """Late activation for the CLI: the advertised address may only be
        known once the server socket is bound.  Claims the active role
        (unless standby), then starts the monitor."""
        if advertise is not None:
            self.advertise = advertise
        if self.ring_view is not None and not self.standby:
            self._claim_active()
        self.start_monitor()

    def probe_active(self) -> None:
        """Standby's half of the monitor: health-probe the active router's
        advertised address; ``takeover_after`` consecutive failures (or an
        armed ``route.router_down`` fault) trigger :meth:`take_over`.  An
        answering active with a *higher* epoch resets our view (we may
        have been demoted while partitioned)."""
        if self.ring_view is None:
            return
        doc = self.ring_view.load()
        if doc is None:
            # nobody has ever published: claim the fleet
            self._active_fails += 1
            if self._active_fails >= self.takeover_after:
                self.take_over("ring view empty")
            return
        if doc.get("router") == self.router_id:
            # the view says we are active (e.g. a restart after takeover)
            self.epoch = max(self.epoch, int(doc.get("epoch") or 0))
            self.standby = False
            return
        # mirror the active's published membership so a takeover inherits
        # mid-life member_add/member_remove (the ring view is the one
        # authority on who is in the fleet)
        self._sync_members(doc)
        address = doc.get("address")
        if isinstance(address, list):
            address = (address[0], int(address[1]))
        try:
            faults.fault_point("route.router_down")
            health = ServeClient(address,
                                 connect_timeout=_probe_timeout_s(),
                                 retries=0, counters=self.counters).request(
                {"op": "healthz"}, timeout=_probe_timeout_s())["health"]
        except (faults.FaultError, ServeClientError, OSError, TypeError) as e:
            self._active_fails += 1
            print(f"route[{self.router_id}]: active router "
                  f"{doc.get('router')} probe failed "
                  f"({self._active_fails}/{self.takeover_after}): {e}",
                  file=sys.stderr, flush=True)
            if self._active_fails >= self.takeover_after:
                self.take_over(f"{self._active_fails} failed probes: {e}")
            return
        self._active_fails = 0
        self.epoch = max(self.epoch, int(doc.get("epoch") or 0),
                         int(health.get("epoch") or 0))

    def _sync_members(self, doc: dict) -> None:
        """Standby's membership mirror: adopt the member list the active
        last published.  Down/adoption bookkeeping for members we already
        track is preserved — only the set of names changes."""
        published = doc.get("members") or []
        if not published:
            return
        want: dict[str, object] = {}
        for name, address in published:
            if isinstance(address, list):
                address = (address[0], int(address[1]))
            want[str(name)] = address
        # journal paths ride along so a takeover can still adopt members
        # that were member_add'ed after this standby was configured
        for name, path in (doc.get("journals") or {}).items():
            self.journals.setdefault(str(name), str(path))
        # the fleet attempt lineage rides along too: a takeover must not
        # grant a crash-looping key a fresh retry budget
        self._merge_attempts(doc)
        with self._lock:
            changed = False
            for name, address in want.items():
                if name not in self._members:
                    self._members[name] = _Member(
                        name, address, self._client_factory(address))
                    changed = True
            for name in [n for n in self._members if n not in want]:
                del self._members[name]
                changed = True
            if changed:
                self.ring = HashRing(list(self._members), vnodes=self.vnodes)

    def take_over(self, why: str) -> None:
        """Standby -> active: bump the epoch, publish, and immediately
        probe the members so routing state is warm.  The old active is
        fenced out by the workers the moment our first forward lands (its
        lower epoch is rejected from then on)."""
        old_epoch = self.epoch
        self._claim_active()
        self.counters.add("router_failovers", 1)
        obs_trace.event("route.takeover", router=self.router_id,
                        old_epoch=old_epoch, epoch=self.epoch, why=why)
        obs_trace.flush()  # durable before the first fencing forward
        obs_flight.set_identity(epoch=self.epoch)
        print(f"route[{self.router_id}]: TAKEOVER epoch {old_epoch} -> "
              f"{self.epoch} ({why})", file=sys.stderr, flush=True)
        # the takeover is the incident the flight ring exists for: what
        # the standby observed leading up to it survives in the dump
        obs_flight.record("router_takeover", router=self.router_id,
                          epoch=self.epoch, why=why)
        obs_flight.dump(reason="router-takeover")
        self.probe_members()

    def _standby_refusal(self) -> dict | None:
        """Non-None when this router must not serve: standby role, or
        demoted by a worker's fencing rejection.  ``busy`` makes the
        client's retry loop rotate to its next router address."""
        if self.standby:
            return {"ok": False, "standby": True, "busy": True,
                    "router": self.router_id, "epoch": self.epoch,
                    "error": f"router {self.router_id} is standby"}
        if self.fenced:
            return {"ok": False, "standby": True, "busy": True,
                    "fenced": True, "router": self.router_id,
                    "epoch": self.epoch,
                    "error": f"router {self.router_id} was fenced "
                             f"(a newer epoch than {self.epoch} is live)"}
        return None

    def _check_active(self) -> None:
        refusal = self._standby_refusal()
        if refusal is not None:
            raise ServeClientError(refusal["error"], refusal)

    # --------------------------------------------- fleet retry budget

    def _merge_attempts(self, doc: dict | None) -> None:
        """Max-merge a ring-view doc's ``attempts`` lineage into ours
        (counts only grow: two routers that each saw part of a key's
        history converge on the larger spend, never a reset)."""
        if not doc:
            return
        published = doc.get("attempts") or {}
        if not isinstance(published, dict):
            return
        with self._lock:
            for key, n in published.items():
                try:
                    n = int(n)
                except (TypeError, ValueError):
                    continue
                if n > self._attempts.get(str(key), 0):
                    self._attempts[str(key)] = n

    def _attempts_snapshot(self) -> dict:
        with self._lock:
            return dict(self._attempts)

    def _budget_spend(self, key: str, what: str, strict: bool = True) -> bool:
        """Spend one fleet attempt for ``key``; the redispatch paths
        (failover resubmit, adoption, journal recovery, steal) all come
        through here.  Past ``CCT_SERVE_MAX_FLEET_ATTEMPTS`` nothing is
        spent: ``strict`` raises the quarantined refusal (polls and
        resubmits answer it to the client), non-strict returns False so
        the caller degrades (a steal goes home, an adoption forwards the
        exhausted lineage for the worker to quarantine durably)."""
        if self.max_fleet_attempts <= 0 or not key:
            return True
        with self._lock:
            n = self._attempts.get(key, 0) + 1
            if n <= self.max_fleet_attempts:
                self._attempts[key] = n
                return True
            spent = n - 1
        self.counters.add("fleet_attempts_exhausted", 1)
        reason = (f"fleet retry budget exhausted for key {key} "
                  f"({spent}/{self.max_fleet_attempts} attempts across "
                  f"the fleet; {what} refused)")
        obs_flight.record("fleet_budget_exhausted", key=key, what=what,
                          attempts=spent, router=self.router_id)
        if strict:
            raise ServeClientError(reason, {
                "ok": False, "error": reason, "refused": True,
                "quarantined": True, "reason": reason, "key": key})
        print(f"route[{self.router_id}]: {reason}",
              file=sys.stderr, flush=True)
        return False

    def _prune_attempts(self, key: str, reply: dict) -> None:
        """A key observed ``done`` no longer needs its lineage — the
        dedup cache answers any re-submit, so the budget entry is dead
        weight (and the map must not grow with every honest steal)."""
        if (reply.get("job") or {}).get("state") == "done":
            with self._lock:
                self._attempts.pop(key, None)

    def _submit_doc(self, spec: dict, key: str) -> dict:
        """Submit forward doc with the key's fleet lineage riding along:
        the worker max-merges it, so its own budget gate (and the
        ``suspect`` ordinals it journals) continue the fleet-wide count
        instead of restarting from zero on every node."""
        doc = {"op": "submit", "spec": spec}
        with self._lock:
            n = self._attempts.get(key, 0)
        if n:
            doc["attempts"] = n
        return doc

    def release(self, key: str) -> dict:
        """Lift a quarantine fleet-wide (``route --release KEY``):
        reset the ring-carried attempt lineage, then ask every up member
        to release the key — the durable marker usually lives on the
        ring owner, but a failover may have left it on a previous
        incarnation's node, so all of them are asked.  The reset lineage
        is published immediately: a router restart must not resurrect
        the spent budget and re-quarantine the key on its next attempt."""
        self._check_active()
        key = str(key)
        with self._lock:
            self._attempts.pop(key, None)
        released = []
        for member in self.members():
            if not member.up:
                continue
            try:
                reply = self._forward(member, {"op": "release", "key": key})
            except ServeClientError:
                continue
            if reply.get("released"):
                released.append(member.name)
        if released:
            self.counters.add("quarantine_released", 1)
        self._publish_view()
        return {"key": key, "released": bool(released),
                "node": released[0] if released else None}

    # ------------------------------------------------------- HA: adoption

    def adoption_sweep(self) -> None:
        """Adopt the journal of every member down past ``adopt_after_s``
        (once per outage).  Failures are logged and retried next sweep —
        adoption is idempotent end to end (resubmits dedup by key, the
        tombstone is only written after every resubmit was acked)."""
        if self.adopt_after_s is None or not self.journals:
            return
        now = time.time()
        for member in self.members():
            if member.up or member.down_since is None \
                    or member.adopted_at is not None:
                continue
            if now - member.down_since < self.adopt_after_s:
                continue
            if member.name not in self.journals:
                continue
            try:
                self.adopt(member.name)
            except Exception as e:
                print(f"WARNING: route[{self.router_id}]: adoption of "
                      f"{member.name} failed ({e}); retrying next sweep",
                      file=sys.stderr, flush=True)

    def adopt(self, node: str, force: bool = False) -> dict:
        """Replay a dead member's journal, resubmit every non-terminal job
        by idempotency key to its ring successor, then tombstone the
        journal with an ``adopted`` marker.

        Exactly-once: resubmits dedup on the successor's journal, the
        successor's ``--resume`` completes any partial stage outputs
        byte-identically, and the tombstone is appended only after every
        resubmit was acknowledged — a failure anywhere aborts without the
        tombstone, so the next sweep (or a returning member) retries with
        nothing lost and nothing doubled."""
        self._check_active()
        with self._lock:
            member = self._members.get(str(node))
        if member is None:
            raise ServeClientError(f"unknown member {node!r}",
                                   {"bad_request": True})
        path = self.journals.get(member.name)
        if not path:
            raise ServeClientError(
                f"no journal path configured for member {node!r}",
                {"bad_request": True})
        if member.up and not force:
            raise ServeClientError(
                f"member {node!r} is up; refusing to adopt a live journal "
                "(pass force to override)", {"bad_request": True})
        faults.fault_point("route.adopt")
        jobs, info = journal_mod.replay(path)
        quarantined = info.get("quarantined") or {}
        pending = []
        skipped_quarantined = 0
        for jid in sorted(jobs):
            rec = jobs[jid]
            if rec.get("state") in ("done", "failed"):
                continue
            if rec.get("adopted"):
                continue  # an earlier adoption already moved it
            if rec.get("key") in quarantined:
                # the dead member had already condemned this key: moving
                # it to a successor would restart the crash loop the
                # quarantine exists to stop — it stays parked until an
                # operator releases it
                skipped_quarantined += 1
                continue
            spec = rec.get("spec")
            if not isinstance(spec, dict) or not spec.get("input") \
                    or not spec.get("output"):
                continue  # rotated-away accepted record: nothing to move
            pending.append((jid, spec, rec))
        if skipped_quarantined:
            print(f"route[{self.router_id}]: adoption of {member.name}: "
                  f"{skipped_quarantined} quarantined job(s) left parked "
                  "(release to retry)", file=sys.stderr, flush=True)
        adopted_keys = []
        for jid, spec, rec in pending:
            # fleet budget: an adoption resubmit is one more attempt on
            # this key's lineage.  Non-strict past the cap — the job is
            # still forwarded (carrying the exhausted count) so the
            # successor's scheduler quarantines it DURABLY instead of
            # the router silently dropping it
            self._budget_spend(str(rec.get("key") or ""),
                               "adoption resubmit", strict=False)
            # the adoption span continues the DEAD member's trace: it
            # links to the ack context persisted on the journal record,
            # and the nested route.submit span inherits that trace_id —
            # so the successor's spans land on the original timeline
            ctx = rec.get("trace") if isinstance(rec.get("trace"), dict) \
                else None
            if ctx is None and obs_trace.enabled():
                obs_trace.note_orphan()
            with obs_trace.span("route.adopt_job", link=ctx,
                                trace_id=rec.get("trace_id"),
                                node=member.name, job_id=jid):
                reply = self.submit(spec)
            if not reply.get("ok"):
                if reply.get("quarantined"):
                    # the successor already holds a quarantine for this
                    # key: containment won, the job stays parked there
                    skipped_quarantined += 1
                    continue
                raise ServeClientError(
                    f"adoption resubmit of {member.name} job {jid} "
                    f"refused: {reply.get('error')}", dict(reply))
            adopted_keys.append(reply.get("key"))
            print(f"route[{self.router_id}]: adopted {member.name} "
                  f"job {jid} -> {reply.get('node')} "
                  f"(key {reply.get('key')}, "
                  f"duplicate={reply.get('duplicate')})",
                  file=sys.stderr, flush=True)
        # every non-terminal job is acked on a live successor: tombstone
        # the dead journal so a returning zombie drops them at replay
        tomb = journal_mod.Journal(path)
        try:
            tomb.append_marker("adopted", router=self.router_id,
                               epoch=self.epoch or None)
        finally:
            tomb.close()
        with self._lock:
            member.adopted_at = time.time()
        self.counters.add("journals_adopted", 1)
        if adopted_keys:
            self.counters.add("jobs_adopted", len(adopted_keys))
        obs_flight.record("journal_adopted", node=member.name,
                          jobs=len(adopted_keys), router=self.router_id)
        print(f"route[{self.router_id}]: journal of {member.name} adopted "
              f"({len(adopted_keys)} job(s) resubmitted, "
              f"{info['records']} record(s) replayed)",
              file=sys.stderr, flush=True)
        return {"node": member.name, "jobs_adopted": len(adopted_keys),
                "keys": adopted_keys}

    # ---------------------------------------------------- HA: membership

    def member_add(self, name: str, address, journal=None) -> dict:
        """Grow the ring by one member (a warm-joined daemon, or a chaos
        test's membership event).  ~1/N of the key space remaps to the new
        member; everything else stays sticky.  ``journal`` registers the
        member's journal path so a later decommission can still adopt
        what it acknowledged."""
        self._check_active()
        name = str(name)
        if isinstance(address, list):
            address = (address[0], int(address[1]))
        with self._lock:
            if name in self._members:
                raise ServeClientError(f"member {name!r} already exists",
                                       {"bad_request": True})
            self._members[name] = _Member(name, address,
                                          self._client_factory(address))
            self.ring = HashRing(list(self._members), vnodes=self.vnodes)
            fleet_size = len(self._members)
        if journal:
            self.journals[name] = str(journal)
        self._publish_view()
        return {"node": name, "fleet_size": fleet_size}

    def member_remove(self, name: str) -> dict:
        """Shrink the ring: the member's keys fall to their ring
        successors.  Its journal path is kept so a later adopt can still
        drain what it had acknowledged."""
        self._check_active()
        name = str(name)
        with self._lock:
            if name not in self._members:
                raise ServeClientError(f"unknown member {name!r}",
                                       {"bad_request": True})
            if len(self._members) == 1:
                raise ServeClientError("refusing to remove the last member",
                                       {"bad_request": True})
            del self._members[name]
            self.ring = HashRing(list(self._members), vnodes=self.vnodes)
            fleet_size = len(self._members)
        self._publish_view()
        return {"node": name, "fleet_size": fleet_size}

    # ------------------------------------------------------------ routing

    def _owner_for(self, key: str, exclude: set | None = None):
        with self._lock:
            up = [m.name for m in self._members.values()
                  if m.up and (not exclude or m.name not in exclude)]
            name = self.ring.owner(key, up=up)
            return None if name is None else self._members.get(name)

    def _remember(self, key: str, spec: dict, node: str,
                  trace: dict | None = None) -> None:
        """Placement cache entry; ``trace`` is the owning worker's ack
        span wire context (from its submit reply) so a later failover
        resubmit can ``follows_from`` the span the dead owner durably
        recorded."""
        with self._lock:
            self._placed[key] = {"spec": dict(spec), "node": node,
                                 "trace": trace if isinstance(trace, dict)
                                 else None}
            self._placed.move_to_end(key)
            while len(self._placed) > self._placed_max:
                self._placed.popitem(last=False)

    def _placed_info(self, key: str) -> dict | None:
        with self._lock:
            info = self._placed.get(key)
            return dict(info) if info else None

    def _forward(self, member: _Member, doc: dict,
                 timeout: float | None = None) -> dict:
        """One member RPC; a transport-level loss (or an armed
        ``route.member_down`` fault) marks the member down and raises
        ``ServeClientError(transport=True)`` for the caller's failover.

        With a ring view configured every forward is stamped with this
        router's ``(epoch, router_id)``; a ``fenced`` rejection from the
        worker means a newer epoch is live — we demote ourselves on the
        spot (no zombie-router double-dispatch) and re-raise."""
        try:
            faults.fault_point("route.member_down")
        except faults.FaultError as e:
            self._mark_down(member, f"injected: {e}")
            raise ServeClientError(str(e), {"transport": True}) from e
        if self.ring_view is not None:
            doc = dict(doc)
            doc["epoch"] = self.epoch
            doc["router"] = self.router_id
        if timeout is None:
            timeout = _forward_timeout_s()
        try:
            # the forward span is the wire context the worker links to:
            # ServeClient stamps the innermost open span onto the doc
            with obs_trace.span("route.forward", op=doc.get("op"),
                                node=member.name):
                return member.client.request(doc, timeout=timeout)
        except ServeClientError as e:
            if e.reply.get("fenced"):
                self._demote(member.name, e.reply)
            if e.reply.get("transport"):
                self._mark_down(member, str(e))
            raise
        except OSError as e:
            self._mark_down(member, str(e))
            raise ServeClientError(str(e), {"transport": True}) from e

    def _demote(self, worker: str, reply: dict) -> None:
        """A worker fenced us: a takeover happened while we thought we
        were active.  Stop serving (clients rotate to the new active) —
        the flight dump records what this zombie saw before it learned."""
        if self.fenced:
            return
        self.fenced = True
        newer = reply.get("epoch")
        print(f"route[{self.router_id}]: FENCED by worker {worker} "
              f"(our epoch {self.epoch} < live {newer}); demoting to "
              "standby-refusal", file=sys.stderr, flush=True)
        obs_flight.record("router_fenced", router=self.router_id,
                          epoch=self.epoch, live_epoch=newer, worker=worker)
        obs_flight.dump(reason="router-fenced")

    def _pick_target(self, key: str, qos: str) -> tuple[_Member, bool]:
        """Home member for the key, or a steal target for deep-queued
        batch/scavenger work.  Returns ``(member, stolen)``."""
        home = self._owner_for(key)
        if home is None:
            raise ServeClientError("no fleet member is up", {"transport": True})
        if qos not in STEALABLE_QOS:
            return home, False
        with self._lock:
            candidates = [m for m in self._members.values()
                          if m.up and not m.draining and m.name != home.name]
            if (home.queued < self.steal_threshold) or not candidates:
                return home, False
            thief = min(candidates, key=lambda m: (m.queued, m.name))
            if thief.queued + self.steal_margin > home.queued:
                return home, False
        try:
            faults.fault_point("route.steal")
        except faults.FaultError as e:
            print(f"WARNING: route: steal fault ({e}); keeping job on "
                  f"home node {home.name}", file=sys.stderr, flush=True)
            return home, False
        # a steal re-homes the key, which is one more place a poison job
        # can take a worker down: it spends from the same fleet lineage.
        # Past the budget the job simply goes home (no amplification;
        # the home scheduler's own gate quarantines it durably there)
        if not self._budget_spend(key, "steal", strict=False):
            return home, False
        return thief, True

    # ---------------------------------------------------------------- ops

    def submit(self, spec: dict, trace: dict | None = None) -> dict:
        """Route one submit; returns the member's wire reply annotated
        with ``node``/``node_address`` (refusals pass through so the
        client's shed/quota handling keeps working).  ``trace`` is the
        submitter's wire trace context: the route-decision span links to
        it, and the span itself rides the forward to the worker, so the
        client -> router -> worker timeline is one connected tree."""
        refusal = self._standby_refusal()
        if refusal is not None:
            return refusal
        if self._draining:
            return {"ok": False, "refused": True,
                    "error": "router is draining; not accepting jobs"}
        spec = dict(spec or {})
        try:
            key = idempotency_key(spec)
        except Exception as e:
            return {"ok": False, "error": f"bad spec: {e}"}
        qos = str(spec.get("qos") or "interactive")
        if not isinstance(trace, dict):
            # a trace-less re-submit of a key this router already placed
            # (client retry after a crash, a chaos test's dedup probes)
            # continues the placed job's timeline: the dedup key
            # makes it the same job, so minting a fresh trace here would
            # split one causal tree into two
            info = self._placed_info(key)
            if info is not None and isinstance(info.get("trace"), dict):
                trace = info["trace"]
        cached = self._cache_answer(key, spec, trace)
        if cached is not None:
            return cached
        tried: set[str] = set()
        stolen = False
        with obs_trace.span("route.submit",
                            link=trace if isinstance(trace, dict) else None,
                            key=key, qos=qos) as sp:
            while True:
                if not tried:
                    try:
                        member, stolen = self._pick_target(key, qos)
                    except ServeClientError as e:
                        return {"ok": False, "error": str(e)}
                else:
                    member = self._owner_for(key, exclude=tried)
                    if member is None:
                        return {"ok": False,
                                "error": "no fleet member is up",
                                "transport": True}
                try:
                    reply = self._forward(member, self._submit_doc(spec, key))
                except ServeClientError as e:
                    if e.reply.get("transport"):
                        # forward-time death: fail over around the ring.
                        # The hop to the next owner is a redispatch — it
                        # spends from the key's fleet lineage, so a
                        # crash-looping key stops walking the ring and
                        # the submitter gets the quarantined refusal
                        # (as a reply dict: submit's refusal contract)
                        try:
                            self._budget_spend(key, "ring failover")
                        except ServeClientError as qe:
                            return dict(qe.reply)
                        tried.add(member.name)
                        stolen = False
                        continue
                    if e.reply.get("refused"):
                        if e.reply.get("shed"):
                            # Digest-keyed shed bypass, router half: a
                            # member shed this key under load, but the
                            # answer journal may hold a committed answer
                            # (landed after the pre-forward check) — a
                            # cached submit is answered, never shed.
                            cached = self._cache_answer(key, spec, trace)
                            if cached is not None:
                                self.counters.add("cache_shed_bypass")
                                return cached
                        return dict(e.reply)
                    return {"ok": False, "error": str(e)}
                with self._lock:
                    member.queued += 1  # soft estimate until the next probe
                self._remember(key, spec, member.name,
                               trace=reply.get("trace"))
                self.counters.add("jobs_routed", 1)
                obs_metrics.inc("node_jobs_routed", node=member.name)
                if stolen:
                    self.counters.add("route_steals", 1)
                    obs_metrics.inc("node_steals", node=member.name)
                # route decision, recorded late (the target is only final
                # once a forward actually landed)
                sp.note(node=member.name, stolen=stolen,
                        trace_id=reply.get("trace") and
                        reply["trace"].get("trace_id"))
                reply = dict(reply)
                reply["node"] = member.name
                reply["node_address"] = member.describe()["address"]
                reply["stolen"] = stolen
                return reply

    def resolve(self, key: str) -> _Member:
        """The member a keyed poll should talk to *right now*: the cached
        placement while that node is up, else the current ring owner —
        resubmitting the cached spec there first, so the poll finds the
        job (replay-aware failover).  Raises when no member is up."""
        self._check_active()
        info = self._placed_info(key)
        if info is not None:
            with self._lock:
                member = self._members.get(info["node"])
            if member is not None and member.up:
                return member
        member = self._owner_for(key)
        if member is None:
            raise ServeClientError("no fleet member is up", {"transport": True})
        if info is not None and info["node"] != member.name \
                and info.get("spec"):
            # spec-less entries (locate-sweep re-primes) can't resubmit;
            # the poll falls through to the owner and sweeps again
            self._failover_resubmit(key, info, member)
        return member

    def _failover_resubmit(self, key: str, info: dict,
                           member: _Member) -> None:
        """Resubmit a dead node's job to its new owner.  Exactly-once by
        construction: the new owner's journal dedups on the key, and the
        shared-filesystem ``--resume`` manifest skips any stage the dead
        node already committed — outputs stay byte-identical.

        The resubmit span ``follows_from`` the dead owner's ack span
        (its wire context was cached at placement, or recovered from its
        journal's accepted record), so the job's trace stays one
        connected tree across the kill.  No stored context — e.g. a
        placement inherited from a pre-tracing router — counts a
        ``trace_orphans`` tally instead of fabricating a link."""
        faults.fault_point("route.resubmit")
        # fleet budget, strict: a failover resubmit past the cap raises
        # the quarantined refusal instead of re-running the job — the
        # keyed poll that triggered us answers it to the client
        self._budget_spend(key, "failover resubmit")
        ctx = info.get("trace") if isinstance(info.get("trace"), dict) \
            else None
        if ctx is None and obs_trace.enabled():
            obs_trace.note_orphan()
        with obs_trace.span("route.resubmit", link=ctx, key=key,
                            node=member.name,
                            trace_id=(ctx or {}).get("trace_id")):
            reply = self._forward(member, self._submit_doc(info["spec"], key))
        self._remember(key, info["spec"], member.name,
                       trace=reply.get("trace"))
        self.counters.add("jobs_routed", 1)
        self.counters.add("route_resubmits", 1)
        obs_metrics.inc("node_jobs_routed", node=member.name)
        obs_metrics.inc("node_resubmits", node=member.name)
        print(f"route: resubmitted key {key} to {member.name} "
              f"(job {reply.get('job_id')}, duplicate="
              f"{reply.get('duplicate')})", file=sys.stderr, flush=True)

    def locate(self, key: str) -> dict:
        member = self.resolve(key)
        return {"node": member.name,
                "address": member.describe()["address"]}

    def _locate_sweep(self, key: str, skip: str | None = None):
        """A keyed poll hit ``unknown job`` at the ring owner.  Two HA
        situations produce that without any job being lost: the placement
        cache died with a failed-over active (this router never saw the
        submit), or a membership change moved the key's ring home away
        from the node that actually ran it.  Ask every other up member
        before giving up; a hit re-primes the placement cache so
        subsequent polls go straight there.  Returns the member or None."""
        for member in self.members():
            if not member.up or member.name == skip:
                continue
            try:
                reply = self._forward(member, {"op": "status", "key": key})
            except ServeClientError:
                continue
            if reply.get("ok"):
                # no spec on hand (the submit predates this router), so
                # the cache entry only pins placement; resolve() skips
                # the spec-needing resubmit path for spec-less entries
                self._remember(key, {}, member.name,
                               trace=(reply.get("job") or {}).get("trace"))
                self.counters.add("route_locate_sweeps", 1)
                obs_trace.event("route.locate_sweep", key=key,
                                node=member.name,
                                trace_id=(reply.get("job") or {})
                                .get("trace_id"))
                print(f"route: located key {key} on {member.name} after "
                      "an unknown-job miss; placement cache re-primed",
                      file=sys.stderr, flush=True)
                return member
        return None

    def _journal_resubmit(self, key: str) -> bool:
        """Last resort after a locate-sweep miss: the job's node is down
        and this router never saw the submit (post-takeover), so no live
        member knows the key — but the configured journal of a down
        member still holds the acked spec.  Recover it read-only and
        resubmit to the live ring successor (journal dedup + manifest
        ``--resume`` keep the eventual double replay exactly-once in its
        effects, same as every failover resubmit)."""
        spec = ctx = None
        for name, path in (self.journals or {}).items():
            with self._lock:
                member = self._members.get(name)
            if member is not None and member.up:
                continue  # live members already answered the sweep
            try:
                jobs, jinfo = journal_mod.replay(path)
            except (OSError, ValueError):
                continue
            qreason = (jinfo.get("quarantined") or {}).get(key)
            if qreason is not None:
                # the down member had condemned this key: the poll gets
                # the quarantine verdict, never a restarted crash loop
                reason = (f"key {key} is quarantined on down node "
                          f"{name}: {qreason}")
                raise ServeClientError(reason, {
                    "ok": False, "error": reason, "refused": True,
                    "quarantined": True, "reason": str(qreason),
                    "key": key})
            for rec in jobs.values():
                # terminal records are answered from the journal instead
                # (resubmitting one would re-run a finished job just to
                # satisfy a status poll)
                if rec.get("key") == key and rec.get("spec") \
                        and not rec.get("adopted") \
                        and rec.get("state") not in ("done", "failed"):
                    spec = dict(rec["spec"])
                    # the accepted record's persisted ack-span context:
                    # the resubmit links to the dead node's trace even
                    # though this router never saw the original submit
                    ctx = rec.get("trace")
                    break
            if spec is not None:
                break
        if spec is None:
            return False
        owner = self._owner_for(key)
        if owner is None:
            return False
        try:
            self._failover_resubmit(key, {"spec": spec, "trace": ctx}, owner)
        except ServeClientError as e:
            if e.reply.get("quarantined"):
                raise  # the poll answers the quarantine, not "unknown"
            print(f"route: journal-recovered resubmit of key {key} "
                  f"failed ({e}); next poll retries", file=sys.stderr,
                  flush=True)
            return False
        print(f"route: recovered key {key} from a down member's journal; "
              f"resubmitted to {owner.name}", file=sys.stderr, flush=True)
        return True

    def _journal_answer(self, key: str) -> dict | None:
        """Terminal fallback after both the sweep and the resubmit miss:
        a ``done``/``failed`` record in a down member's journal is
        authoritative — the outputs are already durable on the shared
        filesystem — so answer the keyed poll from it.  Without this, a
        job that finished *before* its node was perm-killed and adopted
        is unresolvable until the zombie returns: adoption resubmits
        only non-terminal jobs, and the tombstone makes the resubmit
        path skip the record entirely."""
        for name, path in (self.journals or {}).items():
            with self._lock:
                member = self._members.get(name)
            if member is not None and member.up:
                continue  # live members already answered the sweep
            try:
                jobs, _info = journal_mod.replay(path)
            except (OSError, ValueError):
                continue
            for rec in jobs.values():
                if rec.get("key") != key \
                        or rec.get("state") not in ("done", "failed"):
                    continue
                spec = rec.get("spec") or {}
                self.counters.add("route_journal_answers", 1)
                # the answer joins the job's timeline: a span linked to
                # the dead node's persisted ack context, carrying the
                # ORIGINAL trace_id (not a fresh one) so the poll reply
                # and the job's spans correlate
                rctx = rec.get("trace") if isinstance(rec.get("trace"),
                                                      dict) else None
                with obs_trace.span("route.journal_answer", link=rctx,
                                    trace_id=rec.get("trace_id"),
                                    key=key, node=name,
                                    state=rec["state"]):
                    pass
                print(f"route: answered keyed poll {key} from {name}'s "
                      f"journal (terminal state '{rec['state']}', node "
                      "down)", file=sys.stderr, flush=True)
                return {"ok": True, "trace": rctx, "job": {
                    "job_id": rec.get("id"), "key": key,
                    "state": rec["state"], "error": rec.get("error"),
                    "outputs": rec.get("outputs"),
                    "wall_s": rec.get("wall_s"),
                    "attempts": rec.get("attempts"),
                    "gang_size": rec.get("gang_size"),
                    "input": spec.get("input"),
                    "deadline_s": rec.get("deadline_s"),
                    "trace_id": rec.get("trace_id"),
                    "tenant": spec.get("tenant"),
                    "qos": spec.get("qos"),
                }}
        return None

    # ------------------------------------------ content-addressed cache

    def _load_cache_journal(self, path: str) -> None:
        """Replay the cache-answer journal into ``_cache_answers``.
        Same NDJSON + torn-tail discipline as the job journal: a torn
        final record is an answer whose reply never left, dropping it is
        correct.  Runs before the append fd opens (router construction)."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as fh:
            raw = fh.read()
        lines = raw.split(b"\n")
        tail = lines.pop() if lines else b""
        if tail.strip():
            lines.append(tail)
        loaded = 0
        for line in lines:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail / unreadable: that reply never left
            if not isinstance(rec, dict) or rec.get("kind") != "cache_answer":
                continue
            key, job = rec.get("key"), rec.get("job")
            if isinstance(key, str) and isinstance(job, dict):
                self._cache_answers[key] = job
                loaded += 1
        if loaded:
            print(f"route: cache-answer journal replay: {loaded} keyed "
                  "answer(s) restored", file=sys.stderr, flush=True)

    def _cache_answer(self, key: str, spec: dict,
                      trace: dict | None) -> dict | None:
        """Consult the result cache before dispatch.  On a hit the
        payload is materialized into the submitter's own output tree,
        the answer is journaled (fsync'd) BEFORE the reply leaves — the
        exactly-once discipline a terminal journal-answer gets — and a
        submit-ack-shaped reply comes back with ``cached: true``.
        Returns None on a miss or any degradation (the normal dispatch
        path is always correct)."""
        if self.result_cache is None:
            return None
        prior = self._cache_answers.get(key)
        if prior is not None:
            # an idempotent re-submit of an already-answered key: the
            # payload is already materialized and journaled
            return {"ok": True, "job_id": prior.get("job_id", 0),
                    "state": prior.get("state", "done"), "key": key,
                    "duplicate": True, "cached": True, "node": "cache",
                    "trace": prior.get("trace")}
        from consensuscruncher_tpu_torch.serve import result_cache as rc_mod
        try:
            digest = rc_mod.content_digest(spec)
            if digest is None:
                return None
            # placement rides the job ring: the digest's ring owner is
            # where the producing job ran, so probe that shard first
            with self._lock:
                shard = self.ring.owner(digest)
            entry = self.result_cache.lookup(digest, preferred_shard=shard)
        except Exception as e:
            print(f"WARNING: route: cache lookup failed ({e}); "
                  "dispatching normally", file=sys.stderr, flush=True)
            return None
        if entry is None:
            self.counters.add("cache_misses")
            return None
        name = spec.get("name") \
            or os.path.basename(str(spec.get("input"))).split(".")[0]
        base = os.path.join(str(spec.get("output")), name)
        trace_id = (trace or {}).get("trace_id") or obs_trace.mint_trace_id()
        try:
            with obs_trace.span("route.cache_answer", link=trace,
                                trace_id=trace_id, key=key,
                                digest=digest, shard=entry.get("shard"),
                                negative=bool(entry.get("negative"))):
                n = self.result_cache.materialize(entry, base)
                # the answer span's wire context: echoed on the ack (and
                # on duplicate re-submits of the same key) so the
                # submitter links follow-up spans to the cache answer
                ctx = obs_trace.wire_context()
        except Exception as e:
            print(f"WARNING: route: cache materialize of {digest} failed "
                  f"({e}); dispatching normally", file=sys.stderr, flush=True)
            return None
        job = {"job_id": 0, "key": key, "state": "done", "error": None,
               "outputs": {"base": base}, "wall_s": 0.0, "attempts": 0,
               "gang_size": 0, "input": spec.get("input"),
               "deadline_s": None, "trace_id": trace_id, "trace": ctx,
               "tenant": spec.get("tenant"), "qos": spec.get("qos"),
               "cached": True}
        if self._cache_journal is not None:
            try:
                # journaled-before-ack, exactly like a submit: a crash
                # after this line replays the answer, a crash before it
                # means the reply never left and the cache re-answers
                self._cache_journal.append_marker(
                    "cache_answer", key=key, digest=digest, job=job)
            except Exception as e:
                print(f"WARNING: route: cache-answer journal write failed "
                      f"({e}); dispatching normally", file=sys.stderr,
                      flush=True)
                return None
        self._cache_answers[key] = job
        self.counters.add("route_cache_answers", 1)
        self.counters.add("cache_hits", 1)
        if entry.get("negative"):
            self.counters.add("cache_negative_hits", 1)
        print(f"route: answered submit {key} from the result cache "
              f"(digest {digest[:12]}, {n} bytes materialized)",
              file=sys.stderr, flush=True)
        return {"ok": True, "job_id": 0, "state": "done", "key": key,
                "duplicate": False, "cached": True, "node": "cache",
                "trace": ctx}

    def _keyed(self, req: dict) -> str:
        key = req.get("key")
        if not key:
            raise ServeClientError(
                "the router is key-addressed: poll with 'key' (worker "
                "job ids are per-daemon)", {"bad_request": True})
        return str(key)

    def status(self, req: dict) -> dict:
        key = self._keyed(req)
        answered = self._cache_answers.get(key)
        if answered is not None:
            return {"ok": True, "job": dict(answered)}
        tried: set[str] = set()
        swept = False
        while True:
            member = self.resolve(key)
            try:
                reply = self._forward(member, {"op": "status", "key": key})
                self._prune_attempts(key, reply)
                return reply
            except ServeClientError as e:
                if e.reply.get("unknown") and not swept:
                    swept = True  # one fleet sweep per call
                    if self._locate_sweep(key, skip=member.name) is not None \
                            or self._journal_resubmit(key):
                        continue
                    answer = self._journal_answer(key)
                    if answer is not None:
                        return answer
                if not e.reply.get("transport") or member.name in tried:
                    raise
                tried.add(member.name)  # one failover hop per member

    def result(self, req: dict, slice_s: float = 5.0) -> dict:
        """Blocking keyed result with failover: the member-side wait runs
        in bounded slices so a node death mid-poll is noticed within
        ``slice_s`` and the poll continues against the new owner."""
        key = self._keyed(req)
        answered = self._cache_answers.get(key)
        if answered is not None:
            return {"ok": True, "job": dict(answered)}
        timeout = req.get("timeout")
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        swept = False
        while True:
            if self.closing:
                return {"ok": False, "error": "router shutting down",
                        "shutdown": True}
            remaining = slice_s
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"job {key} still pending")
            member = self.resolve(key)
            try:
                reply = self._forward(
                    member,
                    {"op": "result", "key": key,
                     "timeout": min(slice_s, remaining)},
                    timeout=min(slice_s, remaining) + 10.0)
                self._prune_attempts(key, reply)
                return reply
            except ServeClientError as e:
                if e.reply.get("unknown") and not swept:
                    swept = True  # one fleet sweep per call
                    if self._locate_sweep(key, skip=member.name) is not None \
                            or self._journal_resubmit(key):
                        continue
                    answer = self._journal_answer(key)
                    if answer is not None:
                        return answer
                if e.reply.get("timeout") or e.reply.get("shutdown") \
                        or e.reply.get("transport"):
                    continue  # next slice (possibly on a new owner)
                raise

    # -------------------------------------------------- lifecycle / fleet

    def stop_admission(self) -> None:
        self._draining = True

    def drain(self, timeout: float | None = None, node: str | None = None):
        """Drain one member (``node``) or the whole fleet (admission off
        everywhere first, then every member drains in parallel)."""
        if node:
            with self._lock:
                targets = [self._members[node]]
        else:
            targets = list(self.members())
        if node is None:
            self.stop_admission()
        errors: dict[str, str] = {}

        def _drain_one(member: _Member):
            try:
                member.client.drain(timeout=timeout)
                with self._lock:
                    member.draining = True
            except Exception as e:
                errors[member.name] = str(e)

        threads = [threading.Thread(target=_drain_one, args=(m,), daemon=True)
                   for m in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return {"drained": sorted(m.name for m in targets
                                  if m.name not in errors),
                "errors": errors}

    def close(self) -> None:
        self.closing = True
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        if self._cache_journal is not None:
            self._cache_journal.close()

    def shutdown(self, timeout: float | None = None) -> None:
        self.close()

    def healthz(self) -> dict:
        members = [m.describe() for m in self.members()]
        up = [m for m in members if m["up"]]
        if self.standby or self.fenced:
            status = "standby"
        elif self._draining:
            status = "draining"
        else:
            status = "serving" if up else "degraded"
        return {
            "status": status,
            "role": "router",
            "router_id": self.router_id,
            "epoch": self.epoch,
            "ha_state": ("fenced" if self.fenced else
                         ("standby" if self.standby else "active")),
            "queued": sum(m["queued"] for m in up),
            "running": sum(m["running"] for m in up),
            "quarantined": sum(m.get("quarantined", 0) for m in up),
            "uptime_s": round(time.time() - self._started_at, 3),
            "pid": os.getpid(),
            "fleet": {"size": len(members), "up": len(up),
                      "members": members},
        }

    def metrics(self) -> dict:
        """Fleet metrics doc: the router's own counters/labeled series,
        each reachable member's full doc under ``nodes.<name>``, and a
        cross-node merge of the labeled series (so per-qos consumers of
        the single-daemon doc keep working against the router)."""
        nodes: dict[str, dict] = {}
        for member in self.members():
            if not member.up:
                nodes[member.name] = None
                continue
            try:
                nodes[member.name] = member.client.request(
                    {"op": "metrics"}, timeout=15.0)["metrics"]
            except Exception:
                nodes[member.name] = None  # telemetry never fails routing
        merged = obs_metrics.labeled_snapshot()  # router's own node_* series
        for doc in nodes.values():
            labeled = (doc or {}).get("labeled") or {}
            for kind in ("counters", "histograms"):
                for name, entries in (labeled.get(kind) or {}).items():
                    merged.setdefault(kind, {}).setdefault(
                        name, []).extend(entries)
        health = self.healthz()
        cumulative = self.counters.snapshot()
        # the router's own trace-plane tallies (spans / links / orphans)
        # and profiler tallies (samples / drops / shards)
        cumulative.update(obs_trace.counter_snapshot())
        cumulative.update(obs_prof.counter_snapshot())
        cumulative.update(obs_history.counter_snapshot())
        return {
            "stage": "route",
            "phases_s": {"uptime": time.time() - self._started_at},
            "draining": self._draining,
            "router_id": self.router_id,
            "epoch": self.epoch,
            "ha_state": health["ha_state"],
            "cumulative": cumulative,
            "labeled": merged,
            "fleet": health["fleet"],
            "nodes": nodes,
        }

    def trace_fleet(self) -> list[dict]:
        """Every process's span buffer, for the ``trace`` op with ``fleet``: the
        router's own events plus each up member's ``trace`` op reply.
        Down members are skipped (their flushed shards are still
        collectable from ``CCT_TRACE_DIR`` — that is the point of the
        on-disk shards); collection never fails routing."""
        groups: list[dict] = [{"node": self.router_id, "pid": os.getpid(),
                               "events": obs_trace.collect_events()}]
        for member in self.members():
            if not member.up:
                continue
            try:
                reply = member.client.request({"op": "trace"}, timeout=15.0)
            except Exception:
                continue
            buf = reply.get("trace")
            if isinstance(buf, dict):
                groups.append(buf)
        return groups

    def prof_fleet(self) -> list[dict]:
        """Every process's profile, for the ``prof`` op with ``fleet``: the router's own
        shard lines + wall attribution plus each up member's ``prof``
        op reply.  Down members' flushed ``prof-*.ndjson`` shards stay
        collectable from ``CCT_PROF_DIR`` — same discipline as traces;
        collection never fails routing."""
        docs: list[dict] = [obs_prof.collect(node=self.router_id)]
        for member in self.members():
            if not member.up:
                continue
            try:
                reply = member.client.request({"op": "prof"}, timeout=15.0)
            except Exception:
                continue
            doc = reply.get("prof")
            if isinstance(doc, dict):
                docs.append(doc)
        return docs

    def history_fleet(self) -> list[dict]:
        """Every process's telemetry history, for the ``history`` op with ``fleet``: the
        router's own shard lines plus each up member's ``history`` op
        reply.  Down members' flushed ``history-*.ndjson`` shards stay
        collectable from ``CCT_HISTORY_DIR`` — same discipline as
        trace/prof; collection never fails routing."""
        docs: list[dict] = [obs_history.collect(node=self.router_id)]
        for member in self.members():
            if not member.up:
                continue
            try:
                reply = member.client.request({"op": "history"},
                                              timeout=15.0)
            except Exception:
                continue
            doc = reply.get("history")
            if isinstance(doc, dict):
                docs.append(doc)
        return docs


class RouterServer(ServeServer):
    """The router's wire shell: :class:`serve.server.ServeServer`'s
    socket/connection machinery with the dispatch table swapped for the
    fleet ops (submit/status/result/locate/healthz/metrics/drain).  The
    router object rides in the ``scheduler`` slot — ``request_shutdown``
    and ``install_signal_handlers`` work unchanged because the router
    speaks the same ``stop_admission``/``drain`` lifecycle."""

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0, socket_path: str | None = None,
                 max_conns: int | None = None):
        super().__init__(router, host=host, port=port,
                         socket_path=socket_path, max_conns=max_conns)
        self.router = router

    def shutdown(self) -> None:
        self.router.closing = True  # unpark sliced result waiters
        super().shutdown()

    def _dispatch(self, req: dict) -> dict:
        if not isinstance(req, dict):
            return {"ok": False, "error": "request must be a JSON object"}
        op = req.get("op")
        try:
            if op == "submit":
                return self.router.submit(req.get("spec") or {},
                                          trace=req.get("trace"))
            if op == "status":
                return self.router.status(req)
            if op == "result":
                return self.router.result(req)
            if op == "locate":
                loc = self.router.locate(str(req.get("key") or ""))
                return {"ok": True, **loc}
            if op == "healthz":
                return {"ok": True, "health": self.router.healthz()}
            if op == "metrics":
                doc = self.router.metrics()
                if req.get("format") == "prometheus":
                    return {"ok": True,
                            "prometheus": obs_metrics.render_fleet_prometheus(
                                doc)}
                return {"ok": True, "metrics": doc}
            if op == "drain":
                out = self.router.drain(timeout=req.get("timeout"),
                                        node=req.get("node"))
                return {"ok": True, "drained": True, **out}
            if op == "adopt":
                out = self.router.adopt(str(req.get("node") or ""),
                                        force=bool(req.get("force")))
                return {"ok": True, "adopted": True, **out}
            if op == "release":
                out = self.router.release(str(req.get("key") or ""))
                return {"ok": True, **out}
            if op == "member_add":
                out = self.router.member_add(req.get("name"),
                                             req.get("address"),
                                             journal=req.get("journal"))
                return {"ok": True, **out}
            if op == "member_remove":
                out = self.router.member_remove(req.get("name"))
                return {"ok": True, **out}
            if op == "trace":
                # fleet trace collection; works from standbys and fenced
                # zombies too (post-mortems outlive the HA role)
                if req.get("fleet"):
                    return {"ok": True, "trace": self.router.trace_fleet()}
                return {"ok": True, "trace": {
                    "node": self.router.router_id, "pid": os.getpid(),
                    "events": obs_trace.collect_events()}}
            if op == "prof":
                # fleet profile collection; unfenced for the same
                # reason as trace — perf postmortems outlive HA roles
                if req.get("fleet"):
                    return {"ok": True, "prof": self.router.prof_fleet()}
                return {"ok": True,
                        "prof": obs_prof.collect(node=self.router.router_id)}
            if op == "history":
                # fleet history collection; unfenced for the same
                # reason as trace/prof — "what changed over the last
                # hour" outlives HA roles
                if req.get("fleet"):
                    return {"ok": True,
                            "history": self.router.history_fleet()}
                return {"ok": True,
                        "history": obs_history.collect(
                            node=self.router.router_id)}
            return {"ok": False, "error": f"unknown op {op!r}"}
        except ServeClientError as e:
            # a member refusal / ``ok: false`` travels back verbatim
            reply = dict(e.reply) if e.reply else {}
            reply.setdefault("error", str(e))
            reply["ok"] = False
            return reply
        except TimeoutError as e:
            return {"ok": False, "error": str(e), "timeout": True}
        except Exception as e:  # surface, never kill the router
            print(f"WARNING: route op {op!r} failed: {e}",
                  file=sys.stderr, flush=True)
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
