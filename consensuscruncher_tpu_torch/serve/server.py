"""The daemon's wire front-end: newline-delimited JSON over a socket.

One request per line, one JSON reply per line; a connection may carry any
number of requests (the blocking ``result`` op holds its line open until
the job finishes).  Transport is either a unix socket (``socket_path``) or
localhost TCP — both are single-host by design: the daemon is a *device
host* process, remote fan-in belongs to a reverse proxy.

Ops (all replies carry ``"ok"``):

  {"op": "submit", "spec": {...}}       -> {"ok": true, "job_id": N,
                                            "key": "...", "duplicate": bool}
  {"op": "status", "job_id": N}         -> {"ok": true, "job": {...}}
  {"op": "result", "job_id": N,
   "timeout": seconds|null}             -> blocks; {"ok": true, "job": {...}}
  {"op": "healthz"}                     -> {"ok": true, "health": {...}}
  {"op": "metrics"}                     -> {"ok": true, "metrics": {...}}
  {"op": "metrics",
   "format": "prometheus"}              -> {"ok": true, "prometheus": "..."}
                                           (text exposition, histograms
                                           with cumulative le buckets)
  {"op": "drain", "timeout": s|null}    -> blocks; {"ok": true, "drained": true}
  {"op": "trace"}                       -> {"ok": true, "trace": {"node",
                                            "pid", "events": [...]}}
                                           (this process's span buffer,
                                           for ``cct trace fleet``)

Causal tracing: any request may carry a ``"trace"`` context
(``{"trace_id", "span", "pid", "hop"}`` — stamped automatically by
``ServeClient``); the submit path links the accepted job's span tree to
it and the ack reply echoes the job's own durable context back.

Failure containment replies: a submit for a quarantined key (poison
containment — fleet retry budget exhausted or breaker open) comes back
``refused: true, quarantined: true`` with a human ``reason``; during a
resource-exhaustion brownout (journal appends failing ENOSPC) fresh
admissions reply ``refused: true, brownout: true`` while polls and
cache-hit submits keep working.  ``{"op": "release", "key": ...}``
lifts a key's quarantine (``cct route --release``) and re-queues the
parked job.  A forwarded submit may carry ``"attempts"`` — the router's
fleet attempt lineage for the key, max-merged into the scheduler's
budget gate before admission.

``status``/``result`` accept ``"key"`` (the submit reply's idempotency
key) in place of ``"job_id"`` — keys survive a daemon restart, ids are
only as durable as the journal, so restart-invisible polling uses keys.
A submit whose spec hashes to an already-tracked job returns that job
with ``"duplicate": true``.  A job evicted from memory (result TTL)
replies ``state: "expired"`` with the on-disk output path.  A submit shed
for its deadline replies ``refused: true, shed: true``; one refused by a
per-tenant quota replies ``refused: true, quota: true``.  A request
carrying a fleet-router ``epoch`` below the highest this worker has
accepted replies ``fenced: true, epoch: <live>`` (see
:meth:`Scheduler.fence` — zombie-router protection after a standby
takeover; epoch-less requests are never fenced).

Errors reply ``{"ok": false, "error": "..."}`` and keep the connection
usable; a malformed line closes the connection.  The ``serve.accept``
fault site fires per accepted connection (chaos tests turn accept-path
failures into clean error replies, never daemon death); ``serve.sigterm``
fires inside the shutdown path (a fault there degrades to an immediate
stop — journal replay makes even that lossless).

Lifecycle: handler threads are tracked in a bounded registry and joined
in :meth:`ServeServer.close`, so shutdown never leaks a socket mid-reply.
:func:`install_signal_handlers` wires SIGTERM/SIGINT to
:func:`request_shutdown`: stop admission, journal a ``drain`` marker,
break the accept loop — the serve CLI then finishes in-flight work within
``CCT_SERVE_DRAIN_S`` and exits 0.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
import time

from consensuscruncher_tpu_torch.obs import history as obs_history
from consensuscruncher_tpu_torch.obs import prof as obs_prof
from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.obs.metrics import render_prometheus
from consensuscruncher_tpu_torch.serve import wire
from consensuscruncher_tpu_torch.serve.scheduler import (
    AdmissionRefused, BrownoutRefused, DeadlineShed, QuarantineRefused,
    QuotaRefused, RouterFenced, Scheduler,
)
from consensuscruncher_tpu_torch.utils import faults, sanitize

MAX_LINE = 1 << 20  # 1 MiB per request line; specs are tiny


class ServeServer:
    """Accept loop + per-connection handler threads over a Scheduler."""

    def __init__(self, scheduler: Scheduler, host: str = "127.0.0.1",
                 port: int = 0, socket_path: str | None = None,
                 max_conns: int | None = None,
                 read_timeout_s: float | None = None,
                 idle_timeout_s: float | None = None):
        self.scheduler = scheduler
        self.socket_path = socket_path
        if max_conns is None:
            max_conns = int(os.environ.get("CCT_SERVE_MAX_CONNS", "128"))
        self.max_conns = max(1, int(max_conns))
        # per-connection deadlines: read_timeout bounds a *half-frame*
        # stall (bytes buffered, rest never arrives), idle_timeout bounds
        # a connected-but-silent peer.  Either expiring reaps the
        # connection and recovers its max_conns slot (``conns_reaped``).
        # 0 disables a deadline (the legacy unbounded behavior).
        if read_timeout_s is None:
            read_timeout_s = float(
                os.environ.get("CCT_SERVE_READ_TIMEOUT_S", "30"))
        if idle_timeout_s is None:
            idle_timeout_s = float(
                os.environ.get("CCT_SERVE_IDLE_TIMEOUT_S", "300"))
        self.read_timeout_s = max(0.0, float(read_timeout_s))
        self.idle_timeout_s = max(0.0, float(idle_timeout_s))
        if socket_path:
            if os.path.exists(socket_path):
                os.unlink(socket_path)  # stale socket from a dead daemon
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.bind(socket_path)
            self.address: object = socket_path
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self.address = self._sock.getsockname()  # (host, real port)
        self._sock.listen(16)
        self._closed = False
        self._accept_thread: threading.Thread | None = None
        # bounded registry of live connection handlers: close() joins them
        # so shutdown cannot leak a socket mid-reply
        self._conn_lock = sanitize.tracked_lock("server.conns")
        self._conns: dict[int, tuple[socket.socket, threading.Thread]] = {}
        self._next_conn = 0

    def describe(self) -> str:
        if self.socket_path:
            return f"unix:{self.socket_path}"
        host, port = self.address
        return f"tcp:{host}:{port}"

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Run the accept loop on a background thread (tests, embedding)."""
        self._accept_thread = threading.Thread(
            target=self.serve_forever, name="serve-accept", daemon=True)
        self._accept_thread.start()

    def serve_forever(self) -> None:
        while not self._closed:
            try:
                # cct: allow-wire(shutdown closes the listener to break accept; per-connection deadlines start in _handle_conn)
                conn, _addr = self._sock.accept()
            except OSError:
                return  # socket closed under us: clean shutdown
            busy = False
            with self._conn_lock:
                if len(self._conns) >= self.max_conns:
                    busy = True
                else:
                    self._next_conn += 1
                    cid = self._next_conn
                    t = threading.Thread(
                        target=self._handle_conn, args=(conn, cid),
                        name=f"serve-conn-{cid}", daemon=True)
                    self._conns[cid] = (conn, t)
            if busy:
                # reply outside the lock: sendall can block
                self._reply(conn, {"ok": False, "busy": True,
                                   "error": f"server busy "
                                            f"({self.max_conns} connections)"})
                conn.close()
                continue
            t.start()

    def shutdown(self) -> None:
        """Break the accept loop without joining handlers — the signal-safe
        half of close() (callable from a signal handler)."""
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self, timeout: float = 10.0) -> None:
        self.shutdown()
        try:
            # half-close live connections: no new requests are read, but
            # in-flight replies still flush before the join below
            with self._conn_lock:
                live = list(self._conns.values())
            for conn, _t in live:
                try:
                    conn.shutdown(socket.SHUT_RD)
                except OSError:
                    pass
            deadline = time.monotonic() + timeout
            for _conn, t in live:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            # stragglers (e.g. a result waiter mid-poll): force the socket
            # closed and give each thread a moment to unwind
            with self._conn_lock:
                stuck = list(self._conns.values())
            for conn, _t in stuck:
                try:
                    conn.close()
                except OSError:
                    pass
            for _conn, t in stuck:
                t.join(timeout=1.0)
        finally:
            if self.socket_path and os.path.exists(self.socket_path):
                try:
                    os.unlink(self.socket_path)
                except OSError:
                    pass

    # ----------------------------------------------------------- connection

    def _handle_conn(self, conn: socket.socket, cid: int) -> None:
        counters = getattr(self.scheduler, "counters", None)
        replay = wire.ReplayCache()
        try:
            try:
                faults.fault_point("serve.accept")
            except faults.FaultError as e:
                self._reply(conn, {"ok": False, "error": str(e)})
                return
            try:
                buf = b""
                last_activity = time.monotonic()
                while True:
                    # a partial frame in the buffer puts the connection on
                    # the (short) read deadline — a half-frame-then-stall
                    # peer must finish its line or lose the slot; an empty
                    # buffer is merely idle and gets the longer deadline
                    limit = self.read_timeout_s if buf else self.idle_timeout_s
                    if limit > 0:
                        remaining = (last_activity + limit) - time.monotonic()
                        if remaining <= 0:
                            if counters is not None:
                                counters.add("conns_reaped")
                            self._reply(conn, {
                                "ok": False, "transport": True,
                                "reaped": True,
                                "error": "connection reaped "
                                         f"({'read' if buf else 'idle'} "
                                         "deadline exceeded)"})
                            return
                        conn.settimeout(remaining)
                    else:
                        conn.settimeout(None)  # deadline disabled
                    try:
                        chunk = conn.recv(65536)
                    except socket.timeout:
                        continue  # loop re-checks the deadline and reaps
                    if not chunk:
                        return
                    last_activity = time.monotonic()
                    buf += chunk
                    if len(buf) > MAX_LINE:
                        self._reply(conn, {"ok": False,
                                           "error": "request too large"})
                        return
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        if not line.strip():
                            continue
                        try:
                            req = json.loads(line)
                        except ValueError:
                            # an unparseable line IS a corrupted frame —
                            # the crc gate never got a chance.  Answer as
                            # retryable transport loss so the sender
                            # re-sends instead of giving up, then close
                            # (the stream offset can no longer be trusted)
                            if counters is not None:
                                counters.add("wire_crc_errors")
                            self._reply(conn, {
                                "ok": False, "transport": True,
                                "crc_error": True,
                                "error": "bad JSON (corrupted frame)"})
                            return
                        self._reply(conn, self._respond(req, replay, counters))
                        last_activity = time.monotonic()
            except (OSError, BrokenPipeError):
                pass  # client went away mid-exchange; nothing to clean up
        finally:
            conn.close()
            with self._conn_lock:
                self._conns.pop(cid, None)

    def _respond(self, req, replay: wire.ReplayCache, counters) -> dict:
        """Envelope gate around :meth:`_dispatch`: verify the crc of an
        enveloped request (a mismatch is answered as retryable transport
        loss, never dispatched), absorb duplicated frames from the
        per-connection seq replay cache, and seal replies to enveloped
        requests with their own seq echo + crc.  Legacy requests carry
        neither field and pass straight through untouched."""
        if not isinstance(req, dict):
            return {"ok": False, "error": "request must be a JSON object"}
        if not wire.verify(req):
            if counters is not None:
                counters.add("wire_crc_errors")
            return {"ok": False, "transport": True, "crc_error": True,
                    "error": "request failed its crc (corrupted in flight)"}
        seq = req.get("seq")
        if seq is not None:
            cached = replay.check(seq)
            if cached is not None:
                # a duplicated delivery of a frame already answered on
                # this connection: re-answer, never re-dispatch
                if counters is not None:
                    counters.add("wire_dup_dropped")
                return cached
            req = {k: v for k, v in req.items() if k not in ("seq", "crc")}
        reply = self._dispatch(req)
        if seq is not None:
            reply = wire.seal(reply, seq)
            replay.remember(seq, reply)
        return reply

    @staticmethod
    def _reply(conn: socket.socket, doc: dict) -> None:
        try:
            conn.sendall(json.dumps(doc).encode() + b"\n")
        except (OSError, BrokenPipeError):
            pass

    # ------------------------------------------------------------- dispatch

    def _lookup(self, req: dict):
        return self.scheduler.lookup(job_id=req.get("job_id"),
                                     key=req.get("key"))

    @staticmethod
    def _expired_reply(info: dict) -> dict:
        return {"ok": True, "job": {
            "job_id": info["job_id"], "key": info["key"], "state": "expired",
            "final_state": info["final_state"],
            "outputs": {"base": info["base"]},
            "error": f"result expired; outputs on disk at {info['base']}",
        }}

    def _wait_result(self, req: dict) -> dict:
        """Blocking result with shutdown awareness: the scheduler wait runs
        in bounded slices so a close() never wedges behind a parked waiter
        — the client sees ``shutdown: true`` and retries after restart."""
        found = self._lookup(req)
        if found is None:
            return {"ok": False, "error": "unknown job_id",
                    "unknown": True}
        kind, obj = found
        if kind == "expired":
            return self._expired_reply(obj)
        job = obj
        timeout = req.get("timeout")
        deadline = None if timeout is None else time.monotonic() + float(timeout)
        while job.state not in ("done", "failed", "quarantined"):
            if self._closed:
                return {"ok": False, "error": "server shutting down",
                        "shutdown": True}
            remaining = 0.5
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"job {job.id} still {job.state}")
            try:
                self.scheduler.wait(job.id, timeout=min(0.5, remaining))
            except TimeoutError:
                continue
            except KeyError:
                break  # evicted mid-wait: only terminal jobs evict
        return {"ok": True, "job": job.describe()}

    def _dispatch(self, req: dict) -> dict:
        if not isinstance(req, dict):
            return {"ok": False, "error": "request must be a JSON object"}
        op = req.get("op")
        try:
            if "epoch" in req and op in ("submit", "status", "result",
                                         "drain", "release"):
                # fleet-HA fencing: a router-forwarded request carries the
                # sender's ring-view epoch; a stale (pre-takeover) epoch
                # is rejected so a zombie router cannot double-dispatch.
                # healthz/metrics stay unfenced — observability must keep
                # answering even to a demoted router.
                self.scheduler.fence(req.get("epoch"), req.get("router"))
            if op == "submit":
                attempts = req.get("attempts")
                job, created = self.scheduler.submit_info(
                    req.get("spec") or {}, trace=req.get("trace"),
                    fleet_attempts=int(attempts) if attempts else None)
                # the ack echoes the accepted job's durable wire trace
                # context so the submitter (client or router) can link
                # follow-up spans to the ack span it just caused
                return {"ok": True, "job_id": job.id, "state": job.state,
                        "key": job.key, "duplicate": not created,
                        "trace": job.trace_ctx}
            if op == "status":
                found = self._lookup(req)
                if found is None:
                    return {"ok": False, "error": "unknown job_id",
                            "unknown": True}
                kind, obj = found
                if kind == "expired":
                    return self._expired_reply(obj)
                return {"ok": True, "job": obj.describe()}
            if op == "result":
                return self._wait_result(req)
            if op == "healthz":
                return {"ok": True, "health": self.scheduler.healthz()}
            if op == "metrics":
                doc = self.scheduler.metrics()
                if req.get("format") == "prometheus":
                    # text exposition for scrapers; same doc, rendered
                    return {"ok": True,
                            "prometheus": render_prometheus(doc)}
                return {"ok": True, "metrics": doc}
            if op == "drain":
                self.scheduler.drain(timeout=req.get("timeout"))
                return {"ok": True, "drained": True}
            if op == "release":
                # lift a key's quarantine (``cct route --release`` lands
                # here through the router); fenced like submit — only
                # the live epoch's router may re-open a poison key
                out = self.scheduler.release_quarantine(
                    str(req.get("key") or ""))
                return {"ok": True, **out}
            if op == "trace":
                # fleet trace collection: hand over this process's span
                # buffer (flushed shard when CCT_TRACE_DIR is set, else
                # the in-memory ring).  Unfenced like healthz/metrics —
                # a post-mortem must be collectable through a demoted
                # router too.
                return {"ok": True, "trace": {
                    "node": self.scheduler.node, "pid": os.getpid(),
                    "events": obs_trace.collect_events()}}
            if op == "prof":
                # profiler collection: this process's sampled-stack
                # shard lines + wall attribution.  Unfenced like
                # healthz/metrics/trace — perf postmortems must stay
                # collectable through a demoted router.
                return {"ok": True,
                        "prof": obs_prof.collect(node=self.scheduler.node)}
            if op == "history":
                # telemetry-history collection: this process's durable
                # NDJSON shard read back.  Unfenced like trace/prof —
                # "what changed over the last hour" must stay
                # answerable through a demoted router.
                return {"ok": True,
                        "history": obs_history.collect(
                            node=self.scheduler.node)}
            return {"ok": False, "error": f"unknown op {op!r}"}
        except RouterFenced as e:
            return {"ok": False, "error": str(e), "fenced": True,
                    "epoch": e.epoch}
        except DeadlineShed as e:
            return {"ok": False, "error": str(e), "refused": True,
                    "shed": True}
        except QuotaRefused as e:
            return {"ok": False, "error": str(e), "refused": True,
                    "quota": True}
        except QuarantineRefused as e:
            # poison containment: the key is quarantined (budget
            # exhausted / breaker open) — a typed refusal the client
            # must NOT retry (retrying is what poison jobs weaponize)
            return {"ok": False, "error": str(e), "refused": True,
                    "quarantined": True, "reason": e.reason or str(e),
                    "key": e.key}
        except BrownoutRefused as e:
            # resource exhaustion, not load: admissions refuse while the
            # daemon stays up for polls and cache hits
            return {"ok": False, "error": str(e), "refused": True,
                    "brownout": True}
        except AdmissionRefused as e:
            return {"ok": False, "error": str(e), "refused": True}
        except ValueError as e:
            # malformed spec — unknown qos class, unknown vote policy,
            # missing required fields: a typed bad_request the client
            # must fix, never retry (the spec hashes identically again)
            return {"ok": False, "error": str(e), "refused": True,
                    "bad_request": True}
        except TimeoutError as e:
            return {"ok": False, "error": str(e), "timeout": True}
        except Exception as e:  # surface, never kill the daemon
            print(f"WARNING: serve op {op!r} failed: {e}",
                  file=sys.stderr, flush=True)
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}


# -------------------------------------------------------------- lifecycle

def request_shutdown(server: ServeServer, scheduler: Scheduler,
                     journal=None) -> None:
    """Initiate a supervised shutdown: stop admission, journal a ``drain``
    marker, break the accept loop.  The serve CLI then runs the bounded
    drain and exits.  Unit-testable outside a real signal delivery; the
    ``serve.sigterm`` fault site degrades it to an immediate stop (queued
    jobs stay journaled, so even the degraded path loses nothing)."""
    try:
        faults.fault_point("serve.sigterm")
    except faults.FaultError as e:
        print(f"WARNING: serve shutdown handler fault ({e}); stopping "
              "immediately — queued jobs stay journaled for replay",
              file=sys.stderr, flush=True)
        server.shutdown()
        return
    scheduler.stop_admission()
    if journal is not None:
        try:
            n = journal.append_marker("drain")
            scheduler.counters.add("journal_bytes", n)
        except Exception as e:
            print(f"WARNING: drain marker write failed ({e})",
                  file=sys.stderr, flush=True)
    server.shutdown()


def install_signal_handlers(server: ServeServer, scheduler: Scheduler,
                            journal=None) -> None:
    """SIGTERM/SIGINT -> graceful drain.  Closing the listening socket
    makes the (PEP 475 auto-retrying) ``accept`` call in serve_forever
    return, handing control back to the CLI's drain/exit sequence."""
    def _handler(signum, _frame):
        print(f"serve: caught signal {signum}; draining",
              file=sys.stderr, flush=True)
        request_shutdown(server, scheduler, journal)

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _handler)
