"""Blocking client for the serve daemon (used by ``submit`` and tests).

One connection per request keeps the client stateless and retry-friendly;
the blocking ``result`` op simply holds its connection open until the
daemon replies (the server waits on the scheduler's condition, not the
socket, so a long job costs one idle descriptor, not a busy loop).

Restart-invisible polling: every transport failure (connection refused
while the supervisor restarts the daemon, connection reset by a crash,
``shutdown: true`` replies during a drain) is retried with capped
exponential backoff, and ``status``/``result`` can poll by the submit
reply's **idempotency key** instead of the job id.  The key is derived
from the spec, so it resolves against the restarted daemon's journal-
replayed jobs; resubmitting the same spec is also safe (the daemon
dedupes on the key).  A polling client therefore survives a daemon
kill/restart without ever learning it happened.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import sys
import time

from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.serve import wire
from consensuscruncher_tpu_torch.utils import faults, netchaos


class ServeClientError(RuntimeError):
    """The daemon replied ``ok: false`` (error text attached)."""

    def __init__(self, message: str, reply: dict | None = None):
        super().__init__(message)
        self.reply = reply or {}


class JobQuarantined(ServeClientError):
    """The fleet quarantined this job's key (poison containment: fleet
    retry budget exhausted, or the fault-domain breaker is open).  This
    is a *verdict*, not a transient — it is never retried (retry loops
    are exactly what poison jobs weaponize); an operator lifts it with
    ``cct route --release KEY``."""

    def __init__(self, message: str, reply: dict | None = None):
        super().__init__(message, reply)
        self.reason = str((reply or {}).get("reason") or message)
        self.key = (reply or {}).get("key")


class ServeClient:
    """``address`` is a unix socket path (str), a ``(host, port)`` pair,
    or a *list* of such addresses — an HA router pair's front doors.  The
    client talks to the first; on a retryable failure it rotates to the
    next (a standby router answers ``standby: true, busy: true``, which
    is retryable by design, so rotation finds the active automatically —
    the client survives a router failover without configuration).

    ``retries`` transport-level reconnect attempts (default
    ``CCT_SERVE_CLIENT_RETRIES`` or 5) with ``backoff_delay``-capped
    sleeps between them; every op is idempotent so a blind resend is safe.

    ``router`` (optional) is the fleet router's address — or a list of
    router addresses — for clients polling a *worker* directly: the key's
    current owner is re-resolved through a router when the worker stops
    answering, and the resolution itself walks the router list on
    **every** reconnect attempt, so a router failover happening in the
    middle of the client's retry loop is survived too (the responsive
    router is promoted to the front of the list).
    """

    def __init__(self, address, connect_timeout: float = 10.0,
                 retries: int | None = None,
                 retry_base_s: float | None = None,
                 router=None, counters=None):
        self.addresses = self._address_list(address)
        if not self.addresses:
            raise ValueError("serve client: empty address")
        self.address = self.addresses[0]
        self.routers = self._address_list(router)
        self.connect_timeout = connect_timeout
        if retries is None:
            retries = int(os.environ.get("CCT_SERVE_CLIENT_RETRIES", "5"))
        self.retries = max(0, int(retries))
        if retry_base_s is None:
            retry_base_s = float(os.environ.get("CCT_RETRY_BASE_S", "0.5"))
        self.retry_base_s = float(retry_base_s)
        # optional Counters sink (the router passes its own) for wire
        # health: crc mismatches on replies, request deadline hits
        self.counters = counters
        # per-client monotone seq for the wire envelope; next() is atomic,
        # so a client shared across handler threads stays collision-free
        self._seq = itertools.count(1)

    @property
    def router(self):
        """First configured router address (back-compat accessor)."""
        return self.routers[0] if self.routers else None

    @staticmethod
    def _address_list(value) -> list:
        """Normalize an address argument into a list of addresses.  A
        tuple, a string, or a 2-list ``[host, port]`` is ONE address;
        any other list is many (each element normalized likewise)."""
        if value is None:
            return []
        if isinstance(value, (str, tuple)):
            return [value]
        if isinstance(value, list):
            if len(value) == 2 and isinstance(value[0], str) \
                    and isinstance(value[1], int):
                return [(value[0], int(value[1]))]
            out = []
            for v in value:
                if isinstance(v, list) and len(v) == 2:
                    out.append((v[0], int(v[1])))
                else:
                    out.append(v)
            return out
        return [value]

    def _rotate_address(self) -> None:
        """Point at the next configured address (wrapping); a re-resolved
        off-list worker address simply falls back to the first router."""
        if len(self.addresses) < 2 and self.address in self.addresses:
            return
        try:
            i = self.addresses.index(self.address)
        except ValueError:
            i = -1
        nxt = self.addresses[(i + 1) % len(self.addresses)]
        if nxt != self.address:
            print(f"WARNING: serve client: rotating to {nxt}",
                  file=sys.stderr, flush=True)
            self.address = nxt

    def _request_once(self, doc: dict, timeout: float | None = None) -> dict:
        if isinstance(self.address, str):
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # every fleet socket is opened here (client->router, router->worker,
        # standby probes), so this one wrap point puts the whole fleet's
        # traffic behind the netchaos fault layer when a spec is armed
        sock = netchaos.maybe_wrap(sock, self.address)
        try:
            sock.settimeout(self.connect_timeout)
            sock.connect(self.address if isinstance(self.address, str)
                         else tuple(self.address))
            # after connect, the read deadline is the op's own timeout
            sock.settimeout(timeout)
            sealed = wire.seal(doc, next(self._seq))
            sock.sendall(json.dumps(sealed).encode() + b"\n")
            buf = b""
            while b"\n" not in buf:
                chunk = sock.recv(65536)
                if not chunk:
                    # a crash/restart mid-request: retryable transport loss
                    raise ServeClientError("daemon closed the connection",
                                           {"transport": True})
                buf += chunk
            reply = json.loads(buf.split(b"\n", 1)[0])
        finally:
            sock.close()
        if not wire.verify(reply):
            # a corrupted reply is transport loss, not data: drop it and
            # let the retry loop re-fetch (every op is idempotent by key)
            if self.counters is not None:
                self.counters.add("wire_crc_errors")
            raise ServeClientError("reply failed its crc (corrupted in "
                                   "flight)", {"transport": True,
                                               "crc_error": True})
        if not reply.get("ok"):
            if reply.get("quarantined"):
                raise JobQuarantined(
                    reply.get("error", "job quarantined"), reply)
            raise ServeClientError(reply.get("error", "daemon error"), reply)
        return reply

    @staticmethod
    def _retryable(exc: Exception) -> bool:
        if isinstance(exc, ServeClientError):
            # connection died mid-exchange, or the daemon is drain-restarting
            return bool(exc.reply.get("transport") or exc.reply.get("shutdown")
                        or exc.reply.get("busy"))
        # refused/reset while the supervisor restarts the daemon, read
        # timeouts against a wedged process, missing unix socket, ...
        return isinstance(exc, OSError)

    def _reresolve(self, doc: dict) -> bool:
        """Ask a router where this request's key lives *now* and repoint
        ``self.address`` there.  Walks the whole router list on EVERY
        attempt — a failover mid-retry just means the standby-turned-
        active answers instead; the responsive router is promoted to the
        front so later attempts hit it first.  Best-effort: all routers
        unreachable (or a keyless request) keeps the current address —
        the normal retry loop still covers a same-address daemon restart.
        Returns True when a router answered."""
        key = doc.get("key")
        if not key:
            return False
        for r in list(self.routers):
            try:
                reply = ServeClient(r, retries=0).request(
                    {"op": "locate", "key": key}, timeout=10.0)
            except Exception as e:
                print(f"WARNING: serve client: router {r} locate failed "
                      f"({e}); trying next", file=sys.stderr, flush=True)
                continue
            if r != self.routers[0]:
                self.routers.remove(r)
                self.routers.insert(0, r)
            address = reply.get("address")
            if isinstance(address, list):
                address = (address[0], int(address[1]))
            if address and address != self.address:
                print(f"WARNING: serve client: key {key} now owned by "
                      f"{reply.get('node')} at {address}; re-pointing",
                      file=sys.stderr, flush=True)
                self.address = address
            return True
        return False

    def _request(self, doc: dict, timeout: float | None = None) -> dict:
        if "trace" not in doc:
            # wire trace propagation: stamp the caller's open span as the
            # message's causal context (client -> router -> worker).  The
            # router's forward path flows through here too, so its route
            # span rides to the worker with no extra plumbing.  Computed
            # once: a retried resend continues the same causal chain.
            ctx = obs_trace.wire_context()
            if ctx is not None:
                doc = dict(doc, trace=ctx)
        attempts = self.retries + 1
        for attempt in range(attempts):
            try:
                return self._request_once(doc, timeout)
            except Exception as e:
                if isinstance(e, (socket.timeout, TimeoutError)) \
                        and self.counters is not None:
                    self.counters.add("wire_timeouts")
                if attempt + 1 >= attempts or not self._retryable(e):
                    raise
                delay = faults.backoff_delay(attempt + 1, self.retry_base_s, 5.0)
                print(f"WARNING: serve client: {e}; reconnecting in "
                      f"{delay:.1f}s (attempt {attempt + 2}/{attempts})",
                      file=sys.stderr, flush=True)
                time.sleep(delay)
                repointed = False
                if self.routers:
                    repointed = self._reresolve(doc)
                if not repointed and len(self.addresses) > 1:
                    self._rotate_address()
        raise AssertionError("unreachable")

    def request(self, doc: dict, timeout: float | None = None) -> dict:
        """One raw NDJSON request/reply with the full retry + router
        re-resolution discipline (the fleet router forwards through
        this; ops below are typed conveniences over it)."""
        return self._request(doc, timeout)

    # ----------------------------------------------------------------- ops

    @staticmethod
    def _ref(job_id, key) -> dict:
        if key is not None:
            return {"key": key}
        return {"job_id": job_id}

    def submit(self, spec: dict) -> int:
        return int(self.submit_full(spec)["job_id"])

    def submit_full(self, spec: dict, trace: dict | None = None) -> dict:
        """Submit and return the full reply (``job_id``, ``key``,
        ``duplicate``) — poll by ``key`` to survive daemon restarts.
        ``trace`` is the wire trace context a *logical* re-submit should
        continue (the ``trace`` field of the original ack): the dedup key
        makes the job the same job, and passing its context back keeps
        the causal timeline one tree instead of minting a fresh trace."""
        doc = {"op": "submit", "spec": spec}
        if isinstance(trace, dict):
            doc["trace"] = trace
        return self._request(doc)

    def submit_nowait(self, spec: dict) -> dict:
        """Submit without raising on admission refusal: a refused reply
        (queue full, deadline shed, tenant quota) comes back as the raw
        reply dict with ``ok: false`` plus ``refused``/``shed``/``quota``
        flags.  Under deliberate overload — the loadgen's open-loop
        traffic — refusal is data, not an error."""
        try:
            return self.submit_full(spec)
        except ServeClientError as e:
            if e.reply.get("refused"):
                return dict(e.reply)
            raise

    def status(self, job_id: int | None = None, *, key: str | None = None) -> dict:
        return self._request({"op": "status", **self._ref(job_id, key)})["job"]

    def result(self, job_id: int | None = None, timeout: float | None = None,
               *, key: str | None = None) -> dict:
        """Block until the job is done/failed; returns the job description.
        ``timeout`` bounds both the server-side wait and the socket read."""
        sock_timeout = None if timeout is None else timeout + 10.0
        return self._request(
            {"op": "result", "timeout": timeout, **self._ref(job_id, key)},
            timeout=sock_timeout,
        )["job"]

    def healthz(self) -> dict:
        return self._request({"op": "healthz"})["health"]

    def metrics(self) -> dict:
        return self._request({"op": "metrics"})["metrics"]

    def metrics_prometheus(self) -> str:
        """The same metrics doc rendered as Prometheus text exposition."""
        return self._request(
            {"op": "metrics", "format": "prometheus"})["prometheus"]

    def drain(self, timeout: float | None = None) -> None:
        sock_timeout = None if timeout is None else timeout + 10.0
        self._request({"op": "drain", "timeout": timeout}, timeout=sock_timeout)

    def run(self, spec: dict, timeout: float | None = None) -> dict:
        """submit + blocking result; raises on a failed job.  Polls by the
        idempotency key, so the job is found again even if the daemon
        restarted between the submit and the result."""
        sub = self.submit_full(spec)
        job = self.result(timeout=timeout, key=sub["key"])
        if job["state"] == "quarantined":
            raise JobQuarantined(
                f"job {job['job_id']} quarantined: {job.get('error')}",
                {"quarantined": True, "reason": job.get("error"),
                 "key": job.get("key")})
        if job["state"] != "done":
            raise ServeClientError(
                f"job {job['job_id']} {job['state']}: {job.get('error')}", job)
        return job
