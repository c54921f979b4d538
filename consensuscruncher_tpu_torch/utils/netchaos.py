"""Deterministic wire-fault layer for the serve fleet (netchaos).

Every fleet socket — client->router submits, router->worker forwards,
the standby's probes of the active — is opened by :class:`ServeClient`,
which passes each freshly-connected socket through :func:`maybe_wrap`.
With ``CCT_NETCHAOS`` unset that is a no-op returning the raw socket;
with a spec armed the socket comes back wrapped in a
:class:`ChaosSocket` that injects **seeded, per-link** wire faults:

  partition    frames vanish (connects refused outbound, reads starve
               inbound) — directional, so ``a->b`` alone is an
               *asymmetric* partition
  latency:MS   fixed delay before every send/recv on the link
  jitter:MS    seeded 0..MS delay per frame
  torn:OFF     the frame is cut at byte OFF and the write side
               half-closed — the peer holds a torn tail
  truncate     a frame prefix is delivered and the rest never comes
               (half-frame stall; the read deadline reaps it)
  dup          the frame is delivered twice (the seq envelope must
               absorb the duplicate below the idempotency layer)
  corrupt      one seeded byte of the frame is flipped (the crc
               envelope must catch it before anything parses it)
  reset        half the frame, then a connection reset mid-message
  blackhole    the connection accepts and the request is sent, but no
               answer ever arrives

Spec grammar (``;``-separated entries)::

  CCT_NETCHAOS="seed=7;client->r0=corrupt@3;r1->r0=partition;r0<->w1=latency:50"

- ``seed=N`` seeds every per-frame decision (byte offsets, jitter) —
  the schedule is a pure function of (seed, link, kind, firing index);
- ``A->B=kind[@times][:arg]`` arms ``kind`` on frames **from A to B**
  (``A<->B`` arms both directions); ``*`` is a wildcard on either side;
  ``@times`` caps how often the rule fires in this process.
- ``CCT_NETCHAOS=@/path/to/spec`` reads the spec from a file,
  re-checked on every access — a conductor partitions and heals links
  live by rewriting one file the whole fleet watches.  A rewrite
  re-parses the spec, so ``@times`` budgets restart with it.

Identity: a process knows itself via ``CCT_NETCHAOS_NODE`` (default
``client``); the peer name is derived from the address being dialed —
a unix socket path's basename minus ``.sock`` (the fleet convention:
``w0.sock``, ``r1.sock``), or ``host:port`` for TCP.

The layer attacks the WIRE, never the protocol: everything it injects
must be survivable by the deadline/envelope/idempotency machinery, and
the chaos-conductor invariants (no acked job lost, goldens
byte-identical, epochs monotone) hold under any spec.
"""

from __future__ import annotations

import os
import socket
import time
import zlib

KINDS = ("partition", "latency", "jitter", "torn", "truncate", "dup",
         "corrupt", "reset", "blackhole")

#: kinds whose effect needs a numeric argument
_ARG_KINDS = ("latency", "jitter", "torn")


class NetChaosSpecError(ValueError):
    """A malformed CCT_NETCHAOS spec — refused loudly, never guessed at."""


class Rule:
    """One armed fault: ``src -> dst = kind[@times][:arg]``."""

    def __init__(self, src: str, dst: str, kind: str,
                 times: int | None = None, arg: float | None = None):
        if kind not in KINDS:
            raise NetChaosSpecError(
                f"netchaos: unknown fault kind {kind!r} "
                f"(known: {', '.join(KINDS)})")
        if arg is None and kind in _ARG_KINDS:
            raise NetChaosSpecError(
                f"netchaos: kind {kind!r} needs an argument "
                f"({kind}:<number>)")
        self.src = src
        self.dst = dst
        self.kind = kind
        self.times = times
        self.arg = arg
        self.fired = 0

    def matches(self, src: str, dst: str) -> bool:
        return (self.src in ("*", src)) and (self.dst in ("*", dst))

    def active(self) -> bool:
        return self.times is None or self.fired < self.times

    def fire(self) -> int:
        """Consume one firing; returns the firing ordinal (0-based)."""
        n = self.fired
        self.fired += 1
        return n

    @property
    def link(self) -> str:
        return f"{self.src}->{self.dst}"


def parse_spec(text: str) -> tuple[int, list[Rule]]:
    """``(seed, rules)`` from a spec string; empty/blank -> no rules."""
    seed = 0
    rules: list[Rule] = []
    for raw in str(text or "").split(";"):
        entry = raw.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise NetChaosSpecError(
                f"netchaos: bad entry {entry!r} (want link=kind or seed=N)")
        left, right = entry.split("=", 1)
        left, right = left.strip(), right.strip()
        if left == "seed":
            seed = int(right)
            continue
        if "<->" in left:
            a, b = (p.strip() for p in left.split("<->", 1))
            pairs = [(a, b), (b, a)]
        elif "->" in left:
            a, b = (p.strip() for p in left.split("->", 1))
            pairs = [(a, b)]
        else:
            raise NetChaosSpecError(
                f"netchaos: bad link {left!r} (want a->b or a<->b)")
        arg: float | None = None
        if ":" in right:
            right, argtext = right.split(":", 1)
            arg = float(argtext)
        times: int | None = None
        if "@" in right:
            right, timestext = right.split("@", 1)
            times = int(timestext)
        kind = right.strip()
        for src, dst in pairs:
            if not src or not dst:
                raise NetChaosSpecError(
                    f"netchaos: empty endpoint in {entry!r}")
            rules.append(Rule(src, dst, kind, times=times, arg=arg))
    return seed, rules


def peer_name(address) -> str:
    """Link endpoint name for an address: unix socket basename minus
    ``.sock`` (fleet convention), or ``host:port`` for TCP."""
    if isinstance(address, (tuple, list)):
        return f"{address[0]}:{address[1]}"
    base = os.path.basename(str(address))
    return base[:-5] if base.endswith(".sock") else base


def self_name() -> str:
    return os.environ.get("CCT_NETCHAOS_NODE") or "client"


class ChaosLayer:
    """A parsed spec plus its per-rule firing state (process-local)."""

    def __init__(self, spec_text: str):
        self.spec_text = str(spec_text or "")
        self.seed, self.rules = parse_spec(self.spec_text)

    def decide(self, rule: Rule, ordinal: int, salt: str = "") -> int:
        """Deterministic per-firing integer — a pure function of
        (seed, link, kind, ordinal), independent of process timing."""
        token = f"{self.seed}|{rule.link}|{rule.kind}|{ordinal}|{salt}"
        return zlib.crc32(token.encode()) & 0x7FFFFFFF

    def wrap(self, sock, peer: str):
        """The interposition point: returns ``sock`` untouched when no
        rule names the (self, peer) link in either direction."""
        me = self_name()
        out_rules = [r for r in self.rules if r.matches(me, peer)]
        in_rules = [r for r in self.rules if r.matches(peer, me)]
        if not out_rules and not in_rules:
            return sock
        return ChaosSocket(sock, self, out_rules, in_rules)


class ChaosSocket:
    """Socket proxy applying the layer's rules to this connection.

    Outbound rules (self -> peer) act on :meth:`connect`/:meth:`sendall`;
    inbound rules (peer -> self) act on :meth:`recv`.  Everything else
    delegates to the wrapped socket."""

    def __init__(self, sock, layer: ChaosLayer,
                 out_rules: list[Rule], in_rules: list[Rule]):
        self._sock = sock
        self._layer = layer
        self._out = out_rules
        self._in = in_rules
        self._blackholed = False    # request sent into a void
        self._reset_after = None    # bytes delivered, then reset
        self._eof_after = False     # truncate(in): prefix then silence
        self._pending = b""         # dup(in) second copy

    def __getattr__(self, name):
        return getattr(self._sock, name)

    # ------------------------------------------------------------ helpers

    def _first(self, rules: list[Rule], *kinds: str) -> Rule | None:
        for r in rules:
            if r.kind in kinds and r.active():
                return r
        return None

    def _delay(self, rules: list[Rule]) -> None:
        r = self._first(rules, "latency")
        if r is not None:
            r.fire()
            time.sleep(float(r.arg) / 1000.0)
        r = self._first(rules, "jitter")
        if r is not None:
            n = r.fire()
            ms = self._layer.decide(r, n) % (int(r.arg) + 1)
            time.sleep(ms / 1000.0)

    @staticmethod
    def _flip(data: bytes, idx: int) -> bytes:
        b = data[idx]
        x = b ^ 0x20
        if x in (0x0A, 0x0D):
            x = b ^ 0x21
        return data[:idx] + bytes([x]) + data[idx + 1:]

    # --------------------------------------------------------------- wire

    def connect(self, address):
        r = self._first(self._out, "partition")
        if r is not None:
            r.fire()
            raise ConnectionRefusedError(
                f"netchaos: link {r.link} partitioned")
        self._delay(self._out)
        return self._sock.connect(address)

    def sendall(self, data: bytes):
        self._delay(self._out)
        r = self._first(self._out, "partition")
        if r is not None:
            r.fire()
            return None  # the frame vanishes; the reply deadline notices
        r = self._first(self._out, "blackhole")
        if r is not None:
            r.fire()
            self._blackholed = True
            return self._sock.sendall(data)
        r = self._first(self._out, "torn")
        if r is not None:
            r.fire()
            cut = max(0, min(len(data), int(r.arg)))
            if cut:
                self._sock.sendall(data[:cut])
            try:
                self._sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            return None  # the peer holds a torn tail and must reap it
        r = self._first(self._out, "truncate")
        if r is not None:
            n = r.fire()
            cut = 1 + self._layer.decide(r, n) % max(1, len(data) - 1)
            return self._sock.sendall(data[:cut])
        r = self._first(self._out, "reset")
        if r is not None:
            r.fire()
            half = len(data) // 2
            if half:
                self._sock.sendall(data[:half])
            try:
                self._sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_LINGER,
                    b"\x01\x00\x00\x00\x00\x00\x00\x00")
            except OSError:
                pass
            self._sock.close()
            raise ConnectionResetError(
                f"netchaos: link {r.link} reset mid-send")
        r = self._first(self._out, "corrupt")
        if r is not None and len(data) > 1:
            n = r.fire()
            idx = self._layer.decide(r, n) % (len(data) - 1)
            data = self._flip(data, idx)
        r = self._first(self._out, "dup")
        if r is not None:
            r.fire()
            self._sock.sendall(data)
        return self._sock.sendall(data)

    def recv(self, bufsize: int) -> bytes:
        if self._pending:
            out, self._pending = self._pending[:bufsize], \
                self._pending[bufsize:]
            return out
        if self._eof_after:
            return b""
        if self._reset_after is not None:
            raise ConnectionResetError("netchaos: connection reset by peer")
        r = self._first(self._in, "partition", "blackhole")
        if r is not None or self._blackholed:
            if r is not None:
                r.fire()
            raise socket.timeout(
                "netchaos: no answer will ever arrive on this link")
        self._delay(self._in)
        chunk = self._sock.recv(bufsize)
        if not chunk:
            return chunk
        r = self._first(self._in, "reset")
        if r is not None:
            r.fire()
            self._reset_after = True
            return chunk[:max(1, len(chunk) // 2)]
        r = self._first(self._in, "truncate")
        if r is not None:
            n = r.fire()
            cut = 1 + self._layer.decide(r, n) % max(1, len(chunk) - 1)
            self._eof_after = True
            return chunk[:cut]
        r = self._first(self._in, "corrupt")
        if r is not None and len(chunk) > 1:
            n = r.fire()
            idx = self._layer.decide(r, n) % (len(chunk) - 1)
            chunk = self._flip(chunk, idx)
        r = self._first(self._in, "dup")
        if r is not None:
            r.fire()
            self._pending = chunk
        return chunk


# --------------------------------------------------------- process layer

_cached: tuple | None = None   # (cache key, ChaosLayer | None)


def _spec_source() -> tuple[object, str] | None:
    """``(cache_key, spec_text)`` for the current environment, or None
    when netchaos is unarmed.  ``@file`` specs key on (path, mtime,
    size) so a conductor's rewrite is picked up on the next access."""
    spec = os.environ.get("CCT_NETCHAOS") or ""
    if not spec.strip():
        return None
    if spec.startswith("@"):
        path = spec[1:]
        try:
            st = os.stat(path)
            with open(path, "r", encoding="utf-8") as fh:
                text = fh.read()
        except OSError:
            return None  # spec file not there (yet): unarmed
        return (path, st.st_mtime_ns, st.st_size, text), text
    return spec, spec


def get() -> ChaosLayer | None:
    """The process's chaos layer, or None when unarmed.  Cached on the
    spec source so per-rule ``@times`` budgets persist across sockets;
    a changed env value or rewritten spec file re-parses (and restarts
    the budgets — the documented live-control contract)."""
    global _cached
    source = _spec_source()
    if source is None:
        _cached = None
        return None
    key, text = source
    if _cached is not None and _cached[0] == key:
        return _cached[1]
    layer = ChaosLayer(text)
    _cached = (key, layer)
    return layer


def reset() -> None:
    """Drop the cached layer (tests arm/disarm specs mid-process)."""
    global _cached
    _cached = None


def maybe_wrap(sock, address):
    """The one call sites use: wrap ``sock`` for the link to ``address``
    when a spec is armed and names it; the raw socket otherwise."""
    layer = get()
    if layer is None:
        return sock
    return layer.wrap(sock, peer_name(address))
