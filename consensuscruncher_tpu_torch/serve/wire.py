"""Per-message wire envelope: ``{"seq", "crc"}`` over the NDJSON frames.

The serve protocol is one JSON document per line.  That survives process
death (the journal replays) but not the wire itself: a duplicated frame
after a router retry is invisible below the idempotency layer, and a
flipped bit inside a frame parses as a *different* request.  The envelope
closes both holes without breaking old peers:

- a client stamps every request with a per-connection monotone ``seq``
  and a ``crc`` (CRC32 of the canonical encoding of the document minus
  the ``crc`` field itself);
- a server that sees ``crc`` verifies it — a mismatch is answered
  ``{"ok": false, "transport": true, "crc_error": true}`` (counted in
  ``wire_crc_errors``) so the client's transport-retry loop re-sends,
  instead of the server acting on a corrupted document;
- a server that sees ``seq`` remembers its last replies per connection:
  a *duplicated* frame (same seq on the same connection) is answered
  from that replay cache (counted in ``wire_dup_dropped``) instead of
  re-dispatching;
- replies to enveloped requests echo ``seq`` and carry their own
  ``crc``, which the client verifies before trusting the reply.

Negotiation is per-message and implicit: a legacy peer simply never
sends the fields and never gets them back — nothing in the grammar
changed for it (``seq``/``crc`` are registered reply keys in
the JAX package's ``tools/cctlint/protocols.py``).
"""

from __future__ import annotations

import json
import zlib

#: replies remembered per connection for duplicate-frame absorption;
#: small on purpose — a duplicate arrives hot on the heels of the
#: original, never 33 requests later
REPLAY_CACHE_MAX = 32


def crc_of(doc: dict) -> int:
    """CRC32 of the canonical (sorted, compact) encoding of ``doc``
    minus any ``crc`` field — both sides compute over identical bytes
    regardless of key order or whitespace on the wire."""
    body = {k: v for k, v in doc.items() if k != "crc"}
    raw = json.dumps(body, sort_keys=True, separators=(",", ":")).encode()
    return zlib.crc32(raw) & 0xFFFFFFFF


def seal(doc: dict, seq: int) -> dict:
    """Return a copy of ``doc`` carrying the envelope fields.  A doc the
    canonical encoding cannot represent (exotic key types) degrades to
    seq-only — the peer's verify treats a missing crc as legacy, so the
    envelope never turns a deliverable message into an error."""
    out = dict(doc)
    out["seq"] = int(seq)
    try:
        out["crc"] = crc_of(out)
    except (TypeError, ValueError):
        pass
    return out


def verify(doc: dict) -> bool:
    """True when ``doc`` has no crc (legacy peer: nothing to check) or
    its crc matches the payload."""
    crc = doc.get("crc")
    if crc is None:
        return True
    try:
        return int(crc) == crc_of(doc)
    except (TypeError, ValueError):
        return False


class ReplayCache:
    """Per-connection seq -> reply memory (bounded, insertion-ordered).

    ``check(seq)`` returns the remembered reply for a duplicated frame,
    or None for a fresh seq; ``remember(seq, reply)`` stores the reply
    after dispatch so the next duplicate is answered without side
    effects."""

    def __init__(self, max_entries: int = REPLAY_CACHE_MAX):
        self.max_entries = max(1, int(max_entries))
        self._replies: dict[int, dict] = {}

    def check(self, seq) -> dict | None:
        try:
            return self._replies.get(int(seq))
        except (TypeError, ValueError):
            return None

    def remember(self, seq, reply: dict) -> None:
        try:
            seq = int(seq)
        except (TypeError, ValueError):
            return
        self._replies[seq] = reply
        while len(self._replies) > self.max_entries:
            self._replies.pop(next(iter(self._replies)))
