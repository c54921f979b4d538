"""Fleet-wide content-addressed result cache (the serve plane's hit-rate
lever).  Port of ``consensuscruncher_tpu/serve/result_cache.py``: the
digest, the layout and the entry docs are the reference's, so
``content_digest`` gives the JAX package's value for the same spec.  Keep
the two packages' planes apart all the same: a materialized tree's stats
carry the writer's ``backend`` line (``cuda``/``cpu`` here), so an entry
the JAX package wrote would answer a port job with the JAX stats.

At fleet scale the traffic is dominated by overlapping questions: the
same BAM, the same consensus policy, submitted by many tenants.  The
per-worker journal already dedupes *exact resubmits within one journal*
(``journal.idempotency_key``), but identity there includes ``tenant``/
``qos``/``output`` — correct for quota accounting, useless for sharing
work.  This module keys results by what actually determines the bytes:

  content digest = sha256 over the sorted-keys compact JSON of
    {input fingerprint (``manifest.fingerprint``: size + head/tail
     hashes), derived job name, the consensus vote *parameters*
     (cutoff, qualscore, scorrect, max_mismatch, bdelim,
     compress_level), the vote *policy* name (when non-default),
     input_range (when sharded), package ``__version__``}

``tenant``, ``qos``, ``output`` and ``deadline_s`` are deliberately
EXCLUDED: two tenants asking the same question hit the same entry (the
whole point), and the payload is materialized into *their* output tree.
``__version__`` is INCLUDED: a code upgrade invalidates every entry by
construction — no epoch bookkeeping, no stale-result window.

Store layout (``<root>`` is the cache plane dir, shared or per-member)::

    <root>/<shard>/<digest[:2]>/<digest>/payload/<relpath...>
    <root>/<shard>/<digest[:2]>/<digest>/entry.json

``shard`` is the owning member's name — placement rides the same
consistent-hash ring as job routing (the router passes the digest's
ring owner as ``preferred_shard``), so a cache entry lives where the
job that produced it ran, and lookups check the ring home first before
sweeping peers.

Durability discipline:
every byte that lands under ``<root>`` goes through
``manifest.commit_file`` (fsync + rename + dir-fsync).  ``entry.json``
is committed LAST — it is the linearization point.  A reader that finds
``entry.json`` is guaranteed every payload file is durable and complete;
a crash mid-insert leaves at worst an invisible partial payload that a
later insert of the same digest simply overwrites.  There is no
read-repair and no locking between processes: inserts of the same
digest are idempotent byte-identical writes.

Negative entries: a run that provably produced zero consensus families
(an empty ``--input_range`` slice, a filtered-out input) is cached with
``negative: true``.  The payload (empty outputs) still materializes
byte-identically; the flag exists so hits on known-empty work are
counted separately (``cache_negative_hits``) and so range planners can
skip slices that are known-empty without reading BAM bytes.

Fault site ``serve.cache``: fired on every lookup and insert.  The
cache is an optimization, never a correctness dependency — callers
catch the fault (and any real IO error) and degrade to recomputing.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time

from consensuscruncher_tpu_torch import __version__
from consensuscruncher_tpu_torch.utils import faults, sanitize
from consensuscruncher_tpu_torch.utils.manifest import commit_file, fingerprint

#: Spec fields folded into the content digest.  Together with the input
#: fingerprint and ``__version__`` these determine the output bytes;
#: nothing else does (tenant/qos/output/deadline are routing and
#: accounting concerns, not identity).  ``policy`` — the consensus vote
#: policy — changes the bytes and so is identity, but like
#: every field here it folds in only when present: a default (majority)
#: spec keeps its pre-policy digest, so entries written before the
#: policy subsystem still hit.
DIGEST_FIELDS = ("cutoff", "qualscore", "scorrect", "max_mismatch",
                 "bdelim", "compress_level", "input_range", "policy")

ENTRY_NAME = "entry.json"
LOCAL_SHARD = "local"

#: corrupt entries are moved here (never served, kept for post-mortem);
#: excluded from the shard walk so lookups can't wander into it
QUARANTINE_DIR = "quarantine"


def _sha256_file(path: str) -> str | None:
    """Streaming sha256 of a file, or ``None`` when unreadable."""
    h = hashlib.sha256()
    try:
        with open(path, "rb") as fh:
            while True:
                chunk = fh.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
    except OSError:
        return None
    return h.hexdigest()


def content_digest(spec: dict) -> str | None:
    """Content digest of a job spec, or ``None`` when the input cannot be
    fingerprinted (missing/unreadable file -> not cacheable; the submit
    path will surface the real error).  The derived job *name* is part
    of the digest because output filenames embed it — two names produce
    byte-identical content under different paths, which is not the
    byte-identical contract the cache promises."""
    path = spec.get("input")
    if not path:
        return None
    fp = fingerprint(str(path))
    if fp is None:
        return None
    name = spec.get("name") or os.path.basename(str(path)).split(".")[0]
    ident: dict = {"fp": fp, "name": name, "v": __version__}
    for k in DIGEST_FIELDS:
        if spec.get(k) is not None:
            ident[k] = spec.get(k)
    blob = json.dumps(ident, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def _walk_files(base: str) -> list[str]:
    """Relative paths of every regular file under ``base``, sorted for a
    deterministic entry doc (symlinks and special files are skipped —
    the pipeline never writes them)."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(base):
        for fn in filenames:
            full = os.path.join(dirpath, fn)
            if os.path.isfile(full) and not os.path.islink(full):
                out.append(os.path.relpath(full, base))
    return sorted(out)


def _copy_committed(src: str, dest: str) -> tuple[int, str]:
    """Copy one file into place via tmp + ``commit_file``; returns
    ``(bytes, sha256)`` — the digest is computed over the same bytes the
    commit made durable, so the entry doc can pin the payload's identity.
    The tmp file lives in the destination directory so the final rename
    is same-filesystem atomic."""
    dest_dir = os.path.dirname(os.path.abspath(dest))
    os.makedirs(dest_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".cache.", dir=dest_dir)
    try:
        n = 0
        h = hashlib.sha256()
        with os.fdopen(fd, "wb") as out, open(src, "rb") as inp:
            while True:
                chunk = inp.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
                h.update(chunk)
                n += len(chunk)
        commit_file(tmp, dest)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return n, h.hexdigest()


class ResultCache:
    """One process's handle on the cache plane rooted at ``root``.

    ``node`` names this process's shard (where its inserts land);
    lookups read every shard, preferring ``preferred_shard`` (the ring
    owner) so the common case is one directory probe.  ``max_bytes``
    bounds THIS shard's payload bytes; eviction is oldest-entry-first
    and only ever touches the local shard (peers own theirs).
    """

    def __init__(self, root: str, node: str | None = None,
                 max_bytes: int | None = None, counters=None):
        self.root = str(root)
        self.node = str(node or LOCAL_SHARD)
        self.max_bytes = int(max_bytes) if max_bytes else None
        # optional Counters sink: integrity-degraded hits are counted
        # (``cache_integrity_misses``) when the owner wires one in
        self.counters = counters
        os.makedirs(os.path.join(self.root, self.node), exist_ok=True)
        self._lock = sanitize.tracked_lock("result_cache.lock")

    # ------------------------------------------------------------ layout

    def entry_dir(self, digest: str, shard: str | None = None) -> str:
        return os.path.join(self.root, shard or self.node,
                            digest[:2], digest)

    def _shards(self) -> list[str]:
        try:
            names = [d for d in sorted(os.listdir(self.root))
                     if os.path.isdir(os.path.join(self.root, d))
                     and d != QUARANTINE_DIR]
        except OSError:
            return [self.node]
        return names

    # ------------------------------------------------------------ lookup

    def lookup(self, digest: str,
               preferred_shard: str | None = None) -> dict | None:
        """Find a committed entry for ``digest`` anywhere in the plane.
        Returns the entry doc (with ``shard`` and ``dir`` annotated) or
        ``None``.  ``serve.cache`` fires here: an armed fault makes the
        lookup miss, never fail the caller."""
        try:
            faults.fault_point("serve.cache")
        except faults.FaultError as e:
            print(f"WARNING: result cache: lookup degraded to miss ({e})",
                  file=sys.stderr, flush=True)
            return None
        shards = self._shards()
        if preferred_shard and preferred_shard in shards:
            shards.remove(preferred_shard)
            shards.insert(0, preferred_shard)
        elif self.node in shards:
            shards.remove(self.node)
            shards.insert(0, self.node)
        for shard in shards:
            entry = self._read_entry(digest, shard)
            if entry is None:
                continue
            err = self._integrity_error(entry)
            if err is not None:
                # the payload no longer matches the sha256 the insert
                # pinned: NEVER serve it.  Degrade to a counted miss,
                # move the corpse aside for post-mortem, keep probing
                # the other shards (a peer may hold a good copy).
                if self.counters is not None:
                    self.counters.add("cache_integrity_misses")
                moved = self.quarantine(entry)
                print(f"WARNING: result cache: entry {digest} in shard "
                      f"{shard} failed integrity ({err}); quarantined to "
                      f"{moved or '<unmovable>'} and degraded to a miss",
                      file=sys.stderr, flush=True)
                continue
            return entry
        return None

    def _integrity_error(self, entry: dict) -> str | None:
        """Re-hash every payload file against the sha256 the entry doc
        pinned at insert.  ``None`` means clean; entries from before the
        integrity field (no ``sha256`` on any file) have nothing to
        check and pass unchanged."""
        payload_dir = os.path.join(entry["dir"], "payload")
        for f in entry.get("files", []):
            want = f.get("sha256")
            if want is None:
                continue
            got = _sha256_file(os.path.join(payload_dir, f["path"]))
            if got != want:
                return (f"{f['path']}: sha256 "
                        f"{got or 'unreadable'} != {want}")
        return None

    def quarantine(self, entry: dict) -> str | None:
        """Move a corrupt entry's directory to ``<root>/quarantine/``.
        ``entry.json`` is unlinked FIRST — the entry disappears for every
        reader before anything else moves (the exact reverse of insert's
        entry-last commit order), so no lookup can race into a half-moved
        dir.  Returns the quarantine path, or ``None`` if the move
        failed (the entry is still invisible: its doc is gone)."""
        edir = entry["dir"]
        try:
            os.unlink(os.path.join(edir, ENTRY_NAME))
        except OSError:
            pass
        qroot = os.path.join(self.root, QUARANTINE_DIR)
        try:
            os.makedirs(qroot, exist_ok=True)
            dest = os.path.join(
                qroot, f"{entry.get('shard') or self.node}-{entry['digest']}")
            n = 0
            while os.path.exists(dest):
                n += 1
                dest = os.path.join(
                    qroot, f"{entry.get('shard') or self.node}-"
                           f"{entry['digest']}.{n}")
            # not a cache-plane write: the entry doc is already gone, so
            # no reader can observe this dir; the move only relocates a
            # corpse out of the shard tree for post-mortem
            os.rename(edir, dest)
        except OSError:
            return None
        return dest

    def scrub(self) -> dict:
        """Offline integrity sweep (the CLI's ``cache scrub``): re-hash every
        committed entry's payload across every shard; corrupt entries
        are quarantined.  Returns ``{"entries", "intact", "legacy",
        "corrupt", "quarantined": [...]}`` (``legacy`` counts entries
        from before the sha256 field — nothing to verify)."""
        out: dict = {"entries": 0, "intact": 0, "legacy": 0, "corrupt": 0,
                     "quarantined": []}
        for shard in self._shards():
            shard_dir = os.path.join(self.root, shard)
            for dirpath, _dirnames, filenames in os.walk(shard_dir):
                if ENTRY_NAME not in filenames:
                    continue
                entry = self._read_entry(os.path.basename(dirpath), shard)
                if entry is None:
                    continue
                out["entries"] += 1
                if not any(f.get("sha256")
                           for f in entry.get("files", [])):
                    out["legacy"] += 1
                    continue
                err = self._integrity_error(entry)
                if err is None:
                    out["intact"] += 1
                    continue
                out["corrupt"] += 1
                if self.counters is not None:
                    self.counters.add("cache_integrity_misses")
                moved = self.quarantine(entry)
                out["quarantined"].append({
                    "digest": entry["digest"], "shard": shard,
                    "error": err, "moved_to": moved})
        return out

    def _read_entry(self, digest: str, shard: str) -> dict | None:
        edir = self.entry_dir(digest, shard)
        path = os.path.join(edir, ENTRY_NAME)
        try:
            with open(path) as fh:
                entry = json.load(fh)
        except (OSError, ValueError):
            return None
        if not isinstance(entry, dict) or entry.get("digest") != digest:
            return None
        entry["shard"] = shard
        entry["dir"] = edir
        return entry

    # ------------------------------------------------------------ insert

    def insert(self, digest: str, base_dir: str, *,
               negative: bool = False, meta: dict | None = None) -> dict | None:
        """Commit the finished job's output tree under ``base_dir`` as a
        cache entry in this process's shard.  Payload files first (each
        via ``commit_file``), ``entry.json`` last — the entry is visible
        only once every payload byte is durable.  Idempotent: an entry
        that already exists is left alone (same digest -> same bytes).
        Returns the committed entry doc, or ``None`` when the insert was
        skipped or degraded (armed fault / IO error)."""
        try:
            faults.fault_point("serve.cache")
        except faults.FaultError as e:
            print(f"WARNING: result cache: insert skipped ({e})",
                  file=sys.stderr, flush=True)
            return None
        existing = self._read_entry(digest, self.node)
        if existing is not None:
            return existing
        if not os.path.isdir(base_dir):
            return None
        edir = self.entry_dir(digest, self.node)
        payload_dir = os.path.join(edir, "payload")
        files = []
        total = 0
        try:
            for rel in _walk_files(base_dir):
                n, sha = _copy_committed(os.path.join(base_dir, rel),
                                         os.path.join(payload_dir, rel))
                files.append({"path": rel, "size": n, "sha256": sha})
                total += n
            entry = {"v": 1, "digest": digest, "negative": bool(negative),
                     "bytes": total, "files": files, "node": self.node,
                     "t": time.time()}
            if meta:
                entry["meta"] = dict(meta)
            fd, tmp = tempfile.mkstemp(prefix=".entry.", dir=edir)
            try:
                with os.fdopen(fd, "w") as fh:
                    json.dump(entry, fh, sort_keys=True)
                commit_file(tmp, os.path.join(edir, ENTRY_NAME))
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
        except OSError as e:
            print(f"WARNING: result cache: insert of {digest} failed ({e}); "
                  "recompute path unaffected", file=sys.stderr, flush=True)
            return None
        entry["shard"] = self.node
        entry["dir"] = edir
        return entry

    # -------------------------------------------------------- materialize

    def materialize(self, entry: dict, dest_base: str) -> int:
        """Copy a committed entry's payload into ``dest_base`` (the
        requesting job's own output tree), each file via ``commit_file``
        so a crash mid-materialize never leaves a partial output a
        ``--resume`` run would trust.  Returns bytes written."""
        payload_dir = os.path.join(entry["dir"], "payload")
        total = 0
        for f in entry.get("files", []):
            rel = f["path"]
            n, _sha = _copy_committed(os.path.join(payload_dir, rel),
                                      os.path.join(dest_base, rel))
            total += n
        return total

    # ----------------------------------------------------------- eviction

    def shard_stats(self) -> dict:
        """``{"entries", "bytes"}`` for THIS shard (committed entries
        only — invisible partial payloads don't count)."""
        entries = 0
        total = 0
        shard_dir = os.path.join(self.root, self.node)
        for dirpath, _dirnames, filenames in os.walk(shard_dir):
            if ENTRY_NAME not in filenames:
                continue
            entry = self._read_entry(os.path.basename(dirpath), self.node)
            if entry is None:
                continue
            entries += 1
            total += int(entry.get("bytes", 0))
        return {"entries": entries, "bytes": total}

    def evict_to_budget(self, emergency: bool = False) -> list[dict]:
        """Drop oldest committed entries from the local shard until its
        payload bytes fit ``max_bytes``.  The entry doc is unlinked
        FIRST (the entry disappears atomically for readers), payload
        files after — the reverse of insert order, so no reader ever
        sees a visible entry with missing payload.  Returns the evicted
        entry docs.

        ``emergency=True`` is the ENOSPC first responder: the disk the
        journal fsyncs to is full, and cache bytes are the cheapest on
        the box (every entry is re-computable by construction) — evict
        the oldest half of the shard (at least one entry) regardless of
        ``max_bytes`` so the brownout path gets one append's worth of
        space back."""
        if not self.max_bytes and not emergency:
            return []
        with self._lock:
            live = []
            shard_dir = os.path.join(self.root, self.node)
            for dirpath, _dirnames, filenames in os.walk(shard_dir):
                if ENTRY_NAME not in filenames:
                    continue
                entry = self._read_entry(os.path.basename(dirpath), self.node)
                if entry is not None:
                    live.append(entry)
            total = sum(int(e.get("bytes", 0)) for e in live)
            live.sort(key=lambda e: e.get("t", 0.0))
            evicted = []
            budget = self.max_bytes or float("inf")
            keep = len(live)
            if emergency:
                keep = len(live) // 2
            while live and (total > budget or len(live) > keep):
                entry = live.pop(0)
                try:
                    os.unlink(os.path.join(entry["dir"], ENTRY_NAME))
                except OSError:
                    continue
                for f in entry.get("files", []):
                    try:
                        os.unlink(os.path.join(entry["dir"], "payload",
                                               f["path"]))
                    except OSError:
                        pass
                total -= int(entry.get("bytes", 0))
                evicted.append(entry)
            return evicted
