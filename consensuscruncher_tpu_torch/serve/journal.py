"""Write-ahead job journal: the daemon's crash-durability spine.

Every accepted job appends one fsync'd NDJSON record BEFORE the submit
reply leaves the daemon, and appends again on every lifecycle transition
(``accepted -> dispatched -> done | failed``).  A crash — SIGKILL, OOM,
power loss — therefore never loses an acknowledged job: on startup the
scheduler replays the journal and re-enqueues every job not provably
terminal.  Replay is **exactly-once at the output level** even though a
job may *run* more than once, because each replayed job finishes through
the per-job manifest ``--resume`` path: stages whose atomically-committed
outputs are intact are skipped, and the rest re-run byte-identically
(the stages' commit_file discipline guarantees no partial output exists to
resume over).

Record format (one JSON object per line, ``sort_keys`` + compact
separators so the bytes are deterministic):

  {"deadline_s": null, "id": 3, "key": "9c0f...", "rec": "job",
   "spec": {...}, "state": "accepted", "v": 1}
  {"id": 3, "rec": "job", "state": "dispatched", "v": 1}
  {"id": 3, "outputs": {...}, "rec": "job", "state": "done",
   "v": 1, "wall_s": 4.21}
  {"kind": "drain", "rec": "marker", "v": 1}

Later records for an id merge over earlier ones, so transition records
carry only the delta.  The ``drain`` marker distinguishes a clean
SIGTERM shutdown from a crash in post-mortem reads (replay semantics are
identical either way — only what the journal *proves* matters).

Durability mechanics:

- appends go through a single pre-opened ``O_APPEND`` fd with
  ``os.fsync`` after every record — a submit is acknowledged only once
  its record is on disk;
- rotation (checkpointing) writes a compacted snapshot to a temp file
  and swaps it in via ``manifest.commit_file`` (fsync + rename +
  dir-fsync), the same atomic-commit primitive the stage writers use;
- replay tolerates a torn final record (a crash mid-append leaves a
  truncated last line): it is logged and skipped, never fatal.  A torn
  *accepted* record means the submit reply cannot have been sent, so
  dropping it is correct, not lossy.

Fault sites: ``serve.journal_write`` (append path — an armed fault makes
the submit refuse instead of acknowledging an unjournaled job) and
``serve.journal_replay`` (per-record replay — a corrupt record is
skipped and logged, the rest of the journal still recovers).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

from consensuscruncher_tpu_torch import __version__
from consensuscruncher_tpu_torch.obs import trace as obs_trace
from consensuscruncher_tpu_torch.serve import wire
from consensuscruncher_tpu_torch.utils import faults, sanitize
from consensuscruncher_tpu_torch.utils.manifest import commit_file

#: Spec fields that define a job's identity for idempotent resubmit.
#: ``deadline_s`` is deliberately excluded: resubmitting the same work
#: with a different deadline must still dedupe onto the running job.
#: ``tenant``/``qos`` ARE identity: two tenants submitting the same
#: paths are distinct jobs (quotas and SLO accounting must not cross),
#: but both fields are omitted when absent so pre-tenancy specs keep
#: their historical keys.  ``input_range`` is identity too: two shards
#: of the same input are different jobs with different outputs.
#: ``policy`` (the consensus vote policy) is identity — it
#: changes the output bytes — and is likewise omitted when absent, so a
#: default (majority) submit keeps its pre-policy key.
KEY_FIELDS = ("input", "output", "name", "cutoff", "qualscore", "scorrect",
              "max_mismatch", "bdelim", "compress_level", "tenant", "qos",
              "input_range", "policy")

#: The pre-v2 field set (no ``input_range``, no version pin) — kept so
#: :func:`legacy_idempotency_key` can resolve keys written by journals
#: from before the cache plane landed.
_LEGACY_KEY_FIELDS = ("input", "output", "name", "cutoff", "qualscore",
                      "scorrect", "max_mismatch", "bdelim", "compress_level",
                      "tenant", "qos")


def _key_over(spec: dict, fields, version: str | None) -> str:
    ident = {k: spec.get(k) for k in fields if spec.get(k) is not None}
    if version is not None:
        ident["__v"] = version
    blob = json.dumps(ident, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def idempotency_key(spec: dict) -> str:
    """Stable identity of a job spec: sha256 over the sorted-keys compact
    JSON of the normalized identity fields.  Two submits of the same work
    hash identically regardless of field order or extra protocol keys.

    v2: the digest pins the package ``__version__`` (a code upgrade can
    change output bytes, so a stale pre-upgrade key must not claim the
    post-upgrade job) and includes ``input_range`` (shards of one input
    are distinct jobs).  Journals written under v1 keys still replay:
    the scheduler's recovery path registers replayed jobs under BOTH the
    journaled key and the recomputed one (see ``Scheduler._recover``),
    and :func:`legacy_idempotency_key` reproduces the v1 digest."""
    return _key_over(spec, KEY_FIELDS, __version__)


def legacy_idempotency_key(spec: dict) -> str:
    """The pre-cache-plane (v1) key of a spec: no version pin, no
    ``input_range``.  Migration shim only — used at journal replay so a
    client still polling a v1 key resolves against the replayed job."""
    return _key_over(spec, _LEGACY_KEY_FIELDS, None)


def job_record(job_id: int, state: str, *, key: str | None = None,
               spec: dict | None = None, deadline_s: float | None = None,
               outputs: dict | None = None, error: str | None = None,
               wall_s: float | None = None,
               trace_id: str | None = None,
               trace: dict | None = None,
               qc: dict | None = None) -> dict:
    """One journal record; only non-None fields are written (transition
    records carry just the delta, replay merges by id).  ``trace_id`` is
    the correlation id minted at submit — journaled so a replayed job's
    spans stitch onto the pre-crash trace.  ``trace`` is the full wire
    trace context of the submit-ack span ({"trace_id", "span", "pid",
    "hop"}): persisted on the accepted record so a failover resubmit or
    journal adoption can emit a ``follows_from`` edge back to the dead
    owner's durable ack span — the trace survives kill -9 and replay.
    ``qc`` is the job's consensus-quality doc, journaled on the terminal
    record so QC attribution survives a restart too."""
    rec: dict = {"v": 1, "rec": "job", "id": int(job_id), "state": state}
    for field, value in (("key", key), ("spec", spec),
                         ("deadline_s", deadline_s), ("outputs", outputs),
                         ("error", error), ("wall_s", wall_s),
                         ("trace_id", trace_id), ("trace", trace),
                         ("qc", qc)):
        if value is not None:
            rec[field] = value
    return rec


def _encode(doc: dict) -> bytes:
    """One journal line: sorted-keys compact JSON plus a ``crc`` field
    (CRC32 over the record minus the crc itself — the wire envelope's
    canonical digest).  Replay verifies it, so a mid-file bit flip is
    skipped-and-counted instead of silently mis-replaying a job; legacy
    (v1) records without the field replay unchanged.  The record version
    bumps to 2 *because* of the crc: a v2 record missing the field means
    the crc itself was corrupted away, so replay must not mistake it for
    legacy (the crc cannot protect its own key name)."""
    out = {k: v for k, v in doc.items() if k != "crc"}
    out["v"] = 2
    out["crc"] = wire.crc_of(out)
    return json.dumps(out, sort_keys=True, separators=(",", ":")).encode() + b"\n"


class Journal:
    """Append-only fsync'd NDJSON journal with atomic checkpoint rotation.

    ``max_bytes`` is advisory: the owner checks :meth:`size` and calls
    :meth:`rotate` with a compacted snapshot when the file outgrows it.
    """

    def __init__(self, path: str, max_bytes: int | None = None):
        self.path = str(path)
        self.max_bytes = max_bytes
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        # lock-order asserted under CCT_SANITIZE=1; the fd + fsync happen
        # under it so concurrent appends cannot interleave half-records
        self._lock = sanitize.tracked_lock("journal.lock")
        self._fd = os.open(self.path, os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                           0o644)
        self._size = os.fstat(self._fd).st_size

    # ------------------------------------------------------------- appends

    def append(self, doc: dict) -> int:
        """Append one record and fsync; returns bytes written.  Raises on
        any write/fsync failure (the caller must NOT acknowledge work whose
        record did not reach disk).  ``serve.journal_write`` fires here.
        The write+fsync is timed into the ``journal_fsync_s`` histogram —
        fsync latency is the admission path's floor."""
        faults.fault_point("serve.journal_write")
        line = _encode(doc)
        with obs_trace.span("journal.append", histogram="journal_fsync_s",
                            bytes=len(line)):
            with self._lock:
                if self._fd < 0:
                    raise OSError("journal is closed")
                os.write(self._fd, line)
                os.fsync(self._fd)
                self._size += len(line)
        return len(line)

    def append_job(self, job_id: int, state: str, **fields) -> int:
        return self.append(job_record(job_id, state, **fields))

    def append_marker(self, kind: str, **fields) -> int:
        rec = {"v": 1, "rec": "marker", "kind": kind}
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        return self.append(rec)

    def size(self) -> int:
        with self._lock:
            return self._size

    # ------------------------------------------------------------ rotation

    def rotate(self, records: list[dict]) -> None:
        """Checkpoint: replace the journal with a compacted snapshot (one
        full-state record per live job), committed atomically via the same
        fsync+rename+dir-fsync primitive as stage outputs.  A crash during
        rotation leaves either the old journal or the new one — never a
        mix, never a hole."""
        with self._lock:
            fd, tmp = tempfile.mkstemp(
                prefix=os.path.basename(self.path) + ".rot.",
                dir=os.path.dirname(os.path.abspath(self.path)))
            try:
                with os.fdopen(fd, "wb") as fh:
                    for rec in records:
                        fh.write(_encode(rec))
                commit_file(tmp, self.path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            # the O_APPEND fd still points at the renamed-away inode:
            # reopen on the new file
            os.close(self._fd)
            self._fd = os.open(self.path,
                               os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
            self._size = os.fstat(self._fd).st_size

    def close(self) -> None:
        with self._lock:
            if self._fd >= 0:
                os.close(self._fd)
                self._fd = -1


# ------------------------------------------------------------------ replay

def replay(path: str) -> tuple[dict[int, dict], dict]:
    """Read a journal into per-job merged state.

    Returns ``(jobs, info)``: ``jobs`` maps job id -> merged record (the
    union of every record for that id, later fields winning), ``info``
    carries ``{"records", "skipped", "torn_tail", "clean_drain",
    "adopted_by", "fence_epoch"}``.

    Four marker kinds carry fleet-HA state through replay:

    - an ``adopted`` tombstone (written by the router after it resubmits
      a dead member's non-terminal jobs to their ring successors) tags
      every job recorded *before* it with ``"adopted": True`` — a
      returning zombie worker must not re-run work that now lives
      elsewhere; ``info["adopted_by"]`` names the adopting router;
    - a ``fence`` marker persists the highest router epoch this worker
      has accepted, so a restart cannot be tricked into honoring a
      demoted router's forwards (``info["fence_epoch"]``);
    - a ``suspect`` marker (written BEFORE each dispatch) attributes an
      in-flight job to this node: ``info["suspects"]`` maps key -> the
      highest attempt ordinal journaled, so replay after kill -9 can
      blame the job that was running when the process died;
    - a ``quarantined`` marker folds last-wins per key into
      ``info["quarantined"]`` (key -> reason) — duplicates are
      idempotent, and a later ``released: true`` marker for the key
      removes it (the release re-opens the key for dispatch).

    Tolerant by design: a torn final record (crash mid-append) is logged
    and skipped; any other undecodable or fault-injected record is logged,
    counted in ``skipped``, and the rest of the journal still replays.
    ``serve.journal_replay`` fires per record.
    """
    jobs: dict[int, dict] = {}
    info = {"records": 0, "skipped": 0, "crc_skipped": 0, "torn_tail": False,
            "clean_drain": False, "adopted_by": None, "fence_epoch": None,
            "suspects": {}, "quarantined": {}}
    # schedule point: a zombie's replay racing an adopter's tombstone
    # append is exactly the interleaving the model checker explores here
    sanitize.yield_point("journal.replay")
    if not os.path.exists(path):
        return jobs, info
    with open(path, "rb") as fh:
        raw = fh.read()
    lines = raw.split(b"\n")
    # a well-formed journal ends with a newline -> last split element empty;
    # anything else is a torn tail from a crash mid-append
    tail = lines.pop() if lines else b""
    if tail.strip():
        lines.append(tail)
    for idx, line in enumerate(lines):
        if not line.strip():
            continue
        last = idx == len(lines) - 1
        try:
            faults.fault_point("serve.journal_replay")
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("record is not an object")
        except (ValueError, faults.FaultError) as e:
            info["skipped"] += 1
            if last and isinstance(e, ValueError) and line == tail:
                info["torn_tail"] = True
                print(f"WARNING: journal {path}: torn final record "
                      f"({len(line)} bytes) — crash mid-append; dropping it "
                      "(its submit was never acknowledged)",
                      file=sys.stderr, flush=True)
            else:
                print(f"WARNING: journal {path}: skipping unreadable record "
                      f"at line {idx + 1} ({e})", file=sys.stderr, flush=True)
            continue
        crc_bad = not wire.verify(rec)
        if not crc_bad and isinstance(rec.get("v"), int) and rec["v"] >= 2 \
                and "crc" not in rec:
            # v2 records ALWAYS carry a crc; one without it had the crc
            # (or its key name) corrupted away and must not pass as legacy
            crc_bad = True
        if crc_bad:
            # the line parses but its integrity check fails: a mid-file
            # bit flip that happened to keep the JSON well-formed.  Acting
            # on it could resurrect a different job state than was acked —
            # skip it, count it, keep replaying the rest.  (Records from
            # pre-crc v1 journals carry no ``crc`` and verify trivially.)
            info["skipped"] += 1
            info["crc_skipped"] += 1
            print(f"WARNING: journal {path}: record at line {idx + 1} "
                  "failed its crc (mid-file corruption); skipping it",
                  file=sys.stderr, flush=True)
            continue
        info["records"] += 1
        if rec.get("rec") == "marker":
            # markers only matter as the journal's last word: any job
            # record after a drain marker belongs to a newer daemon life
            info["clean_drain"] = rec.get("kind") == "drain"
            if rec.get("kind") == "adopted":
                # tombstone: every job recorded so far was handed to its
                # ring successor; a replaying zombie must not re-run them
                info["adopted_by"] = str(rec.get("router") or "?")
                for merged in jobs.values():
                    merged["adopted"] = True
            elif rec.get("kind") == "fence":
                try:
                    epoch = int(rec.get("epoch"))
                except (TypeError, ValueError):
                    epoch = None
                if epoch is not None:
                    info["fence_epoch"] = max(
                        info["fence_epoch"] or 0, epoch)
            elif rec.get("kind") == "suspect":
                key = rec.get("key")
                try:
                    attempt = int(rec.get("attempt"))
                except (TypeError, ValueError):
                    attempt = None
                if isinstance(key, str) and attempt is not None:
                    info["suspects"][key] = max(
                        info["suspects"].get(key, 0), attempt)
            elif rec.get("kind") == "quarantined":
                key = rec.get("key")
                if isinstance(key, str):
                    if rec.get("released"):
                        # release re-opens the key; last marker wins
                        info["quarantined"].pop(key, None)
                    else:
                        info["quarantined"][key] = \
                            str(rec.get("reason") or "quarantined")
            continue
        info["clean_drain"] = False
        try:
            job_id = int(rec["id"])
        except (KeyError, TypeError, ValueError):
            info["skipped"] += 1
            print(f"WARNING: journal {path}: job record without id "
                  f"at line {idx + 1}", file=sys.stderr, flush=True)
            continue
        merged = jobs.setdefault(job_id, {})
        merged.update({k: v for k, v in rec.items()
                       if k not in ("v", "rec", "crc")})
    return jobs, info
