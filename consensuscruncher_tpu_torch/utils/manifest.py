"""Run manifest: explicit checkpoint/resume over the stage-file model.

Port of ``consensuscruncher_tpu/utils/manifest.py``.  Every stage persists
full BAM outputs, so a crash loses at most the running stage; this module
makes resuming explicit:

- each completed stage records fingerprints of its inputs, outputs, and the
  parameters that shaped them;
- on ``--resume``, a stage is skipped iff its recorded inputs, outputs, and
  parameters all still match — inputs are re-fingerprinted so an upstream
  change invalidates everything downstream, and outputs are re-fingerprinted
  so a half-written file (non-atomic writer, disk-full) never masquerades as
  a checkpoint;
- the manifest file itself is committed durably (write tmp, fsync, rename,
  fsync dir), the same discipline the BAM writers use via
  :func:`commit_file` below.

Fingerprints are ``(size, sha256(head 1 MiB), sha256(tail 1 MiB))`` —
content-based (mtime survives copies/rsync badly) but O(1) in file size, so
resuming a large run never re-hashes hundreds of GB.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

_CHUNK = 1 << 20  # head/tail bytes hashed per file

MANIFEST_VERSION = 1


def commit_file(tmp_path: str, final_path: str) -> None:
    """Atomically and durably publish ``tmp_path`` as ``final_path``:
    fsync the data, rename into place, fsync the directory.

    This is THE stage-output commit point for the whole pipeline (BAM
    writers, columnar merges, the manifest itself).  The rename gives
    all-or-nothing visibility; the two fsyncs make the commit survive a
    power cut — without them a crash can leave a fully *renamed* but
    zero-length file, which would then fingerprint as a valid checkpoint.
    """
    fd = os.open(tmp_path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp_path, final_path)
    dirname = os.path.dirname(os.path.abspath(final_path)) or "."
    try:
        dfd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return  # exotic fs that refuses O_RDONLY on dirs: rename still atomic
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def fingerprint(path: str) -> dict | None:
    """Content fingerprint of ``path``; None if it doesn't exist."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return None
    head = hashlib.sha256()
    tail = hashlib.sha256()
    with open(path, "rb") as fh:
        head.update(fh.read(_CHUNK))
        if size > _CHUNK:
            fh.seek(max(size - _CHUNK, _CHUNK))
            tail.update(fh.read(_CHUNK))
    return {"size": size, "head": head.hexdigest(), "tail": tail.hexdigest()}


class RunManifest:
    """Stage-completion ledger for one pipeline run directory."""

    def __init__(self, path: str):
        self.path = path
        self._stages: dict[str, dict] = {}
        if os.path.exists(path):
            try:
                with open(path) as fh:
                    data = json.load(fh)
                if isinstance(data, dict) and data.get("version") == MANIFEST_VERSION:
                    stages = data.get("stages")
                    if isinstance(stages, dict):
                        self._stages = {
                            name: entry
                            for name, entry in stages.items()
                            if isinstance(entry, dict)
                            and isinstance(entry.get("params"), dict)
                            and isinstance(entry.get("inputs"), dict)
                            and isinstance(entry.get("outputs"), dict)
                        }
            except (OSError, json.JSONDecodeError):
                # A corrupt manifest only disables skipping, never the run.
                self._stages = {}

    # ------------------------------------------------------------- recording

    def record(self, stage: str, inputs: list[str], outputs: list[str], params: dict) -> None:
        """Mark ``stage`` complete; fingerprints are taken now (outputs must
        already be fully written — call after the stage's atomic renames)."""
        entry = {
            "params": dict(params),
            "inputs": {p: fingerprint(p) for p in inputs},
            "outputs": {p: fingerprint(p) for p in outputs},
        }
        missing = [p for p, f in entry["outputs"].items() if f is None]
        if missing:
            raise FileNotFoundError(f"stage {stage!r} recorded missing outputs: {missing}")
        self._stages[stage] = entry
        self._flush()

    def _flush(self) -> None:
        data = {"version": MANIFEST_VERSION, "stages": self._stages}
        d = os.path.dirname(self.path) or "."
        fd, tmp = tempfile.mkstemp(prefix=".manifest.", dir=d)
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(data, fh, indent=2, sort_keys=True)
                fh.write("\n")
            commit_file(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # ------------------------------------------------------------- skipping

    def can_skip(self, stage: str, inputs: list[str], params: dict) -> bool:
        """True iff ``stage`` completed with these exact inputs + params and
        every recorded output is still intact on disk."""
        entry = self._stages.get(stage)
        if entry is None:
            return False
        if entry["params"] != params:
            return False
        if set(entry["inputs"]) != set(inputs):
            return False
        for p, recorded in entry["inputs"].items():
            if recorded is None or fingerprint(p) != recorded:
                return False
        for p, recorded in entry["outputs"].items():
            if fingerprint(p) != recorded:
                return False
        return True

    def outputs_of(self, stage: str) -> list[str]:
        entry = self._stages.get(stage)
        return list(entry["outputs"]) if entry else []

    def invalidate(self, stage: str) -> None:
        if self._stages.pop(stage, None) is not None:
            self._flush()
