"""The port's write-ahead journal and its replay against the JAX package's
(CPU), and a daemon restart that replays a job through ``--resume``.

- The same appends through both packages' ``Journal`` write the same
  bytes, and a journal cut by a simulated crash replays to the
  same ``(jobs, info)`` in both: torn tail, a corrupted mid-file record,
  suspect/fence/quarantine markers, rotation.
- The truncation sweep: a journal cut at every byte replays, in the port
  as in the reference, to the records whose bytes fully survived — or to
  one more when the cut lands exactly after a record's closing brace (the
  newline lost, the JSON whole), the tolerance ``tests/test_history.py``
  states for its shards.  The bound does not depend on where the cuts
  fall, so the sweep cannot flake on path lengths.
- A daemon that died with a dispatched job (its gang's SSCS committed):
  the restarted scheduler replays the journal, re-enqueues the job, runs
  it through ``--resume`` without re-running SSCS, and the tree equals the
  one-shot run; healthz and the counters report the replay.
"""

import json
import os

import pytest

from consensuscruncher_tpu.serve import journal as jax_journal
from consensuscruncher_tpu_torch import cli as torch_cli
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.serve import journal as torch_journal
from consensuscruncher_tpu_torch.serve import scheduler as torch_sched
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")
with open(os.path.join(REPO, "test", "golden.json")) as _fh:
    GOLDEN = json.load(_fh)


def _spec(out, name, inp=SAMPLE):
    return {"input": inp, "output": str(out), "name": name}


def _write(mod, path, root):
    j = mod.Journal(str(path))
    j.append_job(1, "accepted", key="k1", spec=_spec(root, "a"), deadline_s=None,
                 trace_id="t1")
    j.append_job(2, "accepted", key="k2", spec=_spec(root, "b"), trace_id="t2")
    j.append_marker("suspect", key="k1", attempt=1, node=None)
    j.append_job(1, "dispatched", trace_id="t1")
    j.append_marker("fence", epoch=3, router="r0")
    j.append_job(2, "done", outputs={"base": "/o/b"}, wall_s=1.5, trace_id="t2")
    j.append_marker("quarantined", key="k9", reason="poison", node="w0")
    j.append_job(3, "accepted", key="k3", spec=_spec(root, "c"), trace_id="t3")
    j.close()
    return path.read_bytes()


def test_journal_bytes_and_crash_replay_equal_jax(tmp_path, capfd):
    port = _write(torch_journal, tmp_path / "port.wal", tmp_path)
    ref = _write(jax_journal, tmp_path / "jax.wal", tmp_path)
    assert port == ref
    lines = ref.split(b"\n")
    # a crash mid-append (torn tail) and a bit flip that keeps the JSON whole
    flipped = lines[5].replace(b'"wall_s":1.5', b'"wall_s":2.5')
    assert flipped != lines[5]
    crashed = b"\n".join(lines[:5] + [flipped] + lines[6:-2]) + b"\n" + lines[-2][:-9]
    wal = tmp_path / "crashed.wal"
    wal.write_bytes(crashed)
    got, want = torch_journal.replay(str(wal)), jax_journal.replay(str(wal))
    assert got == want
    jobs, info = got
    assert info["torn_tail"] and info["crc_skipped"] == 1 and info["fence_epoch"] == 3
    assert info["suspects"] == {"k1": 1} and info["quarantined"] == {"k9": "poison"}
    assert sorted(jobs) == [1, 2] and jobs[1]["state"] == "dispatched"
    # a rotated journal replays the same in both
    for mod, name in ((torch_journal, "p"), (jax_journal, "j")):
        j = mod.Journal(str(tmp_path / f"rot.{name}"))
        j.append_job(1, "accepted", key="k1", spec=_spec(tmp_path, "a"))
        j.rotate([mod.job_record(1, "done", key="k1", spec=_spec(tmp_path, "a"), wall_s=2.0)])
        j.append_job(4, "accepted", key="k4", spec=_spec(tmp_path, "d"))
        j.close()
    assert torch_journal.replay(str(tmp_path / "rot.p")) == \
        jax_journal.replay(str(tmp_path / "rot.j"))
    capfd.readouterr()


def test_idempotency_keys_follow_the_reference_rule():
    spec = _spec("/o", "x")
    # the reference's rule over the port's own __version__: stable,
    # spec-order blind, output-sensitive
    k = torch_journal.idempotency_key(spec)
    assert k == torch_journal.idempotency_key(dict(reversed(list(spec.items()))))
    assert k != torch_journal.idempotency_key(dict(spec, output="/p"))
    assert torch_journal.legacy_idempotency_key(spec) == \
        jax_journal.legacy_idempotency_key(spec)


def test_truncate_sweep_recovers_every_intact_prefix_or_the_cut_brace(tmp_path, capfd):
    jp = tmp_path / "wal"
    j = torch_journal.Journal(str(jp))
    j.append_job(1, "accepted", key="k1", spec=_spec(tmp_path / "a", "a"))
    j.append_job(2, "accepted", key="k2", spec=_spec(tmp_path / "b", "b"))
    j.append_job(1, "done", wall_s=1.0)
    j.close()
    pristine = jp.read_bytes()
    ends = [i for i, b in enumerate(pristine) if b == 0x0A]
    for cut in range(len(pristine) + 1):
        jp.write_bytes(pristine[:cut])
        jobs, info = torch_journal.replay(str(jp))  # must never raise
        whole = sum(1 for e in ends if e < cut)
        # a tail cut exactly at a record's closing brace (newline missing)
        # is still a complete JSON doc: replay may recover it, never more
        assert whole <= info["records"] <= whole + 1, cut
        if info["records"] == whole + 1:
            assert cut == ends[whole]
        assert info["crc_skipped"] == 0  # truncation tears, never lies
        assert (jobs, info) == jax_journal.replay(str(jp)), cut
    capfd.readouterr()


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def test_restart_replays_a_dispatched_job_through_resume(tmp_path, monkeypatch, capfd):
    wal = str(tmp_path / "serve.wal")
    spec = _spec(tmp_path / "served", "golden")
    sched = torch_sched.Scheduler(journal=wal, paused=True, start=False, device="cpu")
    job = sched.submit(spec)
    # the dead daemon's last acts: the suspect marker, the dispatched
    # record, and the gang's SSCS (committed with its manifest entry)
    with sched._cond:
        (popped,) = sched._pop_gang_locked()
        assert sched._predispatch_locked(popped) is False
        sched._journal_update_locked(popped, "dispatched")
    torch_sched.gang_sscs([spec], device="cpu")
    sched._journal.close()  # no drain marker: the process died

    calls = []
    real = torch_cli.run_sscs
    monkeypatch.setattr(torch_cli, "run_sscs", lambda *a, **k: calls.append(1) or real(*a, **k))
    again = torch_sched.Scheduler(journal=wal, device="cpu")
    replayed = again.get(job.id)
    assert replayed is not None and replayed.key == job.key
    again.wait(job.id, timeout=300)
    assert replayed.state == "done", replayed.error
    assert calls == []  # --resume skipped the gang's SSCS
    doc = again.metrics()
    assert doc["cumulative"]["jobs_replayed"] == 1 and doc["cumulative"]["suspect_blames"] == 1
    assert again.healthz()["status"] == "serving"
    # a resubmit after the restart dedupes onto the replayed job
    dup, created = again.submit_info(spec)
    assert dup.id == job.id and not created
    again.close()
    monkeypatch.setattr(torch_cli, "run_sscs", real)
    base = str(tmp_path / "served" / "golden")
    assert golden_mismatches(base, GOLDEN["consensus"]) == []
    torch_cli.main(["consensus", "-i", SAMPLE, "-o", str(tmp_path / "one"), "-n", "golden",
                    "--device", "cpu"])
    for rel in ("all_unique/golden.all.unique.sscs.bam", "all_unique/golden.all.unique.dcs.bam",
                "sscs/golden.sscs.sorted.bam", "singleton/golden.remaining.singleton.sorted.bam"):
        assert _records(os.path.join(base, rel)) == \
            _records(str(tmp_path / "one" / "golden" / rel)), rel
    jobs, info = torch_journal.replay(wal)
    assert jobs[job.id]["state"] == "done" and jobs[job.id]["outputs"] == {"base": base}
    assert "re-enqueued" in capfd.readouterr().err


@pytest.mark.parametrize("kind", ["accepted", "dispatched"])
def test_replay_requeues_unfinished_and_keeps_finished(tmp_path, kind, capfd):
    wal = str(tmp_path / "w.wal")
    j = torch_journal.Journal(wal)
    j.append_job(7, "accepted", key="k7", spec=_spec(tmp_path, "x"))
    if kind == "dispatched":
        j.append_job(7, "dispatched")
    j.append_job(8, "accepted", key="k8", spec=_spec(tmp_path, "y"))
    j.append_job(8, "done", outputs={"base": "/b"}, wall_s=0.5)
    j.close()
    sched = torch_sched.Scheduler(journal=wal, paused=True, start=False, device="cpu")
    assert sched.get(7).state == "queued" and sched.get(8).state == "done"
    assert sched.lookup(key="k8")[1].outputs == {"base": "/b"}
    assert sched.counters.snapshot()["jobs_replayed"] == 1
    assert sched.submit(_spec(tmp_path, "z")).id > 8  # ids continue after the replay
    sched.shutdown()
    capfd.readouterr()
