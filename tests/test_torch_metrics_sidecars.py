"""The per-stage ``*.metrics.json`` sidecars of the port against the JAX
package's (CPU), and the counters and trace behind them.

- ``<p>.metrics.json`` (SSCS), ``<p>.singleton.metrics.json`` and
  ``<p>.dcs.metrics.json`` on ``sample.bam``: the JAX package's key sets
  (top level, ``phases_s`` and ``cumulative``), its non-time counters
  (families in and out, batches, resident and uploaded pair votes, BAM
  bytes written), ``backend`` the silicon and ``jax_backend`` null; no
  byte crosses to a card under ``--device cpu``; on tagged input the
  rescue walk's sidecar has no ``cumulative`` block, as the JAX one.
- ``note_transfer`` counts only copies to or from a CUDA device;
  ``recompiles`` counts the libraries ``cuda_lib.build`` compiled.
- ``CUMULATIVE_KEYS``, ``Counters``, ``metrics_doc`` and
  ``TimeTracker.as_phases`` equal the JAX ones; the manifest records no sidecar.
- ``--profile DIR`` writes a Chrome trace whose run span covers the run;
  ``trace_summary`` takes the union of the device intervals.
"""

import json
import os
import stat
import sys
import time

import pytest
import torch

from consensuscruncher_tpu.cli import main as jax_main
from consensuscruncher_tpu.obs import registry as jax_registry
from consensuscruncher_tpu.utils import profiling as jax_profiling
from consensuscruncher_tpu.utils.stats import TimeTracker as JaxTimeTracker
from consensuscruncher_tpu_torch.cli import main as torch_main
from consensuscruncher_tpu_torch.io.bam import BamReader, BamWriter
from consensuscruncher_tpu_torch.obs import metrics as obs_metrics
from consensuscruncher_tpu_torch.obs import registry
from consensuscruncher_tpu_torch.ops import cuda_lib
from consensuscruncher_tpu_torch.utils import profiling
from consensuscruncher_tpu_torch.utils.stats import TimeTracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")
SIDECARS = ("sscs/s.metrics.json", "singleton/s.singleton.metrics.json",
            "dcs/s.dcs.metrics.json")
# counters that depend on the data alone (no wall time, no device)
COUNTED = ("families_in", "families_out", "batches_dispatched", "resident_pair_votes",
           "staged_pair_votes", "bytes_bam_written")


def _load(path):
    with open(path) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sidecars")
    argv = ["consensus", "-i", SAMPLE, "-n", "s", "--scorrect", "True"]
    torch_main(argv + ["-o", str(root / "torch"), "--device", "cpu"])
    jax_main(argv + ["-o", str(root / "jax"), "--backend", "xla_cpu"])
    return root


@pytest.mark.parametrize("rel", SIDECARS)
def test_sidecars_match_jax(runs, rel):
    mine, theirs = _load(runs / "torch" / "s" / rel), _load(runs / "jax" / "s" / rel)
    assert sorted(mine) == sorted(theirs)
    assert list(mine["phases_s"]) == list(theirs["phases_s"])
    assert sorted(mine["cumulative"]) == sorted(theirs["cumulative"])
    assert (mine["backend"], mine["jax_backend"]) == ("cpu", None)
    assert mine["stage"] == theirs["stage"]
    for key in COUNTED:
        assert mine["cumulative"][key] == theirs["cumulative"][key], key
    assert mine["cumulative"]["bytes_bam_written"] > 0
    # nothing crossed to a card, and no kernel library was built
    assert mine["cumulative"]["bytes_h2d"] == mine["cumulative"]["bytes_d2h"] == 0
    assert mine["cumulative"]["recompiles"] == 0
    for key in ("n_families", "n_reads", "singletons", "pairs", "sscs_total"):
        if key in theirs:
            assert mine[key] == theirs[key], key


def test_sscs_counts_families(runs):
    doc = _load(runs / "torch" / "s" / "sscs" / "s.metrics.json")
    stats = _load(runs / "torch" / "s" / "sscs" / "s.sscs_stats.json")
    assert doc["cumulative"]["families_out"] == stats["sscs_written"] > 0
    assert doc["n_families"] == stats["families"]
    assert doc["families_per_sec"] > 0
    with open(runs / "torch" / "s" / "manifest.json") as fh:
        assert "metrics.json" not in fh.read()


def test_walk_sidecar_has_no_cumulative(tmp_path):
    """On tagged input (``NM:i:0`` on every read, as an aligner writes) the
    rescue takes the window walk, whose sidecar, as the JAX package's,
    carries no ``cumulative`` block; DCS keeps its block on its walk."""
    tagged = str(tmp_path / "tagged.bam")
    with BamReader(SAMPLE) as reader, BamWriter(tagged, reader.header) as writer:
        for read in reader:
            read.tags = {"NM": ("i", 0), **read.tags}
            writer.write(read)
    argv = ["consensus", "-i", tagged, "-n", "s", "--scorrect", "True"]
    torch_main(argv + ["-o", str(tmp_path / "torch"), "--device", "cpu"])
    jax_main(argv + ["-o", str(tmp_path / "jax"), "--backend", "xla_cpu"])
    for rel in SIDECARS:
        mine, theirs = _load(tmp_path / "torch" / "s" / rel), _load(tmp_path / "jax" / "s" / rel)
        assert sorted(mine) == sorted(theirs), rel
    assert "cumulative" not in _load(tmp_path / "torch" / "s" / SIDECARS[1])


def test_transfers_count_only_the_card():
    before = obs_metrics.transfer_bytes()
    obs_metrics.note_transfer("h2d", 100, torch.device("cpu"))
    obs_metrics.note_transfer("d2h", 100, "cpu")
    assert obs_metrics.transfer_bytes() == before
    obs_metrics.note_transfer("h2d", 100, torch.device("cuda", 0))
    obs_metrics.note_transfer("d2h", 7, "cuda")
    after = obs_metrics.transfer_bytes()
    assert (after["h2d"] - before["h2d"], after["d2h"] - before["d2h"]) == (100, 7)
    with pytest.raises(KeyError):
        obs_metrics.note_transfer("p2p", 1)


def test_recompiles_count_kernel_builds(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` (it writes its ``-o`` file) builds a library
    once: one build counted, none for the cached second call."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'so')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path / "build"))
    before = obs_metrics.recompiles()
    path = cuda_lib.build("consensus_vote")
    assert os.path.exists(path) and obs_metrics.recompiles() == before + 1
    assert cuda_lib.build("consensus_vote") == path
    assert obs_metrics.recompiles() == before + 1


def test_counters_and_docs_match_jax():
    assert registry.CUMULATIVE_KEYS == jax_registry.CUMULATIVE_KEYS
    mine, theirs = profiling.Counters(), jax_profiling.Counters()
    for c in (mine, theirs):
        c.add("families_in", 5)
        c.high_water("queue_depth_hwm", 3)
        c.high_water("queue_depth_hwm", 2)
        with pytest.raises(KeyError):
            c.add("not_a_counter")
    assert mine.snapshot() == theirs.snapshot()
    args = ("SSCS", {"consensus": 1.5, "sort": 0.5}, {"backend": "x", "n_reads": 100},
            {"families_in": 5})
    assert profiling.metrics_doc(*args) == jax_profiling.metrics_doc(*args)
    a, b = TimeTracker(), JaxTimeTracker()
    for t in (a, b):
        t._t0 = 0.0
        t._marks = [("one", 1.25), ("two", 3.5)]
    assert a.as_phases() == b.as_phases() == {"one": 1.25, "two": 2.25}


def test_profile_writes_a_trace_over_the_run(tmp_path):
    t = time.perf_counter()
    res = torch_main(["consensus", "-i", SAMPLE, "-o", str(tmp_path), "--device", "cpu",
                      "--profile", str(tmp_path / "prof")])
    wall_us = (time.perf_counter() - t) * 1e6
    steps_us = sum(res["walls"].values()) * 1e6  # the run's steps, inside the span
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace == f"consensus.{os.getpid()}.trace.json"
    events = _load(tmp_path / "prof" / trace)["traceEvents"]
    (run,) = [e for e in events if e.get("name") == profiling.RUN_SPAN]
    summary = profiling.trace_summary(str(tmp_path / "prof" / trace))
    assert steps_us <= run["dur"] <= summary["window_us"] <= wall_us
    assert summary["device_events"] == 0 and summary["device_busy_share"] == 0.0
    assert (tmp_path / "sample" / "qc.json").exists()


def test_trace_summary_takes_the_union_of_device_time(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "cct.run", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "void vote_tiles_kernel<1, false, true>()",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "void vote_tiles_kernel<1, false, true>()",
         "ts": 120, "dur": 50},  # overlaps the first: counted once
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 400, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 500, "dur": 10},
        {"ph": "i", "name": "marker", "ts": 2000},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiling.trace_summary(str(path))
    assert s["window_us"] == 1000 and s["device_busy_us"] == 100
    assert s["device_busy_share"] == pytest.approx(0.1)
    assert s["kernels"] == {"void vote_tiles_kernel<1, false, true>()": {"count": 2, "us": 100.0}}
    assert s["device_events"] == 3
