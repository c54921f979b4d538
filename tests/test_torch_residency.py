"""Device-resident SSCS planes in the port (``ops.residency``), on the CPU.

- The port's CLI with ``--residency True`` and ``--residency False`` writes
  sha256-identical BAMs, both match the golden digests (committed input)
  and the JAX CLI's records (``--backend xla_cpu``, tags included), and the
  on run really voted from the store (module counters > 0).
- The store against the JAX package's ``ResidentPlanes``: lookups, misses
  by key and by length, pair and against gathers, registration.
- A gather that fails makes the run raise: the port has no fallback.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from consensuscruncher_tpu.cli import main as jax_main
from consensuscruncher_tpu.ops.residency import ResidentPlanes as JaxPlanes
from consensuscruncher_tpu_torch.cli import main as torch_main
from consensuscruncher_tpu_torch.io.columnar import ColumnarReader
from consensuscruncher_tpu_torch.ops import packing, residency
from consensuscruncher_tpu_torch.ops.residency import ResidentPlanes
from consensuscruncher_tpu_torch.utils.digest import golden_mismatches
from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_bam_fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = json.load(open(os.path.join(REPO, "test", "golden.json")))


@pytest.fixture(scope="module")
def sim_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("resident") / "sim.bam")
    simulate_bam_fast(path, SimConfig(n_fragments=400, ref_len=30_000, seed=3))
    return path


def _bam_digests(base):
    out = {}
    for root, _dirs, files in os.walk(base):
        for f in files:
            if f.endswith(".bam"):
                p = os.path.join(root, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, base)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _records(path):
    with ColumnarReader(path) as reader:
        out = [reader.header.text]
        for batch in reader.batches():
            off = batch.rec_off
            out += [bytes(batch.buf[off[i]:off[i + 1]]) for i in range(batch.n)]
    return out


def _run_port(bam, out, name, flag):
    residency.pair_votes = residency.against_votes = 0
    torch_main(["consensus", "-i", bam, "-o", str(out), "-n", name, "--scorrect", "True",
                "--max_mismatch", "0", "--device", "cpu", "--residency", flag])
    return residency.pair_votes, residency.against_votes


@pytest.mark.parametrize("source", ["sample", "simulated"])
def test_residency_on_off_byte_identical_and_match_jax(source, sim_bam, tmp_path):
    bam = os.path.join(REPO, "test", "data", "sample.bam") if source == "sample" else sim_bam
    name = "golden" if source == "sample" else "sim"
    on = _run_port(bam, tmp_path / "on", name, "True")
    off = _run_port(bam, tmp_path / "off", name, "False")
    assert on[0] > 0 and on[1] > 0, on  # DCS pairs and rescues voted from the store
    assert off == (0, 0)
    digests = _bam_digests(str(tmp_path / "on" / name))
    assert len(digests) == 11
    assert digests == _bam_digests(str(tmp_path / "off" / name))
    if source == "sample":
        assert golden_mismatches(str(tmp_path / "on" / name), GOLDEN["consensus"]) == []
    jax_main(["consensus", "-i", bam, "-o", str(tmp_path / "jax"), "-n", name,
              "--scorrect", "True", "--max_mismatch", "0", "--backend", "xla_cpu"])
    for rel in digests:
        assert (_records(str(tmp_path / "on" / name / rel))
                == _records(str(tmp_path / "jax" / name / rel))), rel


def test_failing_gather_makes_the_run_raise(monkeypatch, tmp_path):
    def broken(self, idx, length):
        raise RuntimeError("device gather failed")

    monkeypatch.setattr(ResidentPlanes, "_gather", broken)
    with pytest.raises(RuntimeError, match="device gather failed"):
        _run_port(os.path.join(REPO, "test", "data", "sample.bam"), tmp_path, "x", "True")
    assert not os.path.exists(tmp_path / "x" / "all_unique" / "x.all.unique.dcs.bam")


# ------------------------------------------------------------------ store


def _planes(rng, n, width):
    return np.stack([rng.integers(0, 5, (n, width), dtype=np.uint8),
                     rng.integers(0, 61, (n, width), dtype=np.uint8)])


def _both_stores(chunks):
    """The same appends into the port's store and the JAX package's."""
    import jax.numpy as jnp

    port, ref = packing.resident_planes("cpu"), JaxPlanes()
    for keys, lengths, planes in chunks:
        port.append(keys, lengths, torch.from_numpy(planes), len(keys))
        ref.append(keys, lengths, jnp.asarray(planes), len(keys))
    return port, ref


def test_store_lookups_match_jax():
    rng = np.random.default_rng(0)
    chunks = [([b"a", b"b", b"c"], [16, 16, 12], _planes(rng, 4, 16)),
              ([b"d", b"e"], [24, 20], _planes(rng, 2, 24))]
    port, ref = _both_stores(chunks)
    assert port.families == ref.families == 5
    for length in (12, 16, 20, 24):
        keys = [b"b", b"nope", b"c", b"a", b"e", b"d"]
        assert port.rows_for(keys, length).tolist() == ref.rows_for(keys, length).tolist()
    assert packing.resident_planes("cpu").rows_for([b"a"], 10) is None


def test_store_gathers_and_registration_match_jax():
    rng = np.random.default_rng(1)
    keys = [f"q{i}".encode() for i in range(10)]
    chunks = [(keys[:6], [20] * 6, _planes(rng, 6, 24)),
              (keys[6:], [20] * 4, _planes(rng, 4, 32))]  # the store widens
    port, ref = _both_stores(chunks)
    idx1 = port.rows_for([b"q0", b"q2", b"q7"], 20)
    idx2 = port.rows_for([b"q1", b"q8", b"q9"], 20)
    for got, want in zip(port.duplex_pairs(idx1, idx2, 20),
                         ref.duplex_pairs(idx1.astype(np.int32), idx2.astype(np.int32), 20)):
        np.testing.assert_array_equal(got, np.asarray(want))
    s1 = rng.integers(0, 4, (3, 20), dtype=np.uint8)
    q1 = rng.integers(10, 30, (3, 20), dtype=np.uint8)
    new = [b"r0", b"r1", b"r2"]
    got = port.duplex_against(s1, q1, idx2, 20, register_keys=new)
    want = ref.duplex_against(s1, q1, idx2.astype(np.int32), 20, register_qnames=new)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    ridx = port.rows_for(new, 20)  # the rescue output is resident now
    assert ridx.tolist() == ref.rows_for(new, 20).tolist() and (ridx >= 0).all()
    for g, w in zip(port.duplex_pairs(ridx, idx1, 20),
                    ref.duplex_pairs(ridx.astype(np.int32), idx1.astype(np.int32), 20)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_record_keys_match_the_byte_form():
    """``record_keys`` builds qname + NUL + LE flag per record without a
    Python loop; the store finds rows appended under those keys when asked
    with the plain bytes keys, and the other way round."""
    rng = np.random.default_rng(2)
    names = [bytes(rng.integers(33, 127, rng.integers(1, 40)).astype(np.uint8))
             for _ in range(200)]
    flags = rng.choice([0, 1, 83, 99, 147, 163, 256, 1107], 200)
    data = np.frombuffer(b"".join(names), np.uint8)
    lens = np.array([len(n) for n in names])
    starts = np.cumsum(lens) - lens
    keys = residency.record_keys(data, starts, lens, flags)
    plain = [n + b"\x00" + int(f).to_bytes(2, "little") for n, f in zip(names, flags)]
    assert keys.tolist() == [k.rstrip(b"\x00") for k in plain]
    assert len(set(keys.tolist())) == len(set(plain))
    store = packing.resident_planes("cpu")
    store.append(keys, [24] * 200, torch.from_numpy(_planes(rng, 200, 24)), 200)
    want = store.rows_for(keys, 24)
    assert store.rows_for(plain, 24).tolist() == want.tolist()
    assert sorted(want.tolist()) == sorted(
        max(i for i, k in enumerate(plain) if k == p) for p in set(plain))
    assert (store.rows_for(plain, 23) == -1).all()


def test_store_refuses_planes_from_another_device():
    store = ResidentPlanes("meta")
    with pytest.raises(ValueError, match="store on meta"):
        store.append([b"a"], [4], torch.zeros((2, 1, 4), dtype=torch.uint8), 1)
