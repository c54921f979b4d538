"""Probe of the vote kernels on the card: what their time is made of.

    python -m consensuscruncher_tpu_torch.utils.vote_probe

Prints JSON lines (one card, CUDA required):

- ``scaling``: the kernel's device time (profiler) against its work, B1 on
  pack6 member streams shaped like the main path's (L 128 rows, vote length
  104, family sizes ``max(2, geometric(0.6))``) and B2 on pack4 streams
  shaped like the stage loop's, from a few hundred families to eight times
  the main path's; the time of the smallest call is the launch's fixed
  cost, the slope its throughput, each beside the INT32 bound of the same
  work;
- ``variant``: the same kernel rebuilt with other occupancy constants
  (resident blocks per SM, ring stages) at the main path's and the stage
  loop's shapes, with ptxas registers and spills;
- ``host``: the wall of one ``stream_vote`` call and of one
  ``segment_duplex_step`` on the host, without and with a synchronise;
- ``main_path``: the SSCS vote calls of one ``consensus --scorrect True``
  run on a simulated 200,000-fragment sample (as ``chip_smoke.py`` phase 5
  makes it), each bracketed by synchronises: their walls and the host
  functions they spend them in, at Python's default thread switch
  interval and at a tenth of it (the CLI's writer and prefetch threads
  contend for the interpreter lock with the calls).

Inputs are made from a seed; nothing is read from disk.  Rebuilt variants
go to the ignored ``_build/probe/``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

FOLD_OPS, FINALIZE_OPS, COMBINE_OPS = 6, 30, 6  # as chip_smoke.py counts them
BINNED = np.array([2, 12, 23, 37], np.uint8)
VARIANTS = {"blocks3_stages4": (3, 4), "blocks2_stages4": (2, 4), "blocks3_stages3": (3, 3)}


def _emit(probe, **fields):
    print(json.dumps({"probe": probe, **fields}), flush=True)


def _device_ms(fn, reps=200) -> float:
    """Device milliseconds per launch of the vote kernel (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if "vote_tiles_kernel" in e.key]
    total_us = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
                   for e in rows)
    if not rows or total_us <= 0:
        raise RuntimeError("the profiler saw no device time of the vote kernel")
    return total_us / sum(e.count for e in rows) / 1e3


def _int32_ops_per_s() -> float:
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True,
                           check=True, timeout=60).stdout.split()[0]
    return 64 * torch.cuda.get_device_properties(0).multi_processor_count * float(clock) * 1e6


def sscs_case(rng, nf, dev):
    """A pack6 stream of ``nf`` main-path-like families on ``dev``."""
    from consensuscruncher_tpu_torch.ops.packing import encode_wire

    sizes = np.maximum(2, rng.geometric(0.6, nf)).astype(np.int64)
    m = int(sizes.sum())
    a, book = encode_wire("pack6", rng.integers(0, 4, (m, 128), dtype=np.uint8),
                          rng.choice(np.arange(24, 56, 2, dtype=np.uint8), (m, 128)))
    return torch.from_numpy(a).to(dev), torch.from_numpy(book), torch.from_numpy(sizes), m


def duplex_case(rng, pairs, dev):
    """A pack4 stream of ``pairs`` stage-loop-like pairs on ``dev``."""
    from consensuscruncher_tpu_torch.ops.packing import encode_wire

    sa = np.minimum(1 + rng.geometric(0.25, pairs), 16)
    sb = np.minimum(1 + rng.geometric(0.25, pairs), 16)
    sb[::16] = 0
    sizes = np.concatenate([sa, sb]).astype(np.int64)
    m = int(sizes.sum())
    a, book = encode_wire("pack4", rng.integers(0, 4, (m, 128), dtype=np.uint8),
                          BINNED[rng.integers(0, 4, (m, 128))])
    return torch.from_numpy(a).to(dev), torch.from_numpy(book), torch.from_numpy(sizes), m


def scaling(dev, ops_per_s):
    from consensuscruncher_tpu_torch.ops import consensus_vote as cv

    rng = np.random.default_rng(1)
    for nf in (264, 2_000, 5_000, 10_000, 21_388, 42_776, 85_552, 171_104):
        a, book, sizes, m = sscs_case(rng, nf, dev)
        job = cv.prepare_wire("pack6", a, book, sizes, length=104)
        ops = FOLD_OPS * m * 104 + FINALIZE_OPS * nf * 104
        _emit("scaling", form="sscs", families=nf, members=m, tiles=job.n_tiles,
              ms=_device_ms(job), int32_bound_ms=ops / ops_per_s * 1e3)
    for pairs in (256, 2_048, 8_192, 32_768, 131_072):
        a, book, sizes, m = duplex_case(rng, pairs, dev)
        job = cv.prepare_duplex_wire("pack4", a, book, sizes, length=128, packed_out=True)
        ops = FOLD_OPS * m * 128 + (2 * FINALIZE_OPS + COMBINE_OPS) * pairs * 128
        _emit("scaling", form="duplex", pairs=pairs, members=m, tiles=job.n_tiles,
              ms=_device_ms(job), int32_bound_ms=ops / ops_per_s * 1e3)


def _build_variant(name, blocks, stages):
    from consensuscruncher_tpu_torch.ops import cuda_lib

    src = open(cuda_lib.source_path("consensus_vote")).read()
    for key, val in (("kMinBlocks", blocks), ("kStages", stages)):
        src, n = re.subn(rf"constexpr int {key} = \d+;", f"constexpr int {key} = {val};", src)
        if n != 1:
            raise RuntimeError(f"{key} not found in consensus_vote.cu")
    out = os.path.join(cuda_lib.BUILD_DIR, "probe", name)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "consensus_vote.cu")
    with open(path, "w") as fh:
        fh.write(src)
    so = os.path.join(out, "consensus_vote.so")
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", cuda_lib.CSRC_DIR,
                           "-Xptxas", "-v", "-o", so, path], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", proc.stderr)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", proc.stderr))
    return so, {"registers": [min(regs), max(regs)], "spill_store_bytes": spills}


def variants(dev):
    from concurrent.futures import ThreadPoolExecutor

    from consensuscruncher_tpu_torch.ops import consensus_vote as cv
    from consensuscruncher_tpu_torch.ops import cuda_lib

    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = dict(zip(VARIANTS, ex.map(lambda kv: _build_variant(kv[0], *kv[1]),
                                          VARIANTS.items())))
    rng = np.random.default_rng(2)
    main = sscs_case(rng, 21_388, dev)
    stage = duplex_case(rng, 8_192, dev)
    for name, (so, ptxas) in built.items():
        lib = ctypes.CDLL(so)
        cv._lib = None
        cv._grids.clear()
        load, cuda_lib.load = cuda_lib.load, lambda _name: lib
        try:
            cv._library()
        finally:
            cuda_lib.load = load
        job_main = cv.prepare_wire("pack6", *main[:3], length=104)
        job_stage = cv.prepare_duplex_wire("pack4", *stage[:3], length=128, packed_out=True)
        _emit("variant", name=name, blocks_per_sm=VARIANTS[name][0], stages=VARIANTS[name][1],
              grid=dict((str(k), v) for k, v in cv._grids.items()), **ptxas,
              sscs_ms=_device_ms(job_main), duplex_ms=_device_ms(job_stage))
    cv._lib = None
    cv._grids.clear()


def host(dev):
    from consensuscruncher_tpu_torch.ops import consensus_segment

    rng = np.random.default_rng(3)
    a, book, sizes, _m = sscs_case(rng, 21_388, dev)
    batches = [duplex_case(rng, 8_192, dev) for _ in range(8)]
    step = consensus_segment.segment_duplex_step(8_192, 128, packed_out=True)
    calls = {"stream_vote": lambda: consensus_segment.stream_vote("pack6", a, book, sizes,
                                                                  out_len=104),
             "segment_duplex_step": lambda: [step(p, s, b) for p, b, s, _m in batches]}
    for name, fn in calls.items():
        per = 8 if name == "segment_duplex_step" else 1
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t) / 20 / per * 1e3
        t = time.perf_counter()
        for _ in range(20):
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        _emit("host", call=name, ms_per_call=loop_ms,
              synced_ms_per_call=(time.perf_counter() - t) / 20 / per * 1e3)


def main_path(dev):
    import cProfile
    import pstats
    import shutil
    import sys

    from consensuscruncher_tpu_torch.cli import main as cli_main
    from consensuscruncher_tpu_torch.ops import consensus_segment, cuda_lib
    from consensuscruncher_tpu_torch.utils.simulate import SimConfig, simulate_bam_fast

    work = os.path.join(cuda_lib.BUILD_DIR, "probe", "main_path")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sim = os.path.join(work, "sim.bam")
    simulate_bam_fast(sim, SimConfig(n_fragments=200_000, ref_len=8_000_000, seed=42))
    vote = consensus_segment.stream_vote
    default = sys.getswitchinterval()
    try:
        for interval in (default, default / 10):
            prof, walls = cProfile.Profile(), []

            def timed(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                prof.enable()
                out = vote(*args, **kwargs)
                torch.cuda.synchronize()
                prof.disable()
                walls.append(time.perf_counter() - t)
                return out

            consensus_segment.stream_vote = timed
            sys.setswitchinterval(interval)
            t = time.perf_counter()
            cli_main(["consensus", "-i", sim, "-o", os.path.join(work, "out"), "-n", "sim",
                      "--scorrect", "True", "--device", dev.type])
            wall = time.perf_counter() - t
            sys.setswitchinterval(default)
            stats = pstats.Stats(prof).stats
            top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:8]
            _emit("main_path", switch_interval_s=interval, wall_s=wall, calls=len(walls),
                  vote_s=sum(walls), call_ms=[w * 1e3 for w in walls],
                  top_tottime_s={f"{k[0].rsplit('/', 1)[-1]}:{k[1]}:{k[2]}": v[2]
                                 for k, v in top})
            shutil.rmtree(os.path.join(work, "out"))
    finally:
        consensus_segment.stream_vote = vote
        sys.setswitchinterval(default)
        shutil.rmtree(work, ignore_errors=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("vote_probe: CUDA is not available")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    _emit("card", card=card, kind=torch.cuda.get_device_name(0))
    scaling(dev, _int32_ops_per_s())
    host(dev)
    variants(dev)
    main_path(dev)


if __name__ == "__main__":
    main()
