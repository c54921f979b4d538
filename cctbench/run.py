"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 cctbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json`` at the checkout's root, its
configuration in ``cctbench/configs/<config>.json``, its traffic mix in
``cctbench/traffic/<traffic>.json`` (which names its driver in
``cctbench/drivers/``) and, with ``--trace 1``, each per-layer metric's
reader in ``cctbench/metrics/<metric>.py``.  Needs as many CUDA cards as
the cell asks for, and fails without them.  The last line of standard
output is the result (JSON); the numbers compared, each beside its limit,
are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "cctbench")
# what the benchmark and the program write at run time: fixed directories
# inside the checkout (git-ignored), so that a second run finds them built
WORK_DIR = os.path.join(BENCH_DIR, "_work")
CACHE_DIR = os.path.join(BENCH_DIR, "_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CACHE_DIR, _sub)
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402

# whole top-level module names that no run may hold once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "consensuscruncher_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def find(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    """The per-layer metric's reader, ``cctbench/metrics/<name>.py``; a
    metric split by the end-to-end metric it moves (``<base>.<split>``)
    without a file of its own is read by ``<base>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(BENCH_DIR, "metrics", f"{name.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(f"cctbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool, device: str,
             vote: str = "exact", config: dict | None = None, traffic: dict | None = None) -> dict:
    """One run of cell ``name`` on ``device``: set-up, the window, the
    check; returns the result line as a dict.  ``config`` and ``traffic``
    replace the cell's files (tests run small copies); ``vote`` other
    than ``exact`` puts the reference's control in the program's place."""
    entry = find(bench["workloads"], name, "workload")
    if config is None:
        config = load_json(BENCH_DIR, "configs", f"{entry['config']}.json")
    if traffic is None:
        traffic = load_json(BENCH_DIR, "traffic", f"{entry['traffic']}.json")
    work = os.path.join(WORK_DIR, name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    driver = importlib.import_module(f"cctbench.drivers.{traffic['driver']}")
    cell = driver.Cell(config, traffic, seed, work, device, traced)
    on_card = device != "cpu"
    import torch

    print(f"setup: interpreter and imports {time.perf_counter() - T0:.3f} s",
          file=sys.stderr)
    try:
        cell.setup()
        e2e = cell.window(seconds)
        setup_s = cell.t0 - T0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        # the program's state goes before the reference runs
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        numbers, attempted, failed = cell.check(vote)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    cell.card_kind = kind
    metrics = {}
    if traced:
        for m in bench["per_layer"]:
            if applies(m, name):
                value = reader(m["name"])(cell)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, name):
                value = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": int(entry["chips"]),
           "memory_peak_bytes": int(peak)}
    if traced and cell.summary is not None:
        dev["busy_s"] = cell.summary.busy_s
        dev["window_s"] = cell.summary.window_s
    result = {"correct": failed == 0 and all(v <= lim for _n, v, lim in numbers),
              "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if traced and cell.summary is not None:
        result["breakdown"] = cell.summary.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the reference's control in the program's place: for setting the
    # limits, never in the benchmark's own runs
    p.add_argument("--vote", default="exact", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = find(bench["workloads"], args.workload, "workload")

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", args.vote)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
