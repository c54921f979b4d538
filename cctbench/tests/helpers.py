"""Small copies of the cells for the tests: the benchmark's own files with
the scale cut, every width kept."""

from cctbench import run

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")


def config(name: str, fragments: int) -> dict:
    cfg = run.load_json(run.BENCH_DIR, "configs", f"{name}.json")
    cfg["simulation"]["n_fragments"] = fragments
    return cfg


def mesh_traffic(pairs: int = 24, pool_steps: int = 64) -> dict:
    tr = run.load_json(run.BENCH_DIR, "traffic", "mesh_step.json")
    tr.update(pairs=pairs, pool_steps=pool_steps, sample=3)
    return tr


def run_small(cell: str, seed: int, device: str = "cpu", vote: str = "exact",
              seconds: float = 0.2, config_name: str | None = None) -> dict:
    """One run of ``cell`` at a size a test run holds; ``config_name``
    runs the cell's traffic on another configuration."""
    entry = run.find(BENCH["workloads"], cell, "workload")
    if entry["traffic"] == "mesh_step":
        return run.run_cell(BENCH, cell, seed, seconds, False, device, vote,
                            traffic=mesh_traffic())
    name = config_name or entry["config"]
    fragments = 600 if name == "cfdna-panel" else 40
    return run.run_cell(BENCH, cell, seed, seconds, False, device, vote,
                        config=config(name, fragments))
