"""No module the benchmark runs is JAX or the JAX package, compared by the
whole top-level name (the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

from cctbench import run

BANNED = set(run.FORBIDDEN)


def top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax():
    for d, _dirs, files in os.walk(run.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                assert not set(top_level_imports(os.path.join(d, f))) & BANNED, f


def test_reference_imports_nothing_of_the_program():
    for f in ("reference.py", "simulate.py", "bamio.py", "compare.py", "work.py"):
        names = set(top_level_imports(os.path.join(run.BENCH_DIR, f)))
        assert "consensuscruncher_tpu_torch" not in names, f


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from cctbench import run\n"
            "from cctbench.tests.helpers import run_small\n"
            "r = run_small('ultradeep.mesh_step', 3)\n"
            "assert r['correct'], r\n"
            "print(run.forbidden_modules())\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'consensuscruncher_tpu_torch'}))"
            % run.ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]" and lines[-1] == "['consensuscruncher_tpu_torch']"


def test_forbidden_names_are_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "consensuscruncher_tpu_torch.lookalike", sys)
    tops = {m.split(".")[0] for m in sys.modules}
    assert ("consensuscruncher_tpu" in run.forbidden_modules()) == ("consensuscruncher_tpu" in tops)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()
