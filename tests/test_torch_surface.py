"""The port's public surface against the JAX package's (CPU).

Both packages' sources are walked as ASTs, module by module (the JAX
package's four device modules under the port's names, ``MODULES``): every
public top-level function and class, every public method and class
attribute, every ``__all__`` entry and every upper-case module constant
(assigned or imported) of the JAX package must have a counterpart of the
same name in the port's module, a method on the port's class of that name
(or a base of it), and every flag of the JAX CLI, ``--version`` included,
a flag of the port's CLI.  A name may be missing only when ``ALLOWED``
lists it, and each entry's reason is a passage of ``ROADMAP.md``; an
allowed name that the port has gained fails too, so the list stays true.

The JAX package's tools under ``tools/`` that the port carries (``TOOLS``:
the four measuring tools, the soak, the trace checker and the chaos
conductor) are walked the same way against their ports under ``utils/``:
every public name of the tool, class members included, has a
counterpart, and every flag of an argparse tool is a flag of the port's
with the same default; the port's only extra flags, and its perf gate's
missing default baseline, are the departures ``TOOL_ALLOWED`` lists, each
with its ROADMAP passage.

Some names are also held to the JAX ones by value:
``policies.majority_family_vote`` exactly, with and without the QC rider,
at F 1-16 and L 1-130, with PAD in member and padding slots;
``FamilyBlock.cigar_words_of`` and ``ColumnarBatch.record_blob`` over
``test/data/sample.bam``; ``--version`` on stdout; the constants.
"""

import argparse
import ast
import contextlib
import functools
import importlib
import importlib.util
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import consensuscruncher_tpu
import consensuscruncher_tpu_torch
from consensuscruncher_tpu import cli as jcli
from consensuscruncher_tpu import policies as jpolicies
from consensuscruncher_tpu.io import columnar as jcolumnar
from consensuscruncher_tpu.stages import grouping as jgrouping
from consensuscruncher_tpu_torch import cli as tcli
from consensuscruncher_tpu_torch import policies as tpolicies
from consensuscruncher_tpu_torch.io import columnar as tcolumnar
from consensuscruncher_tpu_torch.stages import grouping as tgrouping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "consensuscruncher_tpu")
PORT_ROOT = os.path.join(REPO, "consensuscruncher_tpu_torch")
SAMPLE_BAM = os.path.join(REPO, "test", "data", "sample.bam")

# the JAX package's device modules -> the port's modules that serve them
MODULES = {"ops/consensus_pallas.py": "ops/consensus_vote.py",
           "ops/consensus_tpu.py": "ops/consensus_dense.py",
           "ops/duplex_tpu.py": "ops/duplex.py",
           "ops/singleton_tpu.py": "ops/singleton.py"}

# the ROADMAP passages that give each departure's reason
A11 = "A11, the bucket autotuner"
HOOKS = "The module-global vote-policy hooks"
PINS = "The JAX-only platform pins"
MESH_P = "`parallel/mesh.P`"
PALLAS = "The Pallas wrappers"

_AUTOTUNER = ("choose_backend", "install", "ladder_shapes", "learn_from_live", "load",
              "measure", "policy", "save", "snapshot_recompiles", "tune",
              "unexpected_recompiles", "warmup_shapes")
ALLOWED = {
    **{("serve/warmup.py", name): A11 for name in (
        "BucketAutotuner", "DEFAULT_TABLE_NAME", "load_autotune_config", "start_learn_loop",
        "warm_duplex_ladder", *(f"BucketAutotuner.{m}" for m in _AUTOTUNER))},
    ("ops/consensus_tpu.py", "get_kernel_policy"): A11,
    ("ops/consensus_tpu.py", "set_kernel_policy"): A11,
    ("parallel/batching.py", "record_bucket_shape"): A11,
    ("parallel/batching.py", "bucket_shape_counts"): A11,
    ("policies/base.py", "get_vote_policy"): HOOKS,
    ("policies/base.py", "set_vote_policy"): HOOKS,
    ("policies/base.py", "installed_vote_policy"): HOOKS,
    ("policies/__init__.py", "get_vote_policy"): HOOKS,
    ("policies/__init__.py", "set_vote_policy"): HOOKS,
    ("utils/backend_probe.py", "force_cpu_platform"): PINS,
    ("utils/backend_probe.py", "jax_platform_for"): PINS,
    ("parallel/mesh.py", "P"): MESH_P,
    **{("ops/consensus_pallas.py", name): PALLAS for name in (
        "consensus_batch_pallas", "consensus_batch_pallas_host", "duplex_batch_pallas",
        "duplex_batch_pallas_host")},
}

# the JAX package's tools -> the port's modules
TOOLS = {"qc_gate": "utils/qc_gate.py", "accuracy_harness": "utils/accuracy_harness.py",
         "perf_gate": "utils/perf_gate.py", "loadgen": "utils/loadgen.py",
         "serve_soak": "utils/serve_soak.py", "trace_check": "utils/trace_check.py",
         "chaos_conductor": "utils/chaos_conductor.py"}
# the tools that parse their flags with argparse (trace_check reads its
# argv by hand; tests/test_torch_trace_check.py holds its usage and codes)
PARSED_TOOLS = sorted(set(TOOLS) - {"trace_check"})
TOOL_DEVICE = "The tools' `--device`"
NO_DEFAULT_BASELINE = "`perf_gate` takes no default baseline"
TOOL_ALLOWED = {("accuracy_harness", "--device"): TOOL_DEVICE,
                ("loadgen", "--device"): TOOL_DEVICE,
                ("serve_soak", "--device"): TOOL_DEVICE,
                ("chaos_conductor", "--device"): TOOL_DEVICE,
                ("perf_gate", "--baseline"): NO_DEFAULT_BASELINE}

_UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")


def _public(name: str) -> bool:
    return not any(part.startswith("_") for part in name.split("."))


def _module_names(tree: ast.Module) -> tuple[set, set]:
    """``(public, defined)``: the names a caller imports (public functions
    and classes, their public methods and attributes, ``__all__``,
    upper-case constants) and every name the module binds at top level."""
    public, defined = set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
            public.add(node.name)
            if isinstance(node, ast.ClassDef):
                public |= {f"{node.name}.{m}" for m in _class_members(node)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                if isinstance(target, ast.Name):
                    defined.add(target.id)
                    if _UPPER.match(target.id):
                        public.add(target.id)
                    if target.id == "__all__":
                        public |= {elt.value for elt in node.value.elts}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                defined.add(name)
                if isinstance(node, ast.ImportFrom) and _UPPER.match(name):
                    public.add(name)
    return {n for n in public if _public(n)}, defined


def _class_members(node: ast.ClassDef) -> set:
    members = set()
    for sub in node.body:
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            members.add(sub.name)
        elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
            members.add(sub.target.id)
        elif isinstance(sub, ast.Assign):
            members |= {t.id for t in sub.targets if isinstance(t, ast.Name)}
    return members


def _walk(root: str) -> dict:
    trees = {}
    for base, _dirs, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(base, name)
                with open(path) as fh:
                    trees[os.path.relpath(path, root)] = ast.parse(fh.read())
    return trees


def _port_classes(trees: dict) -> dict:
    """Class name -> ``(members, base names)`` over the whole port."""
    classes: dict[str, tuple[set, set]] = {}
    for tree in trees.values():
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                members, bases = classes.setdefault(node.name, (set(), set()))
                members |= _class_members(node)
                bases |= {b.id if isinstance(b, ast.Name) else getattr(b, "attr", "")
                          for b in node.bases}
    return classes


def _has_member(classes: dict, cls: str, member: str, seen=()) -> bool:
    if cls not in classes or cls in seen:
        return False
    members, bases = classes[cls]
    return member in members or any(_has_member(classes, b, member, (*seen, cls))
                                    for b in bases)


def _missing() -> set:
    jax_trees, port_trees = _walk(JAX_ROOT), _walk(PORT_ROOT)
    classes = _port_classes(port_trees)
    missing = set()
    for rel, tree in jax_trees.items():
        names, _ = _module_names(tree)
        port_tree = port_trees.get(MODULES.get(rel, rel))
        defined = _module_names(port_tree)[1] if port_tree is not None else set()
        for name in names:
            if "." in name:
                found = _has_member(classes, *name.split(".", 1))
            else:
                found = name in defined
            if not found:
                missing.add((rel, name))
    return missing


def _flags(parser: argparse.ArgumentParser, prefix: str = "") -> set:
    out = set()
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out |= _flags(sub, f"{prefix} {name}".strip())
        else:
            out |= {(prefix, opt) for opt in action.option_strings}
    return out


def test_every_jax_name_has_a_counterpart():
    missing = _missing()
    unexplained = sorted(missing - set(ALLOWED))
    assert not unexplained, f"JAX names without a counterpart in the port: {unexplained}"
    stale = sorted(set(ALLOWED) - missing)
    assert not stale, f"allowed departures the port now has: {stale}"


def test_every_allowed_departure_has_its_roadmap_reason():
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        roadmap = fh.read()
    for reason in set(ALLOWED.values()) | set(TOOL_ALLOWED.values()):
        assert reason in roadmap, reason


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _tool_parser(module) -> argparse.ArgumentParser:
    """The parser a tool's ``main`` builds (each parses its argv first)."""
    def capture(parser, args=None, namespace=None):
        raise _Parsed(parser)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as parsed:
            module.main([])
    return parsed.value.parser


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"surface_reference_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tool_module(name: str):
    return importlib.import_module("consensuscruncher_tpu_torch." +
                                   TOOLS[name][:-3].replace("/", "."))


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_every_tool_name_has_a_counterpart(name):
    with open(os.path.join(REPO, "tools", f"{name}.py")) as fh:
        names, _ = _module_names(ast.parse(fh.read()))
    with open(os.path.join(PORT_ROOT, TOOLS[name])) as fh:
        port_tree = ast.parse(fh.read())
    _, defined = _module_names(port_tree)
    classes = _port_classes({TOOLS[name]: port_tree})
    missing = [n for n in names if not (_has_member(classes, *n.split(".", 1)) if "." in n
                                        else n in defined)]
    assert names and sorted(missing) == []


@pytest.mark.parametrize("name", PARSED_TOOLS)
def test_every_tool_flag_has_a_counterpart_with_its_default(name):
    jax_parser, port_parser = _tool_parser(_jax_tool(name)), _tool_parser(_tool_module(name))
    jax_flags, port_flags = _flags(jax_parser), _flags(port_parser)
    assert sorted(jax_flags - port_flags) == []
    extra = {flag for _, flag in port_flags - jax_flags}
    assert extra == {flag for (tool, flag) in TOOL_ALLOWED
                     if tool == name and flag not in {f for _, f in jax_flags}}
    defaults = {a.dest: a.default for a in port_parser._actions}
    for action in jax_parser._actions:
        assert defaults[action.dest] == action.default, action.dest


def test_perf_gate_departure_is_its_missing_default_baseline(tmp_path):
    fresh = tmp_path / "fresh.json"
    fresh.write_text(json.dumps({"levels": []}))
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        assert _tool_module("perf_gate").main(["--fresh", str(fresh)]) == 2
        assert _jax_tool("perf_gate").main(["--fresh", str(fresh)]) == 0
    assert "pass --baseline" in err.getvalue()


def test_every_jax_cli_flag_has_a_counterpart():
    jax_flags, port_flags = _flags(jcli.build_parser()), _flags(tcli.build_parser())
    assert ("", "--version") in jax_flags
    assert sorted(jax_flags - port_flags) == []


def _version(build_parser) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as done:
        build_parser().parse_args(["--version"])
    assert done.value.code == 0
    return out.getvalue()


def test_version_prints_like_jax():
    assert _version(tcli.build_parser) == _version(jcli.build_parser) == \
        consensuscruncher_tpu_torch.__version__ + "\n"
    assert consensuscruncher_tpu_torch.__version__ == consensuscruncher_tpu.__version__


@pytest.mark.parametrize("module,name", [
    ("", "SANGER_OFFSET"),
    ("ops.consensus_tpu:ops.consensus_dense", "DEFAULT_CUTOFF"),
    ("ops.consensus_tpu:ops.consensus_dense", "DEFAULT_QUAL_CAP"),
    ("ops.consensus_tpu:ops.consensus_dense", "DEFAULT_QUAL_THRESHOLD"),
    ("ops.consensus_segment", "NUM_BASES"),
    ("policies.majority", "NUM_BASES"),
    ("policies.majority", "PAD"),
    ("io.columnar", "CODE_N"),
])
def test_constants_equal_jax(module, name):
    import importlib

    jmod, _, tmod = module.partition(":")
    tmod = tmod or jmod
    jax_mod = importlib.import_module("consensuscruncher_tpu" + (f".{jmod}" if jmod else ""))
    port_mod = importlib.import_module("consensuscruncher_tpu_torch"
                                       + (f".{tmod}" if tmod else ""))
    assert getattr(port_mod, name) == getattr(jax_mod, name)
    assert type(getattr(port_mod, name)) is type(getattr(jax_mod, name))


def _family(rng, f, length):
    bases = rng.integers(0, 6, (f, length)).astype(np.uint8)    # PAD (5) among members
    quals = rng.integers(0, 45, (f, length)).astype(np.uint8)
    # members mostly agree with the first, so votes pass and tie
    agree = rng.random((f, length)) < 0.6
    bases = np.where(agree, bases[:1], bases)
    size = int(rng.integers(0, f + 1))
    bases[size:] = np.where(rng.random((f - size, length)) < 0.5, 5, bases[size:])
    return bases, quals, size


# F 1-16, each at the shortest, the longest and one length between
SHAPES = [(f, length) for f in range(1, 17) for length in (1, 1 + (41 * f) % 130, 130)]


@pytest.mark.parametrize("cfg", [(7, 10, 0, 60), (1, 2, 20, 60), (9, 10, 30, 45)])
def test_majority_family_vote_matches_jax(cfg):
    """With the rider and without (the reference's outputs are the same
    either way, so its rider run gives both)."""
    num, den, qual_threshold, qual_cap = cfg
    kw = dict(num=num, den=den, qual_threshold=qual_threshold, qual_cap=qual_cap)
    reference = jax.jit(functools.partial(jpolicies.majority_family_vote, **kw, with_qc=True))
    rng = np.random.default_rng(num * 100 + qual_threshold)
    for f, length in SHAPES:
        bases, quals, size = _family(rng, f, length)
        want = [np.asarray(w) for w in reference(jnp.asarray(bases), jnp.asarray(quals), size)]
        tb, tq = torch.from_numpy(bases), torch.from_numpy(quals)
        for with_qc in (False, True):
            got = tpolicies.majority_family_vote(tb, tq, size, **kw, with_qc=with_qc)
            assert len(got) == (4 if with_qc else 2)
            for g, w in zip(got, want):
                assert g.shape == w.shape and g.numpy().dtype == w.dtype
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"F {f} L {length}")


def test_majority_family_vote_refusals_match_jax():
    bases = np.zeros((4, 3), np.uint8)
    kw = dict(num=2**29, den=2**29, qual_threshold=0, qual_cap=60)
    with pytest.raises(ValueError) as want:
        jpolicies.majority_family_vote(jnp.asarray(bases), jnp.asarray(bases), 2, **kw)
    with pytest.raises(ValueError) as got:
        tpolicies.majority_family_vote(torch.from_numpy(bases), torch.from_numpy(bases), 2,
                                       **kw)
    assert str(got.value) == str(want.value)


def test_record_blob_matches_jax():
    seen = 0
    with jcolumnar.ColumnarReader(SAMPLE_BAM, batch_bytes=1 << 16) as jr, \
            tcolumnar.ColumnarReader(SAMPLE_BAM, batch_bytes=1 << 16) as tr:
        for jb, tb in zip(jr.batches(), tr.batches(), strict=True):
            assert tb.n == jb.n
            for i in range(jb.n):
                assert tb.record_blob(i) == jb.record_blob(i)
            seen += jb.n
    assert seen > 1000


def test_cigar_words_of_matches_jax():
    families = 0
    with jcolumnar.ColumnarReader(SAMPLE_BAM) as jr, tcolumnar.ColumnarReader(SAMPLE_BAM) as tr:
        jevents = jgrouping.stream_family_blocks(jr, jr.header, "|")
        tevents = tgrouping.stream_family_blocks(tr, tr.header, "|")
        for (jkind, jblock, _), (tkind, tblock, _) in zip(jevents, tevents, strict=True):
            assert tkind == jkind
            if jkind != "block":
                continue
            assert tblock.n_fam == jblock.n_fam
            for j in range(jblock.n_fam):
                want = jblock.cigar_words_of(j)
                got = tblock.cigar_words_of(j)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
            families += jblock.n_fam
    assert families > 100
