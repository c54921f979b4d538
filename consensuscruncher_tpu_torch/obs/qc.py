"""Consensus-quality (QC) document of a run: the data-plane half of obs/.

Port of ``consensuscruncher_tpu/obs/qc.py`` (same doc, same keys,
``QC_VERSION`` 1).  Three pieces:

- :class:`QcAccumulator` — the per-run accumulator the SSCS stage arms
  as the module-level *plane sink*.  The SSCS vote kernel
  (``ops.consensus_vote.vote_wire`` with ``qc_lengths``) already holds
  every lane count of a (family, position); while a sink is armed it also
  sums two ``(L,)`` int32 vectors per batch over the batch's families —
  total votes and votes that disagree with the modal base — and the
  stream stage hands them to the sink still on the card, to be copied to
  the host once, at :meth:`QcAccumulator.finalize`.
- :func:`collect_run` — assembles a per-run ``qc.json`` doc from the
  stage sidecars every pipeline already writes (``*_stats.json``,
  ``*.read_families.txt``), merged with the accumulator's vote-plane
  summary.  Works identically for staged, streaming and resumed runs
  because the sidecar files are the authority for spectrum/yields; only
  the vote-plane block needs a live vote loop.
- :func:`write_qc` / :func:`merge_docs` / :func:`render_report` /
  :func:`render_diff` — the committed artifact (atomic-durable via
  ``utils.manifest.commit_file``) and the report surfaces over one or
  many docs.

Enablement: ``CCT_QC`` env (default on).  QC never perturbs pipeline
outputs — the rider only *reads* the vote's counts — so the BAMs are
byte-identical either way.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

QC_VERSION = 1

_ENV_FLAG = "CCT_QC"
_FALSE = ("0", "false", "off", "no")


def enabled() -> bool:
    """QC accumulation on?  Default yes — the rider is ~free."""
    return os.environ.get(_ENV_FLAG, "1").strip().lower() not in _FALSE


# ------------------------------------------------------------- plane sink
#
# Module-level so the vote's call site sees the run's choice without a
# parameter threaded through every layer.  Armed by ``run_sscs`` around its
# vote loop only, so rescue and DCS votes never mix batches into a run's
# accumulator.

_sink: "QcAccumulator | None" = None


def set_plane_sink(acc: "QcAccumulator | None") -> None:
    """Install (or clear, with ``None``) the active vote-plane sink."""
    global _sink
    _sink = acc


def plane_sink() -> "QcAccumulator | None":
    return _sink


class QcAccumulator:
    """Accumulates per-position vote-plane summaries for one run.

    ``add_plane`` takes host ``(L,)`` vectors; ``add_plane_handle`` takes
    a ``(votes, disagree)`` pair that may still lie on the card (a ``(2,
    L)`` tensor, or two vectors) and defers the tiny copy to the host until
    :meth:`finalize`, so the vote loop never waits on QC.
    """

    def __init__(self, run: str = ""):
        self.run = run
        self._handles: list = []
        self._votes = np.zeros(0, np.int64)
        self._disagree = np.zeros(0, np.int64)

    def _grow(self, n: int) -> None:
        if n > self._votes.shape[0]:
            self._votes = np.pad(self._votes, (0, n - self._votes.shape[0]))
            self._disagree = np.pad(self._disagree,
                                    (0, n - self._disagree.shape[0]))

    def add_plane(self, votes, disagree) -> None:
        votes = np.asarray(votes, dtype=np.int64).reshape(-1)
        disagree = np.asarray(disagree, dtype=np.int64).reshape(-1)
        self._grow(votes.shape[0])
        self._votes[: votes.shape[0]] += votes
        self._disagree[: disagree.shape[0]] += disagree

    def add_plane_handle(self, handle) -> None:
        self._handles.append(handle)

    def finalize(self) -> None:
        """Drain deferred device handles (a few int32 vectors per batch)."""
        handles, self._handles = self._handles, []
        for votes, disagree in handles:
            self.add_plane(_host(votes), _host(disagree))

    @property
    def has_planes(self) -> bool:
        return bool(self._handles) or bool(self._votes.any())

    def plane_doc(self) -> dict | None:
        """The ``plane`` block of a qc doc, or None if nothing accumulated
        (a resume-skipped SSCS stage has no live vote loop — spectrum and
        yields still come from the sidecars)."""
        self.finalize()
        if not self._votes.any():
            return None
        total_votes = int(self._votes.sum())
        total_dis = int(self._disagree.sum())
        return {
            "positions": int(self._votes.shape[0]),
            "votes": [int(x) for x in self._votes],
            "disagree": [int(x) for x in self._disagree],
            "total_votes": total_votes,
            "total_disagree": total_dis,
            "disagree_rate": (total_dis / total_votes) if total_votes else 0.0,
        }


def _host(x) -> np.ndarray:
    """A vector of a handle on the host (a torch tensor may lie on the
    card: it is copied once, here)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


# ------------------------------------------------------ doc construction

def _read_json(path: str) -> dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def read_spectrum(path: str) -> dict[str, int]:
    """``family_size<TAB>count`` sidecar -> {"size": count} (str keys so
    the doc round-trips through JSON unchanged)."""
    out: dict[str, int] = {}
    try:
        with open(path) as fh:
            next(fh, None)
            for line in fh:
                size, count = line.split("\t")
                out[str(int(size))] = int(count)
    except (OSError, ValueError):
        return {}
    return out


_YIELD_KEYS = (
    # sscs stats
    "total_reads", "families", "singletons", "sscs_written", "bad_reads",
    # singleton correction stats
    "rescued_by_sscs", "rescued_by_singleton", "remaining",
    "singletons_total",
    # dcs stats
    "pairs", "sscs_total", "sscs_unpaired", "dcs_written",
)


def _rates(y: dict) -> dict:
    """Derived quality rates; None where the denominator is absent so a
    partial doc (e.g. --scorrect off) stays honest instead of zero-y."""
    def ratio(n, d):
        return (n / d) if d else None

    rescued = y.get("rescued_by_sscs", 0) + y.get("rescued_by_singleton", 0)
    return {
        "sscs_yield": ratio(y.get("sscs_written", 0), y.get("families", 0)),
        "singleton_rate": ratio(y.get("singletons", 0), y.get("families", 0)),
        "rescue_rate": ratio(rescued, y.get("singletons_total", 0)),
        "dropout_rate": ratio(y.get("remaining", 0),
                              y.get("singletons_total", 0)),
        # fraction of SSCS reads whose strand partner existed — the
        # strand-balance summary (1.0 = perfectly duplexed input)
        "duplex_rate": ratio(2 * y.get("pairs", 0), y.get("sscs_total", 0)),
        "dcs_yield": ratio(y.get("dcs_written", 0), y.get("pairs", 0)),
    }


def collect_run(base: str, name: str, pipeline: str = "",
                acc: QcAccumulator | None = None,
                policy: str = "majority") -> dict:
    """Assemble one run's qc doc from its stage sidecars + accumulator.

    ``base`` is the run directory (``<output>/<name>``) with the standard
    ``sscs/ singleton/ dcs/`` layout; missing sidecars (stage not run)
    simply leave their keys at 0 / absent.
    """
    sscs = _read_json(os.path.join(base, "sscs", f"{name}.sscs_stats.json"))
    corr = _read_json(
        os.path.join(base, "singleton", f"{name}.singleton_stats.json"))
    dcs = _read_json(os.path.join(base, "dcs", f"{name}.dcs_stats.json"))
    spectrum = read_spectrum(
        os.path.join(base, "sscs", f"{name}.read_families.txt"))

    yields: dict[str, int] = {}
    sources: list[str] = []
    for label, doc in (("sscs", sscs), ("singleton_correction", corr),
                       ("dcs", dcs)):
        if doc:
            sources.append(label)
        for k in _YIELD_KEYS:
            if k in doc:
                yields[k] = yields.get(k, 0) + int(doc[k])

    return {
        "version": QC_VERSION,
        "run": name,
        "pipeline": pipeline,
        "policy": policy,
        "sources": sources,
        "spectrum": spectrum,
        "yields": yields,
        "rates": _rates(yields),
        "plane": acc.plane_doc() if acc is not None else None,
    }


def merge_docs(docs: list[dict]) -> dict:
    """Merge shard docs (for example runs over parts of one sample) into one
    doc: spectra and yields sum, plane vectors pad-add, rates recompute."""
    spectrum: dict[str, int] = {}
    yields: dict[str, int] = {}
    sources: list[str] = []
    runs: list[str] = []
    pipeline = ""
    policy = ""
    acc = QcAccumulator()
    any_plane = False
    for doc in docs:
        if not doc:
            continue
        runs.append(doc.get("run") or "?")
        pipeline = pipeline or doc.get("pipeline", "")
        # pre-policy shard docs lack the key; report renders those as "-"
        policy = policy or doc.get("policy", "")
        for s in doc.get("sources") or []:
            if s not in sources:
                sources.append(s)
        for size, count in (doc.get("spectrum") or {}).items():
            spectrum[size] = spectrum.get(size, 0) + int(count)
        for k, v in (doc.get("yields") or {}).items():
            yields[k] = yields.get(k, 0) + int(v)
        plane = doc.get("plane")
        if plane:
            any_plane = True
            acc.add_plane(plane.get("votes") or [],
                          plane.get("disagree") or [])
    return {
        "version": QC_VERSION,
        "run": "+".join(runs) if len(runs) > 1 else (runs[0] if runs else ""),
        "pipeline": pipeline,
        "policy": policy,
        "sources": sources,
        "merged_from": len(runs),
        "spectrum": spectrum,
        "yields": yields,
        "rates": _rates(yields),
        "plane": acc.plane_doc() if any_plane else None,
    }


def write_qc(path: str, doc: dict) -> None:
    """Commit a qc doc atomically + durably (``manifest.commit_file``):
    readers never see a torn doc and a crash right after return cannot
    lose it."""
    from consensuscruncher_tpu_torch.utils.manifest import commit_file

    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".qc.", dir=d)
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
        commit_file(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_qc(path: str) -> dict:
    return _read_json(path)


# ------------------------------------------------------------- rendering

def spectrum_distance(a: dict, b: dict) -> float:
    """Total-variation distance between two normalized family-size
    spectra in [0, 1] — a drift scalar between two runs."""
    ta = sum(int(v) for v in (a or {}).values())
    tb = sum(int(v) for v in (b or {}).values())
    if not ta or not tb:
        return 0.0 if ta == tb else 1.0
    sizes = sorted(set(a) | set(b))
    return 0.5 * sum(abs(int(a.get(s, 0)) / ta - int(b.get(s, 0)) / tb)
                     for s in sizes)


def _pct(x) -> str:
    return "-" if x is None else f"{100.0 * x:.2f}%"


_REPORT_COLS = (
    ("run", 20), ("policy", 10), ("families", 9), ("sscs", 8), ("dcs", 8),
    ("yield", 8), ("duplex", 8), ("rescue", 8), ("dropout", 8),
    ("disagree", 9),
)


def _report_row(label: str, doc: dict) -> str:
    y = doc.get("yields") or {}
    r = doc.get("rates") or {}
    plane = doc.get("plane") or {}
    cells = (
        label[:20],
        # pre-policy qc docs carry no "policy" key: dash, not an error
        (doc.get("policy") or "-")[:10],
        str(y.get("families", 0)), str(y.get("sscs_written", 0)),
        str(y.get("dcs_written", 0)), _pct(r.get("sscs_yield")),
        _pct(r.get("duplex_rate")), _pct(r.get("rescue_rate")),
        _pct(r.get("dropout_rate")),
        _pct(plane.get("disagree_rate")) if plane else "-",
    )
    return "  ".join(c.ljust(w) for c, (_n, w) in zip(cells, _REPORT_COLS))


def render_report(docs: list[tuple[str, dict]], spectrum_rows: int = 8) -> str:
    """Per-run table (+ a merged ALL row and its family-size spectrum when
    more than one doc is given)."""
    lines = ["  ".join(n.ljust(w) for n, w in _REPORT_COLS)]
    for label, doc in docs:
        lines.append(_report_row(label, doc))
    merged = merge_docs([d for _l, d in docs])
    if len(docs) > 1:
        lines.append(_report_row("ALL", merged))
    spec = merged.get("spectrum") or {}
    if spec:
        total = sum(spec.values()) or 1
        lines.append("")
        lines.append("family-size spectrum (merged):")
        top = sorted(spec.items(), key=lambda kv: int(kv[0]))
        for size, count in top[:spectrum_rows]:
            bar = "#" * max(1, round(40 * count / total))
            lines.append(f"  {size:>4}  {count:>9}  {bar}")
        if len(top) > spectrum_rows:
            rest = sum(c for _s, c in top[spectrum_rows:])
            lines.append(f"  >{top[spectrum_rows - 1][0]:>3}  {rest:>9}")
    return "\n".join(lines)


def render_diff(a: dict, b: dict, label_a: str = "A",
                label_b: str = "B") -> str:
    """Cross-run comparison: rate deltas + spectrum TV distance."""
    ra, rb = a.get("rates") or {}, b.get("rates") or {}
    pa, pb = a.get("plane") or {}, b.get("plane") or {}
    lines = [f"{'metric':<16}{label_a:>12}{label_b:>12}{'delta':>12}"]
    keys = ("sscs_yield", "singleton_rate", "duplex_rate", "rescue_rate",
            "dropout_rate", "dcs_yield")
    for k in keys:
        va, vb = ra.get(k), rb.get(k)
        delta = ("-" if va is None or vb is None
                 else f"{100.0 * (vb - va):+.2f}pp")
        lines.append(f"{k:<16}{_pct(va):>12}{_pct(vb):>12}{delta:>12}")
    va, vb = pa.get("disagree_rate"), pb.get("disagree_rate")
    delta = ("-" if va is None or vb is None
             else f"{100.0 * (vb - va):+.2f}pp")
    lines.append(f"{'disagree_rate':<16}{_pct(va):>12}{_pct(vb):>12}"
                 f"{delta:>12}")
    tv = spectrum_distance(a.get("spectrum") or {}, b.get("spectrum") or {})
    lines.append(f"{'spectrum_tv':<16}{'':>12}{'':>12}{tv:>12.4f}")
    return "\n".join(lines)
