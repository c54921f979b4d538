"""Plot generation from stage stats files, without matplotlib.

Port of ``consensuscruncher_tpu/stages/generate_plots.py``: the same three
PNGs, read back from the stats files on disk, with the reference's file
names, series and labels:

- ``family_size.png``   families per size and reads per size (log axes),
  plus the cumulative read fraction by family size;
- ``read_recovery.png`` the pipeline-ordered read-accounting funnel across
  the stage stats files;
- ``stage_times.png``   per-stage wall-clock from ``*.metrics.json``.

The machines the port runs on need not have matplotlib, so each plot is a
**series function** (what the reference hands to matplotlib) and a
**renderer** that draws bars, lines, axes and text into a numpy ``uint8``
RGB array and writes the PNG itself with ``zlib`` and ``struct``.  Text is
a 5x7 bitmap font of printable ASCII kept in this module.  The pixels
differ from matplotlib's; the file names, series and labels do not.
"""

from __future__ import annotations

import json
import math
import os
import struct
import zlib

import numpy as np

from consensuscruncher_tpu_torch.utils.stats import FamilySizeHistogram

# 5x7 glyphs of printable ASCII (0x20-0x7e): five column bytes each, bit 0
# the top row
_FONT = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12"
    "2313086462" "3649552250" "0000070000" "001c224100" "0041221c00"
    "082a1c2a08" "08083e0808" "0050300000" "0808080808" "0060600000"
    "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31"
    "1814127f10" "2745454539" "3c4a494930" "0171090503" "3649494936"
    "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"
    "4122140800" "0201510906" "324979413e" "7e1111117e" "7f49494936"
    "3e41414122" "7f4141221c" "7f49494941" "7f09090101" "3e41415132"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040"
    "7f0204027f" "7f0408107f" "3e4141413e" "7f09090906" "3e4151215e"
    "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f"
    "7f2018207f" "6314081463" "0304780403" "6151494543" "00007f4141"
    "0204081020" "41417f0000" "0402010204" "4040404040" "0001020400"
    "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"
    "087e090102" "081454543c" "7f08040478" "00447d4000" "2040443d00"
    "7f10284400" "00417f4000" "7c04180478" "7c08040478" "3844444438"
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020"
    "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "0804081008")
_GW, _GH = 5, 7  # glyph width and height; one column of space between glyphs

_BAR = (0x44, 0x77, 0xAA)  # one hue: every chart encodes one magnitude
_GRID = (0xDD, 0xE0, 0xE5)
_INK = (0x22, 0x22, 0x22)
_DPI = 120  # the reference's savefig dpi: its figure inches map to pixels

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


# ------------------------------------------------------------------ series


def family_size_series(read_families_txt: str) -> dict:
    """What the reference plots of a ``read_families.txt``: the family
    sizes, the families and the reads at each size, and the cumulative
    fraction of reads up to each size."""
    counts = FamilySizeHistogram.read(read_families_txt)
    sizes = sorted(counts)
    fams = [counts[s] for s in sizes]
    reads = [s * counts[s] for s in sizes]
    total_reads = sum(reads) or 1
    cum, acc = [], 0
    for r in reads:
        acc += r
        cum.append(acc / total_reads)
    return {"sizes": sizes, "families": fams, "reads": reads, "cumulative": cum}


# Pipeline-ordered read-accounting keys (stage, key, human label).
_RECOVERY_KEYS = (
    ("SSCS", "total_reads", "input reads"),
    ("SSCS", "bad_reads", "bad reads"),
    ("SSCS", "families", "UMI families"),
    ("SSCS", "sscs_written", "SSCS consensus"),
    ("SSCS", "singletons", "singletons"),
    ("singleton_correction", "rescued_by_sscs", "rescued by SSCS"),
    ("singleton_correction", "rescued_by_singleton", "rescued by singleton"),
    ("singleton_correction", "remaining", "unrescued singletons"),
    ("DCS", "pairs", "duplex pairs"),
    ("DCS", "dcs_written", "DCS consensus"),
    ("DCS", "sscs_unpaired", "unpaired SSCS"),
)


def read_recovery_series(stats_jsons: list[str]) -> tuple[list[str], list]:
    """Labels and counts of the read-accounting funnel, in pipeline order
    (:data:`_RECOVERY_KEYS`); with none of those keys, every numeric key
    of every file, labelled ``stage:key``."""
    by_stage: dict[str, dict] = {}
    for path in stats_jsons:
        with open(path) as fh:
            data = json.load(fh)
        by_stage[data.get("stage", os.path.basename(path))] = data
    labels, values = [], []
    for stage, key, label in _RECOVERY_KEYS:
        data = by_stage.get(stage)
        if data is not None and key in data:
            labels.append(label)
            values.append(data[key])
    if not labels:  # nothing recognizable: fall back to every numeric key
        for stage, data in by_stage.items():
            for key, val in data.items():
                if isinstance(val, (int, float)) and key != "stage":
                    labels.append(f"{stage}:{key}")
                    values.append(val)
    return labels, values


def stage_time_series(metrics_jsons: list[str]) -> tuple[list[str], list]:
    """``stage: phase`` labels and seconds from the ``phases_s`` of each
    ``*.metrics.json`` that exists, in file order."""
    labels, values = [], []
    for path in metrics_jsons:
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            data = json.load(fh)
        stage = data.get("stage", os.path.basename(path))
        for name, seconds in data.get("phases_s", {}).items():
            labels.append(f"{stage}: {name}")
            values.append(seconds)
    return labels, values


# ------------------------------------------------------------------ plots


def plot_family_size(read_families_txt: str, out_png: str) -> None:
    s = family_size_series(read_families_txt)
    w, h = int(7.5 * _DPI), int(8.5 * _DPI)
    c = _Canvas(w, h)
    c.text(w // 2, 12, "UMI family-size distribution", scale=2, align="center")
    left, right = 110, w - 30
    sizes = s["sizes"] or [1]
    xlim = (min(sizes) - 0.6, max(sizes) + 0.6)
    x_ticks = _linear_ticks(min(sizes), max(sizes))
    # panel heights in the reference's ratio 3:3:2
    top, bottom, gap = 48, h - 70, 28
    unit = (bottom - top - 2 * gap) / 8
    panels = [(top, top + 3 * unit), (top + 3 * unit + gap, top + 6 * unit + gap),
              (top + 6 * unit + 2 * gap, bottom)]
    for (y0, y1), values, label in ((panels[0], s["families"], "families (log)"),
                                    (panels[1], s["reads"], "reads (log)")):
        ax = _Axes(c, left, int(y0), right, int(y1), xlim, _log_limits(values), ylog=True)
        ax.grid_x(x_ticks)
        ax.vbars(s["sizes"], values)
        ax.frame(x_ticks, _log_ticks(ax.ylim), label_x=False)
        ax.ylabel(label)
    y0, y1 = panels[2]
    ax = _Axes(c, left, int(y0), right, int(y1), xlim, (0.0, 1.02))
    ax.grid_x(x_ticks)
    ax.grid_y([0.0, 0.25, 0.5, 0.75, 1.0])
    ax.polyline(s["sizes"], s["cumulative"])
    ax.frame(x_ticks, [0.0, 0.25, 0.5, 0.75, 1.0])
    ax.ylabel("cum. read fraction")
    c.text((left + right) // 2, h - 24, "UMI family size", align="center")
    c.save(out_png)


def plot_read_recovery(stats_jsons: list[str], out_png: str) -> None:
    labels, values = read_recovery_series(stats_jsons)
    _barh_png(labels, values, lambda v: f"{v:,}", 1.12, "count", "read recovery by stage",
              out_png)


def plot_stage_times(metrics_jsons: list[str], out_png: str) -> None:
    """Per-stage wall-clock breakdown from ``*.metrics.json`` files; no
    file when none has a phase."""
    labels, values = stage_time_series(metrics_jsons)
    if not labels:
        return
    _barh_png(labels, values, lambda v: f"{v:.2f}s", 1.14, "wall-clock seconds",
              "stage timing", out_png)


def _barh_png(labels, values, fmt, headroom, xlabel, title, out_png) -> None:
    """Horizontal bars top-down in series order, each value labelled at
    its bar's end; the x axis from 0 to ``headroom`` x the largest value."""
    n = len(labels)
    w, h = 8 * _DPI, int((0.45 * n + 1.8) * _DPI)
    c = _Canvas(w, h)
    c.text(w // 2, 12, title, scale=2, align="center")
    left = 20 + max((_text_width(lb) for lb in labels), default=0)
    vmax = max(values) if values else 1
    xlim = (0.0, (vmax or 1) * headroom)
    ax = _Axes(c, left, 48, w - 30, h - 60, xlim, (-0.6, n - 0.4))
    ticks = _linear_ticks(0, xlim[1])
    ax.grid_x(ticks)
    ys = list(range(n))[::-1]  # pipeline order top to bottom
    ax.hbars(ys, values)
    ax.frame(ticks, [])
    for y, label, v in zip(ys, labels, values):
        py = ax.py(y)
        c.text(left - 8, py - _GH // 2, label, align="right")
        c.text(ax.px(v + vmax * 0.01) + 2, py - _GH // 2, fmt(v))
    c.text((left + w - 30) // 2, h - 24, xlabel, align="center")
    c.save(out_png)


# ------------------------------------------------------------------ axes


def _linear_ticks(lo: float, hi: float, most: int = 8) -> list[float]:
    """Round-number ticks covering ``[lo, hi]``: steps of 1, 2 or 5 x 10^k."""
    span = max(hi - lo, 1e-12)
    step = 10.0 ** math.floor(math.log10(span / most))
    for m in (1, 2, 5, 10):
        if span / (m * step) <= most:
            step *= m
            break
    first = math.ceil(lo / step) * step
    return [first + i * step for i in range(int((hi - first) / step + 1e-9) + 1)]


def _log_limits(values) -> tuple[float, float]:
    pos = [v for v in values if v > 0] or [1]
    lo = 10.0 ** math.floor(math.log10(min(pos)))
    hi = 10.0 ** math.ceil(math.log10(max(pos)))
    return (lo, hi * 10 if hi <= lo else hi)


def _log_ticks(ylim) -> list[float]:
    k0, k1 = round(math.log10(ylim[0])), round(math.log10(ylim[1]))
    return [10.0 ** k for k in range(k0, k1 + 1)]


def _tick_label(v: float, log: bool) -> str:
    if log:
        return f"10^{round(math.log10(v))}"
    return f"{v:g}" if v != int(v) else f"{int(v):,}"


class _Axes:
    """A data rectangle on a canvas: data -> pixel maps, bars, lines, the
    left and bottom spines (the reference hides the top and right ones)
    with ticks and tick labels."""

    def __init__(self, canvas, x0, y0, x1, y1, xlim, ylim, ylog=False):
        self.c, self.x0, self.y0, self.x1, self.y1 = canvas, x0, y0, x1, y1
        self.xlim, self.ylim, self.ylog = xlim, ylim, ylog

    def px(self, x: float) -> int:
        lo, hi = self.xlim
        return int(round(self.x0 + (x - lo) / (hi - lo) * (self.x1 - self.x0)))

    def py(self, y: float) -> int:
        lo, hi = self.ylim
        if self.ylog:
            y, lo, hi = (math.log10(max(v, lo)) for v in (y, lo, hi))
        return int(round(self.y1 - (y - lo) / (hi - lo) * (self.y1 - self.y0)))

    def vbars(self, xs, heights, width: float = 0.8) -> None:
        base = self.py(self.ylim[0])
        for x, v in zip(xs, heights):
            if v > 0:
                self.c.rect(self.px(x - width / 2), self.py(v), self.px(x + width / 2), base,
                            _BAR)

    def hbars(self, ys, widths, height: float = 0.8) -> None:
        for y, v in zip(ys, widths):
            if v > 0:
                self.c.rect(self.px(0), self.py(y + height / 2), self.px(v),
                            self.py(y - height / 2), _BAR)

    def polyline(self, xs, ys) -> None:
        pts = [(self.px(x), self.py(y)) for x, y in zip(xs, ys)]
        for (a, b), (p, q) in zip(pts, pts[1:]):
            self.c.line(a, b, p, q, _BAR, width=2)
        if len(pts) == 1:
            self.c.rect(pts[0][0] - 1, pts[0][1] - 1, pts[0][0] + 1, pts[0][1] + 1, _BAR)

    def grid_x(self, ticks) -> None:
        for t in ticks:
            self.c.rect(self.px(t), self.y0, self.px(t), self.y1, _GRID)

    def grid_y(self, ticks) -> None:
        for t in ticks:
            self.c.rect(self.x0, self.py(t), self.x1, self.py(t), _GRID)

    def frame(self, x_ticks, y_ticks, label_x: bool = True) -> None:
        c = self.c
        c.rect(self.x0, self.y0, self.x0, self.y1, _INK)
        c.rect(self.x0, self.y1, self.x1, self.y1, _INK)
        for t in x_ticks:
            x = self.px(t)
            c.rect(x, self.y1, x, self.y1 + 4, _INK)
            if label_x:
                c.text(x, self.y1 + 8, _tick_label(t, False), align="center")
        for t in y_ticks:
            y = self.py(t)
            c.rect(self.x0 - 4, y, self.x0, y, _INK)
            c.text(self.x0 - 7, y - _GH // 2, _tick_label(t, self.ylog), align="right")

    def ylabel(self, label: str) -> None:
        self.c.text(14, (self.y0 + self.y1) // 2, label, align="center", vertical=True)


# ------------------------------------------------------------------ canvas


def _text_width(s: str, scale: int = 1) -> int:
    return len(s) * (_GW + 1) * scale


def _glyphs(s: str) -> np.ndarray:
    """``(7, 6 * len(s))`` bool mask of ``s`` in the bitmap font (one blank
    column after each glyph; characters outside printable ASCII as '?')."""
    out = np.zeros((_GH, (_GW + 1) * len(s)), bool)
    rows = np.arange(_GH)[:, None]
    for i, ch in enumerate(s):
        code = ord(ch) if 0x20 <= ord(ch) <= 0x7E else ord("?")
        cols = np.frombuffer(_FONT, np.uint8, _GW, (code - 0x20) * _GW)
        out[:, i * (_GW + 1):i * (_GW + 1) + _GW] = (cols[None, :] >> rows) & 1
    return out


class _Canvas:
    """A white RGB image with clipped rectangle, line and text drawing."""

    def __init__(self, width: int, height: int):
        self.px = np.full((height, width, 3), 255, np.uint8)

    def rect(self, x0, y0, x1, y1, color) -> None:
        """Fill the inclusive pixel box between two corners."""
        h, w, _ = self.px.shape
        xa, xb = sorted((int(x0), int(x1)))
        ya, yb = sorted((int(y0), int(y1)))
        xa, ya, xb, yb = max(xa, 0), max(ya, 0), min(xb, w - 1), min(yb, h - 1)
        if xa <= xb and ya <= yb:
            self.px[ya:yb + 1, xa:xb + 1] = color

    def line(self, x0, y0, x1, y1, color, width: int = 1) -> None:
        n = max(abs(x1 - x0), abs(y1 - y0), 1)
        t = np.linspace(0.0, 1.0, n + 1)
        for x, y in zip(np.rint(x0 + t * (x1 - x0)), np.rint(y0 + t * (y1 - y0))):
            self.rect(x, y, x + width - 1, y + width - 1, color)

    def text(self, x, y, s: str, color=_INK, scale: int = 1, align: str = "left",
             vertical: bool = False) -> None:
        """Draw ``s`` with its top at ``y`` and its left edge, centre or
        right edge at ``x`` (``align``); ``vertical`` turns it to read
        bottom-up, centred on ``(x, y)``."""
        mask = _glyphs(s)
        if scale > 1:
            mask = np.kron(mask, np.ones((scale, scale), bool))
        if vertical:
            mask = np.rot90(mask)
            x, y = x - mask.shape[1] // 2, y - mask.shape[0] // 2
        elif align == "center":
            x -= mask.shape[1] // 2
        elif align == "right":
            x -= mask.shape[1]
        h, w, _ = self.px.shape
        x, y = int(x), int(y)
        ys, xs = np.nonzero(mask)
        keep = (ys + y >= 0) & (ys + y < h) & (xs + x >= 0) & (xs + x < w)
        self.px[ys[keep] + y, xs[keep] + x] = color

    def save(self, path: str) -> None:
        with open(path, "wb") as fh:
            fh.write(encode_png(self.px))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """An ``(H, W, 3)`` uint8 image as PNG bytes: 8-bit truecolour, no
    interlace, every row with filter 0, one IDAT chunk."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)
    return (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The image of a PNG that :func:`encode_png` wrote, every part
    checked: the signature, each chunk's CRC, the IHDR (8-bit truecolour),
    the zlib stream and its size, filter 0 on every row.  Raises
    ``ValueError`` on anything else."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG (bad signature)")
    off, chunks = 8, []
    while off < len(data):
        (length,) = struct.unpack_from(">I", data, off)
        tag, body = data[off + 4:off + 8], data[off + 8:off + 8 + length]
        (crc,) = struct.unpack_from(">I", data, off + 8 + length)
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        chunks.append((tag, body))
        off += 12 + length
    if not chunks or chunks[0][0] != b"IHDR" or chunks[-1][0] != b"IEND":
        raise ValueError("PNG must start with IHDR and end with IEND")
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"unsupported PNG layout: depth {depth}, colour type {ctype}")
    raw = zlib.decompress(b"".join(body for tag, body in chunks if tag == b"IDAT"))
    if len(raw) != h * (1 + 3 * w):
        raise ValueError(f"PNG data holds {len(raw)} bytes, {w}x{h} needs {h * (1 + 3 * w)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("PNG rows use a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def main(argv=None):
    """Standalone entry: the reference's plot files from a run's
    ``read_families.txt``, stage ``*_stats.json`` and ``*.metrics.json``
    (host only)."""
    import argparse

    p = argparse.ArgumentParser(description="Generate stats plots")
    p.add_argument("--families", help="read_families.txt path")
    p.add_argument("--stats", nargs="*", default=[], help="stage *_stats.json paths")
    p.add_argument("--metrics", nargs="*", default=[], help="stage *.metrics.json paths")
    p.add_argument("--outdir", required=True)
    args = p.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    if args.families:
        plot_family_size(args.families, os.path.join(args.outdir, "family_size.png"))
    if args.stats:
        plot_read_recovery(args.stats, os.path.join(args.outdir, "read_recovery.png"))
    if args.metrics:
        plot_stage_times(args.metrics, os.path.join(args.outdir, "stage_times.png"))


if __name__ == "__main__":
    main()
