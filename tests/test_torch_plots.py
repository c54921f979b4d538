"""``stages/generate_plots.py`` of the port against the JAX package's (CPU).

The port draws without matplotlib, so each plot is a series function and
a renderer.  The series are held to what the JAX ``generate_plots`` hands
to matplotlib on the same stats files (``Axes.bar``, ``barh``, ``plot``,
``set_yticks`` and ``text`` captured by ``unittest.mock.patch.object``),
and every PNG the port writes decodes: signature, IHDR, each chunk's CRC,
the zlib stream.  ``stage_time_series([])`` gives nothing and no file is
written for it, as the reference does.
"""

import json
import os
import struct
import zlib
from unittest import mock

import numpy as np
import pytest
from matplotlib.axes import Axes

from consensuscruncher_tpu.stages import generate_plots as jax_plots
from consensuscruncher_tpu_torch.cli import main as torch_main
from consensuscruncher_tpu_torch.stages import generate_plots as plots

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "test", "data", "sample.bam")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("plots")
    torch_main(["consensus", "-i", SAMPLE, "-o", str(root), "-n", "p", "--device", "cpu"])
    base = root / "p"
    return {
        "base": base,
        "families": str(base / "sscs" / "p.read_families.txt"),
        "stats": [str(base / "sscs" / "p.sscs_stats.json"),
                  str(base / "singleton" / "p.singleton_stats.json"),
                  str(base / "dcs" / "p.dcs_stats.json")],
        "metrics": [str(base / "sscs" / "p.metrics.json"),
                    str(base / "singleton" / "p.singleton.metrics.json"),
                    str(base / "dcs" / "p.dcs.metrics.json"), str(base / "missing.json")],
    }


def _captured(fn, *args):
    """The arguments the JAX plot function passes to matplotlib."""
    calls = {"bar": [], "barh": [], "plot": [], "set_yticks": [], "text": []}

    def spy(name):
        real = getattr(Axes, name)

        def wrapped(self, *a, **k):
            calls[name].append(a)
            return real(self, *a, **k)
        return wrapped

    with mock.patch.object(Axes, "bar", spy("bar")), \
            mock.patch.object(Axes, "barh", spy("barh")), \
            mock.patch.object(Axes, "plot", spy("plot")), \
            mock.patch.object(Axes, "set_yticks", spy("set_yticks")), \
            mock.patch.object(Axes, "text", spy("text")):
        fn(*args)
    return calls


def test_family_size_series_equals_jax(run, tmp_path):
    calls = _captured(jax_plots.plot_family_size, run["families"], str(tmp_path / "j.png"))
    s = plots.family_size_series(run["families"])
    (fams, reads) = calls["bar"]
    assert list(fams[0]) == s["sizes"] == list(reads[0]) and len(s["sizes"]) > 3
    assert list(fams[1]) == s["families"] and list(reads[1]) == s["reads"]
    (line,) = calls["plot"]
    assert list(line[0]) == s["sizes"] and list(line[1]) == s["cumulative"]
    assert s["cumulative"][-1] == 1.0


def test_read_recovery_series_equals_jax(run, tmp_path):
    calls = _captured(jax_plots.plot_read_recovery, run["stats"], str(tmp_path / "j.png"))
    labels, values = plots.read_recovery_series(run["stats"])
    ((ys, jvalues),) = calls["barh"]
    ((ticks, jlabels),) = calls["set_yticks"]
    assert list(jvalues) == values and list(jlabels) == labels and list(ticks) == list(ys)
    assert labels[0] == "input reads" and len(labels) == 10  # sample.bam has no bad reads
    # value labels: the reference's format
    assert [t[2] for t in calls["text"]] == [f"{v:,}" for v in values]
    # the fallback: no recognised key, every numeric key of every file
    odd = tmp_path / "odd.json"
    odd.write_text(json.dumps({"stage": "X", "a": 1, "b": 2.5, "c": "no"}))
    calls = _captured(jax_plots.plot_read_recovery, [str(odd)], str(tmp_path / "o.png"))
    assert plots.read_recovery_series([str(odd)]) == (["X:a", "X:b"], [1, 2.5])
    assert list(calls["set_yticks"][0][1]) == ["X:a", "X:b"]


def test_stage_time_series_equals_jax(run, tmp_path):
    calls = _captured(jax_plots.plot_stage_times, run["metrics"], str(tmp_path / "j.png"))
    labels, values = plots.stage_time_series(run["metrics"])
    ((_ys, jvalues),) = calls["barh"]
    ((_ticks, jlabels),) = calls["set_yticks"]
    assert list(jvalues) == values and list(jlabels) == labels
    assert labels == ["SSCS: consensus", "SSCS: sort", "singleton_correction: rescue",
                      "DCS: pairing", "DCS: sort"]
    # nothing to plot: no file, as the reference
    assert plots.stage_time_series([]) == ([], [])
    plots.plot_stage_times([], str(tmp_path / "none.png"))
    plots.plot_stage_times([str(tmp_path / "missing.json")], str(tmp_path / "none.png"))
    assert not (tmp_path / "none.png").exists()


def _chunks(data: bytes):
    off, out = 8, []
    while off < len(data):
        (length,) = struct.unpack_from(">I", data, off)
        out.append((data[off + 4:off + 8], data[off + 8:off + 8 + length],
                    struct.unpack_from(">I", data, off + 8 + length)[0]))
        off += 12 + length
    return out


@pytest.mark.parametrize("png,size", [("family_size", (1020, 900)),
                                      ("read_recovery", (756, 960)),
                                      ("stage_times", (324, 960))])
def test_run_pngs_decode(run, png, size):
    data = (run["base"] / "plots" / f"p.{png}.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks = _chunks(data)
    assert [c[0] for c in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    for tag, body, crc in chunks:
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc
    w, h, depth, ctype, _c, _f, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (h, w) == size and (depth, ctype, interlace) == (8, 2, 0)
    raw = zlib.decompress(chunks[1][1])
    assert len(raw) == h * (1 + 3 * w)
    img = plots.decode_png(data)
    assert img.shape == (h, w, 3)
    # drawn: the bar hue is there, and ink besides the white page
    assert (img == np.array([0x44, 0x77, 0xAA], np.uint8)).all(axis=2).any()
    assert (img != 255).any(axis=2).mean() > 0.01


def test_decode_refuses_damage():
    img = np.zeros((3, 4, 3), np.uint8)
    img[1, 2] = (1, 2, 3)
    data = plots.encode_png(img)
    assert (plots.decode_png(data) == img).all()
    broken = bytearray(data)
    broken[40] ^= 0xFF  # inside the IDAT body: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        plots.decode_png(bytes(broken))
    with pytest.raises(ValueError, match="signature"):
        plots.decode_png(b"GIF89a" + data[6:])


def test_font_covers_printable_ascii():
    masks = [plots._glyphs(chr(c)) for c in range(0x20, 0x7F)]
    assert all(m.shape == (7, 6) for m in masks)
    assert not masks[0].any() and all(m.any() for m in masks[1:])  # space is blank
    assert len({m.tobytes() for m in masks}) == len(masks)  # every glyph differs
    assert (plots._glyphs("é") == plots._glyphs("?")).all()
