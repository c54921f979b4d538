"""The vote kernels' host tile planner (``ops/tiles.py``), on the CPU.

Every plan is held to the invariants the kernel relies on: each family in
exactly one tile, tiles in family order, each staged tile's byte ranges
16-byte aligned, inside the planes and covering every live member row of its
families, no tile over a stage's records or rows, and every family over the
stage on the direct path, alone in its tile.  Inputs are made from seeds
with numpy.
"""

import numpy as np
import pytest

from consensuscruncher_tpu_torch.ops import tiles

LAYOUTS = [tiles.Layout(), tiles.Layout(threads=256, positions=2, meta_bytes=2048,
                                        data_bytes=8192, packed_max=256)]


def _strand(sizes, row_bytes, width=None, planes=1, starts=None, pad_rows=3,
            aligned=True, contiguous=False):
    sizes = np.asarray(sizes, np.int64)
    if starts is None:
        starts = np.cumsum(sizes) - sizes
    starts = np.asarray(starts, np.int64)
    rows = int((starts + sizes).max(initial=0)) + pad_rows
    return tiles.Strand(starts=starts, sizes=sizes, row_bytes=row_bytes,
                        width=row_bytes if width is None else width, planes=planes,
                        rows=rows, aligned=aligned, contiguous=contiguous)


def _stream_pair(sizes_a, sizes_b, row_bytes, contiguous=False):
    """B2's stream form: one member stream, strand A's slots then B's."""
    seg = np.concatenate([sizes_a, sizes_b]).astype(np.int64)
    starts = np.cumsum(seg) - seg
    n = len(sizes_a)
    rows = int(seg.sum()) + 5
    return [tiles.Strand(starts=starts[:n], sizes=seg[:n], row_bytes=row_bytes,
                         width=row_bytes, planes=1, rows=rows, aligned=True,
                         contiguous=contiguous),
            tiles.Strand(starts=starts[n:], sizes=seg[n:], row_bytes=row_bytes,
                         width=row_bytes, planes=1, rows=rows, aligned=True,
                         contiguous=contiguous)]


def _check_plan(plan, strands, length, layout):
    """The invariants of one plan; returns its table."""
    nf = strands[0].sizes.shape[0]
    t = plan.table
    assert t.shape[1] == tiles.TILE_COLS
    assert plan.records.shape == (nf, 2 * len(strands))
    for s, st in enumerate(strands):
        np.testing.assert_array_equal(plan.records[:, 2 * s], st.starts)
        np.testing.assert_array_equal(plan.records[:, 2 * s + 1], st.sizes)
    if nf == 0 or length <= 0:
        assert t.shape[0] == 0
        return t
    # every family in exactly one tile, tiles in order, none empty
    assert t[0, 0] == 0 and t[-1, 1] == nf
    np.testing.assert_array_equal(t[1:, 0], t[:-1, 1])
    assert (t[:, 1] > t[:, 0]).all()
    groups = -(-length // layout.positions)
    fams = t[:, 1] - t[:, 0]
    assert (fams * 16 * len(strands) <= layout.meta_bytes).all()  # a stage's records
    assert (fams * groups <= tiles.MAX_ITEMS).all()
    big = np.zeros(nf, bool)
    for st in strands:
        big |= st.sizes > layout.packed_max
    any_staged = t[:, 2].any()
    for f0, f1, staged, *spans in t:
        if big[f0:f1].any():  # over the packed tally: direct, alone if the call stages
            assert not staged and (f1 - f0 == 1 or not any_staged)
        if not staged:
            assert not any(spans)
            continue
        total = 0
        for s, st in enumerate(strands):
            off, nbytes = spans[2 * s], spans[2 * s + 1]
            assert off % tiles.ALIGN == 0 and nbytes % tiles.ALIGN == 0
            assert st.aligned
            live = st.sizes[f0:f1] > 0
            if not live.any():
                assert nbytes == 0
                continue
            first = int(st.starts[f0:f1][live].min())
            end = int((st.starts[f0:f1] + st.sizes[f0:f1])[live].max())
            # the live rows [starts[f0], starts[f1-1] + sizes[f1-1]) lie in range
            assert off <= first * st.row_bytes
            assert off + nbytes >= (end - 1) * st.row_bytes + st.width
            assert off + nbytes <= st.extent  # inside the plane's allocation
            total += st.planes * nbytes
        assert total <= layout.data_bytes
    return t


def _case(name, rng):
    """``(strands, length)`` of one named planner case."""
    if name == "empty_batch":
        return [_strand([], 64)], 128
    if name == "all_zero_sizes":
        return [_strand(np.zeros(5000, np.int64), 96)], 104
    if name == "main_path_pack6":  # the SSCS stage's shape: L 128 rows, vote 104
        return [_strand(np.maximum(2, rng.geometric(0.6, 21388)), 96)], 104
    if name == "random_raw":  # two planes per strand
        return [_strand(rng.integers(0, 9, 3000), 128, planes=2)], 128
    if name == "zeros_at_tile_edges":
        sizes = rng.integers(0, 4, 5000)
        sizes[::37] = 0
        sizes[:50] = 0
        sizes[-50:] = 0
        return [_strand(sizes, 64)], 128
    if name == "straddling_budget":  # families near and over a stage's bytes
        sizes = rng.integers(1, 6, 2000)
        sizes[[10, 500, 1500]] = [60, 130, 256]
        return [_strand(sizes, 64)], 128
    if name == "family_1500":  # over the packed tally: the direct path
        sizes = rng.integers(0, 5, 400)
        sizes[[0, 200, 399]] = [1500, 257, 300]
        return [_strand(sizes, 64)], 128
    if name == "families_70000":
        return [_strand(rng.integers(0, 4, 70000), 32)], 40
    if name == "odd_row_bytes":  # L 100 raw: rows not a multiple of 16 bytes
        return [_strand(rng.integers(0, 7, 1000), 100, planes=2)], 100
    if name == "unaligned_planes":  # the planes' address is not 16-byte aligned
        return [_strand(rng.integers(0, 7, 1000), 64, aligned=False)], 128
    if name == "duplex_stream":  # B2's stage loop: two ranges of one stream
        sa = np.minimum(1 + rng.geometric(0.25, 8192), 16)
        sb = np.minimum(1 + rng.geometric(0.25, 8192), 16)
        sb[::16] = 0
        return _stream_pair(sa, sb, 64), 128
    if name == "duplex_stream_1500":
        sa, sb = rng.integers(0, 8, 3000), rng.integers(0, 8, 3000)
        sa[0], sb[7] = 1500, 300
        return _stream_pair(sa, sb, 64), 125
    if name == "dense_form":  # starts = i * F, empty slots as gaps
        b, f = 4096, 8
        sizes = rng.integers(0, f + 1, b)
        starts = np.arange(b) * f
        return [_strand(sizes, 100, planes=2, starts=starts, pad_rows=0)], 100
    if name == "dense_form_duplex_small_rows":
        b, f = 2048, 4
        starts = np.arange(b) * f
        return [_strand(rng.integers(0, f + 1, b), 32, starts=starts, pad_rows=0),
                _strand(rng.integers(0, f + 1, b), 32, starts=starts, pad_rows=0)], 64
    raise KeyError(name)


CASES = ["empty_batch", "all_zero_sizes", "main_path_pack6", "random_raw",
         "zeros_at_tile_edges", "straddling_budget", "family_1500", "families_70000",
         "odd_row_bytes", "unaligned_planes", "duplex_stream", "duplex_stream_1500",
         "dense_form", "dense_form_duplex_small_rows"]


@pytest.mark.parametrize("layout", LAYOUTS, ids=["default", "small_stage"])
@pytest.mark.parametrize("grid", [264, 7])
@pytest.mark.parametrize("name", CASES)
def test_plan_invariants(name, grid, layout):
    rng = np.random.default_rng(CASES.index(name))
    strands, length = _case(name, rng)
    _check_plan(tiles.plan_tiles(strands, length, grid, layout), strands, length, layout)


def test_main_path_tiles_are_staged_and_fill_the_threads():
    rng = np.random.default_rng(2)
    strands, length = _case("main_path_pack6", rng)
    layout = tiles.Layout()
    plan = tiles.plan_tiles(strands, length, 264, layout)
    assert plan.summary()["path"] == "staged"
    items = (plan.table[:, 1] - plan.table[:, 0]) * -(-length // layout.positions)
    # whole families, at most one pass of the block's threads, most of one
    assert (items <= layout.threads).all()
    assert np.median(items) > 0.8 * layout.threads


@pytest.mark.parametrize("name", ["family_1500", "duplex_stream_1500", "straddling_budget"])
def test_big_families_take_the_direct_path(name):
    rng = np.random.default_rng(CASES.index(name))
    strands, length = _case(name, rng)
    layout = tiles.Layout()
    plan = tiles.plan_tiles(strands, length, 264, layout)
    summary = plan.summary()
    assert summary["direct"] >= 1 and summary["staged"] >= 1
    weight = sum(st.planes * st.row_bytes * st.sizes for st in strands)
    over = np.flatnonzero((weight > layout.data_bytes // 2)
                          | np.any([st.sizes > layout.packed_max for st in strands], 0))
    direct = plan.table[plan.table[:, 2] == 0]
    for f in over:
        assert any(f0 == f and f1 == f + 1 for f0, f1 in direct[:, :2])


@pytest.mark.parametrize("name", ["unaligned_planes", "dense_form"])
def test_unstageable_calls_are_direct(name):
    rng = np.random.default_rng(CASES.index(name))
    strands, length = _case(name, rng)
    assert tiles.plan_tiles(strands, length, 264).summary()["path"] == "direct"


def test_stream_duplex_ranges_are_the_two_strands():
    """B2's stream form stages strand A's and strand B's rows as two ranges
    of the one member stream, A's before B's."""
    rng = np.random.default_rng(5)
    strands, length = _case("duplex_stream", rng)
    plan = tiles.plan_tiles(strands, length, 264)
    t = plan.table[plan.table[:, 2] == 1]
    assert len(t)
    split = int(strands[1].starts[0]) * 64  # strand B's first row
    assert (t[:, 3] + t[:, 4] <= split + tiles.ALIGN).all()
    assert (t[:, 5] >= split - tiles.ALIGN).all()


def test_overlong_vote_is_refused():
    with pytest.raises(ValueError, match="positions"):
        tiles.plan_tiles([_strand([1], 8)], tiles.MAX_ITEMS * 4 + 1, 264)


# the stream form (contiguous families, as the wrappers mark default starts)
STREAM_CASES = {
    "main_path_pack6": lambda rng: ([_strand(np.maximum(2, rng.geometric(0.6, 21388)), 96,
                                             contiguous=True)], 104),
    "zeros_at_tile_edges": lambda rng: ([_strand(np.where(np.arange(5000) % 37 == 0, 0,
                                                          rng.integers(0, 4, 5000)), 64,
                                                 pad_rows=0, contiguous=True)], 128),
    "duplex_stream": lambda rng: (_stream_pair(np.minimum(1 + rng.geometric(0.25, 8192), 16),
                                               np.minimum(1 + rng.geometric(0.25, 8192), 16)
                                               * (np.arange(8192) % 16 != 0), 64,
                                               contiguous=True), 128),
    "not_a_tile_multiple": lambda rng: ([_strand(rng.integers(1, 9, 4099), 96,
                                                 contiguous=True)], 128),
    "rows_L100": lambda rng: ([_strand(rng.integers(0, 7, 3000), 100, planes=2,
                                       contiguous=True)], 100),
    "last_row_at_plane_end": lambda rng: ([_strand(rng.integers(1, 5, 999), 40, width=38,
                                                   pad_rows=0, contiguous=True)], 38),
}


@pytest.mark.parametrize("positions", [4, 2])
@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_stream_form_takes_uniform_tiles(name, positions):
    """No table is uploaded for the stream form: the kernel derives each
    uniform tile's row (``tile_row``), which ``plan.table`` models; the
    derived rows keep every invariant."""
    rng = np.random.default_rng(len(name) + positions)
    strands, length = STREAM_CASES[name](rng)
    layout = tiles.Layout(positions=positions)
    plan = tiles.plan_tiles(strands, length, 396, layout)
    assert plan.explicit is None and plan.summary()["uniform"]
    t = _check_plan(plan, strands, length, layout)
    assert plan.n_tiles == t.shape[0]
    fams = t[:, 1] - t[:, 0]
    assert (fams[:-1] == plan.fams).all() and 0 < fams[-1] <= plan.fams
    if name != "last_row_at_plane_end":
        assert plan.summary()["path"] == "staged"


@pytest.mark.parametrize("name", ["family_1500", "straddling_budget", "dense_form"])
def test_big_or_gapped_families_take_an_explicit_table(name):
    rng = np.random.default_rng(CASES.index(name))
    strands, length = _case(name, rng)
    strands = [tiles.Strand(**{**st.__dict__, "contiguous": name != "dense_form"})
               for st in strands]
    plan = tiles.plan_tiles(strands, length, 264)
    assert plan.explicit is not None and not plan.summary()["uniform"]
    _check_plan(plan, strands, length, tiles.Layout())
