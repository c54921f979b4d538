"""Host planner of the vote kernels' tiles (``csrc/consensus_vote.cu``).

A tile is a run of consecutive families ``[f0, f1)``.  The kernel's
persistent blocks walk the tiles; a producer warp stages a tile's family
records and, for a *staged* tile, each strand's member rows (one contiguous
byte range per strand and plane, rounded outward to 16 bytes) into shared
memory with TMA bulk copies, while the consumer warps fold the tiles before
it.  A *direct* tile folds its rows straight from device memory.

A tile holds about as many (family, position group) items as the block has
consumer threads, or a whole multiple of that count when the call has many
more items than the grid has threads, so no thread idles while its warp
works.  Two kinds of plan:

- *uniform* (the stream form the main path and the fused step send: each
  strand's families contiguous, none over the packed tally or half a
  stage): every tile is ``fams`` families, and the kernel derives each
  tile's byte ranges from the family records itself, so the host writes no
  table (:func:`_table` is the same rule, for the tests and the reports);
- *explicit*: a table of cuts from a cumulative byte count (every ``fams``
  families, and inside such a run wherever its bytes pass a multiple of half
  a stage), uploaded with the records.

A tile is direct when:

- it holds a family over the stage (more than :attr:`Layout.packed_max`
  members on a strand, or more than half the stage's bytes): in a call that
  stages, such a family gets a tile of its own;
- its byte range cannot be staged: a plane whose address is not 16-byte
  aligned, a rounded range past the plane's end, or rows spanning more than
  the stage;
- the call cannot be staged at all: rows too wide for a stage to hold a
  tile's families (the dense ``(B, F, L)`` forms at large ``F * L``), or
  families that are not in row order.

Everything here is numpy on the host, from the sizes the wrappers already
hold; the records (and an explicit table) go to the card in one upload.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

TILE_COLS = 8       # f0, f1, staged, off0, bytes0, off1, bytes1, 0
ALIGN = 16          # TMA bulk copies: address and size
MAX_ITEMS = 1 << 16  # items of one tile (the kernel's exact i / groups)
TILES_PER_BLOCK = 8  # tiles a block should walk, so staging overlaps folding


@dataclass(frozen=True)
class Layout:
    """The kernel's shapes that the plan must fit (``cct_tile_constants``):
    consumer threads per block, positions per thread, record bytes and row
    bytes of a stage, members a staged family may have on a strand, stages
    in a block's ring."""

    threads: int = 256
    positions: int = 4
    meta_bytes: int = 2048
    data_bytes: int = 12288
    packed_max: int = 256
    stages: int = 4

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block."""
        return self.stages * (self.meta_bytes + self.data_bytes)


@dataclass(frozen=True)
class Strand:
    """One strand's member rows as the kernel reads them.

    ``starts``/``sizes``: int64 ``(NF,)``, family ``f``'s members are rows
    ``starts[f] .. starts[f] + sizes[f] - 1``; ``row_bytes``: the planes'
    row stride; ``width``: content bytes per row; ``planes``: 2 for the raw
    wire (bases, quals), else 1; ``rows``: rows in each plane; ``aligned``:
    every plane's address is a multiple of 16; ``contiguous``: each
    family's rows start where the one before it ends (``starts`` is the
    exclusive cumsum of ``sizes``)."""

    starts: np.ndarray
    sizes: np.ndarray
    row_bytes: int
    width: int
    planes: int
    rows: int
    aligned: bool
    contiguous: bool = False

    @property
    def extent(self) -> int:
        """Bytes from a plane's address to the end of its last row."""
        return (self.rows - 1) * self.row_bytes + self.width if self.rows else 0

    def gaps(self) -> np.ndarray | None:
        """Rows from each family's first row to the next family's first row
        (``np.diff(starts)``), or None when the families are not in row
        order (a family starting before the one before it ends)."""
        gap = np.diff(self.starts)
        return gap if (gap >= self.sizes[:-1]).all() else None


@dataclass(frozen=True)
class TilePlan:
    """One call's tiles.  ``records``: int64 ``(NF, 2 * strands)``, (start,
    size) per strand; ``explicit``: the int64 ``(T, TILE_COLS)`` table to
    upload, or None for uniform tiles of ``fams`` families."""

    records: np.ndarray
    explicit: np.ndarray | None
    fams: int
    strands: tuple
    layout: Layout

    @property
    def n_tiles(self) -> int:
        if self.explicit is not None:
            return self.explicit.shape[0]
        return -(-self.records.shape[0] // self.fams)

    @cached_property
    def table(self) -> np.ndarray:
        """The tile table: the explicit one, or the rows the kernel derives
        for uniform tiles."""
        if self.explicit is not None:
            return self.explicit
        f0 = np.arange(0, self.records.shape[0], self.fams)
        return _table(self.strands, f0, np.append(f0[1:], self.records.shape[0]),
                      np.ones(f0.size, bool), self.layout,
                      np.empty(f0.size * TILE_COLS, np.int64), contiguous=True)

    @property
    def n_staged(self) -> int:
        return int(self.table[:, 2].sum()) if self.table.size else 0

    @property
    def n_direct(self) -> int:
        return self.table.shape[0] - self.n_staged

    def summary(self) -> dict:
        """Which path the call's tiles took, and whether the table was
        uniform."""
        return {"tiles": int(self.table.shape[0]), "staged": self.n_staged,
                "direct": self.n_direct, "uniform": self.explicit is None,
                "path": ("staged" if self.n_direct == 0 else
                         "direct" if self.n_staged == 0 else "mixed")}


def _families_per_tile(nf: int, groups: int, grid_blocks: int, layout: Layout,
                       max_fam: int) -> int:
    """Families per tile: ``rounds`` passes of the block's threads over the
    tile's items, whole families only, the rounds set so that each block
    walks about :data:`TILES_PER_BLOCK` tiles."""
    threads = layout.threads
    rounds = max(1, round(nf * groups / (grid_blocks * TILES_PER_BLOCK * threads)))
    fams = max(1, rounds * threads // groups)
    return min(fams, max_fam, max(1, MAX_ITEMS // groups))


def plan_tiles(strands: list[Strand], length: int, grid_blocks: int,
               layout: Layout = Layout(), alloc=None) -> TilePlan:
    """Cut the families of one call into tiles.

    ``strands`` share the family axis (one for the SSCS vote, two for the
    duplex vote: pair ``p`` is family ``p`` of each); ``length`` is the vote
    length, ``grid_blocks`` the kernel's persistent grid.  Returns the plan
    (see the module note).  ``alloc(k)``, if given, returns the int64
    buffer of ``k`` entries that the records and an explicit table are
    written into, in that order (so a pinned buffer goes to the card as one
    copy)."""
    nf = int(strands[0].sizes.shape[0])
    nrec = nf * 2 * len(strands)
    strands = tuple(strands)
    groups = -(-length // layout.positions)
    if groups > MAX_ITEMS:
        raise ValueError(f"vote length {length} over the kernel's "
                         f"{MAX_ITEMS * layout.positions} positions")
    max_fam = layout.meta_bytes // (16 * len(strands))
    budget = layout.data_bytes // 2
    fams = _families_per_tile(nf, groups, grid_blocks, layout, max_fam) if nf else 1
    # the stream form: uniform tiles, no table (a family's bytes are its rows)
    uniform = nf > 0 and length > 0 and all(st.contiguous and st.aligned for st in strands)
    if uniform:
        max_sizes = [int(st.sizes.max()) for st in strands]
        uniform = (max(max_sizes) <= layout.packed_max
                   and sum(st.planes * st.row_bytes * m
                           for st, m in zip(strands, max_sizes)) <= budget)
    out = (alloc or (lambda k: np.empty(k, np.int64)))(
        nrec + (0 if uniform else nf * TILE_COLS))
    records = out[:nrec].reshape(nf, 2 * len(strands))
    for s, st in enumerate(strands):
        records[:, 2 * s] = st.starts
        records[:, 2 * s + 1] = st.sizes
    if uniform:
        return TilePlan(records, None, fams, strands, layout)
    if nf == 0 or length <= 0:
        return TilePlan(records, out[nrec:nrec].reshape(0, TILE_COLS), fams, strands, layout)

    # the bytes each family adds to its tile's ranges: its rows and the gap
    # after them (the dense form's empty slots), per strand and plane
    gaps = [st.gaps() for st in strands]
    weight = np.zeros(nf, np.int64)
    big = np.zeros(nf, bool)
    for st, gap in zip(strands, gaps):
        span = st.sizes.copy()
        if gap is not None:
            span[:-1] = gap
        weight += st.planes * st.row_bytes * span
        big |= st.sizes > layout.packed_max
    big |= weight > budget
    # staged unless the families that would share tiles average over half a
    # stage: then every tile is direct, and cut only every `fams` families
    small = int(nf - big.sum())
    staged_mode = (small > 0 and all(g is not None for g in gaps)
                   and all(st.aligned for st in strands)
                   and int(weight[~big].sum()) * fams <= small * budget)

    # cuts: every `fams` families; in staged mode, also wherever a run's
    # byte count passes a multiple of the budget, and around every big
    # family, which takes a direct tile of its own
    cut = np.zeros(nf + 1, bool)
    cut[::fams] = True
    cut[nf] = True
    if staged_mode:
        cw = np.cumsum(weight) - weight
        part = (cw - cw[np.arange(0, nf, fams).repeat(fams)[:nf]]) // budget
        cut[1:nf] |= part[1:] != part[:-1]
        idx = np.flatnonzero(big)
        cut[idx] = True
        cut[idx + 1] = True
    cuts = np.flatnonzero(cut)
    f0 = cuts[:-1]
    staged = np.full(f0.size, staged_mode) & ~big[f0]
    table = _table(strands, f0, cuts[1:], staged, layout, out[nrec:],
                   all(st.contiguous for st in strands))
    return TilePlan(records, table, fams, strands, layout)


def _table(strands, f0, f1, staged, layout, out, contiguous=False) -> np.ndarray:
    """The tile table of tiles ``[f0, f1)`` in ``out``: each tile's byte
    range per strand (families in row order: from its first family's start
    to its last family's end), staged where ``staged`` allows it and the
    rounded ranges stay inside the planes and fit a stage (for uniform
    tiles, the kernel's ``tile_row``)."""
    table = out[:f0.size * TILE_COLS].reshape(f0.size, TILE_COLS)
    table[:, 0], table[:, 1] = f0, f1
    table[:, 3:] = 0
    last = f1 - 1
    starts = np.stack([st.starts for st in strands])
    sizes = np.stack([st.sizes for st in strands])
    col = lambda k: np.array([[getattr(st, k)] for st in strands])  # noqa: E731
    row_bytes = col("row_bytes")
    lo, hi = starts[:, f0], starts[:, last] + sizes[:, last]
    if contiguous:
        live = hi > lo  # any member row in the tile
    else:
        rows = np.cumsum(sizes, axis=1)
        live = rows[:, last] - rows[:, f0] + sizes[:, f0] > 0
    off = (lo * row_bytes) & -ALIGN
    nbytes = (((hi - 1) * row_bytes + col("width") + ALIGN - 1) & -ALIGN) - off
    staged = staged & ((off + nbytes <= col("extent")) | ~live).all(0)
    staged &= (col("planes") * nbytes * live).sum(0) <= layout.data_bytes
    keep = staged & live
    table[:, 2] = staged
    table[:, 3:3 + 2 * len(strands):2] = (off * keep).T
    table[:, 4:4 + 2 * len(strands):2] = (nbytes * keep).T
    return table
