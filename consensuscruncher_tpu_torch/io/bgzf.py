"""BGZF (Blocked GNU Zip Format) codec — the container framing of BAM files.

First-party implementation: this environment has no pysam/htslib, so the
framework ships its own codec (reference parity: the htslib layer under
pysam, SURVEY.md §2 "Native components").  A native C++ hot path lives in
``io/native`` (ctypes-loaded); this module is the pure-Python fallback and the
single place that defines the framing.

Format (htslib SAM spec §4.1): a BGZF file is a series of gzip members, each
at most 64 KiB of payload, carrying a ``BC`` extra subfield whose 16-bit value
``BSIZE`` is (total block length - 1).  The file ends with a fixed 28-byte
empty block (EOF marker).  Because every block is a valid gzip member, plain
``gzip`` tools can read BGZF — but not vice versa, so the writer here always
emits real blocks + EOF marker for htslib compatibility.
"""

from __future__ import annotations

import functools
import io
import os
import struct
import sys
import threading
import time
import zlib
from typing import BinaryIO, Iterator

import numpy as np

from consensuscruncher_tpu_torch.io import native

MAX_BLOCK_PAYLOAD = 0xFF00  # htslib convention: keep compressed block < 64 KiB


class TruncatedBgzfError(ValueError):
    """The stream ended mid-block: the file was cut short (died-mid-copy
    upload, full disk, killed writer).  Distinct from generic corruption so
    callers can offer salvage — re-reading with ``salvage=True`` recovers
    every record up to the last intact block instead of raising."""


def _salvage_warn(context: str) -> None:
    print(f"WARNING: {context}; salvaging records up to the last intact "
          "BGZF block", file=sys.stderr, flush=True)

BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")

_TAIL = struct.Struct("<2I")  # CRC32, ISIZE


def _is_pathlike(x) -> bool:
    return isinstance(x, (str, bytes, os.PathLike))


def _block_header(block_size: int) -> bytes:
    return struct.pack(
        "<4BIBBHBBHH",
        0x1F, 0x8B, 0x08, 0x04,  # gzip magic, deflate, FEXTRA
        0,                        # mtime
        0, 0xFF,                  # XFL, OS=unknown
        6,                        # XLEN
        0x42, 0x43, 2,            # 'B', 'C', SLEN=2
        block_size - 1,           # BSIZE
    )


def compress_block(payload: bytes, level: int = 6) -> bytes:
    """One payload of at most MAX_BLOCK_PAYLOAD bytes -> one complete BGZF block.

    The cap leaves headroom for deflate's worst-case expansion on
    incompressible data: compressed size + 26 framing bytes must fit the
    16-bit BSIZE field (htslib uses the same 0xFF00 payload bound).
    """
    if len(payload) > MAX_BLOCK_PAYLOAD:
        raise ValueError(
            f"BGZF payload too large: {len(payload)} > {MAX_BLOCK_PAYLOAD} "
            "(incompressible data must still fit the 16-bit BSIZE field)"
        )
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    data = comp.compress(payload) + comp.flush()
    block_size = len(data) + 26  # 18 header + data + 8 tail
    return _block_header(block_size) + data + _TAIL.pack(zlib.crc32(payload), len(payload))


def read_block(fh: BinaryIO) -> bytes | None:
    """Read ONE BGZF block from ``fh``: decompressed payload (b"" for empty
    blocks, e.g. the EOF marker), or None at clean EOF.  Validates framing +
    CRC exactly like :func:`iter_blocks` (which is built on this)."""
    header = fh.read(18)
    if len(header) == 0:
        return None  # clean EOF (tolerated even without the marker block)
    if len(header) < 18:
        raise TruncatedBgzfError("truncated BGZF block header")
    if header[0] != 0x1F or header[1] != 0x8B:
        raise ValueError("not a BGZF/gzip stream (bad magic)")
    if header[3] & 0x04 == 0:
        raise ValueError("gzip member lacks the BGZF BC extra subfield")
    # Scan the extra field for the BC subfield (SAM spec §4.1 allows other
    # subfields alongside it, so the 18-byte fast layout is not assumed).
    (xlen,) = struct.unpack_from("<H", header, 10)
    extra = header[12:18]
    if xlen > 6:
        extra += fh.read(xlen - 6)
        if len(extra) < xlen:
            raise TruncatedBgzfError("truncated BGZF extra field")
    bsize = None
    off = 0
    while off + 4 <= xlen:
        si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from("<H", extra, off + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            (bsize,) = struct.unpack_from("<H", extra, off + 4)
            break
        off += 4 + slen
    if bsize is None:
        raise ValueError("gzip member lacks the BGZF BC extra subfield")
    block_size = bsize + 1
    consumed = 12 + xlen
    rest = fh.read(block_size - consumed)
    if len(rest) < block_size - consumed:
        raise TruncatedBgzfError("truncated BGZF block")
    data, (crc, isize) = rest[:-8], _TAIL.unpack(rest[-8:])
    payload = zlib.decompress(data, -15) if isize else b""
    if len(payload) != isize:
        raise ValueError(f"BGZF ISIZE mismatch: {len(payload)} != {isize}")
    if zlib.crc32(payload) != crc:
        raise ValueError("BGZF CRC mismatch")
    return payload


def iter_blocks(fh: BinaryIO, salvage: bool = False) -> Iterator[bytes]:
    """Yield decompressed payloads block by block, validating framing + CRC.

    ``salvage=True``: a truncated/corrupt block ends iteration with a
    warning instead of raising — every intact leading block is served."""
    while True:
        try:
            payload = read_block(fh)
        except ValueError as e:
            if not salvage:
                raise
            _salvage_warn(str(e))
            return
        if payload is None:
            return
        if payload:
            yield payload


def scan_block_metas(buf: bytes, tolerant: bool = False) -> tuple[tuple, int]:
    """Scan complete BGZF blocks at the head of ``buf`` (framing only).

    Returns ``((src_off, comp_len, isize, crc), consumed)`` where the four
    uint arrays describe each complete block's raw-deflate span and expected
    payload, and ``consumed`` is the byte offset of the first incomplete
    block (callers carry the tail into the next scan).  Raises ValueError on
    malformed framing — the same conditions ``iter_blocks`` rejects — unless
    ``tolerant``, which stops the scan there instead (salvage mode).
    """
    offs, lens, sizes, crcs = [], [], [], []
    pos, end = 0, len(buf)
    while True:
        if pos + 18 > end:
            break
        if buf[pos] != 0x1F or buf[pos + 1] != 0x8B:
            if tolerant:
                break
            raise ValueError("not a BGZF/gzip stream (bad magic)")
        if buf[pos + 3] & 0x04 == 0:
            if tolerant:
                break
            raise ValueError("gzip member lacks the BGZF BC extra subfield")
        (xlen,) = struct.unpack_from("<H", buf, pos + 10)
        if pos + 12 + xlen > end:
            break
        bsize = None
        off = pos + 12
        while off + 4 <= pos + 12 + xlen:
            si1, si2, slen = buf[off], buf[off + 1], struct.unpack_from("<H", buf, off + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                (bsize,) = struct.unpack_from("<H", buf, off + 4)
                break
            off += 4 + slen
        if bsize is None:
            if tolerant:
                break
            raise ValueError("gzip member lacks the BGZF BC extra subfield")
        block_size = bsize + 1
        if pos + block_size > end:
            break
        data_off = pos + 12 + xlen
        data_len = block_size - (12 + xlen) - 8
        if data_len < 0:
            if tolerant:
                break
            raise ValueError("corrupt BGZF block (BSIZE smaller than framing)")
        crc, isize = _TAIL.unpack_from(buf, pos + block_size - 8)
        offs.append(data_off)
        lens.append(data_len)
        sizes.append(isize)
        crcs.append(crc)
        pos += block_size
    metas = (
        np.asarray(offs, dtype=np.uint64),
        np.asarray(lens, dtype=np.uint32),
        np.asarray(sizes, dtype=np.uint32),
        np.asarray(crcs, dtype=np.uint32),
    )
    return metas, pos


# --------------------------------------------------------------- knobs
#
# config.ini ``[io]`` values land here via :func:`configure` (the CLI
# folds them in before any writer is built).  Environment variables
# still win so operators can override a config file per-invocation.
_cfg: dict[str, object] = {"threads": None, "async_write": None}

# ---------------------------------------------------------- write stats
#
# Process-wide accumulator for what the writer layer actually spent:
# wall microseconds inside deflate+compressed-write and compressed bytes
# emitted (EOF markers included).  A run snapshots it before and after
# and publishes the difference (``run.metrics.json``) without threading a
# stats object through every writer construction site.  Lock-protected
# because async writers deflate on worker threads.
# ``_caller`` is the other side: the wall a CALLING thread spent in
# ``io.deflate`` spans (a sorted BGZF write with its wait on the
# write-behind worker), kept per thread, so a run reports its own thread's
# deflate wall (``run.metrics.json``'s ``deflate_wall_s``).
_stats_lock = threading.Lock()
_stats = {"deflate_wall_us": 0, "bytes_written": 0}
_caller = threading.local()


def _stats_add(wall_us: int, nbytes: int) -> None:
    with _stats_lock:
        _stats["deflate_wall_us"] += int(wall_us)
        _stats["bytes_written"] += int(nbytes)


def add_caller_wall(wall_us: int) -> None:
    """Count ``wall_us`` microseconds this thread spent in an ``io.deflate``
    span."""
    _caller.us = getattr(_caller, "us", 0) + int(wall_us)


def caller_wall_us() -> int:
    """Microseconds this thread has spent in ``io.deflate`` spans."""
    return getattr(_caller, "us", 0)


def write_stats() -> dict[str, int]:
    """Snapshot of the process-wide writer stats (cumulative; callers
    diff two snapshots to attribute cost to a code region)."""
    with _stats_lock:
        return dict(_stats)


def configure(threads: int | None = None, async_write: bool | None = None) -> None:
    """Fold config-file ``[io]`` knobs into the codec defaults.

    ``threads``: deflate pool size (native pthread pool AND the pure-
    Python block pool); ``async_write``: default for the writer's
    background deflate thread.  CCT_BGZF_THREADS / CCT_ASYNC_WRITER
    environment overrides still win over values set here.
    """
    global _python_pool_obj
    with _python_pool_lock:
        if threads is not None:
            _cfg["threads"] = max(0, int(threads))
            if _python_pool_obj is not None:
                _python_pool_obj.shutdown(wait=False)
                _python_pool_obj = None
        if async_write is not None:
            _cfg["async_write"] = bool(async_write)


def codec_threads() -> int:
    """Worker threads for the deflate pools (native per-batch pthread
    pool and the pure-Python per-block thread pool).

    Blocks within one batch compress/decompress independently, so output
    bytes are IDENTICAL at any pool size — threads are pure wall-clock
    leverage on multi-core hosts (zlib is the single largest host cost
    after the columnar passes).
    Default: cpu_count-1 capped at 8; 0 (inline) on single-core hosts.
    Override with CCT_BGZF_THREADS (wins) or config.ini ``[io]
    bgzf_threads`` via :func:`configure`.
    """
    env = os.environ.get("CCT_BGZF_THREADS")
    if env:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    if _cfg["threads"] is not None:
        return int(_cfg["threads"])  # type: ignore[arg-type]
    n = os.cpu_count() or 1
    return 0 if n <= 1 else min(8, n - 1)


# Shared pure-Python deflate pool: per-block compression is order-
# independent (writeback below is ordered), so one process-wide pool
# serves every writer.  Created lazily; resized by dropping it when
# :func:`configure` changes the thread count.
_python_pool_lock = threading.Lock()
_python_pool_obj = None


def _python_pool():
    n = codec_threads()
    if n <= 1:
        return None
    global _python_pool_obj
    with _python_pool_lock:
        if _python_pool_obj is None:
            from concurrent.futures import ThreadPoolExecutor
            _python_pool_obj = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="bgzf-deflate")
        return _python_pool_obj


_NATIVE_READ_CHUNK = 8 << 20  # compressed bytes per native inflate batch


def _iter_native_batches(fh: BinaryIO,
                         salvage: bool = False) -> Iterator[tuple[int, tuple, bytes]]:
    """Yield ``(base_offset, metas, payload)`` per native inflate batch:
    ``metas`` is the :func:`scan_block_metas` tuple for the batch's blocks
    (offsets relative to ``base_offset``) and ``payload`` their concatenated
    decompressed bytes.  The single native read loop — every consumer of
    batch inflation goes through here so framing/tail handling lives once.
    ``salvage=True``: a truncated or corrupt tail ends iteration (with a
    warning) after every intact leading block has been served."""
    base = fh.tell()
    tail = b""
    while True:
        metas, consumed = scan_block_metas(tail, tolerant=salvage)
        while consumed == 0:
            more = fh.read(_NATIVE_READ_CHUNK)
            if not more:
                if tail:
                    if salvage:
                        _salvage_warn("truncated BGZF block at EOF")
                        return
                    raise TruncatedBgzfError("truncated BGZF block")
                return
            tail += more
            metas, consumed = scan_block_metas(tail, tolerant=salvage)
        try:
            payload = native.inflate_blocks(tail, *metas, n_threads=codec_threads())
        except Exception as e:
            if not salvage:
                raise
            # Inflate the batch block-by-block instead, keeping every block
            # up to the first bad one — the best a cut/corrupt file allows.
            offs, lens, sizes, crcs = metas
            goods = []
            for k in range(len(sizes)):
                span = tail[int(offs[k]): int(offs[k]) + int(lens[k])]
                try:
                    p = zlib.decompress(span, -15) if int(sizes[k]) else b""
                except zlib.error:
                    break
                if len(p) != int(sizes[k]) or zlib.crc32(p) != int(crcs[k]):
                    break
                goods.append(p)
            _salvage_warn(f"BGZF batch inflate failed ({e}); "
                          f"kept {len(goods)}/{len(sizes)} block(s)")
            if goods:
                yield base, tuple(m[:len(goods)] for m in metas), b"".join(goods)
            return
        yield base, metas, payload
        base += consumed
        tail = tail[consumed:]


def _iter_chunks_native(fh: BinaryIO, salvage: bool = False) -> Iterator[bytes]:
    """Yield decompressed chunks via the native batch codec (multi-block)."""
    for _base, _metas, payload in _iter_native_batches(fh, salvage=salvage):
        if payload:
            yield payload


def iter_blocks_with_offsets(fh: BinaryIO) -> Iterator[tuple[int, bytes]]:
    """Yield ``(file_offset, payload)`` per BGZF block — the shape indexers
    need (virtual offsets are built from block starts).  Uses the native
    batch codec when available, else the per-block Python path."""
    if not native.available():
        while True:
            off = fh.tell()
            payload = read_block(fh)
            if payload is None:
                return
            yield off, payload
        return
    for base, metas, payload in _iter_native_batches(fh):
        data_offs, comp_lens, isizes, _crcs = metas
        # Block k starts where k-1 ended: data_off points at the raw-deflate
        # span, so start_{k+1} = data_off_k + comp_len_k + 8 (CRC + ISIZE
        # tail); start_0 = 0 within the batch window.
        u = 0
        start = 0
        for k in range(len(isizes)):
            size = int(isizes[k])
            yield base + start, payload[u : u + size]
            u += size
            start = int(data_offs[k]) + int(comp_lens[k]) + 8


class BgzfReader(io.RawIOBase):
    """File-like sequential reader over BGZF blocks.

    When the native C++ codec (``io/native``) is available, blocks are
    inflated in parallel batches; otherwise the pure-Python ``iter_blocks``
    path serves identical bytes.
    """

    def __init__(self, path_or_fh, start_voffset: int | None = None,
                 salvage: bool = False):
        """``start_voffset``: begin mid-file at a BAI virtual offset
        (``coffset << 16 | within``) — seek to the block boundary and
        discard the intra-block prefix.  The caller owns pointing at a
        record boundary (BAI offsets do).  ``salvage``: serve bytes up to
        the last intact block of a truncated file instead of raising
        :class:`TruncatedBgzfError`."""
        self._own = _is_pathlike(path_or_fh)
        self._fh = open(path_or_fh, "rb") if self._own else path_or_fh
        if start_voffset is not None:
            self._fh.seek(start_voffset >> 16)
        if native.available():
            self._blocks = _iter_chunks_native(self._fh, salvage=salvage)
        else:
            self._blocks = iter_blocks(self._fh, salvage=salvage)
        self._buf = b""
        self._pos = 0
        if start_voffset is not None and start_voffset & 0xFFFF:
            self.read(start_voffset & 0xFFFF)

    def readable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        chunks = []
        if n < 0:
            chunks.append(self._buf[self._pos:])
            self._buf, self._pos = b"", 0
            for payload in self._blocks:
                chunks.append(payload)
            return b"".join(chunks)
        need = n
        while need > 0:
            avail = len(self._buf) - self._pos
            if avail == 0:
                nxt = next(self._blocks, None)
                if nxt is None:
                    break
                self._buf, self._pos = nxt, 0
                continue
            take = min(avail, need)
            chunks.append(self._buf[self._pos : self._pos + take])
            self._pos += take
            need -= take
        return b"".join(chunks)

    def close(self) -> None:
        if self._own:
            self._fh.close()
        super().close()


_NATIVE_WRITE_TARGET = 4 << 20  # payload bytes buffered per native deflate batch


def async_write_default() -> bool:
    """Should BgzfWriter offload deflate+write to a worker thread?

    Overlapping output compression with the stage loop is free throughput
    wherever the producing thread spends time in GIL-releasing work (device
    dispatch/waits, native codec legs, numpy passes) — on the multi-core
    deployment target that is most of the pipeline.  On
    a single-core host the deflate contends for the same core, so default
    off there.  Override with CCT_ASYNC_WRITER=0/1 (wins) or config.ini
    ``[io] async_writer`` via :func:`configure`.
    """
    env = os.environ.get("CCT_ASYNC_WRITER")
    if env in ("0", "1"):
        return env == "1"
    if _cfg["async_write"] is not None:
        return bool(_cfg["async_write"])
    return (os.cpu_count() or 1) > 1


class BgzfWriter(io.RawIOBase):
    """File-like writer that emits proper BGZF blocks + EOF marker on close.

    With the native C++ codec available, payload is buffered and deflated in
    parallel multi-block batches; block boundaries (every MAX_BLOCK_PAYLOAD
    bytes) match the pure-Python path, so both produce the same block
    STRUCTURE and decompressed content.  Compressed bytes are codec-
    specific: the native codec links libdeflate when the build host has it
    (a different, equally valid DEFLATE producer than zlib), so cross-codec
    byte identity is NOT a contract — within one run every output is
    written by one codec, and goldens canonicalize content.

    ``async_write`` (default: :func:`async_write_default`) moves the
    deflate+file-write onto a single worker thread behind a bounded queue:
    the producer never blocks on compression (until the queue is full), and
    because ONE worker consumes chunks in enqueue order with the same block
    boundaries and level, the output bytes are identical in every mode.
    """

    _QUEUE_CHUNKS = 8  # bound: ~8 x 4 MiB payload in flight per writer

    def __init__(self, path_or_fh, level: int = 6, collect_blocks: bool = False,
                 async_write: bool | None = None):
        self._own = _is_pathlike(path_or_fh)
        self._fh = open(path_or_fh, "wb") if self._own else path_or_fh
        self._level = level
        self._buf = bytearray()
        self._native = native.available()
        # When asked, record every payload block's COMPRESSED byte length in
        # write order (payload lengths are implied: MAX_BLOCK_PAYLOAD for
        # all but the final block).  The inline BAI builder turns these into
        # virtual offsets without ever re-reading the file.
        self.block_sizes: list[int] | None = [] if collect_blocks else None
        self._eof_written = False
        self._queue = None
        self._worker = None
        self._worker_err: BaseException | None = None
        if async_write if async_write is not None else async_write_default():
            import queue as _queue
            import threading

            self._queue = _queue.Queue(maxsize=self._QUEUE_CHUNKS)
            self._worker = threading.Thread(
                target=self._drain, name="bgzf-writer", daemon=True)
            self._worker.start()

    def writable(self) -> bool:
        return True

    # -- worker thread ----------------------------------------------------
    def _drain(self) -> None:
        while True:
            payload = self._queue.get()
            if payload is None:
                return
            try:
                # A failed writer is POISONED: once any payload errored,
                # every later payload is dropped — writing past a hole
                # would produce a structurally-valid file with silently
                # missing middle bytes.
                if self._worker_err is None:
                    self._deflate_and_write(payload)
            except BaseException as e:  # sticky; surfaced on write()/close()
                self._worker_err = e
            finally:
                self._queue.task_done()

    def _raise_worker_err(self) -> None:
        if self._worker_err is not None:
            raise RuntimeError(
                "BGZF writer worker failed; output is truncated"
            ) from self._worker_err

    # -- deflate (runs on the worker thread when async, else inline) ------
    def _deflate_and_write(self, payload: bytes) -> None:
        # the elapsed wall feeds the write stats only, never output bytes
        t0 = time.perf_counter_ns()
        nbytes = 0
        if self._native:
            threads = codec_threads()
            if self.block_sizes is not None:
                data, sizes = native.deflate_payload_sizes(payload, self._level,
                                                           threads)
                self.block_sizes.extend(sizes)
            else:
                data = native.deflate_payload(payload, self._level, threads)
            self._fh.write(data)
            nbytes = len(data)
        else:
            # Per-block deflate is embarrassingly parallel AND bit-
            # reproducible: each block is an independent zlib stream at a
            # fixed level, and writeback below preserves enqueue order, so
            # the output bytes are identical at any pool size (same
            # guarantee the native batch codec makes).
            chunks = [payload[off:off + MAX_BLOCK_PAYLOAD]
                      for off in range(0, len(payload), MAX_BLOCK_PAYLOAD)]
            pool = _python_pool() if len(chunks) > 1 else None
            if pool is not None:
                blocks = list(pool.map(
                    functools.partial(compress_block, level=self._level), chunks))
            else:
                blocks = [compress_block(c, self._level) for c in chunks]
            for block in blocks:
                if self.block_sizes is not None:
                    self.block_sizes.append(len(block))
                self._fh.write(block)
                nbytes += len(block)
        _stats_add((time.perf_counter_ns() - t0) // 1000, nbytes)

    def _emit(self, size: int) -> None:
        payload, self._buf = bytes(self._buf[:size]), self._buf[size:]
        if self._queue is not None:
            self._raise_worker_err()
            self._queue.put(payload)
        else:
            self._deflate_and_write(payload)

    def write(self, data) -> int:
        self._buf += data
        target = _NATIVE_WRITE_TARGET if (self._native or self._queue is not None) \
            else MAX_BLOCK_PAYLOAD
        if len(self._buf) >= target:
            n_full = (len(self._buf) // MAX_BLOCK_PAYLOAD) * MAX_BLOCK_PAYLOAD
            self._emit(n_full)
        return len(data)

    def close(self) -> None:
        # Idempotent by construction: ``super().close()`` is guaranteed to
        # run on the FIRST attempt (nested finally below), so ``closed``
        # sticks even when flushing or the fh close raises — a retry-close
        # after a fault-site trip is a no-op instead of stamping a valid
        # EOF marker onto a truncated stream, and a clean double close
        # emits the marker exactly once.
        if self.closed:
            return
        try:
            if self._buf:
                payload, self._buf = bytes(self._buf), bytearray()
                if self._queue is not None:
                    self._queue.put(payload)  # worker drops it if poisoned
                else:
                    self._deflate_and_write(payload)
            if self._worker is not None:
                self._queue.put(None)
                self._worker.join()
                self._worker = None
            if self._worker_err is not None:
                # Never stamp a valid EOF marker onto a truncated stream.
                self._raise_worker_err()
            if not self._eof_written:
                self._fh.write(BGZF_EOF)
                self._eof_written = True
                _stats_add(0, len(BGZF_EOF))
        finally:
            try:
                if self._own:
                    self._fh.close()
            finally:
                super().close()



def total_isize(path) -> int:
    """Total uncompressed size of a BGZF file by framing hops alone: each
    block's header is parsed as :func:`read_block` parses it (the BC
    subfield may sit anywhere in the extra field), the deflate payload is
    skipped and the 4-byte ISIZE tail read; nothing is inflated."""
    total = 0
    with open(path, "rb") as fh:
        while True:
            header = fh.read(18)
            if not header:
                return total
            if len(header) < 18 or header[0] != 0x1F or header[1] != 0x8B:
                raise ValueError(f"{os.fspath(path)!r}: bad BGZF framing")
            (xlen,) = struct.unpack_from("<H", header, 10)
            extra = header[12:18]
            if xlen > 6:
                extra += fh.read(xlen - 6)
                if len(extra) < xlen:
                    raise TruncatedBgzfError(f"{os.fspath(path)!r}: truncated BGZF extra field")
            bsize = None
            off = 0
            while off + 4 <= xlen:
                (slen,) = struct.unpack_from("<H", extra, off + 2)
                if extra[off] == 0x42 and extra[off + 1] == 0x43 and slen == 2:
                    (bsize,) = struct.unpack_from("<H", extra, off + 4)
                    break
                off += 4 + slen
            if bsize is None:
                raise ValueError(f"{os.fspath(path)!r}: gzip member lacks the BGZF BC subfield")
            # consumed so far: 12 fixed bytes + xlen extra; ISIZE is the last 4
            fh.seek(bsize + 1 - 12 - xlen - 4, 1)
            isize = fh.read(4)
            if len(isize) < 4:
                raise TruncatedBgzfError(f"{os.fspath(path)!r}: truncated BGZF block")
            total += struct.unpack("<I", isize)[0]


def decompress_file(path) -> bytes:
    """A whole BGZF file's uncompressed bytes (small files, tests)."""
    with open(path, "rb") as fh:
        return b"".join(iter_blocks(fh))
