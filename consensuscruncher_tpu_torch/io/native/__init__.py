"""ctypes loader for the native C++ BGZF codec (``bgzf_native.cpp``).

The shared library is compiled lazily with ``g++`` the first time it's
needed and cached in the package's ``_build/`` directory (git-ignored); a
content hash in the cache name
means editing the .cpp (or bumping the ABI) transparently rebuilds.  Every
entry point degrades to the pure-Python codec in ``io/bgzf.py`` when the
toolchain is missing or ``CCT_NO_NATIVE=1`` is set — the native layer is a
throughput optimization, never a correctness dependency.

Public surface:
- ``available()`` — is the native codec usable?
- ``inflate_blocks(src, src_off, comp_len, isize, crc)`` — batch raw-inflate
  with CRC/ISIZE checks (metadata arrays from ``io.bgzf.scan_block_metas``)
- ``deflate_payload(data, level)`` — payload bytes -> framed BGZF blocks
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_ABI_VERSION = 9
_SRC = os.path.join(os.path.dirname(__file__), "bgzf_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "_build")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build_and_load() -> ctypes.CDLL | None:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    cache_dir = _BUILD_DIR
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return None
    so_path = os.path.join(cache_dir, f"bgzf_native-{digest}.so")
    if not os.path.exists(so_path):
        # Everything filesystem/toolchain-shaped is guarded: an unwritable
        # cache dir or missing g++ must degrade to the pure-Python codec,
        # never crash the open (the module's "optional, not a dependency"
        # contract).
        tmp = None
        try:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=cache_dir)
            os.close(fd)
            base = ["g++", "-O3", "-shared", "-fPIC", "-pthread", _SRC,
                    "-o", tmp]
            try:
                # libdeflate first (1.5-2.5x zlib on <=64 KiB BGZF blocks;
                # htslib links it the same way when present) ...
                subprocess.run(base + ["-DUSE_LIBDEFLATE", "-ldeflate", "-lz"],
                               check=True, capture_output=True, timeout=300)
            except (OSError, subprocess.SubprocessError):
                # ... plain zlib otherwise — bit-different compressed bytes,
                # identical decompressed content (goldens canonicalize).
                subprocess.run(base + ["-lz"], check=True,
                               capture_output=True, timeout=300)
            os.replace(tmp, so_path)  # atomic: concurrent builders race benignly
        except (OSError, subprocess.SubprocessError):
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        # A cached .so can carry a DT_NEEDED on libdeflate from a build
        # host that had it while this runtime does not — rebuild once
        # against whatever THIS host links instead of silently running
        # pure-Python forever.
        try:
            os.unlink(so_path)
        except OSError:
            return None
        try:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=cache_dir)
            os.close(fd)
            base = ["g++", "-O3", "-shared", "-fPIC", "-pthread", _SRC,
                    "-o", tmp]
            try:
                subprocess.run(base + ["-DUSE_LIBDEFLATE", "-ldeflate", "-lz"],
                               check=True, capture_output=True, timeout=300)
            except (OSError, subprocess.SubprocessError):
                subprocess.run(base + ["-lz"], check=True,
                               capture_output=True, timeout=300)
            os.replace(tmp, so_path)
            lib = ctypes.CDLL(so_path)
        except (OSError, subprocess.SubprocessError):
            return None
    lib.cct_version.restype = ctypes.c_int
    if lib.cct_version() != _ABI_VERSION:
        return None
    lib.cct_out_stride.restype = ctypes.c_uint32
    lib.cct_inflate_blocks.restype = ctypes.c_int
    lib.cct_inflate_blocks.argtypes = [
        ctypes.c_char_p,                    # src
        ctypes.POINTER(ctypes.c_uint64),    # src_off
        ctypes.POINTER(ctypes.c_uint32),    # comp_len
        ctypes.POINTER(ctypes.c_uint32),    # isize
        ctypes.POINTER(ctypes.c_uint32),    # crc
        ctypes.c_int64,                     # n
        ctypes.c_char_p,                    # out
        ctypes.POINTER(ctypes.c_uint64),    # out_off
        ctypes.c_int32,                     # n_threads
    ]
    lib.cct_deflate_blocks.restype = ctypes.c_int
    lib.cct_deflate_blocks.argtypes = [
        ctypes.c_char_p,                    # payload
        ctypes.c_uint64,                    # payload_len
        ctypes.c_int32,                     # level
        ctypes.c_int32,                     # n_threads
        ctypes.c_char_p,                    # out
        ctypes.POINTER(ctypes.c_uint32),    # out_sizes
    ]
    lib.cct_pack8.restype = ctypes.c_int
    lib.cct_pack8.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.cct_pack4.restype = ctypes.c_int
    lib.cct_pack4.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.cct_byte_counts.restype = None
    lib.cct_byte_counts.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.cct_scan_bam_records.restype = ctypes.c_int64
    lib.cct_scan_bam_records.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.cct_expand_nibbles.restype = None
    lib.cct_expand_nibbles.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.cct_gather_fixed.restype = None
    lib.cct_gather_fixed.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_char_p,
    ]
    lib.cct_copy_runs.restype = None
    lib.cct_copy_runs.argtypes = [
        ctypes.c_char_p,                    # src
        ctypes.POINTER(ctypes.c_int64),     # src_starts (bytes)
        ctypes.c_char_p,                    # dst
        ctypes.POINTER(ctypes.c_int64),     # dst_starts (bytes)
        ctypes.POINTER(ctypes.c_int64),     # lens (bytes)
        ctypes.c_int64,                     # n
    ]
    lib.cct_fill_runs.restype = None
    lib.cct_fill_runs.argtypes = [
        ctypes.c_char_p,                    # dst
        ctypes.POINTER(ctypes.c_int64),     # starts (bytes)
        ctypes.POINTER(ctypes.c_int64),     # lens (bytes)
        ctypes.c_int64,                     # n
        ctypes.c_int32,                     # value
    ]
    lib.cct_equal_range_i64.restype = None
    lib.cct_equal_range_i64.argtypes = [
        ctypes.POINTER(ctypes.c_int64),     # arr (sorted)
        ctypes.POINTER(ctypes.c_int64),     # keys
        ctypes.POINTER(ctypes.c_int64),     # lo0
        ctypes.POINTER(ctypes.c_int64),     # hi0
        ctypes.c_int64,                     # m
        ctypes.POINTER(ctypes.c_int64),     # out_lo
        ctypes.POINTER(ctypes.c_int64),     # out_hi
        ctypes.c_int32,                     # n_threads
    ]
    return lib


def _get() -> ctypes.CDLL | None:
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            if os.environ.get("CCT_NO_NATIVE", "") not in ("", "0"):
                _lib = None
            else:
                _lib = _build_and_load()
            _tried = True
    return _lib


def available() -> bool:
    return _get() is not None


def _as_u32_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _as_u64_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def inflate_blocks(
    src: bytes,
    src_off: np.ndarray,
    comp_len: np.ndarray,
    isize: np.ndarray,
    crc: np.ndarray,
    n_threads: int = 0,
) -> bytes:
    """Inflate a batch of raw-deflate spans of ``src`` (CRC/ISIZE-checked).

    The four metadata arrays come from the Python-side framing scan
    (``io.bgzf.scan_block_metas``).  Returns the concatenated payloads as a
    memoryview (zero-copy over the inflate buffer — callers slice/join it).
    Raises ValueError if any block fails validation.
    """
    lib = _get()
    if lib is None:
        raise RuntimeError("native BGZF codec unavailable")
    n = len(src_off)
    out_off = np.zeros(n, dtype=np.uint64)
    if n > 1:
        np.cumsum(isize[:-1].astype(np.uint64), out=out_off[1:])
    total = int(isize.sum(dtype=np.uint64))
    # np.empty (no zero-fill) + one tobytes copy: ctypes.create_string_buffer
    # memsets and its .raw is pathologically slow at tens of MB.
    out = np.empty(max(total, 1), dtype=np.uint8)
    rc = lib.cct_inflate_blocks(
        src,
        _as_u64_ptr(np.ascontiguousarray(src_off, dtype=np.uint64)),
        _as_u32_ptr(np.ascontiguousarray(comp_len, dtype=np.uint32)),
        _as_u32_ptr(np.ascontiguousarray(isize, dtype=np.uint32)),
        _as_u32_ptr(np.ascontiguousarray(crc, dtype=np.uint32)),
        n,
        out.ctypes.data_as(ctypes.c_char_p),
        _as_u64_ptr(out_off),
        int(n_threads),
    )
    if rc != 0:
        raise ValueError(f"BGZF native inflate failed at block {rc - 1} (bad stream or CRC)")
    return out[:total].data


def _i64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def copy_runs(
    src: np.ndarray,
    src_starts: np.ndarray,
    dst: np.ndarray,
    dst_starts: np.ndarray,
    lens: np.ndarray,
) -> None:
    """``dst[dst_starts[i]:+lens[i]] = src[src_starts[i]:+lens[i]]`` via the
    native memcpy loop.  ``src``/``dst`` are 1-D C-contiguous arrays of the
    same itemsize; offsets/lengths are in ELEMENTS (scaled to bytes here).
    Bounds are validated before the call — the C side trusts its inputs.
    """
    lib = _get()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    n = len(lens)
    if n == 0:
        return
    item = src.dtype.itemsize
    if dst.dtype.itemsize != item or not src.flags.c_contiguous or not dst.flags.c_contiguous:
        raise ValueError("copy_runs needs C-contiguous arrays of equal itemsize")
    ss = np.ascontiguousarray(src_starts, dtype=np.int64)
    ds = np.ascontiguousarray(dst_starts, dtype=np.int64)
    ll = np.ascontiguousarray(lens, dtype=np.int64)
    if len(ss) != n or len(ds) != n:
        raise ValueError("copy_runs: starts/lens length mismatch")
    if ll.min(initial=0) < 0:
        raise ValueError("copy_runs: negative length")
    if n and (
        int((ss + ll).max()) > src.size or int((ds + ll).max()) > dst.size
        or int(ss.min()) < 0 or int(ds.min()) < 0
    ):
        raise ValueError("copy_runs: run out of bounds")
    if item != 1:
        ss, ds, ll = ss * item, ds * item, ll * item
    lib.cct_copy_runs(
        src.ctypes.data_as(ctypes.c_char_p), _i64_ptr(ss),
        dst.ctypes.data_as(ctypes.c_char_p), _i64_ptr(ds),
        _i64_ptr(ll), n,
    )


def byte_counts(data: np.ndarray) -> np.ndarray:
    """256-bin histogram of a uint8 array (one native pass; the np.unique
    replacement for wire-batch codebook discovery)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    data = np.ascontiguousarray(data.reshape(-1), dtype=np.uint8)
    counts = np.zeros(256, dtype=np.int64)
    lib.cct_byte_counts(data.ctypes.data_as(ctypes.c_char_p), data.size, _i64_ptr(counts))
    return counts


def scan_bam_records(chunk, limit: int) -> np.ndarray:
    """Record boundary offsets (n+1 entries) of length-prefixed BAM records
    in ``chunk[:limit]`` — native replacement for the per-record
    struct.unpack loop.  Raises ValueError on a corrupt block_size."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    cap = limit // 36 + 2
    out = np.zeros(cap, dtype=np.int64)
    if isinstance(chunk, np.ndarray):
        chunk = np.ascontiguousarray(chunk, dtype=np.uint8)
        src = chunk.ctypes.data_as(ctypes.c_char_p)
    else:
        src = bytes(chunk) if not isinstance(chunk, bytes) else chunk
    n = lib.cct_scan_bam_records(src, int(limit), _i64_ptr(out), cap)
    if n < 0:
        raise ValueError("corrupt BAM record: block_size < 32")
    return out[: n + 1]


def expand_nibbles(src: np.ndarray, lut2: np.ndarray) -> np.ndarray:
    """Expand each byte of ``src`` into two bytes via a ``(256, 2)`` LUT
    (the BAM seq nibble decode).  Returns a ``(2 * len(src),)`` array."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    src = np.ascontiguousarray(src, dtype=np.uint8)
    lut2 = np.ascontiguousarray(lut2, dtype=np.uint8)
    if lut2.size != 512:
        raise ValueError("lut2 must be (256, 2) bytes")
    out = np.empty(2 * src.size, dtype=np.uint8)
    lib.cct_expand_nibbles(
        src.ctypes.data_as(ctypes.c_char_p), src.size,
        lut2.ctypes.data_as(ctypes.c_char_p), out.ctypes.data_as(ctypes.c_char_p),
    )
    return out


def gather_fixed(src: np.ndarray, off: np.ndarray, width: int) -> np.ndarray:
    """``(n, width)`` byte gather at arbitrary offsets (bounds-checked)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    src = np.ascontiguousarray(src, dtype=np.uint8)
    off = np.ascontiguousarray(off, dtype=np.int64)
    n = off.size
    if n and (int(off.min()) < 0 or int(off.max()) + width > src.size):
        raise ValueError("gather_fixed: offset out of bounds")
    out = np.empty(n * width, dtype=np.uint8)
    lib.cct_gather_fixed(
        src.ctypes.data_as(ctypes.c_char_p), _i64_ptr(off), n, int(width),
        out.ctypes.data_as(ctypes.c_char_p),
    )
    return out.reshape(n, width)


def pack_wire(bases: np.ndarray, quals: np.ndarray, lut: np.ndarray, four_bit: bool) -> np.ndarray:
    """Fused base+qual-index wire pack over flattened last axis.

    ``bases``/``quals``: same-shape uint8 arrays; ``lut``: 256-entry
    qual->codebook-index table (255 = absent).  Returns the packed array
    shaped like the input but with the last axis ``ceil(L/2)`` (4-bit mode)
    or ``L`` (8-bit mode).  Raises ValueError on the same bad inputs as the
    numpy path (base out of bit budget / qual not in codebook) — though
    when a batch contains BOTH defects, which one is reported may differ
    (numpy checks all bases first; the native scan is element-wise).
    """
    lib = _get()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    if bases.shape != quals.shape:
        raise ValueError("bases/quals shape mismatch")
    L = bases.shape[-1]
    b = np.ascontiguousarray(bases.reshape(-1), dtype=np.uint8)
    q = np.ascontiguousarray(quals.reshape(-1), dtype=np.uint8)
    lu = np.ascontiguousarray(lut, dtype=np.uint8)
    if lu.size != 256:
        raise ValueError("lut must have 256 entries")
    n = b.size
    if four_bit:
        if L % 2:
            # pad each row's odd tail with a ZERO nibble (base 0, qual
            # index 0 — byte-identical to pack4's concat-a-zero-nibble).
            # The pad qual must hit LUT index 0 even when the codebook is
            # duplicate-padded (a real qual can map to a later duplicate
            # slot), so route it through a spare byte value pinned to 0.
            rows = b.reshape(-1, L)
            qrows = q.reshape(-1, L)
            nr = rows.shape[0]
            pb = np.zeros((nr, L + 1), np.uint8)
            pq = np.zeros((nr, L + 1), np.uint8)
            pb[:, :L] = rows
            pq[:, :L] = qrows
            # The spare byte must not occur in the data: doctoring lut[v]=0
            # for a value the data contains would silently pack an
            # out-of-codebook qual instead of raising like the numpy path.
            present = byte_counts(q) > 0
            spare = np.nonzero((lu == 255) & ~present)[0]
            if not spare.size:
                # every absent-from-codebook byte occurs in the data ->
                # the data necessarily holds an invalid qual
                raise ValueError("quals not in codebook")
            lu = lu.copy()
            lu[spare[0]] = 0
            pq[:, L] = spare[0]
            pb = pb.reshape(-1)
            pq = pq.reshape(-1)
            out = np.empty(pb.size // 2, np.uint8)
            rc = lib.cct_pack4(
                pb.ctypes.data_as(ctypes.c_char_p), pq.ctypes.data_as(ctypes.c_char_p),
                lu.ctypes.data_as(ctypes.c_char_p), pb.size,
                out.ctypes.data_as(ctypes.c_char_p),
            )
        else:
            out = np.empty((n + 1) // 2, np.uint8)
            rc = lib.cct_pack4(
                b.ctypes.data_as(ctypes.c_char_p), q.ctypes.data_as(ctypes.c_char_p),
                lu.ctypes.data_as(ctypes.c_char_p), n,
                out.ctypes.data_as(ctypes.c_char_p),
            )
        out_l = (L + 1) // 2
    else:
        out = np.empty(n, np.uint8)
        rc = lib.cct_pack8(
            b.ctypes.data_as(ctypes.c_char_p), q.ctypes.data_as(ctypes.c_char_p),
            lu.ctypes.data_as(ctypes.c_char_p), n,
            out.ctypes.data_as(ctypes.c_char_p),
        )
        out_l = L
    if rc == 1:
        raise ValueError("base codes exceed the wire bit budget")
    if rc == 2:
        raise ValueError("quals not in codebook")
    return out.reshape(bases.shape[:-1] + (out_l,))


def fill_runs_native(dst: np.ndarray, starts: np.ndarray, lens: np.ndarray, value: int) -> None:
    """Byte-fill runs of a 1-D contiguous uint8 array with ``value``."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    n = len(lens)
    if n == 0:
        return
    if dst.dtype.itemsize != 1 or not dst.flags.c_contiguous:
        raise ValueError("fill_runs_native needs a contiguous 1-byte-item array")
    ss = np.ascontiguousarray(starts, dtype=np.int64)
    ll = np.ascontiguousarray(lens, dtype=np.int64)
    if ll.min(initial=0) < 0 or (n and (int((ss + ll).max()) > dst.size or int(ss.min()) < 0)):
        raise ValueError("fill_runs_native: run out of bounds")
    if not 0 <= int(value) <= 255:  # numpy fallback raises OverflowError too
        raise OverflowError(f"fill value {value} out of bounds for a byte fill")
    lib.cct_fill_runs(
        dst.ctypes.data_as(ctypes.c_char_p), _i64_ptr(ss), _i64_ptr(ll), n, int(value)
    )


def equal_range_windowed(arr: np.ndarray, keys: np.ndarray,
                         lo0: np.ndarray, hi0: np.ndarray,
                         n_threads: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Per-key equal-range over sorted int64 ``arr``, each key searched only
    within its ``[lo0, hi0)`` window (the aligner's prefix-table bounds).
    Returns ``(lo, hi)`` int64 arrays.  Raises RuntimeError when the native
    library is unavailable — callers keep their vectorized numpy fallback.
    """
    lib = _get()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    a = np.ascontiguousarray(arr, dtype=np.int64)
    k = np.ascontiguousarray(keys, dtype=np.int64)
    lo = np.ascontiguousarray(lo0, dtype=np.int64)
    hi = np.ascontiguousarray(hi0, dtype=np.int64)
    m = len(k)
    out_lo = np.empty(m, np.int64)
    out_hi = np.empty(m, np.int64)
    if m:
        if len(lo) != m or len(hi) != m:
            raise ValueError("equal_range_windowed: window arrays mismatch keys")
        if int(hi.max(initial=0)) > len(a) or int(lo.min(initial=0)) < 0:
            raise ValueError("equal_range_windowed: window out of bounds")
        lib.cct_equal_range_i64(
            _i64_ptr(a), _i64_ptr(k), _i64_ptr(lo), _i64_ptr(hi), m,
            _i64_ptr(out_lo), _i64_ptr(out_hi), int(n_threads))
    return out_lo, out_hi


def deflate_payload_sizes(data: bytes, level: int = 6,
                          n_threads: int = 0) -> tuple[bytes, list[int]]:
    """Compress ``data`` into complete framed BGZF blocks (no EOF marker);
    also return each block's compressed byte length in order (the inline
    BAI builder derives virtual offsets from these)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native BGZF codec unavailable")
    if not data:
        return b"", []
    stride = int(lib.cct_out_stride())
    from consensuscruncher_tpu_torch.io.bgzf import MAX_BLOCK_PAYLOAD

    n_blocks = (len(data) + MAX_BLOCK_PAYLOAD - 1) // MAX_BLOCK_PAYLOAD
    out = np.empty(n_blocks * stride, dtype=np.uint8)
    sizes = np.zeros(n_blocks, dtype=np.uint32)
    rc = lib.cct_deflate_blocks(
        data, len(data), int(level), int(n_threads),
        out.ctypes.data_as(ctypes.c_char_p), _as_u32_ptr(sizes),
    )
    if rc != 0:
        raise ValueError(f"BGZF native deflate failed at block {rc - 1}")
    mv = memoryview(out)
    szs = [int(s) for s in sizes]
    return b"".join(mv[i * stride : i * stride + szs[i]] for i in range(n_blocks)), szs


def deflate_payload(data: bytes, level: int = 6, n_threads: int = 0) -> bytes:
    """Compress ``data`` into complete framed BGZF blocks (no EOF marker)."""
    return deflate_payload_sizes(data, level, n_threads)[0]
