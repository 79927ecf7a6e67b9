"""ctypes binding for libnucio.so (see nucio.cpp for the C ABI)."""
from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Tuple

import numpy as np

from nucleoatac_jax.config import IngestParams
from nucleoatac_jax.io.native import load

_lib = load("nucio")
if _lib is None:
    raise ImportError("libnucio.so unavailable")

_lib.nucio_scan_bam.restype = ctypes.c_void_p
_lib.nucio_scan_bam.argtypes = [
    ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
]
_lib.nucio_error.restype = ctypes.c_char_p
_lib.nucio_error.argtypes = [ctypes.c_void_p]
_lib.nucio_n_refs.restype = ctypes.c_int
_lib.nucio_n_refs.argtypes = [ctypes.c_void_p]
_lib.nucio_ref_name.restype = ctypes.c_char_p
_lib.nucio_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
_lib.nucio_ref_len.restype = ctypes.c_long
_lib.nucio_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
_lib.nucio_n_frags.restype = ctypes.c_long
_lib.nucio_n_frags.argtypes = [ctypes.c_void_p, ctypes.c_int]
_lib.nucio_copy_frags.argtypes = [
    ctypes.c_void_p, ctypes.c_int,
    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
]
_lib.nucio_free.argtypes = [ctypes.c_void_p]
try:
    _lib.nucio_encode_delta.restype = ctypes.c_int
    _lib.nucio_encode_delta.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    HAS_ENCODE_DELTA = True
except AttributeError:  # stale .so without the symbol
    HAS_ENCODE_DELTA = False

try:
    _lib.nucio_encode_delta12.restype = ctypes.c_int
    _lib.nucio_encode_delta12.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    HAS_ENCODE_DELTA12 = True
except AttributeError:
    HAS_ENCODE_DELTA12 = False

try:
    _lib.nucio_format_bedgraph.restype = ctypes.c_long
    _lib.nucio_format_bedgraph.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_int, ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64),
    ]
    HAS_FORMAT_BEDGRAPH = True
except AttributeError:
    HAS_FORMAT_BEDGRAPH = False


try:
    _lib.nucio_parse_bedgraph.restype = ctypes.c_long
    _lib.nucio_parse_bedgraph.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.c_long, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
    ]
    HAS_PARSE_BEDGRAPH = True
except AttributeError:
    HAS_PARSE_BEDGRAPH = False


def parse_bedgraph_native(buf: bytes, max_lines: int = 1 << 20):
    """C++ bedgraph text parse (nucio.cpp :: nucio_parse_bedgraph).

    Returns (chroms, seg_starts, starts, ends, vals, consumed): line i in
    [seg_starts[k], seg_starts[k+1]) has chrom chroms[k]; ``consumed`` is
    the byte count of complete parsed lines (a trailing partial line is
    the caller's carry-over)."""
    n_est = min(max_lines, buf.count(b"\n") + 1)
    starts = np.empty(n_est, np.int64)
    ends = np.empty(n_est, np.int64)
    vals = np.empty(n_est, np.float64)
    max_breaks = 4096
    breaks = np.empty(max_breaks, np.int64)
    break_offs = np.empty(max_breaks, np.int64)
    nb = ctypes.c_long(0)
    consumed = ctypes.c_long(0)
    n = _lib.nucio_parse_bedgraph(
        buf, len(buf), n_est,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        breaks.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        break_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        max_breaks, ctypes.byref(nb), ctypes.byref(consumed),
    )
    if n < 0:
        raise ValueError("nucio_parse_bedgraph: malformed bedgraph line")
    k = nb.value
    chroms = []
    for off in break_offs[:k]:
        off = int(off)
        chroms.append(buf[off : buf.index(b"\t", off)].decode())
    seg_starts = np.concatenate([breaks[:k], [n]]).astype(np.int64)
    return chroms, seg_starts, starts[:n], ends[:n], vals[:n], consumed.value


def format_bedgraph_native(
    chrom: str, starts: np.ndarray, ends: np.ndarray, vals: np.ndarray,
    decimals: int = 5,
) -> Tuple[bytes, np.ndarray]:
    """C++ bedgraph line blob (nucio.cpp :: nucio_format_bedgraph):
    returns (lines_blob_with_newlines, line_start_offsets[n+1])."""
    n = len(starts)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    cap = n * (len(chrom) + 70) + 64
    buf = ctypes.create_string_buffer(cap)
    offsets = np.empty(n + 1, np.int64)
    w = _lib.nucio_format_bedgraph(
        chrom.encode(),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, decimals, buf, cap,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if w < 0:
        raise ValueError("nucio_format_bedgraph: buffer overflow")
    # string_at copies only the w written bytes (buf.raw would copy and
    # then slice the whole cap)
    return ctypes.string_at(buf, w), offsets


def encode_delta12_native(
    mids: np.ndarray, sizes: np.ndarray, counts: np.ndarray, out: np.ndarray
) -> None:
    """C++ wire-v6 batch encode (nucio.cpp :: nucio_encode_delta12).

    out: ZEROED [B, E//2 + E] uint8 (E even record capacity)."""
    B, F = mids.shape
    # E is derived from the row width; reject a buffer whose width is not
    # exactly 3E/2 before it silently misaligns the size plane (ADVICE r3)
    if out.shape[1] % 3 != 0 or (2 * out.shape[1] // 3) % 2 != 0:
        raise ValueError(
            f"delta12 out width {out.shape[1]} is not 3*E/2 for even E"
        )
    E = 2 * out.shape[1] // 3
    rc = _lib.nucio_encode_delta12(
        mids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, F,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        E,
    )
    if rc == -1:
        raise ValueError(
            f"delta12-encode overflow: a window needs more than {E} "
            "records; raise frag_cap"
        )
    if rc == -2:
        raise ValueError(
            "encode_delta12 requires midpoint-sorted mids >= 0"
        )


def encode_delta_native(
    mids: np.ndarray, sizes: np.ndarray, counts: np.ndarray, out: np.ndarray
) -> None:
    """C++ batch delta-encode (see nucio.cpp :: nucio_encode_delta).

    mids/sizes: [B, F] int32 C-contiguous, window-relative, sorted per
    row; counts: [B] int64 valid fragments per row; out: ZEROED
    [B, n_entries, 2] uint8."""
    B, F = mids.shape
    rc = _lib.nucio_encode_delta(
        mids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, F,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.shape[1],
    )
    if rc == -1:
        raise ValueError(
            f"delta-encode overflow: a window needs more than "
            f"{out.shape[1]} entries; raise frag_cap"
        )
    if rc == -2:
        raise ValueError(
            "encode_delta requires midpoint-sorted mids >= 0"
        )


def scan_bam_native(
    path: str, params: IngestParams, n_threads: int | None = None
) -> Tuple[List[str], List[int], Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    handle = _lib.nucio_scan_bam(
        path.encode(), params.min_mapq, params.max_size,
        1 if params.atac else 0, n_threads,
    )
    try:
        err = _lib.nucio_error(handle)
        if err:
            raise OSError(f"nucio: {err.decode()}: {path}")
        n = _lib.nucio_n_refs(handle)
        names, lengths = [], []
        lefts: Dict[str, np.ndarray] = {}
        sizes: Dict[str, np.ndarray] = {}
        for i in range(n):
            name = _lib.nucio_ref_name(handle, i).decode()
            names.append(name)
            lengths.append(int(_lib.nucio_ref_len(handle, i)))
            m = int(_lib.nucio_n_frags(handle, i))
            l = np.empty(m, dtype=np.int32)
            s = np.empty(m, dtype=np.int32)
            if m:
                _lib.nucio_copy_frags(
                    handle, i,
                    l.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                )
            order = np.argsort(l, kind="stable")
            lefts[name] = l[order]
            sizes[name] = s[order]
        return names, lengths, lefts, sizes
    finally:
        _lib.nucio_free(handle)
