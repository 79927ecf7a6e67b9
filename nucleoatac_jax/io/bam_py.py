"""Pure-Python BAM scanner — portable fallback for the C++ ingest library.

Replaces the reference's pysam/htslib read path
(reference:pyatac/fragments.py iterating pysam.AlignmentFile — SURVEY.md
§3.1/§3.4). Instead of random-access fetch per peak chunk, the whole
coordinate-sorted BAM is scanned ONCE into per-chromosome sorted fragment
arrays (left, size); peak windows then slice by binary search
(DESIGN.md §10 "pre-binned tensors"). Filters per DESIGN.md §1.
"""
from __future__ import annotations

import gzip
import struct
from typing import Dict, List, Tuple

import numpy as np

from nucleoatac_jax.config import IngestParams

FILTER_OUT = 0x4 | 0x8 | 0x100 | 0x200 | 0x400 | 0x800
REQUIRED = 0x1 | 0x2

# fixed 32-byte alignment record prefix (SAM spec §4.2):
# refID pos l_read_name mapq bin n_cigar_op flag l_seq next_refID next_pos tlen
_FIXED = struct.Struct("<iiBBHHHIiii")


def _read_header(fh) -> Tuple[List[str], List[int]]:
    magic = fh.read(4)
    if magic != b"BAM\x01":
        raise ValueError("not a BAM file")
    (l_text,) = struct.unpack("<i", fh.read(4))
    fh.read(l_text)
    (n_ref,) = struct.unpack("<i", fh.read(4))
    names, lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", fh.read(4))
        names.append(fh.read(l_name)[:-1].decode())
        (l_ref,) = struct.unpack("<i", fh.read(4))
        lengths.append(l_ref)
    return names, lengths


def read_bam_header(path: str) -> Tuple[List[str], List[int]]:
    with gzip.open(path, "rb") as fh:
        return _read_header(fh)


def scan_bam_py(
    path: str, params: IngestParams | None = None
) -> Tuple[List[str], List[int], Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Single streaming pass: returns (ref_names, ref_lengths,
    {chrom: adjusted fragment lefts int32, sorted}, {chrom: adjusted sizes}).
    """
    p = params or IngestParams()
    shift = 4 if p.atac else 0
    shrink = 9 if p.atac else 0
    with gzip.open(path, "rb") as fh:
        names, lengths = _read_header(fh)
        by_ref_left: List[List[int]] = [[] for _ in names]
        by_ref_size: List[List[int]] = [[] for _ in names]
        read = fh.read
        unpack4 = struct.Struct("<i").unpack
        fixed = _FIXED.unpack_from
        while True:
            raw = read(4)
            if len(raw) < 4:
                break
            (block_size,) = unpack4(raw)
            rec = read(block_size)
            if len(rec) < block_size:
                raise ValueError("truncated BAM record")
            (
                ref_id, pos, _lrn, mapq, _bin, _ncig, flag, _lseq,
                _nref, _npos, tlen,
            ) = fixed(rec, 0)
            if ref_id < 0:
                continue
            if (flag & REQUIRED) != REQUIRED or (flag & FILTER_OUT):
                continue
            if tlen <= 0 or mapq < p.min_mapq:
                continue
            size = tlen - shrink
            if size < 1 or size > p.max_size:
                continue
            by_ref_left[ref_id].append(pos + shift)
            by_ref_size[ref_id].append(size)

    lefts: Dict[str, np.ndarray] = {}
    sizes: Dict[str, np.ndarray] = {}
    for i, name in enumerate(names):
        l = np.asarray(by_ref_left[i], dtype=np.int32)
        s = np.asarray(by_ref_size[i], dtype=np.int32)
        order = np.argsort(l, kind="stable")
        lefts[name] = l[order]
        sizes[name] = s[order]
    return names, lengths, lefts, sizes
