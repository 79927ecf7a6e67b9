"""Minimal BAM writer: synthesize coordinate-sorted paired-end BAMs.

The reference ships real example data (`example/` — SURVEY.md §3.2); that
artifact is unavailable (empty reference mount), so tests and the example
pipeline generate synthetic ATAC-seq data with a known ground truth
through this writer (SURVEY.md §8.2 step 1).
"""
from __future__ import annotations

import struct
from typing import Sequence, Tuple

import numpy as np

from nucleoatac_jax.io.bgzf import BGZFWriter


def write_bam(
    path: str,
    ref_names: Sequence[str],
    ref_lengths: Sequence[int],
    fragments: Sequence[Tuple[int, int, int]],
    read_len: int = 36,
    mapq: int = 60,
) -> None:
    """fragments: (ref_id, left, size) RAW genomic fragments (pre +4/-5);
    emits a proper pair per fragment (trivial <read_len>M CIGAR, a seq
    of A's, read names ``frag<i>`` zero-padded to one width),
    coordinate-sorted. All records have one size, so they are built as
    one numpy structured array."""
    fr = np.asarray(fragments, dtype=np.int64).reshape(-1, 3)
    n = len(fr)
    rid, left, size = fr[:, 0], fr[:, 1], fr[:, 2]
    right = left + size - read_len
    digits = len(str(max(n - 1, 0)))
    l_name = 4 + digits + 1  # "frag" + digits + NUL
    l_seq_bytes = (read_len + 1) // 2
    rec = np.dtype([
        ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
        ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
        ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<u4"),
        ("next_ref_id", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4"),
        ("name", f"S{l_name}"), ("cigar", "<u4"),
        ("seq", "u1", (l_seq_bytes,)), ("qual", "u1", (read_len,)),
    ])
    # mate 1 then mate 2 of each fragment, then a stable coordinate sort
    pos = np.stack([left, right], axis=1).ravel()
    order = np.lexsort((pos, np.repeat(rid, 2)))
    frag = np.repeat(np.arange(n), 2)[order]
    mate2 = (np.arange(2 * n) % 2 == 1)[order]
    recs = np.zeros(2 * n, dtype=rec)
    recs["block_size"] = rec.itemsize - 4
    recs["ref_id"] = recs["next_ref_id"] = np.repeat(rid, 2)[order]
    recs["pos"] = pos[order]
    recs["next_pos"] = np.stack([right, left], axis=1).ravel()[order]
    recs["tlen"] = np.where(mate2, -size[frag], size[frag])
    recs["l_read_name"] = l_name
    recs["mapq"] = mapq
    recs["n_cigar"] = 1
    # paired, proper, mate-reverse, first / paired, proper, reverse, second
    recs["flag"] = np.where(mate2, 0x1 | 0x2 | 0x10 | 0x80,
                            0x1 | 0x2 | 0x20 | 0x40)
    recs["l_seq"] = read_len
    recs["name"] = np.char.add(b"frag", np.char.zfill(
        frag.astype(f"S{digits}"), digits))
    recs["cigar"] = read_len << 4  # M
    recs["seq"] = 0x11  # 'AA' packed (A=1)
    recs["qual"] = 30

    header_text = "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(ref_names, ref_lengths)
    ).encode()
    with BGZFWriter(path) as out:
        out.write(b"BAM\x01")
        out.write(struct.pack("<i", len(header_text)))
        out.write(header_text)
        out.write(struct.pack("<i", len(ref_names)))
        for n, l in zip(ref_names, ref_lengths):
            nz = n.encode() + b"\x00"
            out.write(struct.pack("<i", len(nz)) + nz + struct.pack("<i", l))
        step = max(1, (1 << 20) // rec.itemsize)  # ~1 MB per write
        for i in range(0, len(recs), step):
            out.write(recs[i : i + step].tobytes())
