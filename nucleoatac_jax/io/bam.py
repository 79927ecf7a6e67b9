"""BAM ingest front-end: native C++ scanner with pure-Python fallback.

The reference's ingest substrate is pysam/htslib (SURVEY.md §3.4 item 2);
here a single streaming scan produces per-chromosome fragment tensors
(DESIGN.md §10). ``scan_bam`` prefers the C++ library
(io/native/libnucio.so, built by io/native/Makefile) and falls back to
the pure-Python scanner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from nucleoatac_jax.config import IngestParams


@dataclass
class BamFragments:
    """Per-chromosome adjusted fragments, sorted by midpoint."""

    ref_names: List[str]
    ref_lengths: List[int]
    # int64 mids: np.searchsorted against an int32 haystack with a
    # python-int (int64) needle PROMOTES — i.e. copies — the whole chrom
    # array per call (~300 us at 500k frags; measured round 4). Every
    # window lookup in the pipeline searches this array, so the dtype is
    # the performance contract.
    mids: Dict[str, np.ndarray]  # int64, sorted ascending
    sizes: Dict[str, np.ndarray]  # int32, co-indexed with mids

    @property
    def chrom_dict(self) -> Dict[str, int]:
        return dict(zip(self.ref_names, self.ref_lengths))

    def n_fragments(self) -> int:
        return sum(len(v) for v in self.mids.values())

    def window(self, chrom: str, lo: int, hi: int):
        """Fragments with midpoint in [lo, hi): (mids int64, sizes int32)."""
        m = self.mids.get(chrom)
        if m is None or len(m) == 0:
            return np.empty(0, np.int64), np.empty(0, np.int32)
        a = np.searchsorted(m, lo, side="left")
        b = np.searchsorted(m, hi, side="left")
        return m[a:b], self.sizes[chrom][a:b]

    def insertions_in(self, chrom: str, lo: int, hi: int) -> int:
        """Number of Tn5 insertion ends falling in [lo, hi): both fragment
        ends counted (DESIGN.md §8 NFR insertion density).

        Slices FIRST (binary search with a cached per-chrom max-size
        slop), then computes ends on the slice only — the old whole-chrom
        end arrays + per-call s.max() made this O(chrom) per call, which
        was 129 s of the 188 s config-4 nfr stage (~58k calls)."""
        m = self.mids.get(chrom)
        if m is None or len(m) == 0:
            return 0
        s = self.sizes[chrom]
        if not hasattr(self, "_max_size"):
            self._max_size = {}
        slop = self._max_size.get(chrom)
        if slop is None:
            slop = self._max_size[chrom] = int(s.max()) if len(s) else 0
        a = np.searchsorted(m, lo - slop, side="left")
        b = np.searchsorted(m, hi + slop, side="left")
        mm = m[a:b]
        ss = s[a:b].astype(np.int64)
        li = mm - (ss - 1) // 2
        ri = mm + ss // 2
        return int(((li >= lo) & (li < hi)).sum() + ((ri >= lo) & (ri < hi)).sum())


def _to_mid_sorted(lefts: Dict[str, np.ndarray], sizes: Dict[str, np.ndarray]):
    mids: Dict[str, np.ndarray] = {}
    out_sizes: Dict[str, np.ndarray] = {}
    for chrom, l in lefts.items():
        s = sizes[chrom]
        m = l + (s - 1) // 2
        order = np.argsort(m, kind="stable")
        mids[chrom] = m[order].astype(np.int64)
        out_sizes[chrom] = s[order].astype(np.int32)
    return mids, out_sizes


def scan_bam(path: str, params: IngestParams | None = None) -> BamFragments:
    params = params or IngestParams()
    from nucleoatac_jax.io.bam_py import scan_bam_py

    try:
        from nucleoatac_jax.io.native.binding import scan_bam_native
    except ImportError:  # io.native.load has logged the missing library
        names, lengths, lefts, sizes = scan_bam_py(path, params)
    else:
        try:
            names, lengths, lefts, sizes = scan_bam_native(path, params)
        except OSError as e:
            from nucleoatac_jax.utils.logging import log

            log.warning("libnucio.so scan failed, using the Python "
                        "scanner: %s", e)
            names, lengths, lefts, sizes = scan_bam_py(path, params)
    mids, msizes = _to_mid_sorted(lefts, sizes)
    return BamFragments(list(names), list(lengths), mids, msizes)
