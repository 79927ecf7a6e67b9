"""`nucleoatac merge`: combine template dyad calls with occ-only peaks.

Rebuild of reference:nucleoatac/merge.py :: run_merge (SURVEY.md §3.2):
keep every nucpos call; add occ peaks farther than ``sep`` from all
nucpos dyads on the same chromosome (robust at occupancy saturation where
the V-plot signal washes out). DESIGN.md §8.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional

import numpy as np

from nucleoatac_jax.io.tabix import TabixWriter
from nucleoatac_jax.models.nuc import NucCall
from nucleoatac_jax.models.occ import OccPeak


@dataclass
class CombinedEntry:
    chrom: str
    pos: int
    score: float
    source: str  # "nuc" | "occ"


def merge_maps(
    nuc_calls: Iterable[NucCall],
    occ_peaks: Iterable[OccPeak],
    sep: int,
    out_path: Optional[str] = None,
) -> List[CombinedEntry]:
    entries = [CombinedEntry(c.chrom, c.pos, c.z, "nuc") for c in nuc_calls]
    by_chrom = {}
    for e in entries:
        by_chrom.setdefault(e.chrom, []).append(e.pos)
    # per-chrom arrays built ONCE (a per-peak np.asarray of the full
    # chrom dyad list was O(dyads) per occ peak — ~35 s at config-4)
    by_chrom = {k: np.sort(np.asarray(v, np.int64)) for k, v in by_chrom.items()}
    for p in occ_peaks:
        arr = by_chrom.get(p.chrom)
        if arr is not None and len(arr):
            i = int(np.searchsorted(arr, p.pos))
            near = min(
                abs(int(arr[j]) - p.pos)
                for j in (max(0, i - 1), min(len(arr) - 1, i))
            )
            if near <= sep:
                continue
        entries.append(CombinedEntry(p.chrom, p.pos, p.occ, "occ"))
    entries.sort(key=lambda e: (e.chrom, e.pos))
    if out_path:
        with TabixWriter(out_path) as w:
            for e in entries:
                w.add(
                    e.chrom, e.pos, e.pos + 1,
                    f"{e.chrom}\t{e.pos}\t{e.pos + 1}\t{e.score:.5g}\t{e.source}",
                )
    return entries
