"""`nucleoatac nfr`: nucleosome-free region calling.

Rebuild of reference:nucleoatac/NFRCalling.py :: NFRChunk/NFR +
run_nfr.py (SURVEY.md §4.4): candidate gaps between adjacent combined-map
dyads inside each peak chunk (and chunk-edge gaps), kept where the
occupancy upper CI bound stays low; stats = mean occ, max occ upper,
insertion density, mean bias (DESIGN.md §8). Host logic — O(calls), not
O(bp) — over device-produced occupancy tracks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from nucleoatac_jax.config import RunConfig
from nucleoatac_jax.core.chunk import Chunk, ChunkList
from nucleoatac_jax.core.pwm import PWM
from nucleoatac_jax.io.bam import BamFragments
from nucleoatac_jax.io.fasta import FastaFile
from nucleoatac_jax.io.tabix import TabixWriter
from nucleoatac_jax.models.merge import CombinedEntry
from nucleoatac_jax.models.nuc import chunk_log_bias


@dataclass
class NFR:
    chrom: str
    start: int
    end: int
    mean_occ: float
    max_occ_upper: float
    ins_density: float
    mean_bias: float

    def bed_row(self) -> str:
        return (
            f"{self.chrom}\t{self.start}\t{self.end}\t{self.mean_occ:.5g}\t"
            f"{self.max_occ_upper:.5g}\t{self.ins_density:.5g}\t{self.mean_bias:.5g}"
        )


def _longest_true_run(ok: np.ndarray, offset: int) -> tuple[int, int]:
    """Longest contiguous True run; returns genomic (start, end) given the
    genomic position of ok[0]. (offset, offset) if no True."""
    if not ok.any():
        return offset, offset
    padded = np.concatenate([[False], ok, [False]])
    d = np.diff(padded.astype(np.int8))
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    i = int(np.argmax(ends - starts))
    return offset + int(starts[i]), offset + int(ends[i])


def call_nfrs(
    cfg: RunConfig,
    chunks: ChunkList,
    combined: Sequence[CombinedEntry],
    occ_tracks,  # Mapping cid -> {occ, lower, upper}; .get(cid) may be lazy
    frags: BamFragments,
    pwm: Optional[PWM] = None,
    fasta: Optional[FastaFile] = None,
    out_path: Optional[str] = None,
    bias_fn: Optional[Callable[[str, int, int], np.ndarray]] = None,
) -> List[NFR]:
    p = cfg.nfr
    pwm = pwm or PWM.default()
    if bias_fn is None:
        bias_fn = lambda chrom, lo, hi: chunk_log_bias(  # noqa: E731
            fasta, pwm, chrom, lo, hi
        )
    by_chrom: Dict[str, np.ndarray] = {}
    for e in combined:
        by_chrom.setdefault(e.chrom, []).append(e.pos)
    by_chrom = {k: np.sort(np.asarray(v, np.int64)) for k, v in by_chrom.items()}
    _empty = np.zeros(0, np.int64)

    # per-chunk log-bias computed once and sliced per NFR (a per-NFR
    # bias_fn call paid a FASTA fetch + PWM scan each — ~20 s at config-4
    # scale for ~58k NFRs)
    _bias_cache: Dict[int, np.ndarray] = {}

    def chunk_bias(cid: int, chunk: Chunk) -> np.ndarray:
        b = _bias_cache.get(cid)
        if b is None:
            b = bias_fn(chunk.chrom, chunk.start, chunk.end)
            _bias_cache.clear()  # keep at most one chunk resident
            _bias_cache[cid] = b
        return b

    out: List[NFR] = []
    for cid, chunk in enumerate(chunks):
        tr = occ_tracks.get(cid)
        if tr is None:
            continue
        occ, upper = tr["occ"], tr["upper"]
        cd = by_chrom.get(chunk.chrom, _empty)
        dyads = cd[np.searchsorted(cd, chunk.start) : np.searchsorted(cd, chunk.end)]
        # candidate gaps: chunk edges + nucleosome-excluded zones
        cands = []
        prev_end = chunk.start
        for d in dyads:
            cands.append((prev_end, d - p.nuc_half))
            prev_end = d + p.nuc_half + 1
        cands.append((prev_end, chunk.end))
        for s, e in cands:
            s = max(s, chunk.start)
            e = min(e, chunk.end)
            if e - s < p.min_nfr_len:
                continue
            # trim to the longest run with occ upper bound below threshold
            # (DESIGN.md §8: gap edges still feel the neighbor nucleosome)
            i0, i1 = s - chunk.start, e - chunk.start
            ok = upper[i0:i1] < p.max_occ_upper
            s, e = _longest_true_run(ok, s)
            ln = e - s
            if ln < p.min_nfr_len or ln > p.max_nfr_len:
                continue
            i0, i1 = s - chunk.start, e - chunk.start
            max_up = float(upper[i0:i1].max()) if i1 > i0 else 1.0
            mean_occ = float(occ[i0:i1].mean())
            ins = frags.insertions_in(chunk.chrom, s, e)
            logb = chunk_bias(cid, chunk)[i0:i1]
            out.append(
                NFR(
                    chunk.chrom, s, e, mean_occ, max_up,
                    ins / ln, float(np.exp(logb).mean()),
                )
            )
    out.sort(key=lambda n: (n.chrom, n.start))
    if out_path:
        with TabixWriter(out_path) as w:
            for n in out:
                w.add(n.chrom, n.start, n.end, n.bed_row())
    return out
