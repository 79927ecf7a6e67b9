"""pyatac utility commands: reusable ATAC-seq track/matrix computations.

Rebuild of the reference's `pyatac` tool family (SURVEY.md §3.1 L5:
bias, vplot, bias_vplot, ins, cov, sizes, counts, pwm). These operate on
the pre-scanned fragment index (io/bam.py) with vectorized numpy — the
heavy batched work stays in the nucleoatac stages; these are the thin
utility layer the reference exposes for ad-hoc analysis.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from nucleoatac_jax.config import VMatParams
from nucleoatac_jax.core.chunk import Chunk, ChunkList
from nucleoatac_jax.core.fragmentsizes import FragmentSizes
from nucleoatac_jax.core.pwm import BASE_INDEX, PWM
from nucleoatac_jax.io.bam import BamFragments
from nucleoatac_jax.io.fasta import FastaFile
from nucleoatac_jax.mirror.windows import bias_mat as mirror_bias_mat


def fragment_ends(
    frags: BamFragments, chrom: str, lo: int, hi: int
) -> np.ndarray:
    """All Tn5 insertion positions (both fragment ends) in [lo, hi)."""
    m = frags.mids.get(chrom)
    if m is None or len(m) == 0:
        return np.empty(0, np.int64)
    s = frags.sizes[chrom]
    # cached per-chrom max (a per-call whole-chrom max was O(chrom))
    if not hasattr(frags, "_max_size"):
        frags._max_size = {}
    slop = frags._max_size.get(chrom)
    if slop is None:
        slop = frags._max_size[chrom] = int(s.max()) if len(s) else 0
    a = np.searchsorted(m, lo - slop)
    b = np.searchsorted(m, hi + slop)
    mm, ss = m[a:b].astype(np.int64), s[a:b].astype(np.int64)
    left = mm - (ss - 1) // 2
    right = mm + ss // 2
    ends = np.concatenate([left, right])
    return ends[(ends >= lo) & (ends < hi)]


def insertion_track(frags: BamFragments, chunk: Chunk) -> np.ndarray:
    """Per-bp insertion counts (reference InsertionTrack.calculateInsertions)."""
    ends = fragment_ends(frags, chunk.chrom, chunk.start, chunk.end)
    return np.bincount(ends - chunk.start, minlength=len(chunk)).astype(np.float64)


def coverage_track(
    frags: BamFragments, chunk: Chunk, window: int = 121, lower: int = 0,
    upper: int = 1 << 30,
) -> np.ndarray:
    """Smoothed fragment coverage (reference CoverageTrack): fragments of
    size in [lower, upper) overlapping each bp, then centered moving
    average over ``window`` bp."""
    m, s = frags.window(chunk.chrom, chunk.start - 2000, chunk.end + 2000)
    m = m.astype(np.int64)
    s = s.astype(np.int64)
    keep = (s >= lower) & (s < upper)
    m, s = m[keep], s[keep]
    left = m - (s - 1) // 2 - chunk.start
    right = m + s // 2 - chunk.start
    n = len(chunk)
    diff = np.zeros(n + 1, dtype=np.float64)
    lo = np.clip(left, 0, n)
    hi = np.clip(right + 1, 0, n)
    np.add.at(diff, lo, 1.0)
    np.add.at(diff, hi, -1.0)
    cov = np.cumsum(diff[:-1])
    if window > 1:
        k = np.ones(window) / window
        cov = np.convolve(cov, k, mode="same")
    return cov


def region_counts(frags: BamFragments, chunks: ChunkList) -> np.ndarray:
    """Fragments (by midpoint) per region (reference `pyatac counts`)."""
    return np.array(
        [len(frags.window(c.chrom, c.start, c.end)[0]) for c in chunks], np.int64
    )


def sizes_histogram(
    frags: BamFragments, chunks: Optional[ChunkList], lower: int, upper: int
) -> FragmentSizes:
    fs = FragmentSizes(lower, upper)
    if chunks is None:
        for chrom in frags.ref_names:
            fs.add_sizes(frags.sizes.get(chrom, np.empty(0, np.int32)))
    else:
        for c in chunks:
            fs.add_sizes(frags.window(c.chrom, c.start, c.end)[1])
    return fs


def aggregate_vplot(
    frags: BamFragments,
    features: ChunkList,
    lower: int = 105,
    upper: int = 251,
    flank: int = 73,
) -> np.ndarray:
    """Aggregate V-plot around feature centers, strand-aware
    (reference `pyatac vplot` — SURVEY.md §4.5). Returns
    [upper-lower, 2*flank+1]."""
    W = 2 * flank + 1
    mat = np.zeros((upper - lower, W), dtype=np.float64)
    for c in features:
        center = c.center()
        m, s = frags.window(c.chrom, center - flank, center + flank + 1)
        keep = (s >= lower) & (s < upper)
        m, s = m[keep], s[keep]
        col = m - (center - flank)
        if c.strand == "-":
            col = W - 1 - col
        np.add.at(mat, (s - lower, col), 1)
    return mat


def aggregate_vplot_device(
    frags: BamFragments,
    features: ChunkList,
    lower: int = 105,
    upper: int = 251,
    flank: int = 73,
    batch: int = 256,
) -> np.ndarray:
    """Batched DEVICE aggregation of the V-plot (round-3 VERDICT item 7):
    sites scatter into a [B, S, W] raster on device (ops/rasterize.py —
    the same kernel the main pipeline uses) and reduce there, instead of
    the per-site host loop. Counts are integers, so the result equals
    :func:`aggregate_vplot` exactly (tests/test_pyatac.py).

    Crossover: the host loop costs ~40 us/site; one device batch costs a
    dispatch + fetch, so the device path pays off only for many sites —
    `pyatac vplot --device` opts in; the host path remains the default
    and the oracle."""
    import jax
    import jax.numpy as jnp

    from nucleoatac_jax.ops.rasterize import rasterize_batch

    W = 2 * flank + 1
    sites = []
    cap = 1
    for c in features:
        center = c.center()
        m, s = frags.window(c.chrom, center - flank, center + flank + 1)
        sites.append((m - (center - flank), s, c.strand == "-"))
        cap = max(cap, len(m))
    F = 64
    while F < cap:
        F *= 2

    @jax.jit
    def step(mids, szs, valid, neg):
        mat = rasterize_batch(mids, szs, valid, lower, upper, W)
        mat = jnp.where(neg[:, None, None], mat[:, :, ::-1], mat)
        return mat.sum(axis=0)

    total = np.zeros((upper - lower, W), dtype=np.float64)
    for i in range(0, len(sites), batch):
        group = sites[i : i + batch]
        mids = np.zeros((batch, F), np.int32)
        szs = np.zeros((batch, F), np.int32)
        valid = np.zeros((batch, F), bool)
        neg = np.zeros(batch, bool)
        for r, (m, s, isneg) in enumerate(group):
            mids[r, : len(m)] = m
            szs[r, : len(s)] = s
            valid[r, : len(m)] = True
            neg[r] = isneg
        total += np.asarray(
            step(
                jnp.asarray(mids), jnp.asarray(szs), jnp.asarray(valid),
                jnp.asarray(neg),
            ),
            np.float64,
        )
    return total


def bias_vplot(
    frags: BamFragments,
    fasta: FastaFile,
    pwm: PWM,
    features: ChunkList,
    sizes: FragmentSizes,
    lower: int = 105,
    upper: int = 251,
    flank: int = 73,
) -> np.ndarray:
    """Expected (bias-only) aggregate V-plot (reference `pyatac
    bias_vplot`): per feature, the DESIGN.md §6 bias matrix scaled to the
    feature's observed fragment count, summed over features."""
    from nucleoatac_jax.models.nuc import chunk_log_bias

    W = 2 * flank + 1
    h = sizes.get(lower, upper).astype(np.float64)
    q = h / h.sum() if h.sum() > 0 else np.full_like(h, 1.0 / len(h))
    pad = (upper - 1) // 2 + 1
    out = np.zeros((upper - lower, W), dtype=np.float64)
    for c in features:
        center = c.center()
        lo = center - flank - pad
        hi = center + flank + 1 + pad
        logb = chunk_log_bias(fasta, pwm, c.chrom, lo, hi)
        b0 = mirror_bias_mat(logb, q, lower, upper, pad, pad + W)
        m, s = frags.window(c.chrom, center - flank, center + flank + 1)
        nfrag = int(((s >= lower) & (s < upper)).sum())
        seg = b0[:, pad : pad + W]
        if c.strand == "-":
            seg = seg[:, ::-1]
        out += seg * nfrag
    return out


def track_signal_matrix(
    reader, features: ChunkList, up: int = 250, down: int = 250
) -> np.ndarray:
    """Per-feature signal rows extracted from a (tabixed) bedgraph track
    around feature centers, strand-aware (reference `pyatac signal` ::
    pyatac/get_signal.py [M] — SURVEY.md §3.1 notes the command set is
    [M]-confidence; the mechanism is: fetch track values over
    [center-up, center+down], flip minus-strand rows). Positions the
    track does not cover are NaN. Returns [n_features, up+down+1]."""
    L = up + down + 1
    out = np.full((len(features), L), np.nan, dtype=np.float64)
    for i, c in enumerate(features):
        center = c.center()
        lo, hi = center - up, center + down + 1
        for row in reader.fetch(c.chrom, lo, hi):
            s, e, v = int(row[1]), int(row[2]), float(row[3])
            a = max(s, lo) - lo
            b = min(e, hi) - lo
            if b > a:
                out[i, a:b] = v
        if c.strand == "-":
            out[i] = out[i, ::-1]
    return out


def nucleotide_freq_matrix(
    fasta: FastaFile, features: ChunkList, up: int = 250, down: int = 250
) -> np.ndarray:
    """Nucleotide frequencies per offset around feature centers,
    strand-aware with reverse-complement on minus strand (reference
    `pyatac nucleotide` [M]). Returns [4, up+down+1] (rows ACGT)."""
    L = up + down + 1
    counts = np.zeros((4, L), dtype=np.float64)
    chrom_dict = fasta.get_chrom_dict()
    comp = np.array([3, 2, 1, 0], dtype=np.int64)  # A<->T, C<->G
    for c in features:
        center = c.center()
        lo, hi = center - up, center + down + 1
        clen = chrom_dict.get(c.chrom)
        if clen is None or lo < 0 or hi > clen:
            continue
        seq = fasta.fetch(c.chrom, lo, hi)
        arr = BASE_INDEX[np.frombuffer(seq.encode(), dtype=np.uint8)]
        ok = arr >= 0
        if c.strand == "-":
            arr = np.where(ok, comp[np.clip(arr, 0, 3)], -1)[::-1]
            ok = ok[::-1]
        cols = np.arange(L)[ok]
        counts[arr[ok], cols] += 1.0
    col_sums = counts.sum(axis=0)
    col_sums[col_sums == 0] = 1.0
    return counts / col_sums


def pwm_from_data(
    frags: BamFragments,
    fasta: FastaFile,
    chunks: Optional[ChunkList] = None,
    up: int = 9,
    down: int = 9,
    max_insertions: int = 1_000_000,
) -> PWM:
    """Nucleotide frequencies around observed insertion centers
    (reference `pyatac pwm`)."""
    L = up + down + 1
    counts = np.zeros((4, L), dtype=np.float64)
    regions = (
        [(c.chrom, c.start, c.end) for c in chunks]
        if chunks is not None
        else [(n, 0, l) for n, l in zip(fasta.references, fasta.lengths)]
    )
    total = 0
    for chrom, lo, hi in regions:
        if total >= max_insertions:
            break
        ends = fragment_ends(frags, chrom, lo + up, hi - down)
        if len(ends) == 0:
            continue
        ends = ends[: max_insertions - total]
        total += len(ends)
        seq = fasta.fetch(chrom, 0, fasta.get_chrom_dict()[chrom])
        arr = BASE_INDEX[np.frombuffer(seq.encode(), dtype=np.uint8)]
        for col in range(L):
            k = col - up
            vals = arr[ends + k]
            ok = vals >= 0
            counts[:, col] += np.bincount(vals[ok], minlength=4)
    col_sums = counts.sum(axis=0)
    col_sums[col_sums == 0] = 1.0
    return PWM(counts / col_sums, up)
