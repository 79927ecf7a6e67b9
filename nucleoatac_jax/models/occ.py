"""`nucleoatac occ` stage: per-bp occupancy + CI tracks and occ peaks.

Rebuild of reference:nucleoatac/run_occ.py :: run_occ (SURVEY.md §4.1):
fit the fragment-size mixture genome-wide, then batched device windows
instead of a multiprocessing pool, with genome-ordered bedgraph/BED
writers (bgzip+tabix).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from nucleoatac_jax.config import RunConfig
from nucleoatac_jax.core.chunk import Chunk, ChunkList
from nucleoatac_jax.core.fragmentsizes import FragmentSizes
from nucleoatac_jax.core.mixture import FragmentMixDistribution
from nucleoatac_jax.io.bam import BamFragments
from nucleoatac_jax.io.tabix import TabixWriter
from nucleoatac_jax.models.data import (
    make_batches,
    make_delta_batches,
    make_dense_batches,
    make_packed_batches,
    tile_chunks,
)
from nucleoatac_jax.models.engine import DeviceEngine
from nucleoatac_jax.utils.numerics import greedy_select_fast, local_max_candidates_fast


@dataclass
class OccPeak:
    chrom: str
    pos: int  # dyad-like center position
    occ: float
    lower: float
    upper: float


@dataclass
class OccStageResult:
    mix: FragmentMixDistribution
    fragmentsizes: FragmentSizes
    # per-chunk dense tracks, keyed by chunk index in the merged ChunkList.
    # NOTE (library callers): after `run_pipeline` these are the PRINTED
    # surface — values re-read from the 5-decimal bedgraphs just written
    # (_LazyOccTracks), in BOTH the fused and two-pass paths, so that the
    # NFR stage consumes one occ surface everywhere (the reference's nfr
    # also reads the bedgraph, not process memory). Standalone
    # OccStage.run(keep_tracks=True) keeps full-precision in-memory
    # tracks. (ADVICE r3 documentation item.)
    tracks: Dict[int, Dict[str, np.ndarray]] = field(default_factory=dict)
    peaks: List[OccPeak] = field(default_factory=list)
    chunks: Optional[ChunkList] = None


def fit_mixture(
    frags: BamFragments, chunks: ChunkList, cfg: RunConfig
) -> Tuple[FragmentSizes, FragmentMixDistribution]:
    """Genome-wide (peak-restricted) fragment-size histogram + mixture fit
    (reference: FragmentSizes.calculateSizes + FragmentMixDistribution
    .fitDists)."""
    fs = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper)
    for c in chunks:
        _, sizes = frags.window(c.chrom, c.start, c.end)
        fs.add_sizes(sizes)
    mix = FragmentMixDistribution(
        cfg.sizes.lower, cfg.sizes.upper, cfg.mixture
    ).fit(fs)
    return fs, mix


def call_occ_peaks(
    chunk: Chunk, occ: np.ndarray, lower: np.ndarray, cfg: RunConfig
) -> List[OccPeak]:
    """DESIGN.md §4: local maxima of occ (±occ_sep//2) where the CI lower
    bound clears min_occ; greedy by occ with min separation occ_sep."""
    p = cfg.occ
    mask = lower >= p.min_occ
    cand = local_max_candidates_fast(occ, p.occ_sep // 2, mask)
    sel = greedy_select_fast(occ, cand, p.occ_sep)
    return [
        OccPeak(chunk.chrom, chunk.start + i, float(occ[i]), float(lower[i]), float(0))
        for i in sel
    ]


def _pipelined(batches, dispatch, depth: int = 3, fetch_threads: int = 0):
    """Keep ``depth`` batches in flight: dispatch batch i+depth and START
    its device->host copy (copy_to_host_async) before materializing batch
    i's results, so device work and copies overlap the host's handling of
    earlier batches — the device analogue of the reference's
    worker/writer overlap (SURVEY.md §3.3 row 2).

    ``fetch_threads > 0`` additionally materializes results through a
    thread pool: N concurrent np.asarray calls on DISTINCT arrays.
    Results still yield in dispatch order; with threads the yielded
    ``out`` leaves are ALREADY-fetched numpy arrays (np.asarray on them
    is a no-op for consumers). Dispatches stay on the caller's thread —
    only fetches fan out."""
    from collections import deque

    import jax

    if fetch_threads > 0:
        from concurrent.futures import ThreadPoolExecutor

        def fetch(out):
            return jax.tree_util.tree_map(
                lambda l: np.asarray(l)
                if hasattr(l, "copy_to_host_async")
                else l,
                out,
            )

        depth = max(depth, fetch_threads + 2)
        with ThreadPoolExecutor(fetch_threads) as ex:
            q = deque()
            for b in batches:
                out = dispatch(b)
                for leaf in jax.tree_util.tree_leaves(out):
                    if hasattr(leaf, "copy_to_host_async"):
                        leaf.copy_to_host_async()
                q.append((b, ex.submit(fetch, out)))
                if len(q) > depth:
                    b0, f = q.popleft()
                    yield b0, f.result()
            while q:
                b0, f = q.popleft()
                yield b0, f.result()
        return

    q = deque()
    for b in batches:
        out = dispatch(b)
        for leaf in jax.tree_util.tree_leaves(out):
            if hasattr(leaf, "copy_to_host_async"):
                leaf.copy_to_host_async()
        q.append((b, out))
        if len(q) > depth:
            yield q.popleft()
    while q:
        yield q.popleft()


class OccStage:
    def __init__(self, cfg: RunConfig, engine: DeviceEngine):
        self.cfg = cfg
        self.engine = engine

    def track_names(self) -> List[str]:
        return ["occ", "lower", "upper"] + (
            ["cert"] if self.cfg.occ.exact else []
        )

    def prepare_exact(self, mix: FragmentMixDistribution) -> None:
        """Float64 host tables for _exact_refinish (also used by the
        fused occ+nuc driver, models/fused.py)."""
        if self.cfg.occ.exact:
            self._m64 = mix.log_mix_table(self.cfg.occ)
            self._grid64 = mix.alpha_grid(self.cfg.occ)
            # Runtime guard on the certification tolerance (ADVICE r4):
            # exact_tol was validated empirically per backend (PARITY.md
            # "Certification tolerances"); a new device generation /
            # XLA version could push |LL_f32 - LL_f64| past it and
            # silently mis-certify. On the first chunks of every run a
            # sample of CERTIFIED positions is recomputed in f64 and must
            # reproduce the device's grid picks exactly — failing loudly
            # beats silently losing exactness. Decremented from finisher
            # worker threads without a lock: a lost decrement only spot-
            # checks an extra chunk.
            self._spot_chunks = 8

    def run(
        self,
        frags: BamFragments,
        chunks: ChunkList,
        mix: FragmentMixDistribution,
        fragmentsizes: FragmentSizes,
        out_prefix: Optional[str] = None,
        keep_tracks: bool = True,
    ) -> OccStageResult:
        cfg = self.cfg
        eng = self.engine
        result = OccStageResult(mix=mix, fragmentsizes=fragmentsizes, chunks=chunks)

        writers = {}
        if out_prefix:
            writers = {
                "occ": TabixWriter(f"{out_prefix}.occ.bedgraph.gz"),
                "lower": TabixWriter(f"{out_prefix}.occ.lower_bound.bedgraph.gz"),
                "upper": TabixWriter(f"{out_prefix}.occ.upper_bound.bedgraph.gz"),
                "peaks": TabixWriter(f"{out_prefix}.occpeaks.bed.gz"),
            }

        tiles = tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat)
        from nucleoatac_jax.models.data import ChunkAssembler

        names = self.track_names()
        self.prepare_exact(mix)
        asm = ChunkAssembler(chunks, names)
        asm.expect(tiles)
        import jax.numpy as jnp

        # Compact download, ONE uint8 array per batch. Exact mode uses wire v4 (engine.occ_step_*_p2: 2 bytes/bp, CI
        # bounds as 4-bit deltas whose overflow routes through the f64
        # refinisher); non-exact mode keeps wire v2 (occ_step_*_c3,
        # 3 bytes/bp, full CI indices — no refinisher to fall back on).
        sfx = "_p2" if cfg.occ.exact else "_c3"
        # the pool wire is a fused-run format; standalone stages fall back
        # to the per-window delta12 upload (same device programs)
        transfer = cfg.window.transfer
        if transfer == "pool":
            transfer = "delta12"
        if transfer == "delta12":
            step = getattr(eng, "occ_step_delta12" + sfx)

            def dispatch(batch):
                return step(jnp.asarray(batch.buf))

            from nucleoatac_jax.models.data import make_delta12_batches

            batches = make_delta12_batches(
                frags, tiles, eng.width, cfg.window.batch
            )
        elif transfer == "delta":
            step = getattr(eng, "occ_step_delta" + sfx)

            def dispatch(batch):
                return step(jnp.asarray(batch.delta))

            batches = make_delta_batches(frags, tiles, eng.width, cfg.window.batch)
        elif transfer == "packed":
            step = getattr(eng, "occ_step_packed" + sfx)

            def dispatch(batch):
                return step(jnp.asarray(batch.packed))

            batches = make_packed_batches(frags, tiles, eng.width, cfg.window.batch)
        elif transfer == "frags":
            step = getattr(eng, "occ_step_packed" + sfx)

            def dispatch(batch):
                s = np.where(batch.valid, batch.sizes, 0).astype(np.int32)
                m = np.where(batch.valid, batch.mids, 0).astype(np.int32)
                return step(jnp.asarray((s << 16) | m))

            batches = make_batches(frags, tiles, eng.width, cfg.window.batch)
        else:
            step = getattr(eng, "occ_step" + sfx)

            def dispatch(batch):
                return step(jnp.asarray(batch.mats))  # int16

            batches = make_dense_batches(
                frags, tiles, eng.width, cfg.window.batch,
                cfg.sizes.lower, cfg.sizes.upper,
            )
        # multi-buffered (depth 3): later batches run/copy while the host
        # assembles. Occupancy values live on the discrete alpha grid; the
        # wire carries grid INDICES, decoded here with the f64 grid —
        # lossless
        grid64 = mix.alpha_grid(cfg.occ)

        for batch, out in _pipelined(
            batches, dispatch,
            fetch_threads=cfg.window.fetch_threads,
        ):
            raw = np.asarray(out, np.int64)
            if cfg.occ.exact:  # wire v4: [B, 2, core]
                idx, cert_b = eng.decode_occ2(raw)
                cert = cert_b.astype(np.float64)
            else:  # wire v2: [B, 3, core]
                idx = raw & 0x7F
                cert = (raw[:, 0] >> 7).astype(np.float64)
            occ_b = grid64[idx[:, 0]]
            lo_b = grid64[idx[:, 1]]
            up_b = grid64[idx[:, 2]]
            for r, t in enumerate(batch.meta):
                # arrays are core-only: column 0 == t.core_start
                vals = {"occ": occ_b[r], "lower": lo_b[r], "upper": up_b[r]}
                if cfg.occ.exact:
                    vals["cert"] = cert[r]
                for cid, chunk, tracks in asm.add(t, vals, 0):
                    if cfg.occ.exact:
                        self._exact_refinish(chunk, tracks, frags)
                    peaks = self._finish_chunk(chunk, tracks, writers)
                    result.peaks.extend(peaks)
                    if keep_tracks:
                        result.tracks[cid] = tracks

        for w in writers.values():
            w.close()
        return result

    def _exact_refinish(self, chunk: Chunk, tracks, frags: BamFragments) -> None:
        """Re-finish uncertified positions in float64 (DESIGN.md §4).

        Device f32 LL surfaces select the same discrete grid values as
        the f64 mirror except at near-ties; the device bounds the
        distance to the nearest tie and sets the `cert` flag when both
        the argmax and CI-boundary margins clear exact_tol
        (ops/occupancy.py :: occupancy_packed), so certified positions
        are provably f64-equal and only the rest (rare) are recomputed
        here from raw fragment windows — integer counts, so the f64
        finishing step is deterministic and mirror-identical."""
        cert = tracks.pop("cert")
        flagged = np.flatnonzero(cert < 0.5)
        if getattr(self, "_spot_chunks", 0) > 0:
            self._spot_chunks -= 1
            self._spot_check(chunk, tracks, frags, np.flatnonzero(cert >= 0.5))
        if len(flagged) == 0:
            return
        occ_v, lo_v, up_v = self._f64_picks(chunk, flagged, frags)
        tracks["occ"][flagged] = occ_v
        tracks["lower"][flagged] = lo_v
        tracks["upper"][flagged] = up_v

    def _f64_picks(self, chunk: Chunk, positions: np.ndarray, frags: BamFragments):
        """Float64 occ/lower/upper grid values at chunk-relative positions.
        One chunk-wide fragment fetch + vectorized per-window histograms
        (the per-position python loop this replaces dominated the occ
        stage wall time at realistic flag rates). The LL is computed as
        `counts_f64 @ M64` — the same operation and summation order as
        the f64 mirror's per-window `cnt @ M64`, so grid picks stay
        mirror-identical."""
        cfg = self.cfg
        p0 = cfg.occ
        lower, upper = cfg.sizes.lower, cfg.sizes.upper
        S = upper - lower
        M64, grid64 = self._m64, self._grid64
        G = len(grid64)
        m, s = frags.window(
            chunk.chrom, chunk.start - p0.flank, chunk.end + p0.flank + 1
        )
        keep = (s >= lower) & (s < upper)
        m, s = m[keep], s[keep]
        pos_abs = chunk.start + positions
        lo = np.searchsorted(m, pos_abs - p0.flank)
        hi = np.searchsorted(m, pos_abs + p0.flank + 1)
        # Dedup identical fragment windows (round 5): at low coverage,
        # runs of adjacent positions see the same [lo, hi) fragment
        # slice — and low coverage is exactly where most positions are
        # flagged — so compute each distinct window once and fan the
        # grid picks back out (measured ~3x on the sparse synth).
        key = lo.astype(np.int64) * (np.int64(len(m)) + 1) + hi
        _, ui, inv = np.unique(key, return_index=True, return_inverse=True)
        lo, hi = lo[ui], hi[ui]
        tot = hi - lo
        P = len(ui)
        counts = np.zeros((P, S), np.float64)
        if tot.sum() > 0:
            rows = np.repeat(np.arange(P), tot)
            offs = np.arange(tot.sum()) - np.repeat(np.cumsum(tot) - tot, tot)
            cols = s[np.repeat(lo, tot) + offs] - lower
            np.add.at(counts, (rows, cols), 1.0)
        ll = counts @ M64  # [P, G] float64
        best = np.argmax(ll, axis=1)
        ok = ll >= (ll[np.arange(P), best] - p0.ci_drop)[:, None]
        first = np.argmax(ok, axis=1)
        last = G - 1 - np.argmax(ok[:, ::-1], axis=1)
        empty = tot == 0
        return (
            np.where(empty, 0.0, grid64[best])[inv],
            np.where(empty, 0.0, grid64[first])[inv],
            np.where(empty, 1.0, grid64[last])[inv],
        )

    def _spot_check(
        self, chunk: Chunk, tracks, frags: BamFragments, certified: np.ndarray
    ) -> None:
        """Recompute a sample of device-CERTIFIED positions in f64 and fail
        loudly if any grid pick differs — a live guard that occ.exact_tol
        (validated per backend offline) still holds on THIS backend
        (ADVICE r4)."""
        if len(certified) == 0:
            return
        sample = certified[:: max(1, len(certified) // 32)][:32]
        occ_v, lo_v, up_v = self._f64_picks(chunk, sample, frags)
        for name, want in (("occ", occ_v), ("lower", lo_v), ("upper", up_v)):
            got = tracks[name][sample]
            bad = np.flatnonzero(got != want)
            if len(bad):
                i = int(bad[0])
                raise RuntimeError(
                    f"occ certification spot-check FAILED at "
                    f"{chunk.chrom}:{chunk.start + int(sample[i])} "
                    f"({name}: device {got[i]!r} != f64 {want[i]!r}). "
                    "The device f32 LL error on this backend exceeds "
                    f"occ.exact_tol={self.cfg.occ.exact_tol}; re-measure "
                    "the error on this backend (chip_smoke.py phase b, "
                    "nucleoatac_jax/models/selfcheck.py) and raise "
                    "exact_tol."
                )

    def _finish_chunk(self, chunk: Chunk, tracks, writers) -> List[OccPeak]:
        peaks, payloads = self.compute_chunk(
            chunk, tracks, want_payloads=bool(writers)
        )
        self.emit_chunk(chunk, peaks, payloads, writers)
        return peaks

    def compute_chunk(self, chunk: Chunk, tracks, want_payloads):
        """Thread-safe compute phase (see NucStage.compute_chunk): peak
        calling + pre-formatted track payloads; no shared mutable state."""
        from nucleoatac_jax.io.tabix import prepare_bedgraph

        cfg = self.cfg
        occ, lo, up = tracks["occ"], tracks["lower"], tracks["upper"]
        peaks_raw = call_occ_peaks(chunk, occ, lo, cfg)
        peaks = [
            OccPeak(p.chrom, p.pos, p.occ,
                    float(lo[p.pos - chunk.start]), float(up[p.pos - chunk.start]))
            for p in peaks_raw
        ]
        payloads = None
        if want_payloads:
            payloads = {
                name: prepare_bedgraph(chunk.chrom, chunk.start, arr)
                for name, arr in (("occ", occ), ("lower", lo), ("upper", up))
            }
            flank = cfg.occ.flank
            rows = []
            for p in peaks:
                s = max(0, p.pos - flank)
                e = p.pos + flank + 1
                rows.append((
                    s, e,
                    f"{p.chrom}\t{s}\t{e}\t{p.occ:.5g}\t{p.lower:.5g}\t"
                    f"{p.upper:.5g}",
                ))
            payloads["peaks"] = rows
        return peaks, payloads

    def emit_chunk(self, chunk: Chunk, peaks, payloads, writers) -> None:
        if not writers:
            return
        for name in ("occ", "lower", "upper"):
            writers[name].add_prepared(chunk.chrom, payloads[name])
        rows = payloads["peaks"]
        writers["peaks"].add_many(
            chunk.chrom, [r[0] for r in rows], [r[1] for r in rows],
            [r[2] for r in rows],
        )
