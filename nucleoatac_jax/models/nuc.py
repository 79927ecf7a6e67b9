"""`nucleoatac nuc` stage: V-plot template dyad calling.

Rebuild of reference:nucleoatac/run_nuc.py :: run_nuc +
NucleosomeCalling.py :: NucChunk.process (SURVEY.md §4.2): per-chunk Tn5
bias track, batched device xcorr scoring (models/engine.nuc_step), host
peak calling per chunk (cross-tile separation preserved), genome-ordered
writers. Output contract: DESIGN.md §7/§11.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from nucleoatac_jax.config import RunConfig
from nucleoatac_jax.core.chunk import Chunk, ChunkList
from nucleoatac_jax.core.pwm import PWM
from nucleoatac_jax.io.bam import BamFragments
from nucleoatac_jax.io.fasta import FastaFile
from nucleoatac_jax.io.tabix import TabixWriter
from nucleoatac_jax.models.data import (
    ChunkAssembler,
    make_batches,
    make_delta_batches,
    make_dense_batches,
    make_packed_batches,
    pack_nibble_codes,
    tile_chunks,
)
from nucleoatac_jax.models.engine import DeviceEngine
from nucleoatac_jax.utils.numerics import greedy_select_fast, local_max_candidates_fast


@dataclass
class NucCall:
    chrom: str
    pos: int
    z: float
    occ: float
    occ_lower: float
    occ_upper: float
    lr: float
    norm_smooth: float
    signal: float
    fuzz: float

    def bed_row(self) -> str:
        return (
            f"{self.chrom}\t{self.pos}\t{self.pos + 1}\t{self.z:.5g}\t"
            f"{self.occ:.5g}\t{self.occ_lower:.5g}\t{self.occ_upper:.5g}\t"
            f"{self.lr:.5g}\t{self.norm_smooth:.5g}\t{self.signal:.5g}\t"
            f"{self.fuzz:.5g}"
        )


@dataclass
class NucStageResult:
    calls: List[NucCall] = field(default_factory=list)
    redundant: List[NucCall] = field(default_factory=list)
    nuc_dist: np.ndarray = field(default_factory=lambda: np.zeros(1001, np.int64))
    tracks: Dict[int, Dict[str, np.ndarray]] = field(default_factory=dict)
    # chunks where a tile's f64 point-resolution workload grew past the
    # bulk threshold and the whole tile's norm track was recomputed in f64
    # (SmoothResolver bulk path — the cost-bounded descendant of the old
    # full-chunk fallback; expected ~0 on representative data,
    # tests/test_exact_nuc.py::test_fast_path_engages)
    n_fallback_chunks: int = 0
    # chunks with at least one sub-margin selection decision settled by
    # f64 point values (cheap; informational)
    n_resolved_chunks: int = 0


def chunk_seq_codes(
    fasta: Optional[FastaFile], chrom: str, lo: int, hi: int
) -> np.ndarray:
    """uint8 base codes (0..3 = ACGT, 4 = N/out-of-genome) over [lo, hi).

    The wire format for on-device PWM bias (ops/pwmseq.py): 4x fewer
    bytes than the f32 log-bias rows it replaces, and the PWM loop moves
    off the host."""
    from nucleoatac_jax.core.pwm import BASE_INDEX

    n = hi - lo
    out = np.full(n, 4, dtype=np.uint8)
    if fasta is None:
        return out
    a = max(0, lo)
    if a >= hi:
        return out
    seq = fasta.fetch(chrom, a, hi)
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    codes = BASE_INDEX[np.frombuffer(seq, dtype=np.uint8)]
    codes = np.where(codes < 0, 4, codes).astype(np.uint8)
    out[a - lo : a - lo + len(codes)] = codes
    return out


class BiasTrackSource:
    """Precomputed per-bp log-bias input (reference: InsertionBiasTrack
    can read a prior bias bedgraph instead of recomputing from FASTA+PWM —
    SURVEY.md §3.1; VERDICT r1 missing item 3). Reads the tabixed
    bedgraph `pyatac bias` writes; positions absent from the track get
    log-bias 0 (uniform)."""

    def __init__(self, path: str):
        from nucleoatac_jax.io.tabix import TabixReader

        self.reader = TabixReader(path)

    def log_bias(self, chrom: str, lo: int, hi: int) -> np.ndarray:
        out = np.zeros(hi - lo, dtype=np.float64)
        if hi <= 0:
            return out
        for f in self.reader.fetch(chrom, max(0, lo), hi):
            s, e, v = int(f[1]), int(f[2]), float(f[3])
            out[max(s, lo) - lo : max(0, min(e, hi) - lo)] = v
        return out


def chunk_log_bias(
    fasta: Optional[FastaFile], pwm: PWM, chrom: str, lo: int, hi: int
) -> np.ndarray:
    """Per-bp log Tn5 bias over [lo, hi); zeros without a FASTA
    (uniform-bias mode, DESIGN.md §5)."""
    n = hi - lo
    if fasta is None:
        return np.zeros(n, dtype=np.float64)
    pad = max(pwm.up, pwm.down)
    s_lo = lo - pad
    seq = fasta.fetch(chrom, max(0, s_lo), hi + pad)
    clip_lo = max(0, s_lo)
    full = np.zeros(hi + pad - s_lo, dtype=np.float64)
    b = pwm.bias_track(seq)
    full[clip_lo - s_lo : clip_lo - s_lo + len(b)] = b
    out = full[lo - s_lo : lo - s_lo + n]
    return out


class SeqCodesProvider:
    """Per-chunk sequence-code cache -> per-batch uint8 code rows (the
    device PWM bias wire format, ops/pwmseq.py). Shared by NucStage and
    the fused occ+nuc driver (models/fused.py)."""

    def __init__(self, fasta, chunks, eng, batch: int):
        self.fasta = fasta
        self.chunks = chunks
        self.eng = eng
        self.batch = batch
        self.cache: Dict[int, np.ndarray] = {}

    def rows(self, metas) -> np.ndarray:
        """[B, W + L - 1] uint8 rows starting at win_start - pwm.up."""
        eng = self.eng
        up = eng.pwm.up
        halo = eng.halo
        wp = eng.seq_codes_width()
        codes = np.full((self.batch, wp), 4, dtype=np.uint8)
        for r, t in enumerate(metas):
            chunk = self.chunks[t.chunk_id]
            if t.chunk_id not in self.cache:
                self.cache[t.chunk_id] = chunk_seq_codes(
                    self.fasta, chunk.chrom,
                    chunk.start - halo - up,
                    chunk.end + halo + eng.width + eng.pwm.down,
                )
            cb = self.cache[t.chunk_id]
            a = (t.win_start - up) - (chunk.start - halo - up)
            seg = cb[max(0, a) : a + wp]
            dst = max(0, -a)
            codes[r, dst : dst + len(seg)] = seg
        # padding rows (batch not full) never reach output; code 0 keeps
        # them off the 2-bit wire's N-escape list (pack_2bit_codes)
        codes[len(metas) :] = 0
        return codes

    def pop(self, cid: int) -> None:
        self.cache.pop(cid, None)


def host_smooth(normm: np.ndarray, margin: int, gk: np.ndarray):
    """[B, core+2*margin] norm rows -> {'norm': [B, core], 'norm_smooth':
    [B, core]} with the smoothed track recomputed on host.

    The device's per-window gaussian smooth at a core position only reads
    norm within ±margin of the core, all present in the margin-extended
    download, so the host convolution sees exactly the data the device
    would — the smooth track costs zero download bytes."""
    B = normm.shape[0]
    sm = np.empty_like(normm)
    for b in range(B):
        sm[b] = np.convolve(normm[b], gk, mode="same")
    sl = slice(margin, normm.shape[1] - margin)
    return {"norm": normm[:, sl], "norm_smooth": sm[:, sl]}


class NucStage:
    def __init__(
        self,
        cfg: RunConfig,
        engine: DeviceEngine,
        pwm: Optional[PWM] = None,
        fasta: Optional[FastaFile] = None,
        bias_source: Optional[BiasTrackSource] = None,
    ):
        self.cfg = cfg
        self.engine = engine
        self.pwm = pwm or PWM.default()
        self.fasta = fasta
        self.bias_source = bias_source
        if bias_source is not None:
            self.bias_fn = bias_source.log_bias
        else:
            self.bias_fn = lambda chrom, lo, hi: chunk_log_bias(
                self.fasta, self.pwm, chrom, lo, hi
            )
        self.refinisher = None
        if cfg.nuc.exact:
            from nucleoatac_jax.models.nuc_exact import NucRefinisher

            self.refinisher = NucRefinisher(
                cfg, engine.vmat, engine.size_probs64, self.pwm, fasta
            )

    def prepare(self, frags: BamFragments, tiles) -> None:
        """Per-run state for refinish position -> window mapping (also
        called by the fused occ+nuc driver, models/fused.py)."""
        self._tiles_by_cid: Dict[int, List] = {}
        for t in tiles:
            self._tiles_by_cid.setdefault(t.chunk_id, []).append(t)
        self._frags = frags
        # per-chunk norm quantization step (wire v5): max u16 scale over
        # the chunk's windows; added to exact_tol in the tie guard
        self._qstep_by_cid: Dict[int, float] = {}

    def note_qstep(self, cid: int, qstep: float) -> None:
        cur = self._qstep_by_cid.get(cid, 0.0)
        if qstep > cur:
            self._qstep_by_cid[cid] = qstep

    def run(
        self,
        frags: BamFragments,
        chunks: ChunkList,
        occ_lookup: Callable[[int, Chunk, int], Tuple[float, float, float]],
        out_prefix: Optional[str] = None,
        keep_tracks: bool = False,
    ) -> NucStageResult:
        """occ_lookup(chunk_id, chunk, genomic_pos) -> (occ, lower, upper)."""
        cfg = self.cfg
        eng = self.engine
        res = NucStageResult()
        writers = {}
        if out_prefix:
            writers = {
                "norm": TabixWriter(f"{out_prefix}.nucleoatac_signal.bedgraph.gz"),
                "smooth": TabixWriter(
                    f"{out_prefix}.nucleoatac_signal.smooth.bedgraph.gz"
                ),
                "pos": TabixWriter(f"{out_prefix}.nucpos.bed.gz"),
                "red": TabixWriter(f"{out_prefix}.nucpos.redundant.bed.gz"),
            }

        tiles = tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat)
        exact = cfg.nuc.exact
        # exact mode downloads only the per-bp tracks that reach output
        # files (norm, norm_smooth, core columns, engine *_c2); the
        # per-dyad stats are refinished in float64 on host
        # (models/nuc_exact.py), halving download bytes on the link that
        # bounds windows/s
        names = (
            ["norm", "norm_smooth"]
            if exact
            else ["norm", "norm_smooth", "signal", "lr", "fuzz"]
        )
        asm = ChunkAssembler(chunks, names)
        asm.expect(tiles)
        halo = eng.halo
        self.prepare(frags, tiles)

        # per-chunk bias caches (chunk extended by halo on both sides)
        bias_cache: Dict[int, np.ndarray] = {}

        import jax.numpy as jnp

        from nucleoatac_jax.models.occ import _pipelined

        def batch_log_bias(batch):
            n_rows = cfg.window.batch
            logb = np.zeros((n_rows, eng.width), dtype=np.float32)
            for r, t in enumerate(batch.meta):
                cid = t.chunk_id
                chunk = chunks[cid]
                if cid not in bias_cache:
                    # span covers EVERY window of the chunk fully (like the
                    # seq-codes path) so last-tile windows see real bias
                    # instead of zero-padding — keeps the device tracks
                    # within exact_tol of the f64 oracle at chunk edges
                    bias_cache[cid] = self.bias_fn(
                        chunk.chrom, chunk.start - halo,
                        chunk.end + halo + eng.width,
                    )
                cb = bias_cache[cid]
                cb_start = chunk.start - halo
                a = t.win_start - cb_start
                seg = cb[a : a + eng.width]
                logb[r, : len(seg)] = seg
            return logb

        # per-chunk sequence-code caches (device PWM bias path)
        seq_provider = SeqCodesProvider(self.fasta, chunks, eng, cfg.window.batch)

        def batch_seq_codes(batch):
            return seq_provider.rows(batch.meta)

        # compact download: ONE array per batch — in exact mode the
        # u16 affine-quantized norm with smooth margins [B, 2*(core+2m)+8]
        # (wire v5, engine._nucm16: the smoothed track is recomputed on
        # host from the decoded norm, host_smooth; the per-window
        # quantization step rides the wire and WIDENS the tie guard's
        # margin threshold below, keeping f64 certification sound) or
        # [B, 5, W] legacy f32 (engine._nuc5).
        sfx = "_m16" if exact else "_c"
        # the pool wire is a fused-run format; standalone stages fall back
        # to the per-window delta12 upload (same device programs)
        transfer = cfg.window.transfer
        if transfer == "pool":
            transfer = "delta12"
        # a precomputed bias track forces the log-bias upload path (the
        # on-device PWM would recompute bias from sequence)
        seq_ok = eng.pwm is not None and self.bias_source is None
        if transfer == "delta12" and seq_ok:
            step = getattr(eng, "nuc_step_delta12_seq" + sfx)

            def dispatch(batch):
                return step(
                    jnp.asarray(batch.buf),
                    jnp.asarray(pack_nibble_codes(batch_seq_codes(batch))),
                )

            from nucleoatac_jax.models.data import make_delta12_batches

            batches = make_delta12_batches(
                frags, tiles, eng.width, cfg.window.batch
            )
        elif transfer == "delta12":
            step = getattr(eng, "nuc_step_delta12" + sfx)

            def dispatch(batch):
                return step(
                    jnp.asarray(batch.buf), jnp.asarray(batch_log_bias(batch))
                )

            from nucleoatac_jax.models.data import make_delta12_batches

            batches = make_delta12_batches(
                frags, tiles, eng.width, cfg.window.batch
            )
        elif transfer == "delta" and seq_ok:
            step = getattr(eng, "nuc_step_delta_seq" + sfx)

            def dispatch(batch):
                return step(
                    jnp.asarray(batch.delta),
                    jnp.asarray(pack_nibble_codes(batch_seq_codes(batch))),
                )

            batches = make_delta_batches(frags, tiles, eng.width, cfg.window.batch)
        elif transfer == "delta":
            step = getattr(eng, "nuc_step_delta" + sfx)

            def dispatch(batch):
                return step(
                    jnp.asarray(batch.delta), jnp.asarray(batch_log_bias(batch))
                )

            batches = make_delta_batches(frags, tiles, eng.width, cfg.window.batch)
        elif transfer == "packed" and seq_ok:
            step = getattr(eng, "nuc_step_packed_seq" + sfx)

            def dispatch(batch):
                return step(
                    jnp.asarray(batch.packed), jnp.asarray(batch_seq_codes(batch))
                )

            batches = make_packed_batches(frags, tiles, eng.width, cfg.window.batch)
        elif transfer == "packed":
            step = getattr(eng, "nuc_step_packed" + sfx)

            def dispatch(batch):
                return step(
                    jnp.asarray(batch.packed), jnp.asarray(batch_log_bias(batch))
                )

            batches = make_packed_batches(frags, tiles, eng.width, cfg.window.batch)
        elif transfer == "frags":
            step = getattr(eng, "nuc_step_frags" + sfx)

            def dispatch(batch):
                return step(
                    jnp.asarray(batch.mids),
                    jnp.asarray(batch.sizes),
                    jnp.asarray(batch.valid),
                    jnp.asarray(batch_log_bias(batch)),
                )

            batches = make_batches(frags, tiles, eng.width, cfg.window.batch)
        else:
            step = getattr(eng, "nuc_step_dense" + sfx)

            def dispatch(batch):
                return step(
                    jnp.asarray(batch.mats), jnp.asarray(batch_log_bias(batch))
                )

            batches = make_dense_batches(
                frags, tiles, eng.width, cfg.window.batch,
                cfg.sizes.lower, cfg.sizes.upper,
            )
        for batch, out in _pipelined(
            batches, dispatch,
            fetch_threads=cfg.window.fetch_threads,
        ):
            if exact:
                # wire v5 decode; qsteps widen the per-chunk tie guard
                normm, qsteps = eng.f32_from_u16(np.asarray(out))
                arrs = host_smooth(
                    normm.astype(np.float64), self.engine.smooth_margin(),
                    self.refinisher.gk,
                )
            else:
                stacked = np.asarray(out, np.float64)  # [B, 5, W]
                arrs = {n: stacked[:, i] for i, n in enumerate(names)}
            for r, t in enumerate(batch.meta):
                if exact:
                    self.note_qstep(t.chunk_id, float(qsteps[r]))
                # exact mode ships core-only columns (col 0 == core_start)
                col = 0 if exact else t.core_start - t.win_start
                vals = {n: arrs[n][r] for n in names}
                for cid, chunk, tracks in asm.add(t, vals, col):
                    bias_cache.pop(cid, None)  # all tiles dispatched; free it
                    seq_provider.pop(cid)
                    self._finish_chunk(cid, chunk, tracks, occ_lookup, writers, res)
                    if keep_tracks:
                        res.tracks[cid] = tracks
        for w in writers.values():
            w.close()
        return res

    def _finish_chunk(self, cid, chunk, tracks, occ_lookup, writers, res) -> None:
        computed = self.compute_chunk(
            cid, chunk, tracks, occ_lookup, want_payloads=bool(writers)
        )
        self.emit_chunk(chunk, computed, writers, res)

    def compute_chunk(self, cid, chunk, tracks, occ_lookup, want_payloads):
        """Thread-safe compute phase of chunk finishing: f64-certified
        selection + pre-formatted writer payloads. Touches no shared
        mutable state (the ordered-parallel finisher in models/fused.py
        runs this on worker threads; the heavy parts — C++ refinisher,
        BLAS, RLE, native formatting — release the GIL)."""
        from nucleoatac_jax.io.tabix import prepare_bedgraph

        stats = NucStageResult()  # counter carrier only
        if self.refinisher is not None:
            calls, red, sel = self._select_exact(
                cid, chunk, tracks, occ_lookup, stats
            )
        else:
            calls, red, sel = self._select_legacy(cid, chunk, tracks, occ_lookup)
        payloads = None
        if want_payloads:
            payloads = {
                "norm": prepare_bedgraph(chunk.chrom, chunk.start, tracks["norm"]),
                "smooth": prepare_bedgraph(
                    chunk.chrom, chunk.start, tracks["norm_smooth"]
                ),
                # pre-formatted call rows: the per-row add() + f-string
                # work runs here on the finish workers instead of the
                # writer-owning main thread (round-5 config-4 timers:
                # emit was 38 s of main-thread wall at 10k peaks)
                "pos": ([c.pos for c in calls], [c.bed_row() for c in calls]),
                "red": ([c.pos for c in red], [c.bed_row() for c in red]),
            }
        return calls, red, sel, stats, payloads

    def emit_chunk(self, chunk, computed, writers, res) -> None:
        """Ordered emit phase: result aggregation + genome-ordered writes
        (single-threaded, writer-owning thread only)."""
        calls, red, sel, stats, payloads = computed
        res.calls.extend(calls)
        res.redundant.extend(red)
        res.n_fallback_chunks += stats.n_fallback_chunks
        res.n_resolved_chunks += stats.n_resolved_chunks
        # adjacent-dyad spacing histogram (reference nuc_dist diagnostics)
        for a, b in zip(sel, sel[1:]):
            d = b - a
            if d < len(res.nuc_dist):
                res.nuc_dist[d] += 1
        if writers:
            writers["norm"].add_prepared(chunk.chrom, payloads["norm"])
            writers["smooth"].add_prepared(chunk.chrom, payloads["smooth"])
            for name in ("pos", "red"):
                starts, lines = payloads[name]
                writers[name].add_many(
                    chunk.chrom, starts, [p + 1 for p in starts], lines
                )

    def _select_legacy(self, cid, chunk, tracks, occ_lookup):
        """Pre-exact flow: per-bp f32 stat tracks from the device
        (cfg.nuc.exact = False)."""
        p = self.cfg.nuc
        norm = tracks["norm"]
        smooth = tracks["norm_smooth"]
        mask = (norm >= p.min_z) & (tracks["lr"] >= p.min_lr)
        cand = local_max_candidates_fast(smooth, p.nuc_sep // 2, mask)
        cand_idx = np.flatnonzero(cand)
        sel = greedy_select_fast(smooth, cand, p.nuc_sep)

        def mk(i: int) -> NucCall:
            occ, lo, up = occ_lookup(cid, chunk, chunk.start + i)
            return NucCall(
                chunk.chrom, chunk.start + i, float(norm[i]), occ, lo, up,
                float(tracks["lr"][i]), float(smooth[i]),
                float(tracks["signal"][i]), float(tracks["fuzz"][i]),
            )

        return [mk(i) for i in sel], [mk(i) for i in cand_idx], sel

    # ---- exact mode (models/nuc_exact.py; VERDICT r1 item 3) -------------
    def _bias64_chunk(self, chunk) -> np.ndarray:
        """Float64 log-bias covering every window of the chunk,
        starting at chunk.start - halo (same sequence span the device
        seq-codes path sees)."""
        halo = self.engine.halo
        return self.bias_fn(
            chunk.chrom, chunk.start - halo,
            chunk.end + halo + self.engine.width,
        )

    def _select_exact(self, cid, chunk, tracks, occ_lookup, res):
        """Exact-mode selection: every decision either certified by an f32
        margin or resolved with f64 POINT values (SmoothResolver) — never a
        full-chunk f64 recompute (round-3 VERDICT item 1: the chunk-global
        tie guard fired on 82% of chunks and dominated end-to-end wall).

        Decision inventory and how each is made f64-exact:
        1. local-maximum status of each plausible position: certified when
           the f32 margin clears 2*tol (pairwise-comparison error bound),
           else each uncertain comparison is settled on f64 smooth values;
        2. candidate thresholds (norm >= min_z, lr >= min_lr): always
           evaluated on f64 stats (_refinish_at);
        3. greedy selection order: candidate score ranks certified by f32
           gaps > 2*tol; near-tie clusters re-ranked on f64 smooth values
           (exact f64 ties break leftmost, same as the f64 mirror).
        """
        cfg = self.cfg
        p = cfg.nuc
        eng = self.engine
        tiles = self._tiles_by_cid.get(cid, [])
        norm32 = tracks["norm"]
        smooth32 = tracks["norm_smooth"]
        # exact_tol bounds |device f32 - f64| per track value; the wire-v5
        # u16 norm adds at most scale/2 on top (engine._u16_impl rounds to
        # nearest: |decode - f32| <= scale/2 exactly; qstep = scale, so
        # qstep/2 is the tight bound — pinned by test_u16_norm_roundtrip —
        # plus a hair for the f32 decode arithmetic). eps2 = 2*tol bounds
        # the error of any COMPARISON between two track values. Widening
        # tol only ever ADDS f64 resolutions.
        tol = (
            p.exact_tol
            + 0.5 * self._qstep_by_cid.pop(cid, 0.0) * (1.0 + 1e-2)
            + 1e-7
        )
        eps2 = 2.0 * tol
        bias64 = None  # built lazily
        W = eng.width
        L = len(smooth32)

        def bias_row(t):
            nonlocal bias64
            if bias64 is None:
                bias64 = self._bias64_chunk(chunk)
            a = t.win_start - (chunk.start - eng.halo)
            return bias64[a : a + W]

        from nucleoatac_jax.models.nuc_exact import SmoothResolver, TileSession
        from nucleoatac_jax.utils.numerics import local_max_margin_fast

        # one prebuilt F/B0 per tile, shared by every f64 query below
        sessions: Dict[int, TileSession] = {}

        def session_for(t_idx: int) -> TileSession:
            s = sessions.get(t_idx)
            if s is None:
                t = tiles[t_idx]
                m, sz = self._frags.window(
                    chunk.chrom, t.win_start, t.win_start + W
                )
                s = TileSession(
                    self.refinisher, m - t.win_start, sz, bias_row(t)
                )
                sessions[t_idx] = s
            return s

        resolver = SmoothResolver(self.refinisher, chunk, tiles, session_for)
        hw = p.nuc_sep // 2

        # 1. local maxima. margin > eps2 -> f64 local max for sure;
        #    margin < -eps2 -> not one; in between AND plausible (f64 norm
        #    could clear min_z) -> resolve the specific comparisons in f64.
        #    Implausible positions can never become candidates (the mask in
        #    step 2 is f64), so their local-max status is irrelevant.
        margin = local_max_margin_fast(smooth32, hw)
        plausible = norm32 >= p.min_z - tol
        lm_mask = plausible & (margin > eps2)
        amb_idx = np.flatnonzero(plausible & (np.abs(margin) <= eps2))
        resolved_any = len(amb_idx) > 0
        if len(amb_idx):
            # competitors whose f32 comparison against i is uncertain
            comps = []
            for i in amb_idx:
                a, b = max(0, i - hw), min(L, i + hw + 1)
                js = np.flatnonzero(smooth32[a:b] >= smooth32[i] - eps2) + a
                comps.append(js[js != i])
            resolver.ensure(np.concatenate([amb_idx, *comps]))
            for i, js in zip(amb_idx, comps):
                si = resolver.at(i)
                # mirror.local_max_candidates semantics: strict > left,
                # >= right (leftmost-of-plateau); certain comparisons
                # (smooth32[j] < smooth32[i] - eps2) hold in f64 a fortiori
                if all(
                    si > resolver.at(j) if j < i else si >= resolver.at(j)
                    for j in js
                ):
                    lm_mask[i] = True
        lm_idx = np.flatnonzero(lm_mask)

        # 2. float64 stats at every local max -> exact candidate mask
        st = self._refinish_at(chunk, tiles, session_for, lm_idx)
        mask64 = (st["norm"] >= p.min_z) & (st["lr"] >= p.min_lr)
        cand_idx = lm_idx[mask64]

        # 3. greedy selection on a certified score ORDER: gaps > eps2 are
        #    f64-safe in f32; near-tie clusters get their true f64 scores
        #    substituted (|f64 - f32| <= tol < any cross-cluster gap, so
        #    the substitution cannot reorder across clusters).
        scores = smooth32[cand_idx].astype(np.float64)
        if len(cand_idx) >= 2:
            order0 = np.argsort(-scores, kind="stable")
            ss = scores[order0]
            tie_runs = np.flatnonzero(-np.diff(ss) <= eps2)
            if len(tie_runs):
                resolved_any = True
                members = np.unique(
                    np.concatenate([order0[tie_runs], order0[tie_runs + 1]])
                )
                resolver.ensure(cand_idx[members])
                for j in members:
                    scores[j] = resolver.at(int(cand_idx[j]))
        order = np.lexsort((cand_idx, -scores))
        taken = np.zeros(L, bool)
        kept: List[int] = []
        for pos in cand_idx[order]:
            if taken[pos]:
                continue
            kept.append(int(pos))
            taken[max(0, pos - p.nuc_sep + 1) : pos + p.nuc_sep] = True
        sel = sorted(kept)
        sel_set = set(sel)
        res.n_resolved_chunks += resolved_any
        res.n_fallback_chunks += resolver.n_bulk_tiles > 0

        # printed rows: stats are f64; the smoothed-score column is f64 in
        # strict mode (via the resolver — same values the old want_smooth
        # refinish produced), else the f32 device value uniformly
        st_rows = {k: st[k][mask64] for k in st}
        if p.strict:
            resolver.ensure(cand_idx)
            smooth_col = np.array([resolver.at(int(i)) for i in cand_idx])
        else:
            smooth_col = smooth32[cand_idx]

        def mk(j: int) -> NucCall:
            i = int(cand_idx[j])
            occ, lo, up = occ_lookup(cid, chunk, chunk.start + i)
            return NucCall(
                chunk.chrom, chunk.start + i, float(st_rows["norm"][j]),
                occ, lo, up, float(st_rows["lr"][j]), float(smooth_col[j]),
                float(st_rows["signal"][j]), float(st_rows["fuzz"][j]),
            )

        red = [mk(j) for j in range(len(cand_idx))]
        calls = [red[j] for j in range(len(cand_idx)) if int(cand_idx[j]) in sel_set]
        return calls, red, sel

    def _refinish_at(self, chunk, tiles, session_for, positions,
                     want_smooth=False):
        """Float64 stats at chunk-relative positions, grouped per tile so
        each position is scored in the same window the device used."""
        out = {
            k: np.zeros(len(positions))
            for k in ("norm", "lr", "signal", "fuzz", "n", "smooth")
        }
        if len(positions) == 0:
            return out
        gpos = chunk.start + np.asarray(positions, np.int64)
        core_starts = np.array([t.core_start for t in tiles])
        ti = np.searchsorted(core_starts, gpos, side="right") - 1
        for t_idx in np.unique(ti):
            t = tiles[t_idx]
            in_t = ti == t_idx
            cols = gpos[in_t] - t.win_start
            st = session_for(int(t_idx)).stats_at(cols, want_smooth)
            for k in out:
                out[k][in_t] = st[k]
        return out
