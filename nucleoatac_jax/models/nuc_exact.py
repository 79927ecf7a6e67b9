"""Float64 host refinish of nuc-stage dyad statistics + tie certification.

Round-1 VERDICT item 3: the occ stage already has a provably-exact path
(device margin certification + host f64 refinish, models/occ.py); this is
the nuc-stage equivalent. The device computes per-bp norm/smooth tracks
in f32 (all that output files need per-bp); every PRINTED per-dyad stat
and every SELECTION decision is then either

- recomputed in float64 from the raw integer fragment window + float64
  bias model (``NucRefinisher.stats_at`` — C++ inner loop,
  io/native/nucrefine.cpp, numpy fallback below), or
- certified by an f32 margin: decisions whose score margins exceed
  2x ``cfg.nuc.exact_tol`` (a bound on |f32 track - f64 track|) provably
  agree with float64; each sub-margin decision is settled individually on
  f64 point values (``SmoothResolver`` — round-3 VERDICT item 1 replaced
  the old full-chunk fallback, which fired on 82% of chunks).

Equality target: the float64 mirror pipeline (mirror/windows.py). The
refinisher and the mirror may differ by ~1e-13 (different but
mathematically-equal operation orders: e.g. exp(a)*exp(b) vs exp(a+b));
that is far below the %.5g print surface of nucpos.bed, so printed rows
are bit-identical (tests/test_exact_nuc.py).

Reference behavior being made exact: nucleoatac/NucleosomeCalling.py
per-dyad stats + nucpos selection (SURVEY.md §3.2/§4.2).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np

from nucleoatac_jax.config import RunConfig
from nucleoatac_jax.core.pwm import PWM
from nucleoatac_jax.core.vmat import VMat
from nucleoatac_jax.io.native import load
from nucleoatac_jax.ops.smooth import gauss_kernel

@functools.cache
def _load_lib():
    """libnucrefine.so with its ctypes signatures, or None (logged once by
    io.native.load) -> the numpy fallback."""
    lib = load("nucrefine")
    if lib is None:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    lp = ctypes.POINTER(ctypes.c_int64)
    lib.nucrefine_stats.restype = ctypes.c_int
    lib.nucrefine_stats.argtypes = [
        ip, ip, ctypes.c_long, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        lp, ctypes.c_long, ctypes.c_int, dp, ctypes.c_int, dp,
    ]
    lib.nucrefine_norm_track.restype = ctypes.c_int
    lib.nucrefine_norm_track.argtypes = [
        ip, ip, ctypes.c_long, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, dp,
    ]
    lib.nucrefine_build.restype = ctypes.c_int
    lib.nucrefine_build.argtypes = [
        ip, ip, ctypes.c_long, dp, dp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, dp, dp,
    ]
    lib.nucrefine_stats_pre.restype = ctypes.c_int
    lib.nucrefine_stats_pre.argtypes = [
        dp, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        lp, ctypes.c_long, ctypes.c_int, dp, ctypes.c_int, dp,
    ]
    lib.nucrefine_norm_track_pre.restype = ctypes.c_int
    lib.nucrefine_norm_track_pre.argtypes = [
        dp, dp, dp, dp, dp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, dp,
    ]
    try:  # round-5 lean resolver kernel; stale .so lacks it
        lib.nucrefine_norm_cols_pre.restype = ctypes.c_int
        lib.nucrefine_norm_cols_pre.argtypes = [
            dp, dp, dp, dp, dp,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
            lp, ctypes.c_long, dp,
        ]
        lib._has_norm_cols = True
    except AttributeError:
        lib._has_norm_cols = False
    return lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NucRefinisher:
    """Per-tile float64 stats at dyad columns + full-track fallback."""

    def __init__(
        self,
        cfg: RunConfig,
        vmat: VMat,
        size_probs64: np.ndarray,
        pwm: Optional[PWM],
        fasta,
        use_native: bool = True,
    ):
        self.cfg = cfg
        self.width = cfg.window.width(cfg.occ, cfg.vmat)
        self.halo = cfg.window.halo(cfg.occ, cfg.vmat)
        self.core_lo = self.halo
        self.core_hi = self.width - self.halo
        self.pwm = pwm
        self.fasta = fasta
        self.V = np.ascontiguousarray(vmat.mat, dtype=np.float64)
        self.logV = np.log(np.maximum(self.V, cfg.nuc.v_floor))
        self.q = np.ascontiguousarray(size_probs64, dtype=np.float64)
        self.Sv, self.K = self.V.shape
        if self.Sv != cfg.vmat.upper - cfg.vmat.lower:
            raise ValueError("vmat size range mismatch")
        # float64 gaussian kernel, identical support to the device kernel
        k32 = gauss_kernel(cfg.nuc.smooth_sd)
        hw = len(k32) // 2
        t = np.arange(-hw, hw + 1, dtype=np.float64)
        k = np.exp(-0.5 * (t / cfg.nuc.smooth_sd) ** 2)
        self.gk = k / k.sum()
        self.lib = _load_lib() if use_native else None
        self._fftk = None  # lazy FFT kernel spectra (full_stat_tracks)

    def fft_plan(self):
        """Precomputed rfft spectra of the 8 correlation kernels (round 5:
        the full-tile f64 stat-track path). Correlation corr(x, k)[c] =
        sum_j x[c+j] k[j] is computed as irfft(rfft(x, L) * rfft(k[::-1],
        L))[K-1 + c], L >= W + K - 1 so no circular wrap; summing the
        per-size-row products in the frequency domain turns the mirror's
        S independent np.correlate calls into ONE inverse FFT per track.
        Agrees with mirror.nuc_scores to f64 roundoff (~1e-16 rel,
        measured) — the same operation-order equality band as the C++
        fresh-sums kernel (module docstring)."""
        if self._fftk is None:
            K, Sv, W = self.K, self.Sv, self.width
            L = 1 << int(W + K - 1).bit_length()
            ones = np.ones_like(self.V)
            offs = (np.arange(K, dtype=np.float64) - K // 2)[None, :] * np.ones(
                (Sv, 1)
            )
            kers_f = {
                "signal": self.V, "n": ones, "flogv": self.logV,
                "fo": offs, "fo2": offs * offs,
            }
            kers_b = {"bsum": ones, "vb": self.V, "v2b": self.V * self.V}
            self._fftk = (
                L,
                {k: np.fft.rfft(v[:, ::-1], L, axis=1)
                 for k, v in kers_f.items()},
                {k: np.fft.rfft(v[:, ::-1], L, axis=1)
                 for k, v in kers_b.items()},
            )
        return self._fftk

    # ---- bias row for a window (float64, same semantics as the device
    # seq-codes path: real sequence over the full window span) -----------
    def log_bias_row(self, chrom: str, win_start: int) -> np.ndarray:
        from nucleoatac_jax.models.nuc import chunk_log_bias

        if self.pwm is None or self.fasta is None:
            return np.zeros(self.width, dtype=np.float64)
        return chunk_log_bias(
            self.fasta, self.pwm, chrom, win_start, win_start + self.width
        )

    # ---- per-column stats ------------------------------------------------
    def stats_at(
        self,
        mids: np.ndarray,  # window-relative int32, any size range
        sizes: np.ndarray,
        log_bias: np.ndarray,  # [W] float64
        cols: np.ndarray,  # window-relative dyad columns, int64
        want_smooth: bool = False,
    ) -> Dict[str, np.ndarray]:
        cols = np.ascontiguousarray(cols, dtype=np.int64)
        mids = np.ascontiguousarray(mids, dtype=np.int32)
        sizes = np.ascontiguousarray(sizes, dtype=np.int32)
        log_bias = np.ascontiguousarray(log_bias, dtype=np.float64)
        if self.lib is not None:
            out = np.empty((len(cols), 6), dtype=np.float64)
            rc = self.lib.nucrefine_stats(
                mids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(mids), _dp(log_bias), _dp(self.q), _dp(self.V),
                _dp(self.logV), self.width, self.K, self.Sv,
                self.cfg.vmat.lower, self.core_lo, self.core_hi,
                self.cfg.nuc.var_floor,
                cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(cols), 1 if want_smooth else 0, _dp(self.gk),
                len(self.gk), _dp(out),
            )
            if rc != 0:
                raise ValueError(f"nucrefine_stats failed rc={rc} (footprint)")
        else:
            out = self._stats_numpy(mids, sizes, log_bias, cols, want_smooth)
        return {
            "norm": out[:, 0], "lr": out[:, 1], "signal": out[:, 2],
            "fuzz": out[:, 3], "n": out[:, 4], "smooth": out[:, 5],
        }

    # ---- full-width float64 norm + smooth (tie fallback / strict) --------
    def full_tracks(self, mids, sizes, log_bias):
        mids = np.ascontiguousarray(mids, dtype=np.int32)
        sizes = np.ascontiguousarray(sizes, dtype=np.int32)
        log_bias = np.ascontiguousarray(log_bias, dtype=np.float64)
        if self.lib is not None:
            norm = np.empty(self.width, dtype=np.float64)
            rc = self.lib.nucrefine_norm_track(
                mids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(mids), _dp(log_bias), _dp(self.q), _dp(self.V),
                _dp(self.logV), self.width, self.K, self.Sv,
                self.cfg.vmat.lower, self.core_lo, self.core_hi,
                self.cfg.nuc.var_floor, _dp(norm),
            )
            if rc != 0:
                raise ValueError(f"nucrefine_norm_track failed rc={rc}")
        else:
            norm = self._norm_track_numpy(mids, sizes, log_bias)
        smooth = np.convolve(norm, self.gk, mode="same")
        return norm, smooth

    # ---- numpy fallback (also the correctness oracle for the C++ lib) ----
    def _window_arrays(self, mids, sizes, log_bias):
        from nucleoatac_jax import mirror

        cfg = self.cfg
        F = mirror.rasterize(
            mids, sizes, cfg.vmat.lower, cfg.vmat.upper, self.width
        ).astype(np.float64)
        b0 = mirror.bias_mat(
            log_bias, self.q, cfg.vmat.lower, cfg.vmat.upper,
            self.core_lo, self.core_hi,
        )
        return F, b0

    def _sums_at(self, F, b0, c):
        half = self.K // 2
        fw = F[:, c - half : c + half + 1]
        bw = b0[:, c - half : c + half + 1]
        offs = np.arange(self.K, dtype=np.float64) - half
        return dict(
            signal=float((self.V * fw).sum()), n=float(fw.sum()),
            flogv=float((self.logV * fw).sum()),
            fo=float((offs[None, :] * fw).sum()),
            fo2=float((offs[None, :] ** 2 * fw).sum()),
            bsum=float(bw.sum()), vb=float((self.V * bw).sum()),
            v2b=float((self.V * self.V * bw).sum()),
        )

    def _finish(self, s):
        var_floor = self.cfg.nuc.var_floor
        safe_b = s["bsum"] if s["bsum"] > 0 else 1.0
        mu = s["vb"] / safe_b
        mu2 = s["v2b"] / safe_b
        var = s["n"] * (mu2 - mu * mu)
        ok = var > var_floor and s["n"] > 0
        norm = (s["signal"] - s["n"] * mu) / np.sqrt(var) if ok else 0.0
        lr = (
            s["flogv"] - s["n"] * np.log(max(mu, 1e-300))
            if s["n"] > 0 else 0.0
        )
        fuzz = 0.0
        if s["n"] > 0:
            m1, m2 = s["fo"] / s["n"], s["fo2"] / s["n"]
            fuzz = float(np.sqrt(max(m2 - m1 * m1, 0.0)))
        return norm, lr, s["signal"], fuzz, s["n"]

    def _stats_numpy(self, mids, sizes, log_bias, cols, want_smooth):
        F, b0 = self._window_arrays(mids, sizes, log_bias)
        return self._stats_numpy_pre(F, b0, cols, want_smooth)

    def _stats_numpy_pre(self, F, b0, cols, want_smooth):
        out = np.zeros((len(cols), 6), dtype=np.float64)
        hw = len(self.gk) // 2
        for i, c in enumerate(cols):
            out[i, :5] = self._finish(self._sums_at(F, b0, int(c)))
            if want_smooth:
                nb = np.array(
                    [
                        self._finish(self._sums_at(F, b0, int(c) + d))[0]
                        for d in range(-hw, hw + 1)
                    ]
                )
                out[i, 5] = float(self.gk @ nb)
        return out

    def _norm_track_numpy(self, mids, sizes, log_bias):
        from nucleoatac_jax import mirror

        F, b0 = self._window_arrays(mids, sizes, log_bias)
        return mirror.nuc_scores(
            F, b0, self.V, self.cfg.nuc.v_floor, self.cfg.nuc.var_floor
        ).norm


class TileSession:
    """Prebuilt F/B0 matrices for one tile, shared across all the f64
    queries a chunk's finishing makes (stats at maxima, resolver columns,
    strict smooth, bulk track). Rebuilding F/B0 per ctypes call was ~60%
    of the round-4 resolution cost."""

    def __init__(self, refin: "NucRefinisher", mids, sizes, log_bias):
        self.refin = refin
        mids = np.ascontiguousarray(mids, dtype=np.int32)
        sizes = np.ascontiguousarray(sizes, dtype=np.int32)
        log_bias = np.ascontiguousarray(log_bias, dtype=np.float64)
        if refin.lib is not None:
            self.F = np.empty((refin.Sv, refin.width), dtype=np.float64)
            self.B0 = np.empty((refin.Sv, refin.width), dtype=np.float64)
            rc = refin.lib.nucrefine_build(
                mids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(mids), _dp(log_bias), _dp(refin.q), refin.width,
                refin.K, refin.Sv, refin.cfg.vmat.lower, refin.core_lo,
                refin.core_hi, _dp(self.F), _dp(self.B0),
            )
            if rc != 0:
                raise ValueError(f"nucrefine_build failed rc={rc}")
        else:
            self.F, self.B0 = refin._window_arrays(mids, sizes, log_bias)
        self._full = None

    def stats_at(self, cols: np.ndarray, want_smooth: bool = False):
        r = self.refin
        cols = np.ascontiguousarray(cols, dtype=np.int64)
        if self._full is not None:  # full tracks already computed: lookup
            f = self._full
            return {k: f[k][cols] for k in
                    ("norm", "lr", "signal", "fuzz", "n", "smooth")}
        if r.lib is not None:
            out = np.empty((len(cols), 6), dtype=np.float64)
            rc = r.lib.nucrefine_stats_pre(
                _dp(self.F), _dp(self.B0), _dp(r.q), _dp(r.V), _dp(r.logV),
                r.width, r.K, r.Sv, r.cfg.vmat.lower, r.core_lo, r.core_hi,
                r.cfg.nuc.var_floor,
                cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(cols), 1 if want_smooth else 0, _dp(r.gk), len(r.gk),
                _dp(out),
            )
            if rc != 0:
                raise ValueError(f"nucrefine_stats_pre failed rc={rc}")
        else:
            out = r._stats_numpy_pre(self.F, self.B0, cols, want_smooth)
        return {
            "norm": out[:, 0], "lr": out[:, 1], "signal": out[:, 2],
            "fuzz": out[:, 3], "n": out[:, 4], "smooth": out[:, 5],
        }

    def full_stat_tracks(self):
        """All f64 stat tracks over the full tile width in one pass
        (round 5): eight FFT correlations (kernel spectra precomputed,
        NucRefinisher.fft_plan) + the mirror's finishing formulas. At
        ~9 ms/tile this replaces both the per-column C++ path when a
        tile's resolution workload is dense (the common case: a smoothed
        sd=10 track has flat peak shoulders, so ambiguous comparisons
        span hundreds of columns) and the old bulk norm_track (26 ms).
        Cached; every subsequent resolver/refinish query on the tile is
        an array lookup."""
        if getattr(self, "_full", None) is not None:
            return self._full
        r = self.refin
        L, kf, kb = r.fft_plan()
        K, W = r.K, r.width
        half = K // 2
        xf = np.fft.rfft(self.F, L, axis=1)
        bf = np.fft.rfft(self.B0, L, axis=1)
        n_out = W - K + 1

        def corr(src, spec):
            return np.fft.irfft((src * spec).sum(axis=0), L)[
                K - 1 : K - 1 + n_out
            ]

        def pad(x):
            out = np.zeros(W, dtype=np.float64)
            out[half : half + n_out] = x
            return out

        signal = pad(corr(xf, kf["signal"]))
        n = pad(corr(xf, kf["n"]))
        flogv = pad(corr(xf, kf["flogv"]))
        fo = pad(corr(xf, kf["fo"]))
        fo2 = pad(corr(xf, kf["fo2"]))
        bsum = pad(corr(bf, kb["bsum"]))
        vb = pad(corr(bf, kb["vb"]))
        v2b = pad(corr(bf, kb["v2b"]))
        # identical finishing algebra to mirror.nuc_scores / _finish
        var_floor = r.cfg.nuc.var_floor
        safe_b = np.where(bsum > 0, bsum, 1.0)
        mu = vb / safe_b
        mu2 = v2b / safe_b
        var = n * (mu2 - mu * mu)
        ok = (var > var_floor) & (n > 0)
        norm = np.where(
            ok, (signal - n * mu) / np.sqrt(np.where(ok, var, 1.0)), 0.0
        )
        lr = np.where(
            n > 0, flogv - n * np.log(np.maximum(mu, 1e-300)), 0.0
        )
        safe_n = np.where(n > 0, n, 1.0)
        m1 = fo / safe_n
        m2 = fo2 / safe_n
        fuzz = np.where(n > 0, np.sqrt(np.maximum(m2 - m1 * m1, 0.0)), 0.0)
        self._full = {
            "norm": norm, "lr": lr, "signal": signal, "fuzz": fuzz, "n": n,
            "smooth": np.convolve(norm, r.gk, mode="same"),
        }
        return self._full

    def norm_cols(self, cols: np.ndarray) -> np.ndarray:
        """Norm-only f64 point values (the SmoothResolver's query shape):
        the lean C++ kernel skips the logV stream and the flogv/fo/fo2
        sums (~40% of the per-column flops; round 5). Values sit within
        the module's ~1e-13 operation-order band of stats_at's (different
        partial-sum vectorization) and all resolver columns flow through
        this one kernel, so its comparisons stay self-consistent."""
        if self._full is not None:
            return self._full["norm"][np.asarray(cols, np.int64)]
        r = self.refin
        if r.lib is not None and getattr(r.lib, "_has_norm_cols", False):
            cols = np.ascontiguousarray(cols, dtype=np.int64)
            out = np.empty(len(cols), dtype=np.float64)
            rc = r.lib.nucrefine_norm_cols_pre(
                _dp(self.F), _dp(self.B0), _dp(r.q), _dp(r.V), _dp(r.logV),
                r.width, r.K, r.Sv, r.cfg.vmat.lower, r.core_lo, r.core_hi,
                r.cfg.nuc.var_floor,
                cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(cols), _dp(out),
            )
            if rc != 0:
                raise ValueError(f"nucrefine_norm_cols_pre failed rc={rc}")
            return out
        return self.stats_at(cols)["norm"]

    def norm_track(self) -> np.ndarray:
        r = self.refin
        if r.lib is not None:
            norm = np.empty(r.width, dtype=np.float64)
            rc = r.lib.nucrefine_norm_track_pre(
                _dp(self.F), _dp(self.B0), _dp(r.q), _dp(r.V), _dp(r.logV),
                r.width, r.K, r.Sv, r.cfg.vmat.lower, r.core_lo, r.core_hi,
                r.cfg.nuc.var_floor, _dp(norm),
            )
            if rc != 0:
                raise ValueError(f"nucrefine_norm_track_pre failed rc={rc}")
            return norm
        from nucleoatac_jax import mirror

        return mirror.nuc_scores(
            self.F, self.B0, r.V, r.cfg.nuc.v_floor, r.cfg.nuc.var_floor
        ).norm


class SmoothResolver:
    """Float64 smoothed-norm POINT values for per-decision tie resolution.

    Round-3 VERDICT weak #1: the chunk-global tie guard recomputed every
    tile of a chunk in full f64 (``full_tracks``, ~63 ms/tile) whenever ANY
    position's f32 margin fell under exact_tol — which on real data is 82%
    of chunks, because a smoothed (sd=10) track always has near-flat peak
    shoulders. But a near-tie at position i only affects selection
    decisions that compare i against positions within nuc_sep of it, so
    this resolver computes f64 smooth values only at the positions a
    specific ambiguous comparison needs:

        smooth64(p) = sum_d gk[d] * norm64(c_p - ghw + d)    (sequential d)

    with norm64 columns computed by the same fresh-sums f64 kernel as
    ``stats_at`` (io/native/nucrefine.cpp) batched per tile, so each value
    equals the f64 mirror's up to operation-order roundoff (~1e-13, the
    documented equality band of this module). A tile whose needed column
    count crosses the FFT breakeven switches to one
    ``TileSession.full_stat_tracks`` call (round 5: 8 frequency-domain
    correlations, ~9 ms for EVERY stat track of the tile, ~1e-16 of the
    mirror), after which all further queries on the tile are lookups.
    """

    def __init__(self, refin: "NucRefinisher", chunk, tiles, session_for):
        self.refin = refin
        self.chunk = chunk
        self.tiles = tiles
        self.session_for = session_for  # tile_idx -> TileSession (cached)
        self.gk = refin.gk
        self.ghw = len(refin.gk) // 2
        self._core_starts = np.array([t.core_start for t in tiles])
        self._cols: Dict[int, Dict[int, float]] = {}  # tile -> col -> norm64
        self._full: Dict[int, np.ndarray] = {}  # tile -> full norm64 track
        self._smooth: Dict[int, float] = {}  # chunk-rel pos -> smooth64
        # round 5: the expensive per-column bulk fallback (norm_track,
        # ~26 ms/tile) is gone — dense tiles switch to the ~9 ms FFT
        # full-track path instead (full_stat_tracks). n_bulk_tiles is
        # kept for the NucStageResult.n_fallback_chunks contract and is
        # now always 0.
        self.n_bulk_tiles = 0
        self.n_fft_tiles = 0
        self.n_point_cols = 0

    def ensure(self, positions) -> None:
        """Batch-compute smooth64 at the given chunk-relative positions."""
        pos = sorted({int(p) for p in positions} - self._smooth.keys())
        if not pos:
            return
        pos_a = np.asarray(pos, np.int64)
        gpos = self.chunk.start + pos_a
        ti = np.searchsorted(self._core_starts, gpos, side="right") - 1
        for t_idx in np.unique(ti):
            t = self.tiles[t_idx]
            sub = pos_a[ti == t_idx]
            need: set[int] = set()
            for p in sub:
                c = int(self.chunk.start + p - t.win_start)
                need.update(range(c - self.ghw, c + self.ghw + 1))
            full = self._full.get(t_idx)
            if full is None:
                have = self._cols.setdefault(int(t_idx), {})
                missing = sorted(need - have.keys())
                # FFT full-track breakeven: ~9 ms for every track of the
                # tile (full_stat_tracks) vs ~19 us per fresh-sums point
                # column — switch once the tile's projected column count
                # crosses ~tracks/point ratio. After the switch every
                # stats_at/_refinish_at on the tile is a lookup too.
                if len(have) + len(missing) > 350:
                    full = self.session_for(int(t_idx)).full_stat_tracks()[
                        "norm"
                    ]
                    self._full[int(t_idx)] = full
                    self.n_fft_tiles += 1
                elif missing:
                    vals = self.session_for(int(t_idx)).norm_cols(
                        np.asarray(missing, np.int64)
                    )
                    for c, v in zip(missing, vals):
                        have[c] = float(v)
                    self.n_point_cols += len(missing)
            src = full if full is not None else self._cols[int(t_idx)]
            gk, ghw = self.gk, self.ghw
            for p in sub:
                c = int(self.chunk.start + p - t.win_start)
                sm = 0.0
                for d in range(2 * ghw + 1):  # same order as nucrefine.cpp
                    sm += float(gk[d]) * float(src[c - ghw + d])
                self._smooth[int(p)] = sm

    def at(self, p: int) -> float:
        return self._smooth[int(p)]
