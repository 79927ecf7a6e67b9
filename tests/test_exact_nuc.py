"""f64-exact nuc stage (VERDICT r1 item 3; BASELINE 'bit-identical
nucpos.bed' north star): every row of nucpos.bed / nucpos.redundant.bed —
selection AND printed statistics — must equal a pure-float64 mirror
pipeline's rows. In strict mode the equality is full-string (every
column); in default mode every column except the smoothed-score one
(documented f32) is string-equal and the smoothed column agrees to the
f32 error bound."""
import dataclasses
import gzip

import numpy as np
import pytest

from nucleoatac_jax import mirror
from nucleoatac_jax.config import NucParams, RunConfig, WindowParams
from nucleoatac_jax.core.chunk import ChunkList
from nucleoatac_jax.core.pwm import PWM
from nucleoatac_jax.core.vmat import VMat
from nucleoatac_jax.io.bam import scan_bam
from nucleoatac_jax.io.fasta import FastaFile
from nucleoatac_jax.models.data import tile_chunks
from nucleoatac_jax.models.nuc import NucCall, chunk_log_bias
from nucleoatac_jax.models.pipeline import run_pipeline
from nucleoatac_jax.utils.numerics import (
    greedy_select_fast,
    local_max_candidates_fast,
)
from tests.synth import make_example


def _q64(frags, chunks, cfg):
    from nucleoatac_jax.models.occ import fit_mixture

    fs, _ = fit_mixture(frags, chunks, cfg)
    h = fs.get(cfg.vmat.lower, cfg.vmat.upper).astype(np.float64)
    return h / h.sum() if h.sum() > 0 else np.full_like(h, 1.0 / len(h))


def _mirror_rows(cfg, bam, bed, fasta_path, occ_tracks):
    """Pure-float64 oracle: per-tile mirror nuc scoring + f64 selection,
    emitting (nucpos_rows, redundant_rows) exactly as the stage prints."""
    frags = scan_bam(bam)
    chunks = ChunkList.read(bed, frags.chrom_dict).merge()
    fasta = FastaFile(fasta_path) if fasta_path else None
    pwm = PWM.default()
    V = VMat.default(cfg.vmat).mat
    q = _q64(frags, chunks, cfg)
    W = cfg.window.width(cfg.occ, cfg.vmat)
    halo = cfg.window.halo(cfg.occ, cfg.vmat)
    tiles = tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat)
    p = cfg.nuc
    pos_rows, red_rows = [], []
    for cid, chunk in enumerate(chunks):
        L = len(chunk)
        tr = {
            k: np.zeros(L)
            for k in ("norm", "smooth", "lr", "signal", "fuzz")
        }
        for t in tiles:
            if t.chunk_id != cid:
                continue
            m, s = frags.window(chunk.chrom, t.win_start, t.win_start + W)
            F = mirror.rasterize(
                m - t.win_start, s, cfg.vmat.lower, cfg.vmat.upper, W
            ).astype(np.float64)
            if fasta is not None:
                lb = chunk_log_bias(
                    fasta, pwm, chunk.chrom, t.win_start, t.win_start + W
                )
            else:
                lb = np.zeros(W)
            b0 = mirror.bias_mat(
                lb, q, cfg.vmat.lower, cfg.vmat.upper, halo, W - halo
            )
            sc = mirror.nuc_scores(F, b0, V, p.v_floor, p.var_floor)
            sm = mirror.gauss_smooth(sc.norm, p.smooth_sd)
            off = t.core_start - chunk.start
            n_core = t.core_end - t.core_start
            c0 = t.core_start - t.win_start
            for k, arr in (
                ("norm", sc.norm), ("smooth", sm), ("lr", sc.lr),
                ("signal", sc.signal), ("fuzz", sc.fuzz),
            ):
                tr[k][off : off + n_core] = arr[c0 : c0 + n_core]
        mask = (tr["norm"] >= p.min_z) & (tr["lr"] >= p.min_lr)
        cand = local_max_candidates_fast(tr["smooth"], p.nuc_sep // 2, mask)
        cand_idx = np.flatnonzero(cand)
        sel = set(greedy_select_fast(tr["smooth"], cand, p.nuc_sep))
        occ_tr = occ_tracks[cid]

        def row(i):
            return NucCall(
                chunk.chrom, chunk.start + i, float(tr["norm"][i]),
                float(occ_tr["occ"][i]), float(occ_tr["lower"][i]),
                float(occ_tr["upper"][i]), float(tr["lr"][i]),
                float(tr["smooth"][i]), float(tr["signal"][i]),
                float(tr["fuzz"][i]),
            ).bed_row()

        for i in cand_idx:
            red_rows.append(row(int(i)))
            if int(i) in sel:
                pos_rows.append(row(int(i)))
    return pos_rows, red_rows


def _read_rows(path):
    with gzip.open(path, "rt") as fh:
        return [line.rstrip("\n") for line in fh]


@pytest.fixture(scope="module")
def strict_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("exact_nuc")
    ex = make_example(d)
    cfg = RunConfig(
        window=WindowParams(core=256, batch=4),
        nuc=NucParams(strict=True),
    )
    out = str(d / "out")
    run_pipeline(
        ex["bam"], ex["bed"], out, fasta_path=ex["fasta"], cfg=cfg,
        write_plots=False,
    )
    return ex, cfg, out


def test_nucpos_rows_equal_f64_mirror_strict(strict_run):
    """Strict mode: every column of every row is string-identical to the
    pure-f64 mirror pipeline (the bit-identical north star surface)."""
    ex, cfg, out = strict_run
    # occ tracks for the oracle's occ columns: read back the (f64-exact)
    # occ stage outputs the pipeline itself wrote
    from nucleoatac_jax.models.standalone import OccTrackReader

    frags = scan_bam(ex["bam"])
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    reader = OccTrackReader(out)
    occ_tracks = {
        cid: reader.chunk_tracks(chunk) for cid, chunk in enumerate(chunks)
    }
    want_pos, want_red = _mirror_rows(
        cfg, ex["bam"], ex["bed"], ex["fasta"], occ_tracks
    )
    got_pos = _read_rows(out + ".nucpos.bed.gz")
    got_red = _read_rows(out + ".nucpos.redundant.bed.gz")
    assert got_pos == want_pos
    assert got_red == want_red
    assert len(got_pos) >= 4  # planted dyads found


def test_default_mode_exact_except_smooth(tmp_path):
    """Default (non-strict) mode: positions and all columns except the
    documented-f32 smoothed-score column are string-identical."""
    ex = make_example(tmp_path)
    cfg = RunConfig(window=WindowParams(core=256, batch=4))
    out = str(tmp_path / "out")
    run_pipeline(
        ex["bam"], ex["bed"], out, fasta_path=ex["fasta"], cfg=cfg,
        write_plots=False,
    )
    from nucleoatac_jax.models.standalone import OccTrackReader

    frags = scan_bam(ex["bam"])
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    reader = OccTrackReader(out)
    occ_tracks = {
        cid: reader.chunk_tracks(chunk) for cid, chunk in enumerate(chunks)
    }
    want_pos, _ = _mirror_rows(cfg, ex["bam"], ex["bed"], ex["fasta"], occ_tracks)
    got_pos = _read_rows(out + ".nucpos.bed.gz")
    assert len(got_pos) == len(want_pos)
    SMOOTH_COL = 8
    for g, w in zip(got_pos, want_pos):
        gf, wf = g.split("\t"), w.split("\t")
        for j, (a, b) in enumerate(zip(gf, wf)):
            if j == SMOOTH_COL:
                assert abs(float(a) - float(b)) < cfg.nuc.exact_tol
            else:
                assert a == b, (j, g, w)


def test_cpp_refinisher_equals_numpy(tmp_path):
    """The C++ refinisher (io/native/nucrefine.cpp) matches the numpy
    mirror-based fallback to f64 roundoff on stats and full tracks."""
    from nucleoatac_jax.models.nuc_exact import NucRefinisher

    cfg = RunConfig(window=WindowParams(core=256, batch=4))
    rng = np.random.default_rng(3)
    W = cfg.window.width(cfg.occ, cfg.vmat)
    n = 800
    mids = np.sort(rng.integers(0, W, size=n)).astype(np.int32)
    sizes = rng.integers(80, 251, size=n).astype(np.int32)
    lb = 0.3 * rng.standard_normal(W)
    q = rng.random(cfg.vmat.upper - cfg.vmat.lower)
    q /= q.sum()
    vm = VMat.default(cfg.vmat)
    a = NucRefinisher(cfg, vm, q, None, None, use_native=True)
    b = NucRefinisher(cfg, vm, q, None, None, use_native=False)
    if a.lib is None:
        pytest.skip("libnucrefine.so not built")
    halo = cfg.window.halo(cfg.occ, cfg.vmat)
    cols = np.arange(halo + 40, halo + 200, 13, dtype=np.int64)
    sa = a.stats_at(mids, sizes, lb, cols, want_smooth=True)
    sb = b.stats_at(mids, sizes, lb, cols, want_smooth=True)
    for k in ("norm", "lr", "signal", "fuzz", "n", "smooth"):
        np.testing.assert_allclose(sa[k], sb[k], rtol=1e-9, atol=1e-9, err_msg=k)
    ta, tsa = a.full_tracks(mids, sizes, lb)
    tb, tsb = b.full_tracks(mids, sizes, lb)
    np.testing.assert_allclose(ta, tb, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tsa, tsb, rtol=1e-9, atol=1e-9)


def test_fft_full_tracks_equal_mirror():
    """Round 5: TileSession.full_stat_tracks (frequency-domain
    correlations) matches the f64 mirror and the C++ fresh-sums kernel
    within the module's operation-order band on every stat track."""
    from nucleoatac_jax import mirror
    from nucleoatac_jax.models.nuc_exact import NucRefinisher, TileSession

    cfg = RunConfig(window=WindowParams(core=256, batch=4))
    rng = np.random.default_rng(5)
    W = cfg.window.width(cfg.occ, cfg.vmat)
    n = 600
    mids = np.sort(rng.integers(0, W, size=n)).astype(np.int32)
    sizes = rng.integers(80, 251, size=n).astype(np.int32)
    lb = 0.3 * rng.standard_normal(W)
    q = rng.random(cfg.vmat.upper - cfg.vmat.lower)
    q /= q.sum()
    vm = VMat.default(cfg.vmat)
    r = NucRefinisher(cfg, vm, q, None, None)
    s = TileSession(r, mids, sizes, lb)
    sc = mirror.nuc_scores(
        s.F, s.B0, np.asarray(vm.mat, np.float64),
        cfg.nuc.v_floor, cfg.nuc.var_floor,
    )
    # C++ point stats at some core columns BEFORE the full tracks exist
    halo = cfg.window.halo(cfg.occ, cfg.vmat)
    cols = np.arange(halo + 10, W - halo - 10, 17, dtype=np.int64)
    point = s.stats_at(cols, want_smooth=True)
    full = s.full_stat_tracks()
    for k, ref in (("norm", sc.norm), ("lr", sc.lr), ("signal", sc.signal),
                   ("fuzz", sc.fuzz), ("n", sc.n)):
        np.testing.assert_allclose(full[k], ref, rtol=1e-10, atol=1e-10,
                                   err_msg=k)
    np.testing.assert_allclose(
        full["smooth"], np.convolve(sc.norm, r.gk, mode="same"),
        rtol=1e-10, atol=1e-10,
    )
    # cached-lookup stats_at agrees with the C++ fresh-sums values
    cached = s.stats_at(cols, want_smooth=True)
    for k in ("norm", "lr", "signal", "fuzz", "n", "smooth"):
        np.testing.assert_allclose(cached[k], point[k], rtol=1e-9,
                                   atol=1e-9, err_msg=k)


def _tie_dataset(d):
    """Two identical fragment clusters closer than nuc_sep -> exactly tied
    f64 scores conflicting in greedy selection."""
    from nucleoatac_jax.io.bam_writer import write_bam

    frags = []
    for center in (1000, 1100):  # 100 bp apart < nuc_sep=120 -> conflict
        for k in range(60):
            size = 140 + (k % 21)
            mid = center + (k % 11) - 5
            frags.append((0, mid - (size - 1) // 2 - 4, size))
    bam = str(d / "tie.bam")
    write_bam(bam, ["chr1"], [4000], frags)
    bed = str(d / "peaks.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t600\t1600\tpeak1\n")
    return bam, bed


def test_near_tie_resolved_per_decision(tmp_path):
    """Exactly tied scores must be settled by the f64 point resolver (not
    a full-chunk recompute) and the selection must match the mirror's
    (leftmost tie-break). Round-3 VERDICT item 1."""
    bam, bed = _tie_dataset(tmp_path)
    cfg = RunConfig(window=WindowParams(core=256, batch=4))
    out = str(tmp_path / "out")
    res = run_pipeline(bam, bed, out, cfg=cfg, write_plots=False)
    assert res.nuc.n_resolved_chunks > 0  # the tie was actually detected
    got = _read_rows(out + ".nucpos.bed.gz")
    from nucleoatac_jax.models.standalone import OccTrackReader

    fr = scan_bam(bam)
    chunks = ChunkList.read(bed, fr.chrom_dict).merge()
    reader = OccTrackReader(out)
    occ_tracks = {
        cid: reader.chunk_tracks(chunk) for cid, chunk in enumerate(chunks)
    }
    want, _ = _mirror_rows(cfg, bam, bed, None, occ_tracks)
    assert len(got) == len(want) > 0
    SMOOTH_COL = 8
    for g, w in zip(got, want):
        gf, wf = g.split("\t"), w.split("\t")
        assert gf[1] == wf[1]  # selected positions identical to f64 mirror
        for j, (a, b) in enumerate(zip(gf, wf)):
            if j == SMOOTH_COL:
                assert abs(float(a) - float(b)) < cfg.nuc.exact_tol
            else:
                assert a == b, (j, g, w)


def test_near_tie_strict_rows_equal_mirror(tmp_path):
    """Strict mode on the engineered tie: every column of every row
    string-identical to the f64 mirror (the resolver's f64 smooth values
    ARE the mirror's up to print precision)."""
    bam, bed = _tie_dataset(tmp_path)
    cfg = RunConfig(
        window=WindowParams(core=256, batch=4), nuc=NucParams(strict=True)
    )
    out = str(tmp_path / "out")
    run_pipeline(bam, bed, out, cfg=cfg, write_plots=False)
    got = _read_rows(out + ".nucpos.bed.gz")
    from nucleoatac_jax.models.standalone import OccTrackReader

    fr = scan_bam(bam)
    chunks = ChunkList.read(bed, fr.chrom_dict).merge()
    reader = OccTrackReader(out)
    occ_tracks = {
        cid: reader.chunk_tracks(chunk) for cid, chunk in enumerate(chunks)
    }
    want, _ = _mirror_rows(cfg, bam, bed, None, occ_tracks)
    assert got == want and len(got) > 0


def test_fast_path_engages(tmp_path, monkeypatch):
    """Round-3 VERDICT item 8: on representative synthetic ATAC data the
    certified fast path must actually engage — the bulk f64 recompute
    (full_tracks) fires on < 5% of chunks (expected: none), pinning the
    regression where the 'rare' fallback ran on 82% of chunks."""
    import os
    import sys

    sys.path.insert(
        0, os.path.join(os.path.dirname(__file__), os.pardir, "scripts")
    )
    from bench_e2e import synth_dataset

    from nucleoatac_jax.models import nuc_exact

    bam, bed, fa = synth_dataset(str(tmp_path), 1, 8, 2000, 500, seed=11)
    calls = {"full_tracks": 0}
    orig = nuc_exact.NucRefinisher.full_tracks

    def counting(self, *a, **kw):
        calls["full_tracks"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(nuc_exact.NucRefinisher, "full_tracks", counting)
    out = str(tmp_path / "out")
    res = run_pipeline(bam, bed, out, fasta_path=fa, write_plots=False)
    with open(bed) as fh:
        n_chunks = sum(1 for _ in fh)
    assert res.nuc.n_fallback_chunks / n_chunks < 0.05
    assert calls["full_tracks"] == 0  # certified chunks skip it entirely
    assert len(res.nuc.calls) >= 8  # planted nucleosome arrays were found
