#!/usr/bin/env python
"""Benchmark: fused occ+nuc window pipeline vs measured CPU baseline.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} plus the
device it ran on.

The timed loop is the production fused run loop (models/fused.py): host
encode of each batch's fragments, upload, the chained run_step_delta12
program, depth-3 pipelined dispatch (models/occ.py::_pipelined), and a
fetch + unpack of every batch's packed output, which is the sync; every
timed iteration uses a DISTINCT input buffer. windows/s = total windows /
wall-clock of that loop.

The CPU baseline is measured here from the float64 mirror implementation
of the same per-window math (mirror/windows.py) — the vectorized-numpy
equivalent of reference NucleoATAC's per-window work (Occupancy MLE +
V-plot xcorr + Cython variance), a conservative (fast) stand-in for the
reference's own Python loops (the reference publishes no numbers,
BASELINE.md / SURVEY.md §7).

Usage: python bench.py [--batch 128] [--batches 24] [--cpu-windows 8]
                       [--platform cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def make_inputs(rng, n_batches, B, F, W, wp, encoder=None):
    """n_batches DISTINCT raw fragment sets + nibble-packed seq codes.

    Returns (mids, szs, nibs); delta encoding happens inside the timed
    loop (it is part of the production per-batch host work)."""
    mids = np.sort(rng.integers(0, W, size=(n_batches, B, F)), axis=2).astype(
        np.int64
    )
    szs = np.concatenate(
        [
            rng.normal(147, 20, size=(n_batches, B, F // 2)),
            rng.exponential(45, size=(n_batches, B, F - F // 2)) + 20,
        ],
        axis=2,
    )
    szs = np.clip(szs, 1, 250).astype(np.int64)
    from nucleoatac_jax.models.data import pack_nibble_codes

    nibs = [
        pack_nibble_codes(rng.integers(0, 4, size=(B, wp)).astype(np.uint8))
        for _ in range(n_batches)
    ]
    return mids, szs, nibs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frag-cap", type=int, default=2048)
    ap.add_argument("--batches", type=int, default=24,
                    help="distinct batches per timed repeat (dedupe-proof)")
    ap.add_argument("--repeats", type=int, default=4,
                    help="timed repeats (fresh buffers each); best reported")
    ap.add_argument("--depth", type=int, default=3, help="pipeline depth")
    ap.add_argument("--fetch-threads", default="auto",
                    help="concurrent result fetches; 'auto' alternates 0/8 "
                         "across repeats and keeps the best")
    ap.add_argument("--wire", default="delta12", choices=["delta12", "delta"],
                    help="upload format (delta12 = wire v6, production)")
    ap.add_argument("--cpu-windows", type=int, default=8)
    ap.add_argument("--platform", default=None, help="force jax platform")
    ap.add_argument("--breakdown", action="store_true",
                    help="print encode/fetch split to stderr")
    ap.add_argument("--e2e-peaks", type=int, default=100,
                    help="also run the FULL `nucleoatac run` pipeline on a "
                         "synthetic dataset of this many peaks and report "
                         "e2e windows/s next to the engine number (round-3 "
                         "VERDICT item 3; 0 = skip)")
    ap.add_argument("--e2e-transfer", default="pool",
                    help="wire format for the e2e pipeline run")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from nucleoatac_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    import jax.numpy as jnp

    from __graft_entry__ import _tiny_engine
    from nucleoatac_jax import mirror
    from nucleoatac_jax.models.data import encode_delta_batch
    from nucleoatac_jax.models.occ import _pipelined

    cfg, engine = _tiny_engine(core=1024, batch=args.batch)
    B, F, W = args.batch, args.frag_cap, engine.width
    wp = engine.seq_codes_width()
    rng = np.random.default_rng(1)

    from nucleoatac_jax.models.data import (
        delta12_entry_capacity,
        encode_delta12_batch,
    )

    n_entries = F + W // 255 + 1
    E12 = delta12_entry_capacity(F, W)
    use_v6 = args.wire == "delta12"

    def run_loop(mids, szs, nibs, collect=None, fetch_threads=0):
        """The production loop: encode -> upload -> chained stages ->
        pipelined fetch + unpack. Returns elapsed seconds."""
        n = mids.shape[0]

        def gen():
            for i in range(n):
                if use_v6:
                    db = np.zeros((B, E12 // 2 + E12), np.uint8)
                    encode_delta12_batch(mids[i], szs[i], db)
                else:
                    db = np.zeros((B, n_entries, 2), np.uint8)
                    encode_delta_batch(mids[i], szs[i], db)
                yield i, db

        step = engine.run_step_delta12 if use_v6 else engine.run_step_delta

        def dispatch(item):
            i, db = item
            return step(jnp.asarray(db), jnp.asarray(nibs[i]))

        t0 = time.perf_counter()
        for _, out in _pipelined(gen(), dispatch, depth=args.depth,
                                 fetch_threads=fetch_threads):
            buf = np.asarray(out)  # the sync: real output bytes
            idx, cert, norm, qstep = engine.unpack_run(buf)
            if collect is not None:
                collect.append((idx[0, 0, 0], norm[0, 0]))
        return time.perf_counter() - t0

    # warm-up: compile + warm the fetch path on distinct throwaway buffers
    # (the timed loops are steady-state)
    t0 = time.perf_counter()
    wm, ws, wn = make_inputs(rng, 2, B, F, W, wp)
    run_loop(wm, ws, wn)
    print(f"# warmed in {time.perf_counter()-t0:.0f}s", file=sys.stderr)

    if args.fetch_threads == "auto":
        thread_plan = [0, 8]
    else:
        thread_plan = [int(args.fetch_threads)]
    best, best_ft = float("inf"), thread_plan[0]
    for r in range(max(1, args.repeats)):
        ft = thread_plan[r % len(thread_plan)]
        mids, szs, nibs = make_inputs(rng, args.batches, B, F, W, wp)
        t = run_loop(mids, szs, nibs, fetch_threads=ft)
        print(f"# repeat {r}: fetch_threads={ft} "
              f"{args.batches*B/t:,.0f} w/s", file=sys.stderr)
        if t < best:
            best, best_ft = t, ft
    dev_wps = args.batches * B / best

    if args.breakdown:
        # split: host encode alone, then loop without encode (pre-encoded)
        mids, szs, nibs = make_inputs(rng, args.batches, B, F, W, wp)
        t0 = time.perf_counter()
        dbs = []
        for i in range(args.batches):
            if use_v6:
                db = np.zeros((B, E12 // 2 + E12), np.uint8)
                encode_delta12_batch(mids[i], szs[i], db)
            else:
                db = np.zeros((B, n_entries, 2), np.uint8)
                encode_delta_batch(mids[i], szs[i], db)
            dbs.append(db)
        t_enc = (time.perf_counter() - t0) / args.batches
        step = engine.run_step_delta12 if use_v6 else engine.run_step_delta

        def dispatch(i):
            return step(jnp.asarray(dbs[i]), jnp.asarray(nibs[i]))

        t0 = time.perf_counter()
        for _, out in _pipelined(range(args.batches), dispatch,
                                 depth=args.depth,
                                 fetch_threads=best_ft):
            engine.unpack_run(np.asarray(out))
        t_noenc = (time.perf_counter() - t0) / args.batches
        print(
            f"# breakdown per batch of {B}: host encode {t_enc*1e3:.2f} ms, "
            f"pipelined loop w/o encode {t_noenc*1e3:.2f} ms, "
            f"full loop {best/args.batches*1e3:.2f} ms",
            file=sys.stderr,
        )

    # --- CPU baseline (float64 mirror, same math per window) -----------
    M64 = np.asarray(engine.log_mix, np.float64)
    grid = np.asarray(engine.alpha_grid, np.float64)
    q = np.asarray(engine.size_probs, np.float64)
    V = engine.vmat.mat
    n_cpu = max(1, args.cpu_windows)
    pwm = engine.pwm
    wp_cpu = W + (pwm.length - 1 if pwm is not None else 0)
    seqs = [
        "".join("ACGT"[c] for c in rng.integers(0, 4, size=wp_cpu))
        for _ in range(n_cpu)
    ]
    cmids = rng.integers(0, W, size=(n_cpu, F)).astype(np.int64)
    cszs = np.clip(rng.normal(147, 40, size=(n_cpu, F)), 1, 250).astype(np.int64)
    logb = (0.3 * rng.standard_normal((n_cpu, W))).astype(np.float64)
    t_cpu = float("inf")
    for _ in range(2):  # best-of-2: reject host contention noise
        t0 = time.perf_counter()
        for b in range(n_cpu):
            mat = mirror.rasterize(cmids[b], cszs[b], 0, cfg.sizes.upper, W)
            mirror.occupancy_window(mat, M64, grid, cfg.occ.flank)
            if pwm is not None:  # per-window PWM bias (device does this too)
                lb = pwm.bias_track(seqs[b])[pwm.up : pwm.up + W]
            else:
                lb = logb[b]
            b0 = mirror.bias_mat(
                lb, q, cfg.vmat.lower, cfg.vmat.upper,
                engine.core_lo, engine.core_hi,
            )
            fmat = mat[cfg.vmat.lower : cfg.vmat.upper]
            sc = mirror.nuc_scores(fmat, b0, V)
            mirror.gauss_smooth(sc.norm, cfg.nuc.smooth_sd)
        t_cpu = min(t_cpu, (time.perf_counter() - t0) / n_cpu)
    cpu_wps = 1.0 / t_cpu

    out = {
        "metric": "occ+nuc candidate windows/s per device (1024bp cores)",
        "value": round(dev_wps, 2),
        "unit": "windows/s",
        "vs_baseline": round(dev_wps / cpu_wps, 2),
        "device": {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "count": len(jax.devices()),
        },
    }

    # --- pipeline end-to-end: the number a user of `nucleoatac run`
    # actually gets (ingest -> fused occ+nuc -> merge -> nfr -> writers).
    # Printed NEXT to the engine number with their ratio — the honesty
    # standard the engine bench meets must extend to the pipeline
    # (round-3 VERDICT item 3).
    if args.e2e_peaks > 0:
        import os

        sys.path.insert(
            0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "scripts"),
        )
        import tempfile

        from bench_e2e import synth_dataset

        from nucleoatac_jax.config import RunConfig, WindowParams
        from nucleoatac_jax.core.chunk import ChunkList
        from nucleoatac_jax.io.bam import scan_bam
        from nucleoatac_jax.models.data import tile_chunks
        from nucleoatac_jax.models.pipeline import run_pipeline

        bam, bed, fa = synth_dataset(
            tempfile.gettempdir(), 1, args.e2e_peaks, 2000, 500
        )
        e2e_cfg = RunConfig(
            window=WindowParams(transfer=args.e2e_transfer)
        )
        frs = scan_bam(bam)
        n_windows = len(
            tile_chunks(
                ChunkList.read(bed, frs.chrom_dict).merge(),
                e2e_cfg.window, e2e_cfg.occ, e2e_cfg.vmat,
            )
        )
        del frs
        # warm-up run first: the first execution of each program
        # pays its compile — the same discipline as the engine loop's
        # warm-up. The timed run is the steady state a user's 2nd+ run
        # (or any genome-scale run, where compile amortizes to
        # nothing) sees.
        warmdir = tempfile.mkdtemp(prefix="nucleoatac_bench_warm_")
        t0 = time.perf_counter()
        run_pipeline(
            bam, bed, os.path.join(warmdir, "run"), fasta_path=fa,
            cfg=e2e_cfg, write_plots=False,
        )
        print(f"# e2e warm-up run: {time.perf_counter()-t0:.0f}s",
              file=sys.stderr)
        outdir = tempfile.mkdtemp(prefix="nucleoatac_bench_e2e_")
        t0 = time.perf_counter()
        run_pipeline(
            bam, bed, os.path.join(outdir, "run"), fasta_path=fa,
            cfg=e2e_cfg, write_plots=False,
        )
        e2e_wall = time.perf_counter() - t0
        out["e2e_windows_per_s"] = round(n_windows / e2e_wall, 2)
        out["e2e_peaks"] = args.e2e_peaks
        out["e2e_wall_s"] = round(e2e_wall, 2)
        out["e2e_vs_engine"] = round(n_windows / e2e_wall / dev_wps, 4)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
