#!/usr/bin/env python
"""Profile the per-chunk host finishing layer of the fused occ+nuc pass.

Round-4 VERDICT weak #1: at config 4 the fused pass is ~279 s of which
~270 s is host work (~27 ms/peak on this 2-core box) — and nobody had
profiled what those 27 ms are made of. This script runs the production
fused driver on the CPU backend with INLINE finishing (finish_threads=0,
fetch_threads=0) under cProfile and prints a table of the top terms,
aggregated to the components named in VERDICT r4 item 1:

  - TileSession builds (nucrefine_build F/B0 construction)
  - f64 stats at local maxima (_refinish_at / stats_at)
  - SmoothResolver point resolutions
  - occ f64 refinish (_exact_refinish / _f64_picks)
  - occ peak calling + greedy selection
  - RLE + line formatting (prepare_bedgraph)
  - writer/bgzf work
  - assembler bookkeeping + wire decode

Usage: python scripts/profile_finish.py [--peaks 1000] [--top 40]
"""
from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--peaks", type=int, default=1000)
    ap.add_argument("--frags-per-peak", type=int, default=500)
    ap.add_argument("--chroms", type=int, default=4)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--strict", action="store_true")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from nucleoatac_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    from bench_e2e import synth_dataset

    import dataclasses
    import tempfile

    from nucleoatac_jax.config import NucParams, RunConfig, WindowParams

    bam, bed, fa = synth_dataset(
        "/tmp", args.chroms, args.peaks, 2000, args.frags_per_peak
    )
    cfg = RunConfig(window=WindowParams(finish_threads=0, fetch_threads=0))
    if args.strict:
        cfg = dataclasses.replace(cfg, nuc=NucParams(strict=True))

    from nucleoatac_jax.models.pipeline import run_pipeline

    outdir = tempfile.mkdtemp(prefix="nucleoatac_profile_")
    # warm-up at tiny scale compiles the programs outside the profile
    wbam, wbed, wfa = synth_dataset("/tmp", 1, 8, 2000, args.frags_per_peak)
    run_pipeline(wbam, wbed, os.path.join(outdir, "warm"), fasta_path=wfa,
                 cfg=cfg, write_plots=False)

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    run_pipeline(bam, bed, os.path.join(outdir, "run"), fasta_path=fa,
                 cfg=cfg, write_plots=False)
    pr.disable()
    wall = time.perf_counter() - t0
    print(f"\n=== fused occ+nuc wall: {wall:.1f} s "
          f"({args.peaks} peaks, {wall / args.peaks * 1e3:.1f} ms/peak) ===\n")
    st = pstats.Stats(pr)
    st.sort_stats("cumulative").print_stats(args.top)

    # component table: tottime aggregated by the terms named in the
    # round-5 PARITY profile (cumulative table above is ground truth)
    st2 = pstats.Stats(pr)
    groups = {
        "TileSession build (F/B0)": ("nuc_exact.py", "__init__"),
        "f64 point stats (stats_at)": ("nuc_exact.py", "stats_at"),
        "lean norm columns": ("nuc_exact.py", "norm_cols"),
        "FFT full tracks": ("nuc_exact.py", "full_stat_tracks"),
        "SmoothResolver.ensure": ("nuc_exact.py", "ensure"),
        "occ _f64_picks": ("occ.py", "_f64_picks"),
        "RLE+format (prepare_bedgraph)": ("tabix.py", "prepare_bedgraph"),
        "nfr occ-track scan": ("standalone.py", "get"),
    }
    print("component tottime (s):")
    for label, (fname, func) in groups.items():
        tot = sum(
            v[2] for k, v in st2.stats.items()
            if k[0].endswith(fname) and k[2] == func
        )
        print(f"  {label:34s} {tot:7.2f}")


if __name__ == "__main__":
    main()
