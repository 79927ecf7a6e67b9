#!/usr/bin/env python
"""Genome-scale end-to-end pipeline benchmark.

Synthesizes an ATAC-like dataset (peaks with nucleosome arrays + NFRs,
millions of fragments), then times the FULL `nucleoatac run` pipeline —
C++ BAM ingest, mixture fit, device occ+nuc stages, merge/nfr, BGZF+tabix
writers — the production path a user actually runs (reference flow:
SURVEY.md §4.3). Reports per-stage wall time and peak-bp/s throughput.

The synthetic dataset is cached under --workdir (default /tmp) keyed by
its parameters, so repeat runs only pay the pipeline.

Usage: python scripts/bench_e2e.py [--peaks 500] [--peak-bp 2000]
       [--frags-per-peak 2000] [--chroms 4] [--platform cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synth_dataset(workdir, n_chroms, n_peaks, peak_bp, frags_per_peak, seed=7):
    """ATAC-like synthetic data: per peak, a nucleosome array at ~180 bp
    spacing with NFR gaps, nucleosomal fragments (~147+9 raw) around dyads
    and short fragments in linker/NFR space."""
    key = hashlib.md5(
        f"{n_chroms}-{n_peaks}-{peak_bp}-{frags_per_peak}-{seed}".encode()
    ).hexdigest()[:10]
    d = os.path.join(workdir, f"nucleoatac_e2e_{key}")
    bam = os.path.join(d, "synth.bam")
    bed = os.path.join(d, "peaks.bed")
    fa = os.path.join(d, "synth.fa")
    if all(os.path.exists(p) for p in (bam, bed, fa)):
        return bam, bed, fa
    os.makedirs(d, exist_ok=True)
    from nucleoatac_jax.io.bam_writer import write_bam
    from nucleoatac_jax.io.fasta import write_fasta

    rng = np.random.default_rng(seed)
    per_chrom = n_peaks // n_chroms
    gap = 5000
    chrom_len = (peak_bp + gap) * per_chrom + 2 * gap
    names = [f"chr{i + 1}" for i in range(n_chroms)]
    parts = []  # per peak: [n, 3] (chrom index, raw left, raw size)
    bed_rows = []
    for ci, name in enumerate(names):
        for pi in range(per_chrom):
            start = gap + pi * (peak_bp + gap)
            end = start + peak_bp
            bed_rows.append((name, start, end))
            # nucleosome dyads at ~180 bp spacing, skip one mid-peak (NFR)
            dyads = list(range(start + 90, end - 90, 180))
            if len(dyads) > 4:
                del dyads[len(dyads) // 2]
            n_nuc = int(frags_per_peak * 0.55)
            n_short = frags_per_peak - n_nuc
            dy = rng.choice(dyads, size=n_nuc)
            szs = np.clip(rng.normal(156, 14, n_nuc), 130, 250).astype(int)
            mids = dy + np.clip(rng.normal(0, 12, n_nuc), -40, 40).astype(int)
            sl = np.clip(rng.exponential(42, n_short) + 24, 24, 128).astype(int)
            ll = rng.integers(start, end - 40, n_short)
            left = np.concatenate([mids - (szs - 1) // 2 - 4, ll])
            parts.append(np.stack(
                [np.full(len(left), ci), left, np.concatenate([szs, sl])],
                axis=1,
            ))
    frags = np.concatenate(parts)
    frags = frags[np.lexsort((frags[:, 1], frags[:, 0]))]  # stable
    write_bam(bam, names, [chrom_len] * n_chroms, frags)
    with open(bed, "w") as fh:
        for name, s, e in bed_rows:
            fh.write(f"{name}\t{s}\t{e}\n")
    # random sequence genome (bias signal is uniform-random; the PWM conv
    # still runs at full cost on device)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    write_fasta(fa, {n: acgt[rng.integers(0, 4, chrom_len)].tobytes().decode()
                     for n in names})
    return bam, bed, fa


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--peaks", type=int, default=500)
    ap.add_argument("--peak-bp", type=int, default=2000)
    ap.add_argument("--frags-per-peak", type=int, default=2000)
    ap.add_argument("--chroms", type=int, default=4)
    ap.add_argument("--workdir", default="/tmp")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--out", default=None, help="output prefix (tmp default)")
    ap.add_argument("--strict", action="store_true",
                    help="NucParams(strict=True): f64-refinish the "
                         "smoothed-score column of every printed row")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batch", type=int, default=None,
                    help="override WindowParams.batch")
    ap.add_argument("--finish-threads", type=int, default=None,
                    help="override WindowParams.finish_threads (scaling "
                         "measurements)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from nucleoatac_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    t0 = time.perf_counter()
    bam, bed, fa = synth_dataset(
        args.workdir, args.chroms, args.peaks, args.peak_bp,
        args.frags_per_peak, seed=args.seed,
    )
    t_synth = time.perf_counter() - t0

    outdir = args.out or os.path.join(args.workdir, "nucleoatac_e2e_out")
    os.makedirs(outdir, exist_ok=True)
    prefix = os.path.join(outdir, "run")

    from nucleoatac_jax.models.pipeline import run_pipeline

    # standalone ingest probe (BASELINE config "ingest MB/s"): C++ BGZF
    # inflate + BAM parse + per-chrom midpoint sort
    from nucleoatac_jax.io.bam import scan_bam

    t0 = time.perf_counter()
    frags_probe = scan_bam(bam)
    t_ingest = time.perf_counter() - t0
    bam_mb = os.path.getsize(bam) / 1e6
    n_ingested = frags_probe.n_fragments()
    del frags_probe

    run_cfg = None
    if args.strict or args.finish_threads is not None or args.batch is not None:
        import dataclasses

        from nucleoatac_jax.config import NucParams, RunConfig, WindowParams

        run_cfg = RunConfig()
        if args.strict:
            run_cfg = dataclasses.replace(run_cfg, nuc=NucParams(strict=True))
        wkw = {}
        if args.finish_threads is not None:
            wkw["finish_threads"] = args.finish_threads
        if args.batch is not None:
            wkw["batch"] = args.batch
        if wkw:
            run_cfg = dataclasses.replace(
                run_cfg,
                window=dataclasses.replace(run_cfg.window, **wkw),
            )
    t0 = time.perf_counter()
    res = run_pipeline(bam, bed, prefix, fasta_path=fa, write_plots=False,
                       cfg=run_cfg)
    t_run = time.perf_counter() - t0

    import resource

    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    total_bp = args.peaks * args.peak_bp
    n_frags = args.peaks * args.frags_per_peak

    from nucleoatac_jax.config import RunConfig
    from nucleoatac_jax.core.chunk import ChunkList
    from nucleoatac_jax.io.bam import scan_bam as _scan
    from nucleoatac_jax.models.data import tile_chunks

    _cfg = RunConfig()
    n_windows = len(
        tile_chunks(
            ChunkList.read(bed, _scan(bam).chrom_dict).merge(),
            _cfg.window, _cfg.occ, _cfg.vmat,
        )
    )
    print(json.dumps({
        "metric": "e2e pipeline peak-bp/s (ingest+occ+nuc+merge+nfr+writers)",
        "value": round(total_bp / t_run, 1),
        "unit": "bp/s",
        "wall_s": round(t_run, 2),
        "windows": n_windows,
        "windows_per_s": round(n_windows / t_run, 2),
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "peaks": args.peaks,
        "fragments": n_frags,
        "ingest_MBps": round(bam_mb / t_ingest, 1),
        "ingest_frags_per_s": round(n_ingested / t_ingest, 1),
        "bam_MB": round(bam_mb, 1),
        "peak_rss_MB": round(rss_mb, 1),
        "dyads_called": len(res.nuc.calls),
        "nfrs": len(res.nfrs),
        "synth_s": round(t_synth, 1),
    }))


if __name__ == "__main__":
    main()
