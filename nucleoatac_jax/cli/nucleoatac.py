"""`nucleoatac` CLI: run / occ / vprocess / nuc / merge / nfr.

Flag-compatible rebuild of reference:nucleoatac/cli.py :: main /
nucleoatac_parser (SURVEY.md §3.2 L4). Shared flags: --bed --bam --fasta
--out [--pwm] [--vmat] [--cores]; --cores is accepted for compatibility
but parallelism is device-mesh based (see nucleoatac_jax.parallel).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from nucleoatac_jax.config import (
    NFRParams,
    NucParams,
    OccParams,
    RunConfig,
    SizesParams,
    WindowParams,
)


def _common(p: argparse.ArgumentParser, fasta_required: bool = False) -> None:
    p.add_argument("--bed", required=True, help="peak regions (BED)")
    p.add_argument("--bam", required=True, help="coordinate-sorted paired-end BAM")
    p.add_argument("--out", required=True, help="output prefix")
    p.add_argument("--fasta", required=fasta_required, default=None)
    p.add_argument("--pwm", default=None, help="Tn5 PWM file (default: built-in)")
    p.add_argument("--cores", type=int, default=1, help="compat flag (device-parallel)")
    p.add_argument("--no_plots", action="store_true")


def _tune(p: argparse.ArgumentParser) -> None:
    p.add_argument("--lower", type=int, default=SizesParams.lower)
    p.add_argument("--upper", type=int, default=SizesParams.upper)
    p.add_argument("--flank", type=int, default=OccParams.flank)
    p.add_argument("--min_occ", type=float, default=OccParams.min_occ)
    p.add_argument("--occ_sep", type=int, default=OccParams.occ_sep)
    p.add_argument("--nuc_sep", type=int, default=NucParams.nuc_sep)
    p.add_argument("--min_z", type=float, default=NucParams.min_z)
    p.add_argument("--min_lr", type=float, default=NucParams.min_lr)
    p.add_argument("--smooth_sd", type=float, default=NucParams.smooth_sd)
    p.add_argument("--max_occ_upper", type=float, default=NFRParams.max_occ_upper)
    p.add_argument("--min_nfr_len", type=int, default=NFRParams.min_nfr_len)
    p.add_argument("--max_nfr_len", type=int, default=NFRParams.max_nfr_len)
    p.add_argument("--not_atac", action="store_true", help="skip +4/-5 offsets")
    p.add_argument(
        "--strict", action="store_true",
        help="f64-refinish the smoothed-score column of every printed "
             "nucpos row (removes the last cross-backend %%.5g "
             "divergence, at a higher host-finishing cost)",
    )
    p.add_argument(
        "--platform", default=None, metavar="NAME",
        help="force the jax platform (e.g. cpu) — applied before any "
             "device use",
    )
    p.add_argument(
        "--batch", type=int, default=WindowParams.batch,
        help="windows per device batch (bigger amortizes per-transfer cost)",
    )
    p.add_argument(
        "--conv", default=WindowParams.conv,
        choices=["diag", "direct"],
        help="nuc conv-stack implementation (diag: batched GEMM + "
             "diagonal sum; direct: two XLA convolutions)",
    )
    p.add_argument(
        "--transfer", default=WindowParams.transfer,
        choices=["pool", "delta12", "delta", "packed", "frags", "dense"],
        help="host->device wire format (DESIGN.md §10)",
    )
    p.add_argument(
        "--fetch-threads", type=int, default=WindowParams.fetch_threads,
        help="concurrent device->host fetch threads (0 = serial async "
             "pipelining)",
    )
    p.add_argument(
        "--finish-threads", type=int, default=WindowParams.finish_threads,
        help="host chunk-finishing worker threads (-1 = auto, 0 = serial; "
             "writes stay genome-ordered)",
    )


def build_config(args: argparse.Namespace) -> RunConfig:
    cfg = RunConfig()
    transfer = getattr(args, "transfer", cfg.window.transfer)
    upper = getattr(args, "upper", cfg.sizes.upper)
    if transfer in ("delta", "delta12", "pool") and upper > 255:
        import sys

        print(
            f"WARNING: --upper {upper} > 255 is incompatible with the "
            f"'{transfer}' wire format (uint8 size field); falling back "
            "to 'packed'",
            file=sys.stderr,
        )
        transfer = "packed"
    return dataclasses.replace(
        cfg,
        ingest=dataclasses.replace(cfg.ingest, atac=not getattr(args, "not_atac", False)),
        window=dataclasses.replace(
            cfg.window,
            conv=getattr(args, "conv", cfg.window.conv),
            batch=getattr(args, "batch", cfg.window.batch),
            transfer=transfer,
            fetch_threads=getattr(
                args, "fetch_threads", cfg.window.fetch_threads
            ),
            finish_threads=getattr(
                args, "finish_threads", cfg.window.finish_threads
            ),
        ),
        sizes=dataclasses.replace(cfg.sizes, lower=args.lower, upper=args.upper),
        occ=dataclasses.replace(
            cfg.occ, flank=args.flank, min_occ=args.min_occ, occ_sep=args.occ_sep
        ),
        nuc=dataclasses.replace(
            cfg.nuc,
            nuc_sep=args.nuc_sep,
            min_z=args.min_z,
            min_lr=args.min_lr,
            smooth_sd=args.smooth_sd,
            strict=getattr(args, "strict", False),
        ),
        nfr=dataclasses.replace(
            cfg.nfr,
            max_occ_upper=args.max_occ_upper,
            min_nfr_len=args.min_nfr_len,
            max_nfr_len=args.max_nfr_len,
        ),
    )


def nucleoatac_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nucleoatac",
        description="Nucleosome calling from ATAC-seq on an accelerator "
        "(capabilities of GreenleafLab/NucleoATAC)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("run", help="occ + nuc + merge + nfr")
    _common(pr)
    _tune(pr)
    pr.add_argument("--vmat", default=None, help="V-plot template (default built-in)")
    pr.add_argument("--bias_track", default=None, metavar="BEDGRAPH_GZ",
                    help="precomputed per-bp log-bias track (pyatac bias "
                    "output) used instead of FASTA+PWM scoring")
    pr.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax profiler trace to DIR")
    pr.add_argument("--num_hosts", type=int, default=None,
                    help="multi-host run: total hosts (or via jax.distributed env)")
    pr.add_argument("--host_id", type=int, default=None,
                    help="multi-host run: this host's index")
    pr.add_argument("--resume", action="store_true",
                    help="reuse existing occ outputs (stage files are "
                    "checkpoints, as in the reference)")
    pr.add_argument("--finalize", action="store_true",
                    help="merge per-host shards + run merge/nfr (host 0, "
                    "after all hosts finish; automatic under jax.distributed)")

    po = sub.add_parser("occ", help="occupancy stage only")
    _common(po)
    _tune(po)

    pv = sub.add_parser("vprocess", help="raw aggregate V-plot -> template")
    pv.add_argument("--vplot", required=True, help="raw V-plot matrix (VMat text)")
    pv.add_argument("--out", required=True)
    pv.add_argument("--lower", type=int, default=105)
    pv.add_argument("--upper", type=int, default=251)
    pv.add_argument("--width", type=int, default=147)
    pv.add_argument("--smooth_sd_size", type=float, default=1.0)
    pv.add_argument("--smooth_sd_pos", type=float, default=1.0)
    pv.add_argument("--no_plots", action="store_true")

    pn = sub.add_parser("nuc", help="dyad-calling stage only")
    _common(pn)
    _tune(pn)
    pn.add_argument("--vmat", default=None)
    pn.add_argument(
        "--occ_track_prefix", default=None,
        help="prefix of a prior `occ` run (defaults to --out)",
    )
    pn.add_argument("--sizes", default=None, help="fragmentsizes.txt from occ run")
    pn.add_argument("--bias_track", default=None, metavar="BEDGRAPH_GZ",
                    help="precomputed per-bp log-bias track (pyatac bias "
                    "output) used instead of FASTA+PWM scoring")

    pm = sub.add_parser("merge", help="merge occpeaks + nucpos")
    pm.add_argument("--occpeaks", required=True)
    pm.add_argument("--nucpos", required=True)
    pm.add_argument("--out", required=True)
    pm.add_argument("--sep", type=int, default=OccParams.occ_sep)

    pf = sub.add_parser("nfr", help="NFR calling from a prior run")
    _common(pf)
    _tune(pf)
    pf.add_argument("--occ_track_prefix", default=None)
    pf.add_argument("--calls", default=None, help="nucmap_combined.bed.gz")
    pf.add_argument("--bias_track", default=None, metavar="BEDGRAPH_GZ",
                    help="precomputed per-bp log-bias track (pyatac bias "
                    "output) used instead of FASTA+PWM scoring")
    return p


def main(argv=None) -> int:
    from nucleoatac_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    args = nucleoatac_parser().parse_args(argv)
    if getattr(args, "platform", None):
        import jax

        jax.config.update("jax_platforms", args.platform)
    if args.command in ("run", "occ", "nuc"):
        import jax

        from nucleoatac_jax.utils.logging import log

        log.info("jax backend: %s (%s, %d devices)", jax.default_backend(),
                 jax.devices()[0].device_kind, len(jax.devices()))
    if args.command == "run":
        if args.finalize:
            from nucleoatac_jax.models.distributed_pipeline import finalize_shards

            finalize_shards(
                args.out, args.num_hosts or 1, args.bam, args.bed,
                args.fasta, args.pwm, build_config(args),
            )
            return 0
        if args.num_hosts or args.host_id is not None:
            from nucleoatac_jax.models.distributed_pipeline import run_distributed

            run_distributed(
                args.bam, args.bed, args.out,
                fasta_path=args.fasta, pwm_path=args.pwm, vmat_path=args.vmat,
                cfg=build_config(args), host_id=args.host_id,
                num_hosts=args.num_hosts,
            )
            return 0
        from nucleoatac_jax.models.pipeline import run_pipeline

        run_pipeline(
            args.bam, args.bed, args.out,
            fasta_path=args.fasta, pwm_path=args.pwm, vmat_path=args.vmat,
            cfg=build_config(args), write_plots=not args.no_plots,
            profile_dir=args.profile, resume=args.resume,
            bias_track=args.bias_track,
        )
        return 0
    if args.command == "occ":
        from nucleoatac_jax.models.standalone import run_occ

        run_occ(args)
        return 0
    if args.command == "vprocess":
        from nucleoatac_jax.config import VMatParams
        from nucleoatac_jax.core.vmat import VMat

        raw = VMat.open(args.vplot)
        params = VMatParams(
            lower=args.lower, upper=args.upper, width=args.width,
            smooth_sd_size=args.smooth_sd_size, smooth_sd_pos=args.smooth_sd_pos,
        )
        v = VMat.process_raw(raw.mat, raw.lower, params)
        v.save(f"{args.out}.VMat")
        if not args.no_plots:
            from nucleoatac_jax.utils import plotting

            plotting.plot_vmat(v, f"{args.out}.VMat.eps")
            plotting.plot_vmat_1d(v, f"{args.out}.VMat.1d.eps")
        return 0
    if args.command == "nuc":
        from nucleoatac_jax.models.standalone import run_nuc

        run_nuc(args)
        return 0
    if args.command == "merge":
        from nucleoatac_jax.models.standalone import run_merge

        run_merge(args)
        return 0
    if args.command == "nfr":
        from nucleoatac_jax.models.standalone import run_nfr

        run_nfr(args)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
