"""`nucleoatac run`: occ -> nuc -> merge -> nfr with in-memory handoff.

Rebuild of reference:nucleoatac/cli.py run flow (SURVEY.md §4.3). The
reference hands stages off through files on disk; here stage artifacts
stay HBM/host-resident within a run while every reference output file is
still written for compatibility (SURVEY.md §3.3 "stage pipeline" row).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from nucleoatac_jax.config import RunConfig
from nucleoatac_jax.core.chunk import Chunk, ChunkList
from nucleoatac_jax.core.pwm import PWM
from nucleoatac_jax.core.vmat import VMat
from nucleoatac_jax.io.bam import BamFragments, scan_bam
from nucleoatac_jax.io.fasta import FastaFile
from nucleoatac_jax.models.engine import DeviceEngine
from nucleoatac_jax.models.merge import merge_maps
from nucleoatac_jax.models.nfr import call_nfrs
from nucleoatac_jax.models.nuc import NucStage, NucStageResult
from nucleoatac_jax.core.fragmentsizes import FragmentSizes  # noqa: F401
from nucleoatac_jax.models.occ import OccStage, OccStageResult, fit_mixture


@dataclass
class RunResult:
    occ: OccStageResult
    nuc: NucStageResult
    combined: list
    nfrs: list


def _occ_outputs_exist(prefix: str) -> bool:
    import os

    return all(
        os.path.exists(prefix + s)
        for s in (
            ".occ.bedgraph.gz", ".occ.lower_bound.bedgraph.gz",
            ".occ.upper_bound.bedgraph.gz", ".occpeaks.bed.gz",
            ".fragmentsizes.txt", ".occ_fit.txt",
        )
    )


def _load_occ_stage(prefix: str, cfg: RunConfig, chunks: ChunkList):
    """--resume: reconstruct the occ stage result from its file artifacts
    (the reference's stage files double as checkpoints — SURVEY.md §6)."""
    import gzip

    from nucleoatac_jax.core.fragmentsizes import FragmentSizes
    from nucleoatac_jax.core.mixture import FragmentMixDistribution
    from nucleoatac_jax.models.occ import OccPeak
    from nucleoatac_jax.models.standalone import OccTrackReader

    fs = FragmentSizes.open(f"{prefix}.fragmentsizes.txt")
    mix = FragmentMixDistribution.open(f"{prefix}.occ_fit.txt")
    reader = OccTrackReader(prefix)
    res = OccStageResult(mix=mix, fragmentsizes=fs, chunks=chunks)
    for cid, chunk in enumerate(chunks):
        res.tracks[cid] = reader.chunk_tracks(chunk)
    flank = cfg.occ.flank
    with gzip.open(f"{prefix}.occpeaks.bed.gz", "rt") as fh:
        for line in fh:
            f = line.split("\t")
            if len(f) >= 6:
                res.peaks.append(
                    OccPeak(f[0], int(f[1]) + flank, float(f[3]), float(f[4]),
                            float(f[5]))
                )
    return fs, mix, res


def occ_lookup_from_tracks(occ_result: OccStageResult):
    """occ stat accessor for dyad calls, backed by in-memory chunk tracks."""

    def lookup(cid: int, chunk: Chunk, pos: int) -> Tuple[float, float, float]:
        tr = occ_result.tracks.get(cid)
        if tr is None:
            return 0.0, 0.0, 1.0
        i = pos - chunk.start
        if i < 0 or i >= len(tr["occ"]):
            return 0.0, 0.0, 1.0
        return float(tr["occ"][i]), float(tr["lower"][i]), float(tr["upper"][i])

    return lookup


def auto_mesh(cfg: RunConfig):
    """1-D ('data',) mesh over all local devices when the window batch
    divides evenly; None (single-device jit) otherwise. The reference
    scales with `--cores` processes (SURVEY.md §3.3); here extra chips
    shard the window batch."""
    import jax

    devs = jax.devices()
    if len(devs) > 1 and cfg.window.batch % len(devs) == 0:
        from nucleoatac_jax.parallel.mesh import make_mesh

        return make_mesh()
    return None


def run_pipeline(
    bam: str,
    bed: str,
    out_prefix: str,
    fasta_path: Optional[str] = None,
    pwm_path: Optional[str] = None,
    vmat_path: Optional[str] = None,
    cfg: Optional[RunConfig] = None,
    write_plots: bool = True,
    profile_dir: Optional[str] = None,
    resume: bool = False,
    bias_track: Optional[str] = None,
) -> RunResult:
    from nucleoatac_jax.models.standalone import warn_synthetic_defaults
    from nucleoatac_jax.utils.logging import log, maybe_profile, stage_timer

    cfg = cfg or RunConfig()
    warn_synthetic_defaults(pwm_path, vmat_path, bias_track, needs_vmat=True)
    with maybe_profile(profile_dir):
        with stage_timer("ingest"):
            frags = scan_bam(bam, cfg.ingest)
            log.info("ingest: %d fragments, %d chroms",
                     frags.n_fragments(), len(frags.ref_names))
        fasta = FastaFile(fasta_path) if fasta_path else None
        pwm = PWM.open(pwm_path) if pwm_path else PWM.default()
        vmat = VMat.open(vmat_path) if vmat_path else VMat.default(cfg.vmat)
        bias_source = None
        if bias_track:
            from nucleoatac_jax.models.nuc import BiasTrackSource

            bias_source = BiasTrackSource(bias_track)

        chrom_dict = frags.chrom_dict
        chunks = ChunkList.read(bed, chrom_dict).merge()
        log.info("peaks: %d chunks, %d bp", len(chunks), chunks.total_bp())

        # --- occ + nuc stages (reference run_occ.py / run_nuc.py) ------
        from nucleoatac_jax.models.fused import fused_supported, run_fused

        if resume and _occ_outputs_exist(out_prefix):
            with stage_timer("occ (resumed from files)"):
                fs, mix, occ_res = _load_occ_stage(out_prefix, cfg, chunks)
                engine = DeviceEngine(
                    cfg, mix, fs, vmat, pwm=None if bias_source else pwm,
                    mesh=auto_mesh(cfg), conv_mode=cfg.window.conv,
                )
            with stage_timer("nuc"):
                nuc_stage = NucStage(cfg, engine, pwm, fasta, bias_source=bias_source)
                nuc_res = nuc_stage.run(
                    frags, chunks, occ_lookup_from_tracks(occ_res), out_prefix
                )
                log.info("nuc: %d dyads (%d redundant)",
                         len(nuc_res.calls), len(nuc_res.redundant))
        else:
            with stage_timer("fit"):
                fs, mix = fit_mixture(frags, chunks, cfg)
                fs.save(f"{out_prefix}.fragmentsizes.txt")
                mix.save(f"{out_prefix}.occ_fit.txt")
                if write_plots:
                    from nucleoatac_jax.utils import plotting  # needs matplotlib

                    plotting.plot_occ_fit(mix, f"{out_prefix}.occ_fit.eps")
                engine = DeviceEngine(
                    cfg, mix, fs, vmat, pwm=None if bias_source else pwm,
                    mesh=auto_mesh(cfg), conv_mode=cfg.window.conv,
                )
            occ_stage = OccStage(cfg, engine)
            nuc_stage = NucStage(cfg, engine, pwm, fasta, bias_source=bias_source)
            if fused_supported(cfg, engine):
                # one upload + one download per batch for BOTH stages
                # (models/fused.py) — outputs byte-identical to the
                # two-pass path, at roughly half the wire bytes
                with stage_timer("occ+nuc (fused pass)"):
                    occ_res, nuc_res = run_fused(
                        cfg, engine, occ_stage, nuc_stage, frags, chunks,
                        mix, fs, out_prefix, keep_tracks=False,
                    )
                    log.info(
                        "occ: %d occ peaks; nuc: %d dyads (%d redundant)",
                        len(occ_res.peaks), len(nuc_res.calls),
                        len(nuc_res.redundant),
                    )
                    # occ tracks were evicted as nuc consumed them (host
                    # memory stays O(batch), VERDICT r2 item 5); downstream
                    # consumers (nfr, library users) stream them back per
                    # chunk from the indexed bedgraphs just written
                    from nucleoatac_jax.models.standalone import (
                        OccTrackReader,
                        _LazyOccTracks,
                    )

                    occ_res.tracks = _LazyOccTracks(
                        OccTrackReader(out_prefix), chunks
                    )
            else:
                with stage_timer("occ"):
                    occ_res = occ_stage.run(
                        frags, chunks, mix, fs, out_prefix, keep_tracks=True
                    )
                    log.info("occ: %d occ peaks", len(occ_res.peaks))
                with stage_timer("nuc"):
                    nuc_res = nuc_stage.run(
                        frags, chunks, occ_lookup_from_tracks(occ_res),
                        out_prefix,
                    )
                    log.info("nuc: %d dyads (%d redundant)",
                             len(nuc_res.calls), len(nuc_res.redundant))
                # NFR must consume the SAME occ surface in both the fused
                # and two-pass paths: the written bedgraphs (5-decimal
                # print surface — also the reference contract: its nfr
                # stage reads the occ bedgraph, not process memory).
                # Without this swap a value within 5e-6 of an NFR
                # threshold could make fused and two-pass nfrpos.bed
                # diverge (round-3 review finding).
                from nucleoatac_jax.models.standalone import (
                    OccTrackReader,
                    _LazyOccTracks,
                )

                occ_res.tracks = _LazyOccTracks(
                    OccTrackReader(out_prefix), chunks
                )
        np.savetxt(
            f"{out_prefix}.nuc_dist.txt", nuc_res.nuc_dist[None], fmt="%d",
            delimiter="\t",
        )
        if write_plots:
            from nucleoatac_jax.utils import plotting  # needs matplotlib

            plotting.plot_nuc_dist(nuc_res.nuc_dist, f"{out_prefix}.nuc_dist.eps")

        # --- merge (reference merge.py) --------------------------------
        combined = merge_maps(
            nuc_res.calls, occ_res.peaks, cfg.occ.occ_sep,
            f"{out_prefix}.nucmap_combined.bed.gz",
        )

        # --- nfr (reference run_nfr.py) --------------------------------
        with stage_timer("nfr"):
            # nfr iterates chunks strictly in order -> stream the written
            # occ bedgraphs in ONE pass instead of per-chunk indexed
            # fetches (same 5-decimal printed surface as occ_res.tracks)
            from nucleoatac_jax.models.standalone import SequentialOccTracks

            nfrs = call_nfrs(
                cfg, chunks, combined,
                SequentialOccTracks(out_prefix, chunks), frags, pwm, fasta,
                f"{out_prefix}.nfrpos.bed.gz",
                bias_fn=bias_source.log_bias if bias_source else None,
            )
            log.info("nfr: %d NFRs; combined map: %d", len(nfrs), len(combined))
    return RunResult(occ_res, nuc_res, combined, nfrs)
