"""Multi-host `nucleoatac run`: contiguous chunk shards per host + merge.

Multi-host replacement for the reference's single-host pool (SURVEY.md
§3.3): each host process takes a contiguous (genome-ordered) slice of the
peak chunks, runs occ+nuc over its local devices writing
`<out>.part<k>.*` shards, and host 0 concatenates the shards (re-indexing
tabix) and runs the cheap merge/nfr host stages on the combined outputs.
Works under jax.distributed (JAX_COORDINATOR_ADDRESS et al.) or any
external launcher passing --num_hosts/--host_id explicitly.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from nucleoatac_jax.config import RunConfig
from nucleoatac_jax.core.chunk import ChunkList
from nucleoatac_jax.core.pwm import PWM
from nucleoatac_jax.core.vmat import VMat
from nucleoatac_jax.io.bam import scan_bam
from nucleoatac_jax.io.fasta import FastaFile
from nucleoatac_jax.models.engine import DeviceEngine
from nucleoatac_jax.models.nuc import NucStage
from nucleoatac_jax.models.occ import OccStage, fit_mixture
from nucleoatac_jax.models.pipeline import occ_lookup_from_tracks
from nucleoatac_jax.parallel.distributed import (
    host_tile_slice,
    init_distributed,
    merge_host_shards,
)
from nucleoatac_jax.utils.logging import log

_SHARD_SUFFIXES = [
    ".occ.bedgraph.gz",
    ".occ.lower_bound.bedgraph.gz",
    ".occ.upper_bound.bedgraph.gz",
    ".occpeaks.bed.gz",
    ".nucleoatac_signal.bedgraph.gz",
    ".nucleoatac_signal.smooth.bedgraph.gz",
    ".nucpos.bed.gz",
    ".nucpos.redundant.bed.gz",
]


def _run_fingerprint(bam: str, bed: str, cfg: RunConfig) -> str:
    """Identity of a logical run: inputs + config. Shards from a different
    run (stale leftovers, changed flags) must never merge silently."""
    import hashlib
    import os

    h = hashlib.sha256()
    h.update(repr(cfg).encode())
    for p in (bam, bed):
        st = os.stat(p)
        h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


def _write_manifest(shard_prefix: str, pid: int, nhosts: int, fp: str) -> None:
    """Written AFTER every shard file is closed — its presence certifies a
    complete, fresh shard (VERDICT r1 item 10)."""
    import hashlib
    import json
    import os

    files = {}
    for suffix in _SHARD_SUFFIXES + [".nuc_dist.txt"]:
        p = shard_prefix + suffix
        md5 = hashlib.md5()
        with open(p, "rb") as fh:
            for block in iter(lambda: fh.read(1 << 20), b""):
                md5.update(block)
        files[suffix] = {"size": os.path.getsize(p), "md5": md5.hexdigest()}
    with open(shard_prefix + ".manifest.json", "w") as fh:
        json.dump(
            {"host_id": pid, "num_hosts": nhosts, "fingerprint": fp,
             "files": files},
            fh,
        )


def check_manifests(out_prefix: str, nhosts: int, fp: str) -> None:
    """Refuse to merge unless every host wrote a complete, matching
    manifest and every shard file still matches it (crashed hosts leave
    no manifest; stale shards from another run carry the wrong
    fingerprint; truncated/modified files fail size/md5)."""
    import hashlib
    import json
    import os

    for k in range(nhosts):
        mpath = f"{out_prefix}.part{k}.manifest.json"
        if not os.path.exists(mpath):
            raise RuntimeError(
                f"finalize: missing shard manifest {mpath} — host {k} did "
                f"not complete; refusing to merge"
            )
        with open(mpath) as fh:
            m = json.load(fh)
        if m.get("num_hosts") != nhosts or m.get("host_id") != k:
            raise RuntimeError(
                f"finalize: manifest {mpath} is for host {m.get('host_id')}"
                f"/{m.get('num_hosts')} hosts, expected {k}/{nhosts}"
            )
        if m.get("fingerprint") != fp:
            raise RuntimeError(
                f"finalize: manifest {mpath} fingerprint {m.get('fingerprint')}"
                f" != this run's {fp} — stale shards from a different "
                f"run/config; refusing to merge"
            )
        for suffix, want in m["files"].items():
            p = f"{out_prefix}.part{k}{suffix}"
            if not os.path.exists(p) or os.path.getsize(p) != want["size"]:
                raise RuntimeError(
                    f"finalize: shard {p} missing or size-mismatched vs "
                    "its manifest; refusing to merge"
                )
            md5 = hashlib.md5()
            with open(p, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 20), b""):
                    md5.update(block)
            if md5.hexdigest() != want["md5"]:
                raise RuntimeError(
                    f"finalize: shard {p} checksum mismatch vs its "
                    "manifest; refusing to merge"
                )


def fit_mixture_distributed(frags, all_chunks, cfg, pid: int, nhosts: int):
    """Genome-wide size histogram + mixture fit, sharded across hosts.

    Under a live jax.distributed runtime each host bins only ITS chunk
    shard and the global histogram comes from one cross-host collective
    (allgather + ordered sum — deterministic), removing the
    O(hosts x genome) startup of every host binning every chunk (VERDICT
    r1 item 7). File-shard launchers without a collective runtime fall
    back to each host computing the identical full fit."""
    import jax

    if jax.process_count() <= 1:
        return fit_mixture(frags, all_chunks, cfg)

    from jax.experimental import multihost_utils

    from nucleoatac_jax.core.fragmentsizes import FragmentSizes
    from nucleoatac_jax.core.mixture import FragmentMixDistribution

    local = ChunkList(host_tile_slice(all_chunks.chunks, pid, nhosts))
    fs_local = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper)
    for c in local:
        _, sizes = frags.window(c.chrom, c.start, c.end)
        fs_local.add_sizes(sizes)
    counts = np.asarray(fs_local.vals, np.int64)
    gathered = np.asarray(multihost_utils.process_allgather(counts))
    total = gathered.sum(axis=0)  # fixed host order -> deterministic
    fs = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper, total)
    mix = FragmentMixDistribution(
        cfg.sizes.lower, cfg.sizes.upper, cfg.mixture
    ).fit(fs)
    return fs, mix


def run_distributed(
    bam: str,
    bed: str,
    out_prefix: str,
    fasta_path: Optional[str] = None,
    pwm_path: Optional[str] = None,
    vmat_path: Optional[str] = None,
    cfg: Optional[RunConfig] = None,
    host_id: Optional[int] = None,
    num_hosts: Optional[int] = None,
) -> None:
    cfg = cfg or RunConfig()
    pid, nhosts = init_distributed()
    if host_id is not None:
        pid = host_id
    if num_hosts is not None:
        nhosts = num_hosts

    frags = scan_bam(bam, cfg.ingest)
    fasta = FastaFile(fasta_path) if fasta_path else None
    pwm = PWM.open(pwm_path) if pwm_path else PWM.default()
    vmat = VMat.open(vmat_path) if vmat_path else VMat.default(cfg.vmat)
    all_chunks = ChunkList.read(bed, frags.chrom_dict).merge()

    fs, mix = fit_mixture_distributed(frags, all_chunks, cfg, pid, nhosts)
    if pid == 0:
        fs.save(f"{out_prefix}.fragmentsizes.txt")
        mix.save(f"{out_prefix}.occ_fit.txt")

    local_chunks = ChunkList(host_tile_slice(all_chunks.chunks, pid, nhosts))
    log.info("host %d/%d: %d of %d chunks", pid, nhosts, len(local_chunks),
             len(all_chunks))
    shard_prefix = f"{out_prefix}.part{pid}"
    from nucleoatac_jax.models.pipeline import auto_mesh

    engine = DeviceEngine(cfg, mix, fs, vmat, pwm=pwm, mesh=auto_mesh(cfg), conv_mode=cfg.window.conv)
    occ_res = OccStage(cfg, engine).run(
        frags, local_chunks, mix, fs, shard_prefix, keep_tracks=True
    )
    nuc_res = NucStage(cfg, engine, pwm, fasta).run(
        frags, local_chunks, occ_lookup_from_tracks(occ_res), shard_prefix
    )
    np.savetxt(
        f"{shard_prefix}.nuc_dist.txt", nuc_res.nuc_dist[None], fmt="%d",
        delimiter="\t",
    )
    _write_manifest(shard_prefix, pid, nhosts, _run_fingerprint(bam, bed, cfg))

    # Finalize here only when we can know every host is done: single host,
    # or a real jax.distributed barrier. External launchers (e.g. slurm)
    # run all hosts, then call finalize_shards once (CLI `--finalize`).
    import jax

    if nhosts <= 1:
        finalize_shards(out_prefix, nhosts, bam, bed, fasta_path, pwm_path, cfg)
    elif jax.process_count() > 1:
        _sync(nhosts)
        if pid == 0:
            finalize_shards(
                out_prefix, nhosts, bam, bed, fasta_path, pwm_path, cfg
            )


def _sync(nhosts: int) -> None:
    if nhosts <= 1:
        return
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("nucleoatac_shards")
    # external launchers without jax.distributed coordinate via their own
    # barrier (e.g. the caller waits for all hosts before finalize)


def finalize_shards(
    out_prefix: str,
    nhosts: int,
    bam: str,
    bed: str,
    fasta_path: Optional[str],
    pwm_path: Optional[str],
    cfg: RunConfig,
) -> None:
    """Concatenate per-host shards (rebuilding tabix), sum nuc_dist, then
    run the host-side merge + nfr stages on the combined outputs. Refuses
    to merge unless every shard carries a complete, fresh manifest
    (check_manifests — VERDICT r1 item 10)."""
    import argparse
    import os

    check_manifests(out_prefix, nhosts, _run_fingerprint(bam, bed, cfg))
    for suffix in _SHARD_SUFFIXES:
        merge_host_shards(out_prefix, suffix, nhosts)
    dist = None
    for k in range(nhosts):
        p = f"{out_prefix}.part{k}.nuc_dist.txt"
        d = np.loadtxt(p, ndmin=2)
        dist = d if dist is None else dist + d
        os.remove(p)
        os.remove(f"{out_prefix}.part{k}.manifest.json")
    np.savetxt(f"{out_prefix}.nuc_dist.txt", dist, fmt="%d", delimiter="\t")

    from nucleoatac_jax.models.standalone import run_merge, run_nfr

    margs = argparse.Namespace(
        occpeaks=f"{out_prefix}.occpeaks.bed.gz",
        nucpos=f"{out_prefix}.nucpos.bed.gz",
        out=out_prefix,
        sep=cfg.occ.occ_sep,
    )
    run_merge(margs)
    nargs = argparse.Namespace(
        bam=bam, bed=bed, out=out_prefix, fasta=fasta_path, pwm=pwm_path,
        occ_track_prefix=out_prefix, calls=None,
        # tuning flags consumed by build_config via getattr defaults
        lower=cfg.sizes.lower, upper=cfg.sizes.upper, flank=cfg.occ.flank,
        min_occ=cfg.occ.min_occ, occ_sep=cfg.occ.occ_sep,
        nuc_sep=cfg.nuc.nuc_sep, min_z=cfg.nuc.min_z, min_lr=cfg.nuc.min_lr,
        smooth_sd=cfg.nuc.smooth_sd, max_occ_upper=cfg.nfr.max_occ_upper,
        min_nfr_len=cfg.nfr.min_nfr_len, max_nfr_len=cfg.nfr.max_nfr_len,
        not_atac=not cfg.ingest.atac,
    )
    run_nfr(nargs)
