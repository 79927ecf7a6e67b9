"""Multi-host file-shard pipeline: 2 simulated hosts == single-host run."""
import gzip
import os

import numpy as np
import pytest

from nucleoatac_jax.models.distributed_pipeline import run_distributed
from nucleoatac_jax.models.pipeline import run_pipeline
from tests.synth import make_example


@pytest.fixture(scope="module")
def ex(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    e = make_example(d)
    # second peak chunk so the 2-host split is non-trivial
    with open(e["bed"], "a") as fh:
        fh.write("chr1\t3600\t5600\tpeak2\n")
    return e


def _read(path):
    return gzip.open(path, "rt").read()


def test_two_host_shards_equal_single_run(ex, tmp_path_factory):
    d = tmp_path_factory.mktemp("out")
    single = str(d / "single")
    run_pipeline(ex["bam"], ex["bed"], single, fasta_path=ex["fasta"],
                 write_plots=False)

    multi = str(d / "multi")
    # two hosts executed sequentially in-process (the file-shard contract
    # is launcher-agnostic; jax.distributed not needed for correctness)
    run_distributed(ex["bam"], ex["bed"], multi, fasta_path=ex["fasta"],
                    host_id=0, num_hosts=2)
    run_distributed(ex["bam"], ex["bed"], multi, fasta_path=ex["fasta"],
                    host_id=1, num_hosts=2)
    from nucleoatac_jax.config import RunConfig
    from nucleoatac_jax.models.distributed_pipeline import finalize_shards

    finalize_shards(multi, 2, ex["bam"], ex["bed"], ex["fasta"], None,
                    RunConfig())

    for suffix in (
        ".occ.bedgraph.gz", ".occpeaks.bed.gz", ".nucpos.bed.gz",
        ".nucmap_combined.bed.gz", ".nfrpos.bed.gz",
    ):
        assert _read(single + suffix) == _read(multi + suffix), suffix
        assert os.path.exists(multi + suffix + ".tbi")
    s = np.loadtxt(single + ".nuc_dist.txt", ndmin=2)
    m = np.loadtxt(multi + ".nuc_dist.txt", ndmin=2)
    np.testing.assert_array_equal(s, m)


def test_finalize_refuses_incomplete_or_stale_shards(ex, tmp_path_factory):
    """VERDICT r1 item 10: --finalize must not silently merge shards from
    a crashed host (missing manifest) or a different run (fingerprint)."""
    import json

    from nucleoatac_jax.config import RunConfig
    from nucleoatac_jax.models.distributed_pipeline import finalize_shards

    d = tmp_path_factory.mktemp("guard")
    multi = str(d / "multi")
    run_distributed(ex["bam"], ex["bed"], multi, fasta_path=ex["fasta"],
                    host_id=0, num_hosts=2)
    # host 1 "crashed": no shard, no manifest
    with pytest.raises(RuntimeError, match="did not complete"):
        finalize_shards(multi, 2, ex["bam"], ex["bed"], ex["fasta"], None,
                        RunConfig())
    # host 1 present but its manifest carries a different fingerprint
    run_distributed(ex["bam"], ex["bed"], multi, fasta_path=ex["fasta"],
                    host_id=1, num_hosts=2)
    mpath = multi + ".part1.manifest.json"
    m = json.load(open(mpath))
    m["fingerprint"] = "deadbeefdeadbeef"
    json.dump(m, open(mpath, "w"))
    with pytest.raises(RuntimeError, match="stale"):
        finalize_shards(multi, 2, ex["bam"], ex["bed"], ex["fasta"], None,
                        RunConfig())
    # corrupted shard bytes fail the checksum
    run_distributed(ex["bam"], ex["bed"], multi, fasta_path=ex["fasta"],
                    host_id=1, num_hosts=2)
    p = multi + ".part1.nucpos.bed.gz"
    raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    with pytest.raises(RuntimeError, match="checksum|size"):
        finalize_shards(multi, 2, ex["bam"], ex["bed"], ex["fasta"], None,
                        RunConfig())
    # intact shards merge fine
    run_distributed(ex["bam"], ex["bed"], multi, fasta_path=ex["fasta"],
                    host_id=1, num_hosts=2)
    finalize_shards(multi, 2, ex["bam"], ex["bed"], ex["fasta"], None,
                    RunConfig())
    assert os.path.exists(multi + ".nfrpos.bed.gz")


def test_sharded_histogram_fit_equals_full_fit(ex):
    """VERDICT r1 item 7: per-host shard histograms summed in host order
    reproduce the full-scan histogram exactly, so the collective-fit path
    (fit_mixture_distributed under jax.distributed) is bit-equal to the
    replicated full fit."""
    from nucleoatac_jax.config import RunConfig
    from nucleoatac_jax.core.chunk import ChunkList
    from nucleoatac_jax.core.fragmentsizes import FragmentSizes
    from nucleoatac_jax.core.mixture import FragmentMixDistribution
    from nucleoatac_jax.io.bam import scan_bam
    from nucleoatac_jax.models.occ import fit_mixture
    from nucleoatac_jax.parallel.distributed import host_tile_slice

    cfg = RunConfig()
    frags = scan_bam(ex["bam"])
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    fs_full, mix_full = fit_mixture(frags, chunks, cfg)

    nhosts = 3
    total = np.zeros_like(fs_full.vals)
    for pid in range(nhosts):
        local = ChunkList(host_tile_slice(chunks.chunks, pid, nhosts))
        fs_local = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper)
        for c in local:
            _, sizes = frags.window(c.chrom, c.start, c.end)
            fs_local.add_sizes(sizes)
        total += fs_local.vals
    np.testing.assert_array_equal(total, fs_full.vals)
    fs = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper, total)
    mix = FragmentMixDistribution(cfg.sizes.lower, cfg.sizes.upper, cfg.mixture).fit(fs)
    np.testing.assert_array_equal(
        mix.log_mix_table(cfg.occ), mix_full.log_mix_table(cfg.occ)
    )
