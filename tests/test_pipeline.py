"""End-to-end pipeline integration test on synthetic data with planted
ground truth (SURVEY.md §5: the reference's oracle is output equality on
example data; our example data is synthesized with known dyads/NFRs)."""
import gzip
import os

import numpy as np
import pytest

from nucleoatac_jax.config import RunConfig
from nucleoatac_jax.io.bam_writer import write_bam
from nucleoatac_jax.io.fasta import write_fasta
from nucleoatac_jax.models.pipeline import run_pipeline

DYADS = [1000, 1200, 1500, 2600]
NFR_GAP = (1700, 2500)
CHROM_LEN = 6000


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    d = tmp_path_factory.mktemp("example")
    rng = np.random.default_rng(42)
    frags = []
    for dyad in DYADS:
        for _ in range(300):
            size = int(np.clip(rng.normal(156, 12), 120, 250))
            mid = dyad + int(np.clip(rng.normal(0, 8), -30, 30))
            frags.append((0, mid - (size - 1) // 2 - 4, size))
    # NFR gap: dense short fragments
    for _ in range(500):
        size = int(np.clip(rng.exponential(40) + 24, 24, 119))
        left = int(rng.integers(NFR_GAP[0], NFR_GAP[1] - 50))
        frags.append((0, left, size))
    # light background everywhere in the peak
    for _ in range(200):
        size = int(np.clip(rng.exponential(45) + 24, 24, 245))
        left = int(rng.integers(500, 3400))
        frags.append((0, left, size))
    bam = str(d / "example.bam")
    write_bam(bam, ["chr1"], [CHROM_LEN], frags)
    seq = "".join(rng.choice(list("ACGT"), CHROM_LEN))
    fa = str(d / "example.fa")
    write_fasta(fa, {"chr1": seq})
    bed = str(d / "peaks.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t500\t3500\tpeak1\n")
    return {"dir": d, "bam": bam, "fasta": fa, "bed": bed}


@pytest.fixture(scope="module")
def result(example):
    out = str(example["dir"] / "out")
    res = run_pipeline(
        example["bam"], example["bed"], out, fasta_path=example["fasta"]
    )
    return res, out


def test_occ_high_at_dyads_low_in_gap(result):
    res, _ = result
    tr = res.occ.tracks[0]
    occ = tr["occ"]
    for d in DYADS:
        assert occ[d - 500] > 0.7, (d, occ[d - 500])
    gap_mid = (NFR_GAP[0] + NFR_GAP[1]) // 2
    assert occ[gap_mid - 500] < 0.3


def test_nucpos_calls_near_planted_dyads(result):
    res, _ = result
    called = sorted(c.pos for c in res.nuc.calls)
    assert len(called) >= len(DYADS)
    for d in DYADS:
        assert min(abs(c - d) for c in called) <= 15, (d, called)
    # no calls inside the NFR gap interior
    for c in called:
        assert not (NFR_GAP[0] + 100 < c < NFR_GAP[1] - 100), (c, called)


def test_nucpos_stats_populated(result):
    res, _ = result
    for c in res.nuc.calls:
        if min(abs(c.pos - d) for d in DYADS) <= 15:
            assert c.z >= 3.0
            assert c.occ > 0.5
            assert 0 <= c.fuzz < 60
            assert c.lr != 0


def test_nfr_called_in_gap(result):
    res, _ = result
    hits = [n for n in res.nfrs if n.start < NFR_GAP[1] and n.end > NFR_GAP[0]]
    assert hits, [str(n.bed_row()) for n in res.nfrs]
    top = max(hits, key=lambda n: n.end - n.start)
    assert top.ins_density > 0.1
    assert top.max_occ_upper < 0.25


def test_output_files_exist_and_parse(result):
    _, out = result
    expected = [
        ".occ.bedgraph.gz", ".occ.lower_bound.bedgraph.gz",
        ".occ.upper_bound.bedgraph.gz", ".occpeaks.bed.gz",
        ".fragmentsizes.txt", ".occ_fit.txt", ".occ_fit.eps",
        ".nucleoatac_signal.bedgraph.gz", ".nucleoatac_signal.smooth.bedgraph.gz",
        ".nucpos.bed.gz", ".nucpos.redundant.bed.gz", ".nuc_dist.txt",
        ".nuc_dist.eps", ".nucmap_combined.bed.gz", ".nfrpos.bed.gz",
    ]
    for suffix in expected:
        path = out + suffix
        assert os.path.exists(path), suffix
        if suffix.endswith(".gz"):
            assert os.path.exists(path + ".tbi"), suffix + ".tbi"
            text = gzip.open(path, "rt").read()
            for line in text.splitlines():
                f = line.split("\t")
                assert len(f) >= 4 and int(f[1]) < int(f[2])


def test_nucpos_bed_has_11_columns(result):
    _, out = result
    text = gzip.open(out + ".nucpos.bed.gz", "rt").read().strip()
    for line in text.splitlines():
        assert len(line.split("\t")) == 11


def test_occ_bedgraph_matches_inmemory_tracks(result):
    res, out = result
    text = gzip.open(out + ".occ.bedgraph.gz", "rt").read().strip().splitlines()
    tr = res.occ.tracks[0]["occ"]
    # reconstruct dense vector from run-length bedgraph
    dense = np.zeros_like(tr)
    for line in text:
        c, a, b, v = line.split("\t")
        dense[int(a) - 500 : int(b) - 500] = float(v)
    np.testing.assert_allclose(dense, np.round(tr, 5), atol=1e-9)


def test_pipelined_threaded_matches_serial():
    """_pipelined with a fetch pool yields the same (order, values) as
    the serial async path — the pool only changes WHERE np.asarray runs
    (probe_parallel_fetch.py wire finding), never results."""
    import jax.numpy as jnp
    import numpy as np

    from nucleoatac_jax.models.occ import _pipelined

    items = [np.full((4, 8), i, np.float32) for i in range(12)]

    def dispatch(x):
        return jnp.asarray(x) * 2.0

    serial = [
        (i, np.asarray(o))
        for i, o in _pipelined(iter(items), dispatch, depth=2)
    ]
    threaded = [
        (i, np.asarray(o))
        for i, o in _pipelined(
            iter(items), dispatch, depth=2, fetch_threads=4
        )
    ]
    assert len(serial) == len(threaded) == len(items)
    for (a, va), (b, vb) in zip(serial, threaded):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(va, vb)
        assert isinstance(vb, np.ndarray)
