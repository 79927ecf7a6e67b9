"""Shared synthetic example-data builder for tests (known ground truth)."""
import numpy as np

from nucleoatac_jax.io.bam_writer import write_bam
from nucleoatac_jax.io.fasta import write_fasta

DYADS = [1000, 1200, 1500, 2600]
NFR_GAP = (1700, 2500)
CHROM_LEN = 6000


def make_example(d, seed=42, n_per_dyad=300, n_nfr=500, n_bg=200):
    rng = np.random.default_rng(seed)
    frags = []
    for dyad in DYADS:
        for _ in range(n_per_dyad):
            size = int(np.clip(rng.normal(156, 12), 120, 250))
            mid = dyad + int(np.clip(rng.normal(0, 8), -30, 30))
            frags.append((0, mid - (size - 1) // 2 - 4, size))
    for _ in range(n_nfr):
        size = int(np.clip(rng.exponential(40) + 24, 24, 119))
        left = int(rng.integers(NFR_GAP[0], NFR_GAP[1] - 50))
        frags.append((0, left, size))
    for _ in range(n_bg):
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
