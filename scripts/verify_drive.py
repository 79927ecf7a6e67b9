#!/usr/bin/env python
"""End-to-end drive on synthetic data (the /verify recipe, runnable).

Synthesizes a BAM with planted dyads + an NFR gap, runs the full
pipeline on the CPU backend, and asserts: occupancy ~1 at dyads / ~0 in
the gap, dyad calls within 10 bp of planted positions, all outputs
BGZF-readable with tabix indexes.

Usage: python scripts/verify_drive.py
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
import jax

jax.config.update("jax_platforms", "cpu")

import gzip
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from nucleoatac_jax.io.bam_writer import write_bam
from nucleoatac_jax.io.tabix import TabixReader
from nucleoatac_jax.models.pipeline import run_pipeline


def main() -> None:
    rng = np.random.default_rng(7)
    dyads = [3000, 3180, 6000]
    frags = []
    for d in dyads:
        for _ in range(300):
            mid = d + int(rng.integers(-8, 9))
            frags.append((0, int(mid - 78), 156))
    for _ in range(500):
        frags.append(
            (0, int(rng.integers(3900, 5600)), int(rng.exponential(40)) + 30)
        )
    frags.sort(key=lambda t: t[1])
    tmp = tempfile.mkdtemp()
    bam = f"{tmp}/synth.bam"
    write_bam(bam, ["chr1"], [10000], frags)
    bed = f"{tmp}/peaks.bed"
    with open(bed, "w") as fh:
        fh.write("chr1\t2500\t7000\n")
    out = f"{tmp}/out"
    run_pipeline(bam, bed, out, write_plots=False)

    def vals(path, lo, hi):
        rows = list(TabixReader(path).fetch("chr1", lo, hi))
        return [
            float(r[3] if not isinstance(r, str) else r.split("\t")[3])
            for r in rows
        ]

    v = vals(f"{out}.occ.bedgraph.gz", 2900, 3100)
    print("occ at dyad 3000:", max(v))
    assert max(v) > 0.8
    g = vals(f"{out}.occ.bedgraph.gz", 4500, 5000) or [0.0]
    print("occ in NFR gap:", max(g))
    assert max(g) < 0.3
    pos = [int(l.split("\t")[1]) for l in gzip.open(f"{out}.nucpos.bed.gz", "rt")]
    print("nucpos calls:", pos)
    for d in dyads:
        assert any(abs(p - d) <= 10 for p in pos), f"dyad {d} missed: {pos}"
    for suf in (
        ".occ.bedgraph.gz",
        ".nucleoatac_signal.bedgraph.gz",
        ".nucpos.bed.gz",
        ".nfrpos.bed.gz",
        ".nucmap_combined.bed.gz",
    ):
        gzip.open(out + suf, "rt").read()
        assert os.path.exists(out + suf + ".tbi"), suf + " missing .tbi"
    print("VERIFY OK")


if __name__ == "__main__":
    main()
