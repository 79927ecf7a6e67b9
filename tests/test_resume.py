"""--resume: rerun with existing occ outputs must reproduce the run."""
import gzip

import pytest

from nucleoatac_jax.models.pipeline import run_pipeline
from tests.synth import make_example


def test_resume_reproduces_outputs(tmp_path_factory):
    ex = make_example(tmp_path_factory.mktemp("resume"))
    out = str(ex["dir"] / "r")
    res1 = run_pipeline(ex["bam"], ex["bed"], out, fasta_path=ex["fasta"],
                        write_plots=False)
    nucpos1 = gzip.open(out + ".nucpos.bed.gz", "rt").read()
    nfr1 = gzip.open(out + ".nfrpos.bed.gz", "rt").read()

    res2 = run_pipeline(ex["bam"], ex["bed"], out, fasta_path=ex["fasta"],
                        write_plots=False, resume=True)
    nucpos2 = gzip.open(out + ".nucpos.bed.gz", "rt").read()
    nfr2 = gzip.open(out + ".nfrpos.bed.gz", "rt").read()
    assert nucpos1 == nucpos2
    assert nfr1 == nfr2
    assert len(res2.occ.peaks) == len(res1.occ.peaks)
