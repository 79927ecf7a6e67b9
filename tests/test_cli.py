"""CLI surface tests: standalone stage drivers + pyatac utilities."""
import gzip
import os

import numpy as np
import pytest

from nucleoatac_jax.cli.nucleoatac import main as nucleoatac_main
from nucleoatac_jax.cli.pyatac import main as pyatac_main
from tests.synth import DYADS, NFR_GAP, make_example


@pytest.fixture(scope="module")
def ex(tmp_path_factory):
    return make_example(tmp_path_factory.mktemp("cli_example"))


def _lines(path):
    return [l for l in gzip.open(path, "rt").read().splitlines() if l]


def test_staged_occ_nuc_merge_nfr(ex, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("stages") / "st")
    base = ["--bed", ex["bed"], "--bam", ex["bam"], "--out", out, "--no_plots"]
    assert nucleoatac_main(["occ"] + base) == 0
    assert os.path.exists(out + ".occ.bedgraph.gz.tbi")
    assert nucleoatac_main(["nuc"] + base + ["--fasta", ex["fasta"]]) == 0
    calls = [l.split("\t") for l in _lines(out + ".nucpos.bed.gz")]
    called = sorted(int(c[1]) for c in calls)
    for d in DYADS:
        assert min(abs(c - d) for c in called) <= 15, (d, called)
    # occ stats re-read from files must be populated (file-handoff path)
    assert any(float(c[4]) > 0.5 for c in calls)
    assert nucleoatac_main([
        "merge", "--occpeaks", out + ".occpeaks.bed.gz",
        "--nucpos", out + ".nucpos.bed.gz", "--out", out,
    ]) == 0
    assert nucleoatac_main(["nfr"] + base + ["--fasta", ex["fasta"]]) == 0
    nfrs = [l.split("\t") for l in _lines(out + ".nfrpos.bed.gz")]
    assert any(int(f[1]) < NFR_GAP[1] and int(f[2]) > NFR_GAP[0] for f in nfrs)


def test_vprocess_roundtrip(ex, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("vp") / "vp")
    assert pyatac_main([
        "vplot", "--bam", ex["bam"], "--bed", ex["bed"], "--out", out,
        "--no_plots",
    ]) == 0
    assert nucleoatac_main([
        "vprocess", "--vplot", out + ".VMat", "--out", out, "--no_plots",
    ]) == 0
    from nucleoatac_jax.core.vmat import VMat

    v = VMat.open(out + ".VMat")
    assert v.width == 147 and v.lower == 105
    assert abs(v.mat.sum() - 1.0) < 1e-9
    # symmetric by construction
    np.testing.assert_allclose(v.mat, v.mat[:, ::-1], atol=1e-12)


def test_pyatac_tracks_and_counts(ex, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("py") / "u")
    args = ["--bam", ex["bam"], "--bed", ex["bed"], "--out", out, "--no_plots"]
    assert pyatac_main(["ins"] + args) == 0
    assert pyatac_main(["cov"] + args) == 0
    assert pyatac_main(["sizes", "--bam", ex["bam"], "--out", out, "--no_plots"]) == 0
    assert pyatac_main(["counts"] + args) == 0
    ins = _lines(out + ".ins.bedgraph.gz")
    assert ins and all(len(l.split("\t")) == 4 for l in ins)
    # NFR gap should be insertion-dense
    gap_ins = sum(
        float(l.split("\t")[3]) * (int(l.split("\t")[2]) - int(l.split("\t")[1]))
        for l in ins
        if NFR_GAP[0] <= int(l.split("\t")[1]) < NFR_GAP[1]
    )
    assert gap_ins > 500
    counts = open(out + ".counts.txt").read().strip().splitlines()
    assert len(counts) == 1 and int(counts[0].split("\t")[3]) > 1000


def test_pyatac_bias_and_pwm(ex, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bias") / "b")
    assert pyatac_main([
        "bias", "--fasta", ex["fasta"], "--bed", ex["bed"], "--out", out,
    ]) == 0
    rows = _lines(out + ".Scores.bedgraph.gz")
    assert rows
    assert pyatac_main([
        "pwm", "--bam", ex["bam"], "--fasta", ex["fasta"], "--out", out,
        "--no_plots",
    ]) == 0
    from nucleoatac_jax.core.pwm import PWM

    pwm = PWM.open(out + ".PWM.txt")
    assert pwm.length == 19
    assert pyatac_main([
        "bias_vplot", "--bam", ex["bam"], "--bed", ex["bed"], "--fasta",
        ex["fasta"], "--out", out, "--no_plots",
    ]) == 0
    assert os.path.exists(out + ".Bias.VMat")


def test_pyatac_signal_and_nucleotide(ex, tmp_path_factory):
    d = tmp_path_factory.mktemp("signal")
    out = str(d / "s")
    base = ["--bed", ex["bed"], "--bam", ex["bam"], "--out", out, "--no_plots"]
    assert nucleoatac_main(["occ"] + base) == 0
    sites = str(d / "sites.bed")
    with open(sites, "w") as fh:
        for dy in DYADS:
            fh.write(f"chr1\t{dy}\t{dy+1}\tsite\t0\t+\n")
    assert pyatac_main([
        "signal", "--bed", sites, "--bg", out + ".occ.bedgraph.gz",
        "--out", out, "--up", "100", "--down", "100", "--all",
    ]) == 0
    agg = [l.split("\t") for l in open(out + ".signal.agg.txt")]
    assert len(agg) == 201
    center = dict((int(r[0]), r[1]) for r in agg)[0]
    assert center != "NA" and float(center) > 0.5  # dyads are high-occ
    mat = np.loadtxt(out + ".signal.txt")
    assert mat.shape == (len(DYADS), 201)
    assert pyatac_main([
        "nucleotide", "--bed", sites, "--fasta", ex["fasta"], "--out", out,
        "--up", "20", "--down", "20",
    ]) == 0
    rows = open(out + ".nucfreq.txt").read().strip().splitlines()
    assert rows[0].startswith("#offset")
    assert len(rows) == 42
    freqs = np.array([[float(x) for x in r.split("\t")[1:]] for r in rows[1:]])
    np.testing.assert_allclose(freqs.sum(axis=1), 1.0, atol=1e-9)


def test_bias_track_input_matches_fasta_pwm(tmp_path):
    """`--bias_track` (pyatac bias output) reproduces the FASTA+PWM path:
    same dyad positions, stats equal to the bedgraph's 5-decimal bias
    quantization (reference InsertionBiasTrack read path)."""
    import gzip

    import numpy as np

    from nucleoatac_jax.cli.nucleoatac import main as nucleoatac_main
    from nucleoatac_jax.cli.pyatac import main as pyatac_main
    from tests.synth import make_example

    ex = make_example(tmp_path)
    common = [
        "--bed", ex["bed"], "--bam", ex["bam"], "--batch", "4",
        "--no_plots",
    ]
    # direct FASTA+PWM run
    direct = str(tmp_path / "direct")
    assert nucleoatac_main(
        ["run", *common, "--fasta", ex["fasta"], "--out", direct]
    ) == 0
    # precompute the bias track, then run with it
    assert pyatac_main(
        ["bias", "--fasta", ex["fasta"], "--bed", ex["bed"],
         "--out", str(tmp_path / "b")]
    ) == 0
    via = str(tmp_path / "via")
    assert nucleoatac_main(
        ["run", *common, "--fasta", ex["fasta"], "--out", via,
         "--bias_track", str(tmp_path / "b") + ".Scores.bedgraph.gz"]
    ) == 0

    def rows(p):
        with gzip.open(p, "rt") as fh:
            return [line.split("\t") for line in fh.read().splitlines()]

    a = rows(direct + ".nucpos.bed.gz")
    b = rows(via + ".nucpos.bed.gz")
    assert [r[1] for r in a] == [r[1] for r in b]  # same dyads
    for ra, rb in zip(a, b):
        for j in (3, 7, 9):  # z, lr, signal: bias-dependent stats
            np.testing.assert_allclose(
                float(ra[j]), float(rb[j]), rtol=1e-3, atol=1e-3
            )
    # occ outputs are bias-independent: byte-identical
    assert (
        gzip.open(direct + ".occ.bedgraph.gz", "rb").read()
        == gzip.open(via + ".occ.bedgraph.gz", "rb").read()
    )


def test_build_config_strict_and_platform_flags():
    """Round-5 CLI knobs: --strict reaches NucParams.strict; defaults
    stay off."""
    from nucleoatac_jax.cli.nucleoatac import build_config, nucleoatac_parser

    base = ["run", "--bam", "x.bam", "--bed", "x.bed", "--out", "o"]
    args = nucleoatac_parser().parse_args(base + ["--strict"])
    assert build_config(args).nuc.strict is True
    args = nucleoatac_parser().parse_args(base)
    assert build_config(args).nuc.strict is False
