"""Fused occ+nuc pass (models/fused.py) must produce byte-identical
output files to the standalone two-pass drivers — it is a wire
optimization, not a semantic change."""
import gzip
import os

from nucleoatac_jax.config import RunConfig, WindowParams
from nucleoatac_jax.core.chunk import ChunkList
from nucleoatac_jax.core.pwm import PWM
from nucleoatac_jax.io.bam import scan_bam
from nucleoatac_jax.io.fasta import FastaFile
from nucleoatac_jax.models.engine import DeviceEngine
from nucleoatac_jax.models.fused import fused_supported, run_fused
from nucleoatac_jax.models.nuc import NucStage
from nucleoatac_jax.models.occ import OccStage, fit_mixture
from nucleoatac_jax.models.pipeline import occ_lookup_from_tracks
from tests.synth import make_example

FILES = [
    ".occ.bedgraph.gz", ".occ.lower_bound.bedgraph.gz",
    ".occ.upper_bound.bedgraph.gz", ".occpeaks.bed.gz",
    ".nucleoatac_signal.bedgraph.gz", ".nucleoatac_signal.smooth.bedgraph.gz",
    ".nucpos.bed.gz", ".nucpos.redundant.bed.gz",
]


def _rows(prefix, suffix):
    with gzip.open(prefix + suffix, "rt") as fh:
        return fh.read()


def test_fused_equals_two_pass(tmp_path):
    ex = make_example(tmp_path)
    cfg = RunConfig(window=WindowParams(core=256, batch=4))
    frags = scan_bam(ex["bam"])
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    fs, mix = fit_mixture(frags, chunks, cfg)
    pwm = PWM.default()
    fasta = FastaFile(ex["fasta"])
    engine = DeviceEngine(cfg, mix, fs, pwm=pwm)
    assert fused_supported(cfg, engine)

    two = str(tmp_path / "two")
    occ_stage = OccStage(cfg, engine)
    occ_res = occ_stage.run(frags, chunks, mix, fs, two, keep_tracks=True)
    nuc_stage = NucStage(cfg, engine, pwm, fasta)
    nuc_res = nuc_stage.run(
        frags, chunks, occ_lookup_from_tracks(occ_res), two
    )

    one = str(tmp_path / "one")
    occ_f, nuc_f = run_fused(
        cfg, engine, OccStage(cfg, engine), NucStage(cfg, engine, pwm, fasta),
        frags, chunks, mix, fs, one,
    )

    for sfx in FILES:
        assert os.path.exists(one + sfx) and os.path.exists(two + sfx), sfx
        assert _rows(one, sfx) == _rows(two, sfx), sfx

    assert len(occ_f.peaks) == len(occ_res.peaks)
    assert [c.bed_row() for c in nuc_f.calls] == [
        c.bed_row() for c in nuc_res.calls
    ]


def test_fused_evicts_occ_tracks_when_not_kept(tmp_path):
    """VERDICT r2 item 5: run-path host memory must stay O(batch) — each
    chunk's occ tracks are dropped once its nuc finishing consumed them,
    and downstream consumers stream them back from the written bedgraphs
    (pipeline.py :: _LazyOccTracks swap-in)."""
    ex = make_example(tmp_path)
    cfg = RunConfig(window=WindowParams(core=256, batch=4))
    frags = scan_bam(ex["bam"])
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    fs, mix = fit_mixture(frags, chunks, cfg)
    engine = DeviceEngine(cfg, mix, fs, pwm=PWM.default())
    out = str(tmp_path / "ev")
    occ_f, nuc_f = run_fused(
        cfg, engine, OccStage(cfg, engine),
        NucStage(cfg, engine, PWM.default(), FastaFile(ex["fasta"])),
        frags, chunks, mix, fs, out, keep_tracks=False,
    )
    assert occ_f.tracks == {}  # all evicted as nuc consumed them
    assert nuc_f.tracks == {}
    # the written bedgraphs still reconstruct the tracks (nfr path)
    from nucleoatac_jax.models.standalone import OccTrackReader, _LazyOccTracks

    lazy = _LazyOccTracks(OccTrackReader(out), chunks)
    tr = lazy[0]
    assert set(tr) == {"occ", "lower", "upper"}
    assert len(tr["occ"]) == len(chunks[0])


def test_fused_and_two_pass_nfr_consume_same_occ_surface(tmp_path):
    """NFR must see the SAME occ values in both run paths: the written
    bedgraph print surface (also the reference contract — its nfr stage
    reads the occ bedgraph). Round-3 review finding: the two-pass path
    used to hand NFR the exact in-memory tracks, which can flip an NFR
    threshold decision within 5e-6 of max_occ_upper."""
    from nucleoatac_jax.models.nfr import call_nfrs
    from nucleoatac_jax.models.merge import merge_maps
    from nucleoatac_jax.models.standalone import OccTrackReader, _LazyOccTracks

    ex = make_example(tmp_path)
    cfg = RunConfig(window=WindowParams(core=256, batch=4))
    frags = scan_bam(ex["bam"])
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    fs, mix = fit_mixture(frags, chunks, cfg)
    pwm = PWM.default()
    fasta = FastaFile(ex["fasta"])
    engine = DeviceEngine(cfg, mix, fs, pwm=pwm)

    def nfr_rows(prefix, occ_tracks, nuc_res, occ_res):
        combined = merge_maps(nuc_res.calls, occ_res.peaks, cfg.occ.occ_sep)
        nfrs = call_nfrs(
            cfg, chunks, combined, occ_tracks, frags, pwm, fasta, None
        )
        return [n.bed_row() for n in nfrs]

    # two-pass, occ surface = written bedgraphs (as run_pipeline now does)
    two = str(tmp_path / "two")
    occ_res = OccStage(cfg, engine).run(
        frags, chunks, mix, fs, two, keep_tracks=True
    )
    nuc_res = NucStage(cfg, engine, pwm, fasta).run(
        frags, chunks, occ_lookup_from_tracks(occ_res), two
    )
    lazy_two = _LazyOccTracks(OccTrackReader(two), chunks)
    rows_two = nfr_rows(two, lazy_two, nuc_res, occ_res)

    # fused, occ surface = written bedgraphs (evicted in-memory tracks)
    one = str(tmp_path / "one")
    occ_f, nuc_f = run_fused(
        cfg, engine, OccStage(cfg, engine), NucStage(cfg, engine, pwm, fasta),
        frags, chunks, mix, fs, one, keep_tracks=False,
    )
    lazy_one = _LazyOccTracks(OccTrackReader(one), chunks)
    rows_one = nfr_rows(one, lazy_one, nuc_f, occ_f)

    assert rows_one == rows_two
    assert rows_one  # non-vacuous: at least one NFR called


def test_pool_transfer_run_outputs_identical(tmp_path):
    """`nucleoatac run` with transfer='pool' (wire v7) writes byte-identical
    outputs to the delta12 wire."""
    import dataclasses
    import gzip

    from tests.synth import make_example

    from nucleoatac_jax.config import RunConfig, WindowParams
    from nucleoatac_jax.models.pipeline import run_pipeline

    ex = make_example(tmp_path)
    outs = {}
    for mode in ("delta12", "pool"):
        cfg = RunConfig(window=WindowParams(core=256, batch=4, transfer=mode))
        out = str(tmp_path / f"out_{mode}")
        run_pipeline(
            ex["bam"], ex["bed"], out, fasta_path=ex["fasta"], cfg=cfg,
            write_plots=False,
        )
        outs[mode] = out
    for sfx in (
        ".occ.bedgraph.gz", ".occpeaks.bed.gz", ".nucpos.bed.gz",
        ".nucleoatac_signal.bedgraph.gz", ".nfrpos.bed.gz",
    ):
        with gzip.open(outs["delta12"] + sfx) as f1, gzip.open(
            outs["pool"] + sfx
        ) as f2:
            assert f1.read() == f2.read(), sfx
