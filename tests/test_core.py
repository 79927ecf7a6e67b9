"""Core data model: chunks/tiling, fragment sizes, mixture persistence,
VMat processing, PWM bias."""
import numpy as np
import pytest

from nucleoatac_jax.config import OccParams, VMatParams, WindowParams
from nucleoatac_jax.core.chunk import Chunk, ChunkList
from nucleoatac_jax.core.fragmentsizes import FragmentSizes
from nucleoatac_jax.core.mixture import FragmentMixDistribution
from nucleoatac_jax.core.pwm import PWM
from nucleoatac_jax.core.vmat import VMat


def test_chunklist_read_merge_clip(tmp_path):
    bed = tmp_path / "x.bed"
    bed.write_text(
        "chr1\t100\t200\ta\n# comment\nchr1\t150\t300\tb\nchr2\t5\t50\nchrZ\t0\t10\n"
    )
    cl = ChunkList.read(str(bed), {"chr1": 250, "chr2": 40}).merge()
    assert [(c.chrom, c.start, c.end) for c in cl] == [
        ("chr1", 100, 250), ("chr2", 5, 40),
    ]


def test_chunklist_checkchroms_raises(tmp_path):
    bed = tmp_path / "x.bed"
    bed.write_text("chrMISSING\t0\t100\n")
    cl = ChunkList.read(str(bed))
    with pytest.raises(ValueError, match="chrMISSING"):
        cl.checkChroms({"chr1": 1000})


def test_tiling_covers_and_right_aligns():
    cl = ChunkList([Chunk("chr1", 1000, 4000)])
    tiles = cl.tile(1024)
    assert tiles[0][1:] == (1000, 2024)
    assert tiles[-1][1:] == (4000 - 1024, 4000)
    covered = set()
    for _, s, e in tiles:
        covered.update(range(s, e))
    assert covered == set(range(1000, 4000))
    # short chunk -> single partial tile
    small = ChunkList([Chunk("chr1", 10, 200)]).tile(1024)
    assert small == [(small[0][0], 10, 200)]


def test_window_params_width_is_lane_aligned():
    wp = WindowParams()
    assert wp.width(OccParams(), VMatParams()) % 128 == 0
    assert wp.halo(OccParams(), VMatParams()) >= 60


def test_fragmentsizes_roundtrip(tmp_path, rng):
    fs = FragmentSizes(10, 300)
    fs.add_sizes(rng.integers(0, 400, 5000))
    p = str(tmp_path / "fs.txt")
    fs.save(p)
    fs2 = FragmentSizes.open(p)
    assert fs2.lower == 10 and fs2.upper == 300
    np.testing.assert_array_equal(fs.vals, fs2.vals)


def test_mixture_roundtrip(tmp_path, rng):
    fs = FragmentSizes(0, 251)
    fs.add_sizes(rng.exponential(45, 40_000).astype(int))
    fs.add_sizes(rng.normal(147, 20, 40_000).astype(int))
    mix = FragmentMixDistribution(0, 251).fit(fs)
    p = str(tmp_path / "fit.txt")
    mix.save(p)
    mix2 = FragmentMixDistribution.open(p)
    assert abs(mix.tau - mix2.tau) < 1e-9
    assert abs(mix.w - mix2.w) < 1e-9
    np.testing.assert_allclose(mix.p_nuc, mix2.p_nuc, atol=1e-9)


def test_vmat_roundtrip_and_processing(tmp_path):
    v = VMat.default()
    assert abs(v.mat.sum() - 1.0) < 1e-12
    assert v.width == 147 and (v.lower, v.upper) == (105, 251)
    np.testing.assert_allclose(v.mat, v.mat[:, ::-1], atol=1e-15)
    p = str(tmp_path / "v.txt")
    v.save(p)
    v2 = VMat.open(p)
    np.testing.assert_allclose(v.mat, v2.mat, atol=1e-12)
    # process_raw trims and normalizes
    raw = np.random.default_rng(0).random((200, 201))
    out = VMat.process_raw(raw, 60)
    assert out.mat.shape == (146, 147)
    assert abs(out.mat.sum() - 1.0) < 1e-9
    with pytest.raises(ValueError):
        VMat(np.ones((10, 10)), 0, 10)  # even width


def test_pwm_bias_track_matches_bruteforce(tmp_path, rng):
    pwm = PWM.default()
    seq = "".join(rng.choice(list("ACGT"), 200))
    fast = pwm.bias_track(seq)
    lr = pwm.log_ratio()
    base_to_i = {b: i for i, b in enumerate("ACGT")}
    for p in [0, 5, 50, 199]:
        exp = 0.0
        for col in range(pwm.length):
            g = p + col - pwm.up
            if 0 <= g < len(seq):
                exp += lr[base_to_i[seq[g]], col]
        assert abs(fast[p] - exp) < 1e-9, p


def test_pwm_palindromic_and_roundtrip(tmp_path):
    pwm = PWM.default()
    rc = pwm.probs[::-1, ::-1]
    np.testing.assert_allclose(pwm.probs, rc, atol=1e-12)
    p = str(tmp_path / "p.txt")
    pwm.save(p)
    pwm2 = PWM.open(p)
    assert pwm2.up == pwm.up
    np.testing.assert_allclose(pwm.probs, pwm2.probs, atol=1e-9)
    # N bases contribute zero
    b = pwm.bias_track("N" * 50)
    np.testing.assert_allclose(b, 0.0)
