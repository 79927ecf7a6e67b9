"""Device ops vs float64 mirror: the core parity layer (SURVEY.md §5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nucleoatac_jax.config import OccParams
from nucleoatac_jax.core.fragmentsizes import FragmentSizes
from nucleoatac_jax.core.mixture import FragmentMixDistribution
from nucleoatac_jax.core.vmat import VMat
from nucleoatac_jax import mirror
from nucleoatac_jax.ops import (
    bias_mat_batch,
    gauss_kernel,
    gauss_smooth_batch,
    greedy_select_batch,
    local_max_batch,
    nuc_scores_batch,
    occupancy_batch,
    rasterize_batch,
)
from nucleoatac_jax.ops.xcorr import build_kernels

B, W = 3, 512
LOWER, UPPER = 0, 251
VLO, VUP = 105, 251


def _frags(rng, b=B, f=800, w=W):
    mids = rng.integers(-20, w + 20, size=(b, f)).astype(np.int32)
    sizes = rng.integers(1, 300, size=(b, f)).astype(np.int32)
    valid = rng.random((b, f)) < 0.9
    return mids, sizes, valid


def test_rasterize_matches_mirror(rng):
    mids, sizes, valid = _frags(rng)
    dev = np.asarray(rasterize_batch(jnp.asarray(mids), jnp.asarray(sizes), jnp.asarray(valid), LOWER, UPPER, W))
    for b in range(B):
        ref = mirror.rasterize(mids[b][valid[b]], sizes[b][valid[b]], LOWER, UPPER, W)
        np.testing.assert_array_equal(dev[b], ref)


def _mix(rng):
    fs = FragmentSizes(LOWER, UPPER)
    fs.add_sizes(rng.exponential(45, 50_000).astype(int))
    fs.add_sizes(rng.normal(147, 20, 50_000).astype(int))
    return FragmentMixDistribution(LOWER, UPPER).fit(fs), fs


def test_occupancy_matches_mirror(rng):
    mix, _ = _mix(rng)
    occp = OccParams()
    M64 = mix.log_mix_table(occp)
    grid = mix.alpha_grid(occp)
    mids, sizes, valid = _frags(rng)
    mats = np.asarray(rasterize_batch(jnp.asarray(mids), jnp.asarray(sizes), jnp.asarray(valid), LOWER, UPPER, W))
    out = occupancy_batch(
        jnp.asarray(mats, jnp.float32),
        jnp.asarray(M64, jnp.float32),
        jnp.asarray(grid, jnp.float32),
        occp.flank,
    )
    occ_d = np.asarray(out.occ, np.float64)
    lo_d = np.asarray(out.lower, np.float64)
    up_d = np.asarray(out.upper, np.float64)
    n_d = np.asarray(out.n)
    for b in range(B):
        ref = mirror.occupancy_window(mats[b].astype(np.int64), M64, grid, occp.flank)
        np.testing.assert_allclose(n_d[b], ref.n, atol=0.5)
        # grid-valued outputs: agree except provable near-ties in f64 LL
        for name, d, r in (("occ", occ_d[b], ref.occ), ("lo", lo_d[b], ref.lower), ("up", up_d[b], ref.upper)):
            mismatch = np.flatnonzero(np.abs(d - r) > 1e-6)
            for p in mismatch:
                ll = ref.ll[p]
                gi_d = int(round(d[p] * 100))
                gi_r = int(round(r[p] * 100))
                if name == "occ":
                    # argmax flip: the two grid points must be a near-tie
                    assert abs(ll[gi_d] - ll[gi_r]) < 2e-2, (name, p, d[p], r[p])
                else:
                    # CI-edge flip: the disputed grid point must sit within
                    # f32 tolerance of the llmax - 1.92 threshold
                    thresh = ll.max() - 1.92
                    gap = min(abs(ll[gi_d] - thresh), abs(ll[gi_r] - thresh))
                    assert gap < 2e-2, (name, p, d[p], r[p], gap)
            assert len(mismatch) < 0.02 * W + 5


def test_bias_mat_matches_mirror(rng):
    logb = rng.normal(0, 0.5, size=(B, W))
    q = rng.random(VUP - VLO)
    q /= q.sum()
    core_lo, core_hi = 100, W - 100
    dev = np.asarray(
        bias_mat_batch(jnp.asarray(logb, jnp.float32), jnp.asarray(q, jnp.float32), VLO, VUP, core_lo, core_hi)
    )
    for b in range(B):
        ref = mirror.bias_mat(logb[b], q, VLO, VUP, core_lo, core_hi)
        np.testing.assert_allclose(dev[b], ref, rtol=2e-4, atol=1e-9)


def test_nuc_scores_match_mirror(rng):
    vm = VMat.default()
    V = vm.mat
    mids, sizes, valid = _frags(rng)
    fmat = np.asarray(rasterize_batch(jnp.asarray(mids), jnp.asarray(sizes), jnp.asarray(valid), VLO, VUP, W))
    logb = rng.normal(0, 0.3, size=(B, W))
    q = rng.random(VUP - VLO)
    q /= q.sum()
    b0 = np.stack([mirror.bias_mat(logb[b], q, VLO, VUP, 50, W - 50) for b in range(B)])
    fk, bk = build_kernels(V)
    dev = nuc_scores_batch(jnp.asarray(fmat, jnp.float32), jnp.asarray(b0, jnp.float32), fk, bk)
    for b in range(B):
        ref = mirror.nuc_scores(fmat[b], b0[b], V)
        np.testing.assert_allclose(np.asarray(dev.signal[b]), ref.signal, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(dev.n[b]), ref.n, atol=0.5)
        np.testing.assert_allclose(np.asarray(dev.var[b]), ref.var, rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(np.asarray(dev.norm[b]), ref.norm, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(np.asarray(dev.lr[b]), ref.lr, rtol=1e-3, atol=5e-2)
        np.testing.assert_allclose(np.asarray(dev.fuzz[b]), ref.fuzz, rtol=1e-3, atol=1e-2)


def test_smooth_matches_mirror(rng):
    x = rng.normal(0, 1, size=(B, W))
    k = gauss_kernel(10.0)
    dev = np.asarray(gauss_smooth_batch(jnp.asarray(x, jnp.float32), jnp.asarray(k)))
    for b in range(B):
        ref = mirror.gauss_smooth(x[b], 10.0)
        np.testing.assert_allclose(dev[b], ref, rtol=1e-4, atol=1e-5)


def test_peaks_match_mirror(rng):
    x = rng.normal(0, 1, size=(B, W))
    # inject plateaus to exercise tie-breaking
    x[:, 100:104] = 5.0
    x[:, 300] = 6.0
    mask = x > -10
    halfwin, sep = 60, 120
    cand_d = np.asarray(local_max_batch(jnp.asarray(x, jnp.float32), halfwin, jnp.asarray(mask)))
    sel_d = greedy_select_batch(
        jnp.asarray(x, jnp.float32), jnp.asarray(cand_d), sep, max_calls=8
    )
    pos_d = np.asarray(sel_d.positions)
    val_d = np.asarray(sel_d.valid)
    for b in range(B):
        cand_r = mirror.local_max_candidates(x[b], halfwin, mask[b])
        np.testing.assert_array_equal(cand_d[b], cand_r)
        sel_r = mirror.greedy_select(x[b], cand_r, sep)
        got = sorted(pos_d[b][val_d[b]].tolist())
        assert got == sel_r


def test_diag_conv_path_matches_direct_and_mirror(rng):
    """The diag-matmul conv restructure (ops/xcorr.py ::
    nuc_conv_outputs_diag) must agree with the direct conv stacks and
    with the f64 mirror's eight footprint reductions."""
    import jax

    from nucleoatac_jax.mirror.windows import _corr_rows
    from nucleoatac_jax.ops.xcorr import (
        _conv_stack,
        build_kernels,
        build_kernels_diag,
        nuc_conv_outputs_diag,
    )

    S, K, W, B = 146, 147, 512, 3
    V = np.exp(-0.5 * ((np.arange(S)[:, None] - 70) / 25.0) ** 2) * np.exp(
        -0.5 * ((np.arange(K)[None, :] - K // 2) / 30.0) ** 2
    ) + 1e-4
    fmat = rng.poisson(0.05, size=(B, S, W)).astype(np.float64)
    b0 = (rng.random((B, S, W)) * 1e-3).astype(np.float64)
    fk, bk = build_kernels(V)
    diag = build_kernels_diag(V)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    fo_d, bo_d = nuc_conv_outputs_diag(f32(fmat), f32(b0), *map(jnp.asarray, diag))
    fo = np.asarray(_conv_stack(f32(fmat), jnp.asarray(fk)))
    bo = np.asarray(_conv_stack(f32(b0), jnp.asarray(bk)))
    np.testing.assert_allclose(np.asarray(fo_d), fo, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(bo_d), bo, rtol=1e-4, atol=1e-6)
    # and directly vs the f64 mirror reductions
    logv = np.log(np.maximum(V, 1e-5))
    offs = (np.arange(K, dtype=np.float64) - K // 2) * np.ones((S, 1))
    for b in range(B):
        for ch, kern in ((0, V), (1, np.ones_like(V)), (2, logv),
                         (3, offs), (4, offs * offs)):
            ref = _corr_rows(fmat[b], kern)
            np.testing.assert_allclose(
                np.asarray(fo_d)[b, ch], ref, rtol=2e-4, atol=2e-3,
                err_msg=f"f ch{ch}",
            )
        for ch, kern in ((0, np.ones_like(V)), (1, V), (2, V * V)):
            ref = _corr_rows(b0[b], kern)
            np.testing.assert_allclose(
                np.asarray(bo_d)[b, ch], ref, rtol=2e-4, atol=1e-6,
                err_msg=f"b ch{ch}",
            )
