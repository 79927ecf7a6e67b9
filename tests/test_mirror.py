"""Sanity tests of the float64 mirror math (the oracle itself)."""
import numpy as np

from nucleoatac_jax.config import MixtureParams, OccParams
from nucleoatac_jax.core.fragmentsizes import FragmentSizes
from nucleoatac_jax.core.mixture import FragmentMixDistribution, fit_truncated_exponential_tau
from nucleoatac_jax.mirror import (
    gauss_smooth,
    greedy_select,
    local_max_candidates,
    occupancy_window,
    rasterize,
)


def _fit_mix(rng, n=200_000):
    """Synthetic fragment sizes: exponential NFR + gaussian nucleosomal."""
    nfr = rng.exponential(45.0, size=n // 2).astype(int)
    nuc = rng.normal(147.0, 20.0, size=n // 2).astype(int)
    fs = FragmentSizes(0, 251)
    fs.add_sizes(np.concatenate([nfr, nuc]))
    return FragmentMixDistribution(0, 251).fit(fs), fs


def test_truncated_exponential_recovers_tau(rng):
    tau_true = 45.0
    sizes = np.arange(0, 251)
    x = rng.exponential(tau_true, size=500_000).astype(int)
    counts = np.bincount(x[x < 251], minlength=251).astype(float)
    tau = fit_truncated_exponential_tau(sizes, counts, 20, 120)
    assert abs(tau - tau_true) < 2.0


def test_mixture_fit_separates_components(rng):
    mix, _ = _fit_mix(rng)
    assert 0.3 < mix.w < 0.7
    # nuc component concentrated at nucleosomal sizes
    assert mix.p_nuc[:100].sum() < 0.02
    assert mix.p_nuc[127:167].sum() > 0.5
    # nfr component decaying
    assert mix.p_nfr[0] > mix.p_nfr[100] > mix.p_nfr[200]


def test_occupancy_extremes(rng):
    mix, _ = _fit_mix(rng)
    occp = OccParams()
    M = mix.log_mix_table(occp)
    grid = mix.alpha_grid(occp)
    W = 400
    # all-nucleosomal window
    mids = np.full(200, W // 2) + rng.integers(-30, 30, 200)
    sizes = rng.normal(147, 15, 200).astype(int)
    mat = rasterize(mids, sizes, 0, 251, W)
    res = occupancy_window(mat, M, grid, flank=60)
    assert res.occ[W // 2] > 0.8
    # all-NFR window
    sizes2 = rng.exponential(40, 200).astype(int) + 1
    mat2 = rasterize(mids, sizes2, 0, 251, W)
    res2 = occupancy_window(mat2, M, grid, flank=60)
    assert res2.occ[W // 2] < 0.2
    # empty window
    mat3 = np.zeros_like(mat)
    res3 = occupancy_window(mat3, M, grid, flank=60)
    assert res3.occ[10] == 0.0 and res3.upper[10] == 1.0 and res3.lower[10] == 0.0


def test_occupancy_ci_brackets_mle(rng):
    mix, _ = _fit_mix(rng)
    occp = OccParams()
    M = mix.log_mix_table(occp)
    grid = mix.alpha_grid(occp)
    W = 300
    mids = rng.integers(0, W, 400)
    sizes = np.concatenate(
        [rng.normal(147, 20, 200).astype(int), rng.exponential(40, 200).astype(int)]
    )
    mat = rasterize(mids, sizes, 0, 251, W)
    res = occupancy_window(mat, M, grid, flank=60)
    assert np.all(res.lower <= res.occ + 1e-12)
    assert np.all(res.occ <= res.upper + 1e-12)


def test_local_max_and_greedy():
    x = np.array([0, 1, 3, 3, 2, 1, 0, 2, 5, 2, 0, 0], dtype=float)
    cand = local_max_candidates(x, halfwin=2)
    # leftmost of the [3,3] plateau; 5 at index 8
    assert list(np.flatnonzero(cand)) == [2, 8]
    sel = greedy_select(x, cand, sep=4)
    assert sel == [2, 8]
    sel2 = greedy_select(x, cand, sep=10)
    assert sel2 == [8]


def test_gauss_smooth_preserves_mass_interior():
    x = np.zeros(201)
    x[100] = 1.0
    y = gauss_smooth(x, 10.0)
    assert abs(y.sum() - 1.0) < 1e-9
    assert y[100] == y.max()
