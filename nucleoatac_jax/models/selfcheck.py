"""Device stages against the float64 mirror, on synthetic windows.

Drives the stage chain of ``DeviceEngine.run_step_pool2`` (the production
fused dispatch) one jitted stage at a time: pool raster, occupancy, PWM
bias, bias matrix, conv stack and finish. Each stage's f32 output is read
BEFORE the wire quantisation (the u16 norm and the packed occ bytes would
hide the error being measured) and compared with nucleoatac_jax/mirror,
the float64 numpy reference:

- occ: max |LL_f32 - LL_f64| over the core columns, and the grid picks
  (argmax, CI bounds) at every position the device certified, which must
  equal the mirror's (DESIGN.md §4);
- nuc: max |norm_f32 - norm_f64| over the core columns (DESIGN.md §12).

The maxima are what ``OccParams.exact_tol`` and ``NucParams.exact_tol``
bound. chip_smoke.py runs this on the card at production widths; the
tests run it on the CPU at small widths.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nucleoatac_jax import mirror
from nucleoatac_jax.config import RunConfig, WindowParams
from nucleoatac_jax.models.engine import DeviceEngine


def make_engine(
    core: int = 1024, batch: int = 64, conv: str = "diag", mesh=None
) -> DeviceEngine:
    """Engine at the production size range, template and PWM, with a
    deterministic synthetic size histogram (exponential NFR part plus a
    mono-nucleosome peak) in place of a fitted sample."""
    from nucleoatac_jax.core.fragmentsizes import FragmentSizes
    from nucleoatac_jax.core.mixture import FragmentMixDistribution
    from nucleoatac_jax.core.pwm import PWM

    cfg = RunConfig(window=WindowParams(core=core, batch=batch, conv=conv))
    s = np.arange(cfg.sizes.lower, cfg.sizes.upper, dtype=np.float64)
    counts = (
        2e4 * np.exp(-s / 45.0) + 1.5e4 * np.exp(-0.5 * ((s - 147) / 20) ** 2)
    ).astype(np.int64)
    fs = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper, counts)
    mix = FragmentMixDistribution(cfg.sizes.lower, cfg.sizes.upper).fit(fs)
    return DeviceEngine(cfg, mix, fs, mesh=mesh, pwm=PWM.default(),
                        conv_mode=conv)


def synth_windows(engine: DeviceEngine, n_frags: int, seed: int):
    """One batch of ATAC-like windows: nucleosome arrays at ~180 bp
    spacing (55% of fragments, ~147 bp around a dyad) plus short NFR
    fragments, over random sequence with a few N bases.

    Returns (mids [B, n_frags] sorted window-relative midpoints, sizes
    [B, n_frags], codes [B, W + L - 1] uint8 base codes starting at
    window position -pwm.up)."""
    rng = np.random.default_rng(seed)
    B, W = engine.cfg.window.batch, engine.width
    n_nuc = int(n_frags * 0.55)
    mids = np.empty((B, n_frags), np.int64)
    sizes = np.empty((B, n_frags), np.int64)
    for b in range(B):
        dyads = np.arange(int(rng.integers(0, 180)), W, 180)
        m_nuc = rng.choice(dyads, n_nuc) + np.rint(
            np.clip(rng.normal(0, 12, n_nuc), -40, 40)
        ).astype(np.int64)
        s_nuc = np.clip(rng.normal(156, 14, n_nuc), 130, 250).astype(np.int64)
        m_short = rng.integers(0, W, n_frags - n_nuc)
        s_short = np.clip(
            rng.exponential(42, n_frags - n_nuc) + 24, 24, 128
        ).astype(np.int64)
        m = np.clip(np.concatenate([m_nuc, m_short]), 0, W - 1)
        s = np.concatenate([s_nuc, s_short])
        order = np.argsort(m, kind="stable")
        mids[b], sizes[b] = m[order], s[order]
    codes = rng.integers(0, 4, size=(B, engine.seq_codes_width())).astype(
        np.uint8
    )
    codes[0, 3:10] = 4  # N bases ride the 2-bit wire's escape list
    return mids, sizes, codes


def pool_batch(mids: np.ndarray, sizes: np.ndarray):
    """[B, F] sorted window-relative fragments -> the wire-v7 upload
    (pool [cap//2 + cap] uint8, table [B, 3] int32, emax), one pool
    segment per window (models/data.py :: make_pool_batches builds the
    same layout from chunks)."""
    from nucleoatac_jax.models.data import _bucket, _encode_chunk_stream12

    nib_parts, sz_parts, rows = [], [], []
    pos = 0
    emax_raw = 1
    for b in range(mids.shape[0]):
        rn, rsz, _, _ = _encode_chunk_stream12(mids[b], sizes[b], 0)
        n_rec = len(rn)
        emax_raw = max(emax_raw, n_rec)
        rows.append((pos, n_rec, 0))
        if n_rec & 1:
            rn = np.append(rn, np.uint8(0))
            rsz = np.append(rsz, np.uint8(0))
        nib_parts.append(rn)
        sz_parts.append(rsz)
        pos += len(rn)
    cap = _bucket(pos, minimum=1024)
    nib_cat = np.zeros(cap, np.uint8)
    nib_cat[:pos] = np.concatenate(nib_parts)
    sz_cat = np.zeros(cap, np.uint8)
    sz_cat[:pos] = np.concatenate(sz_parts)
    pool = np.concatenate(
        [(nib_cat[0::2] | (nib_cat[1::2] << 4)).astype(np.uint8), sz_cat]
    )
    return pool, np.asarray(rows, np.int32), _bucket(emax_raw)


class StageErrors(NamedTuple):
    ll_max: float  # max |LL_f32 - LL_f64| over core columns
    norm_max: float  # max |norm_f32 - norm_f64| over core columns
    n_certified: int  # certified occ positions whose picks were compared
    n_picks_wrong: int  # of those, positions whose picks differ from f64


def _log_bias64(engine: DeviceEngine, codes_row: np.ndarray) -> np.ndarray:
    """Host f64 PWM log bias of one code row (core/pwm.py ::
    PWM.bias_track), aligned to window columns [0, W)."""
    seq = np.frombuffer(b"ACGTN", np.uint8)[np.minimum(codes_row, 4)]
    up = engine.pwm.up
    return engine.pwm.bias_track(seq.tobytes())[up : up + engine.width]


def _mirror_window(engine: DeviceEngine, mids, sizes, codes_row):
    """f64 mirror of one window over the core columns: (LL [core, G],
    grid picks [3, core] (occ, lower, upper), norm [core])."""
    cfg = engine.cfg
    core = slice(engine.core_lo, engine.core_lo + engine.core)
    full = mirror.rasterize(
        mids, sizes, cfg.sizes.lower, cfg.sizes.upper, engine.width
    )
    occ64 = mirror.occupancy_window(
        full, engine.log_mix64, engine.alpha_grid64, cfg.occ.flank,
        cfg.occ.ci_drop,
    )
    fmat = mirror.rasterize(
        mids, sizes, cfg.vmat.lower, cfg.vmat.upper, engine.width
    )
    b064 = mirror.bias_mat(
        _log_bias64(engine, codes_row), engine.size_probs64,
        cfg.vmat.lower, cfg.vmat.upper, engine.core_lo, engine.core_hi,
    )
    norm64 = mirror.nuc_scores(
        fmat, b064, np.asarray(engine.vmat.mat, np.float64),
        cfg.nuc.v_floor, cfg.nuc.var_floor,
    ).norm
    picks = np.stack([occ64.occ, occ64.lower, occ64.upper])
    return occ64.ll[core], picks[:, core], norm64[core]


def mirror_windows(engine: DeviceEngine, mids, sizes, codes) -> list:
    """_mirror_window for every window of a batch, on a thread pool (the
    numpy kernels release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(
            functools.partial(_mirror_window, engine), mids, sizes, codes
        ))


def raster(engine: DeviceEngine, mids: np.ndarray, sizes: np.ndarray):
    """The production pool raster of one batch: f32 [B, S, W] on device."""
    pool, table, emax = pool_batch(mids, sizes)
    return engine._raster_pool(jnp.asarray(pool), jnp.asarray(table), emax)


def nuc_norm(
    engine: DeviceEngine,
    mat: jax.Array,
    codes: np.ndarray,
    conv_precision: Optional[jax.lax.Precision] = None,
) -> jax.Array:
    """f32 nuc norm [B, W] from the production PWM-bias, bias-matrix,
    conv and finish stages, before the wire quantisation.
    ``conv_precision`` overrides ops/xcorr.py :: CONV_PRECISION."""
    from nucleoatac_jax.models.data import pack_2bit_codes

    packed2, esc, ok = pack_2bit_codes(codes)
    if not ok:
        raise ValueError("too many N bases for the 2-bit escape list")
    b0 = engine._bias(
        engine._logbias_2bit(jnp.asarray(packed2), jnp.asarray(esc))
    )
    convs = engine._convs
    if conv_precision is not None:
        convs = jax.jit(
            functools.partial(engine._convs_impl, precision=conv_precision)
        )
    return engine._finish5(*convs(mat, b0))[:, 0]


def stage_errors(
    engine: DeviceEngine,
    mids: np.ndarray,
    sizes: np.ndarray,
    codes: np.ndarray,
    conv_precision: Optional[jax.lax.Precision] = None,
    reference: Optional[list] = None,
) -> StageErrors:
    """Run one batch through the production stages and compare each with
    the f64 mirror (``reference``: mirror_windows of the same batch,
    computed here when not given). ``conv_precision`` overrides the conv
    stack's matmul precision (default: the production
    ops/xcorr.py :: CONV_PRECISION)."""
    if reference is None:
        reference = mirror_windows(engine, mids, sizes, codes)
    mat = raster(engine, mids, sizes)
    # the occ stage's own program, with its LL surface as a second output:
    # the LL compared below is the one the certified flags were decided on
    occ2, ll32 = jax.jit(
        functools.partial(engine._occ_packed2_impl, return_ll=True)
    )(mat)
    idx, cert = engine.decode_occ2(np.asarray(occ2))
    norm32 = np.asarray(
        nuc_norm(engine, mat, codes, conv_precision), np.float64
    )
    ll32 = np.asarray(ll32, np.float64)

    core = slice(engine.core_lo, engine.core_lo + engine.core)
    ll_max = norm_max = 0.0
    n_cert = n_wrong = 0
    for b, (ll64, picks64, norm64) in enumerate(reference):
        ll_max = max(ll_max, float(np.abs(ll32[b] - ll64).max()))
        norm_max = max(norm_max, float(np.abs(norm32[b, core] - norm64).max()))
        sel = cert[b]
        got = engine.alpha_grid64[idx[b]]
        n_cert += int(sel.sum())
        n_wrong += int((got[:, sel] != picks64[:, sel]).any(axis=0).sum())
    return StageErrors(ll_max, norm_max, n_cert, n_wrong)
